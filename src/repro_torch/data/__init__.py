from .ct import make_ct_dataset

__all__ = ["make_ct_dataset"]
