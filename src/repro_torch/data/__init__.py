"""Data substrate: projection-data generation for CT and the
deterministic synthetic token pipeline for LM training."""

from .ct import make_ct_dataset
from .tokens import TokenPipeline, TokenPipelineConfig, feature_batch

__all__ = ["make_ct_dataset", "TokenPipeline", "TokenPipelineConfig",
           "feature_batch"]
