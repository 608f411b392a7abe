"""stablelm-1.6b [dense] (hf:stabilityai/stablelm-2-1_6b).
24L d_model=2048 32H (kv=32) d_ff=5632 vocab=100352."""

from repro_torch.models.lm import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv=32,
    d_ff=5632,
    vocab=100352,
    pattern=("attn",),
    sub_quadratic=False,
)


def reduced() -> ArchConfig:
    return ArchConfig(
        name="stablelm-1.6b-smoke", family="dense", n_layers=2,
        d_model=128, n_heads=8, n_kv=8, d_ff=256, vocab=512,
        pattern=("attn",), sub_quadratic=False,
    )
