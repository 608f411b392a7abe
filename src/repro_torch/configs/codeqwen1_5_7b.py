"""codeqwen1.5-7b [dense]: qwen1.5-arch decoder (hf:Qwen/CodeQwen1.5-7B).
32L d_model=4096 32H (kv=32) d_ff=13440 vocab=92416, rope theta 1e6."""

from repro_torch.models.lm import ArchConfig

CONFIG = ArchConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv=32,
    d_ff=13440,
    vocab=92416,
    pattern=("attn",),
    rope_theta=1_000_000.0,
    sub_quadratic=False,
)


def reduced() -> ArchConfig:
    return ArchConfig(
        name="codeqwen1.5-7b-smoke", family="dense", n_layers=2,
        d_model=128, n_heads=4, n_kv=4, d_ff=256, vocab=512,
        pattern=("attn",), rope_theta=1_000_000.0, sub_quadratic=False,
    )
