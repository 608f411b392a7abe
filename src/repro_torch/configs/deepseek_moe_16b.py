"""deepseek-moe-16b [moe] (arXiv:2401.06066): fine-grained MoE with 2 shared
+ 64 routed experts top-6, expert d_ff=1408, first layer dense (d_ff=10944).
28L d_model=2048 16H (kv=16) vocab=102400."""

from repro_torch.models.lm import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv=16,
    d_ff=10944,                 # dense first layer
    d_expert=1408,
    vocab=102400,
    n_experts=64,
    top_k=6,
    n_shared=2,
    prelude=("dense",),
    pattern=("moe",),
    sub_quadratic=False,
)


def reduced() -> ArchConfig:
    return ArchConfig(
        name="deepseek-moe-16b-smoke", family="moe", n_layers=3,
        d_model=128, n_heads=4, n_kv=4, d_ff=256, d_expert=64, vocab=512,
        n_experts=8, top_k=2, n_shared=1, prelude=("dense",),
        pattern=("moe",), sub_quadratic=False,
    )
