"""moonshot-v1-16b-a3b [moe] (hf:moonshotai/Moonlight-16B-A3B): fine-grained
MoE, 64 routed experts top-6 (per the assigned spec), expert d_ff=1408,
first layer dense.  48L d_model=2048 16H (kv=16) vocab=163840."""

from repro_torch.models.lm import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv=16,
    d_ff=11264,                 # dense first layer
    d_expert=1408,
    vocab=163840,
    n_experts=64,
    top_k=6,
    n_shared=0,
    prelude=("dense",),
    pattern=("moe",),
    sub_quadratic=False,
)


def reduced() -> ArchConfig:
    return ArchConfig(
        name="moonshot-v1-16b-a3b-smoke", family="moe", n_layers=3,
        d_model=128, n_heads=4, n_kv=4, d_ff=256, d_expert=64, vocab=512,
        n_experts=8, top_k=2, n_shared=0, prelude=("dense",),
        pattern=("moe",), sub_quadratic=False,
    )
