"""zamba2-7b [hybrid]: 81 Mamba2 blocks + a *shared* GQA attention block
invoked every 6th layer (13 call sites, one parameter set), per
arXiv:2411.15242.  81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000,
ssm_state=64.  Sub-quadratic: long_500k runs (decode state is O(1) for the
mamba layers; the shared-attn caches are linear reads)."""

from repro_torch.models.lm import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv=32,
    d_ff=14336,
    vocab=32000,
    ssm_state=64,
    prelude=("mamba", "mamba", "mamba"),
    pattern=("mamba", "mamba", "mamba", "mamba", "mamba", "mamba_shared"),
    sub_quadratic=True,
)


def reduced() -> ArchConfig:
    return ArchConfig(
        name="zamba2-7b-smoke", family="hybrid", n_layers=10,
        d_model=128, n_heads=4, n_kv=4, d_ff=256, vocab=512,
        ssm_state=16, mamba_head_dim=32, ssd_chunk=16,
        prelude=("mamba",),
        pattern=("mamba", "mamba", "mamba_shared"),
        sub_quadratic=True,
    )
