"""gemma2-9b [dense]: alternating local(4096-window)/global attention with
attention-logit softcap 50 and final-logit softcap 30, sandwich norms,
GeGLU, embedding scaling (arXiv:2408.00118).  42L d_model=3584 16H (kv=8)
head_dim=256 d_ff=14336 vocab=256000.  long_500k skipped (global layers are
full attention)."""

from repro_torch.models.lm import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv=8,
    head_dim=256,
    d_ff=14336,
    vocab=256000,
    pattern=("attn_local", "attn_global"),
    window=4096,
    softcap=50.0,
    final_softcap=30.0,
    activation="gelu_tanh",
    embed_scale=True,
    sub_quadratic=False,
)


def reduced() -> ArchConfig:
    return ArchConfig(
        name="gemma2-9b-smoke", family="dense", n_layers=4,
        d_model=128, n_heads=4, n_kv=2, head_dim=32, d_ff=256, vocab=512,
        pattern=("attn_local", "attn_global"), window=16,
        softcap=50.0, final_softcap=30.0, activation="gelu_tanh",
        embed_scale=True, sub_quadratic=False,
    )
