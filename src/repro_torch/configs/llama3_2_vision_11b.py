"""llama-3.2-vision-11b [vlm] (hf:meta-llama/Llama-3.2-11B-Vision): 40-layer
text backbone with a gated cross-attention image layer every 5th layer
(8 sites).  The vision tower is a STUB: ``input_specs`` provides
precomputed patch embeddings (B, n_patches, d_model).  40L d_model=4096
32H (kv=8) d_ff=14336 vocab=128256."""

from repro_torch.models.lm import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv=8,
    d_ff=14336,
    vocab=128256,
    pattern=("attn", "attn", "attn", "attn", "xattn"),
    rope_theta=500_000.0,
    n_ctx_tokens=1600,                # patch embeddings from the stub tower
    sub_quadratic=False,
)


def reduced() -> ArchConfig:
    return ArchConfig(
        name="llama-3.2-vision-11b-smoke", family="vlm", n_layers=5,
        d_model=128, n_heads=4, n_kv=2, d_ff=256, vocab=512,
        pattern=("attn", "attn", "attn", "attn", "xattn"),
        rope_theta=500_000.0, n_ctx_tokens=16, sub_quadratic=False,
    )
