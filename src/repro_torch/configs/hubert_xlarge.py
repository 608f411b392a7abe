"""hubert-xlarge [audio]: encoder-only transformer backbone
(arXiv:2106.07447); the conv waveform frontend is a STUB -- ``input_specs``
provides precomputed frame embeddings (B, S, d_model).  48L d_model=1280
16H (kv=16) d_ff=5120 vocab=504 (codebook targets).  LayerNorm + plain GELU
FFN.  decode_32k / long_500k skipped (no decode step)."""

from repro_torch.models.lm import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv=16,
    d_ff=5120,
    vocab=504,
    pattern=("attn_bidir",),
    norm="layer",
    activation="gelu",
    encoder_only=True,
    sub_quadratic=False,
)


def reduced() -> ArchConfig:
    return ArchConfig(
        name="hubert-xlarge-smoke", family="audio", n_layers=2,
        d_model=128, n_heads=4, n_kv=4, d_ff=256, vocab=64,
        pattern=("attn_bidir",), norm="layer", activation="gelu",
        encoder_only=True, sub_quadratic=False,
    )
