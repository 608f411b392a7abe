"""minicpm3-4b [dense, MLA] (hf:openbmb/MiniCPM3-4B): multi-head latent
attention with q_lora 768 / kv_lora 256 / nope 64 / rope 32 / v 64.
62L d_model=2560 40H d_ff=6400 vocab=73448."""

from repro_torch.models.lm import ArchConfig

CONFIG = ArchConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv=40,
    d_ff=6400,
    vocab=73448,
    pattern=("mla",),
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_nope_dim=64,
    qk_rope_dim=32,
    v_head_dim=64,
    sub_quadratic=False,
)


def reduced() -> ArchConfig:
    return ArchConfig(
        name="minicpm3-4b-smoke", family="dense", n_layers=2,
        d_model=128, n_heads=4, n_kv=4, d_ff=256, vocab=512,
        pattern=("mla",), q_lora_rank=48, kv_lora_rank=32,
        qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16, sub_quadratic=False,
    )
