"""xlstm-350m [ssm] (arXiv:2405.04517): alternating mLSTM (parallel matrix
memory) and sLSTM (sequential scalar memory) blocks at ratio 3:1.
24L d_model=1024 4H vocab=50304, no separate FFN (d_ff=0; blocks carry
their own projections).  Sub-quadratic: long_500k runs (O(1) decode
state)."""

from repro_torch.models.lm import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv=4,
    d_ff=0,
    vocab=50304,
    pattern=("mlstm", "mlstm", "mlstm", "slstm"),
    sub_quadratic=True,
)


def reduced() -> ArchConfig:
    return ArchConfig(
        name="xlstm-350m-smoke", family="ssm", n_layers=4,
        d_model=64, n_heads=2, n_kv=2, d_ff=0, vocab=512,
        pattern=("mlstm", "mlstm", "mlstm", "slstm"), sub_quadratic=True,
    )
