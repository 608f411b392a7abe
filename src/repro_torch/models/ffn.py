"""Feed-forward variants: gated (SwiGLU / GeGLU) and plain MLPs.

Port of ``repro/models/ffn.py`` for one device (no sequence-parallel
sharding).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .common import dense_init

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class FFNConfig:
    d_model: int
    d_ff: int
    activation: str = "silu"        # silu (llama/qwen), gelu_tanh (gemma2)
    gated: bool = True              # gated (SwiGLU/GeGLU) vs plain 2-layer


def _act(x: torch.Tensor, name: str) -> torch.Tensor:
    if name == "silu":
        return F.silu(x)
    if name == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    if name == "gelu":
        return F.gelu(x)
    if name == "relu":
        return F.relu(x)
    raise ValueError(f"unknown activation {name!r}")


def init_ffn(gen: Optional[torch.Generator], cfg: FFNConfig,
             dtype=torch.bfloat16, device=None) -> Params:
    if cfg.gated:
        return {
            "w_gate": dense_init(gen, (cfg.d_model, cfg.d_ff), 0, dtype,
                                 device),
            "w_up": dense_init(gen, (cfg.d_model, cfg.d_ff), 0, dtype, device),
            "w_down": dense_init(gen, (cfg.d_ff, cfg.d_model), 0, dtype,
                                 device),
        }
    return {
        "w_up": dense_init(gen, (cfg.d_model, cfg.d_ff), 0, dtype, device),
        "w_down": dense_init(gen, (cfg.d_ff, cfg.d_model), 0, dtype, device),
    }


def ffn_fwd(p, x: torch.Tensor, cfg: FFNConfig) -> torch.Tensor:
    if cfg.gated:
        h = _act(x @ p["w_gate"], cfg.activation) * (x @ p["w_up"])
    else:
        h = _act(x @ p["w_up"], cfg.activation)
    return h @ p["w_down"]
