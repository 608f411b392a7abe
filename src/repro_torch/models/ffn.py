"""Feed-forward variants: gated (SwiGLU / GeGLU) and plain MLPs, on one
device and tensor-parallel on a mesh.

Port of ``repro/models/ffn.py``.  Its sequence-parallel layout (weights
replicated, each model shard the FFN of its rows) is
:class:`~repro_torch.models.sharded_lm.ShardedLM`'s, which calls
:func:`ffn_fwd` on a shard's rows of an MLA block.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

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


#: the reference's logical axes of the FFN leaves (``FFN_AXES``)
FFN_AXES = {
    "w_gate": ("embed", "mlp"),
    "w_up": ("embed", "mlp"),
    "w_down": ("mlp", "embed"),
}


def ffn_fwd(p, x: torch.Tensor, cfg: FFNConfig) -> torch.Tensor:
    if cfg.gated:
        h = _act(x @ p["w_gate"], cfg.activation) * (x @ p["w_up"])
    else:
        h = _act(x @ p["w_up"], cfg.activation)
    return h @ p["w_down"]


def ffn_fwd_mesh(ps, xs: List[torch.Tensor], cfg: FFNConfig, split: bool,
                 comm, group: Sequence[int]) -> List[torch.Tensor]:
    """:func:`ffn_fwd` of one data replica over its model shards
    ``group``: member ``j`` holds the replicated input ``xs[j]`` and its
    slices ``ps[j]``; with ``split`` (``mlp`` on the model axis) those are
    blocks of ``w_gate``'s and ``w_up``'s columns and of ``w_down``'s rows,
    and the members' partial outputs are summed over the group
    (:meth:`MeshComm.all_reduce`); else each holds the whole FFN."""
    outs = [ffn_fwd(p, x, cfg) for p, x in zip(ps, xs)]
    return comm.all_reduce(outs, group, "ffn") if split else outs
