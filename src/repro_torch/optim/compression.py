"""Int8 error-feedback gradient compression.

Port of ``repro/optim/compression.py``.  Each gradient leaf is quantised
to int8 with a per-leaf float32 scale before a cross-pod reduction; the
quantisation error is fed back into the next step's gradient (error
feedback keeps SGD/Adam convergence, Karimireddy et al. 2019).  On one
device there is no reduction to compress: these are the building blocks,
for the multi-device trainer (ROADMAP A3.4).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from .adamw import _map

Tree = Dict[str, Any]


def compress_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantisation: (q, scale), ``g ~ q *
    scale`` with q in [-127, 127] rounded half to even."""
    amax = torch.max(torch.abs(g)) + 1e-12
    scale = amax / 127.0
    q = torch.clip(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def make_error_feedback_state(grads: Tree) -> Tree:
    return _map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                      device=g.device), grads)


def ef_compress_update(grads: Tree, ef_state: Tree) -> Tuple[Tree, Tree]:
    """Add the fed-back error, then compress: returns (a tree of (q,
    scale) pairs, the new error state).  The caller reduces the quantised
    values across pods and decompresses."""
    def comp(g, e):
        c = g.float() + e
        q, s = compress_int8(c)
        return (q, s), c - decompress_int8(q, s)

    out = _map(comp, grads, ef_state)
    return (_map(lambda t: t[0], out), _map(lambda t: t[1], out))
