"""FISTA with TV proximal step (Beck & Teboulle), TIGRE's FISTA analogue.

    y_{k}   : extrapolated point
    x_{k+1} = prox_{TV/L}( y_k - (1/L) A^T (A y_k - b) )
    t_{k+1} = (1 + sqrt(1 + 4 t_k^2)) / 2
    y_{k+1} = x_{k+1} + (t_k - 1)/t_{k+1} (x_{k+1} - x_k)

Port of ``repro/core/algorithms/fista.py`` on tensors.  The gradient step
runs through the operator with the exact adjoint (the Joseph pair), so the
vectors live where the operator keeps its data (``op.data_device``: the
device in plain mode, host memory in stream mode).  The proximal operator
is the ROF denoiser (paper SS2.3's second regulariser), plain PyTorch ops
that always run on ``op.device``: in stream mode its input is copied to
the device and its result back.  L is estimated by power iteration on
A^T A unless given.

Step-wise form (``fista_tv_init`` / ``fista_tv_step``): the momentum
variables (x, y, t) live in a :class:`FISTAState`, so a caller can advance
one iteration at a time and checkpoint between iterations; :func:`fista_tv`
wraps the same steps.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..device import DeviceLike, as_f32
from ..operator import CTOperator
from ..regularization import rof_denoise


@dataclasses.dataclass
class FISTAState:
    """Resumable FISTA state (iterate, extrapolated point, momentum)."""
    op: CTOperator
    b: torch.Tensor
    L: float
    tv_lambda: float
    tv_iters: int
    x: torch.Tensor
    y: torch.Tensor
    t: float = 1.0
    it: int = 0


def fista_tv_init(proj, geo, angles, tv_lambda: float = 20.0,
                  tv_iters: int = 20, L: Optional[float] = None,
                  op: Optional[CTOperator] = None,
                  device: DeviceLike = None, **_ignored) -> FISTAState:
    """With ``op=None`` a plain operator with the exact adjoint runs on the
    card, or on the CPU with ``device="cpu"``."""
    angles = np.asarray(angles, np.float32)
    if op is None:
        op = CTOperator(geo, angles, mode="plain", bp_weight="matched",
                        device=device)
    if L is None:
        L = op.norm_squared_est(n_iter=6) * 1.05
    dev = op.data_device
    x = torch.zeros(geo.n_voxel, dtype=torch.float32, device=dev)
    return FISTAState(op=op, b=as_f32(proj, dev), L=L, tv_lambda=tv_lambda,
                      tv_iters=tv_iters, x=x, y=x)


def fista_tv_step(st: FISTAState) -> FISTAState:
    """One FISTA iteration: gradient step + TV prox + momentum update."""
    grad = st.op.At(st.op.A(st.y) - st.b, weight="matched")
    z = st.y - grad / st.L
    x_new = rof_denoise(z.to(st.op.device), lam=st.tv_lambda * st.L,
                        n_iters=st.tv_iters).to(st.op.data_device)
    t_new = (1.0 + float(np.sqrt(1.0 + 4.0 * st.t * st.t))) / 2.0
    st.y = x_new + ((st.t - 1.0) / t_new) * (x_new - st.x)
    st.x, st.t = x_new, t_new
    st.it += 1
    return st


def fista_tv_finalize(st: FISTAState) -> torch.Tensor:
    return st.x


def fista_tv(proj, geo, angles, n_iter: int = 20, tv_lambda: float = 20.0,
             tv_iters: int = 20, L: Optional[float] = None,
             op: Optional[CTOperator] = None,
             callback: Optional[Callable] = None,
             device: DeviceLike = None) -> torch.Tensor:
    st = fista_tv_init(proj, geo, angles, tv_lambda=tv_lambda,
                       tv_iters=tv_iters, L=L, op=op, device=device)
    for it in range(n_iter):
        st = fista_tv_step(st)
        if callback is not None:
            callback(it, st.x)
    return fista_tv_finalize(st)
