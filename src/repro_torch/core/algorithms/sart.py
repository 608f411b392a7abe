"""SART family: SIRT, SART, OS-SART (the paper's SS3.2 workhorse).

Port of ``repro/core/algorithms/sart.py`` on tensors.  Update rule
(relaxation ``lmbda``):

    x <- x + lmbda * V_s . A_s^T ( W_s . (b_s - A_s x) )

with W = 1 / A 1 (ray normalisation) and V = 1 / A^T 1 (voxel
normalisation), computed per angle subset ``s``:

* SIRT     : one subset = all angles.
* SART     : one subset per angle.
* OS-SART  : blocks of ``subset_size`` angles (paper used 200).

The vectors live where the operator keeps its data (``op.data_device``:
the device in plain mode, host memory in stream mode).  The step-wise form
(``ossart_init`` / ``ossart_step``) carries the iterate in an
:class:`OSSARTState`; the one-shot :func:`ossart` runs the same steps, so
both give the same bits.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

from ..device import DeviceLike, as_f32
from ..operator import CTOperator

_EPS = 1e-6


def _inv(t: torch.Tensor) -> torch.Tensor:
    return torch.where(t > _EPS, 1.0 / torch.clamp(t, min=_EPS), 0.0)


def _norm_factors(op: CTOperator, idx: np.ndarray):
    """(W, V) of the angle subset ``idx``: the inverse ray sums of a volume
    of ones and the inverse pmatched backprojection of projections of
    ones (0 where a sum is below ``_EPS``)."""
    angles = op.angles_np[idx]
    dev = op.data_device
    ones_vol = torch.ones(op.geo.n_voxel, dtype=torch.float32, device=dev)
    W = _inv(op.A(ones_vol, angles))
    ones_proj = torch.ones((len(idx),) + tuple(op.geo.n_detector),
                           dtype=torch.float32, device=dev)
    V = _inv(op.At(ones_proj, angles, weight="pmatched"))
    return W, V


@dataclasses.dataclass
class OSSARTState:
    """Resumable OS-SART iteration state (one entry per outer iteration)."""
    op: CTOperator
    proj: torch.Tensor
    angles: np.ndarray
    subsets: List[np.ndarray]
    factors: list
    lmbda: float
    bp_weight: str
    x: torch.Tensor
    it: int = 0


def ossart_init(proj, geo, angles, subset_size: int = 20, lmbda: float = 1.0,
                op: Optional[CTOperator] = None, x0=None,
                bp_weight: str = "pmatched", device: DeviceLike = None,
                **_ignored) -> OSSARTState:
    """Build the OS-SART state: normalisation factors + initial image.
    With ``op=None`` a plain operator runs on the card, or on the CPU with
    ``device="cpu"``."""
    angles = np.asarray(angles, np.float32)
    if op is None:
        op = CTOperator(geo, angles, mode="plain", device=device)
    dev = op.data_device
    subsets = op.subset_indices(subset_size)
    factors = [_norm_factors(op, idx) for idx in subsets]
    x = (torch.zeros(geo.n_voxel, dtype=torch.float32, device=dev)
         if x0 is None else as_f32(x0, dev))
    return OSSARTState(op=op, proj=as_f32(proj, dev), angles=angles,
                       subsets=subsets, factors=factors, lmbda=lmbda,
                       bp_weight=bp_weight, x=x)


def ossart_step(st: OSSARTState) -> OSSARTState:
    """One outer OS-SART iteration (a full sweep over all subsets)."""
    x = st.x
    for idx, (W, V) in zip(st.subsets, st.factors):
        a_sub = st.angles[idx]
        # subsets are contiguous runs of angles (CTOperator.subset_indices)
        b_sub = st.proj[int(idx[0]):int(idx[-1]) + 1]
        resid = W * (b_sub - st.op.A(x, a_sub))
        upd = st.op.At(resid, a_sub, weight=st.bp_weight)
        x = x + st.lmbda * V * upd
    st.x = x
    st.it += 1
    return st


def ossart_finalize(st: OSSARTState) -> torch.Tensor:
    return st.x


def ossart(proj, geo, angles, n_iter: int = 20, subset_size: int = 20,
           lmbda: float = 1.0, op: Optional[CTOperator] = None,
           x0=None, callback: Optional[Callable] = None,
           bp_weight: str = "pmatched",
           device: DeviceLike = None) -> torch.Tensor:
    """OS-SART.  ``subset_size=len(angles)`` gives SIRT; ``1`` gives SART."""
    st = ossart_init(proj, geo, angles, subset_size=subset_size, lmbda=lmbda,
                     op=op, x0=x0, bp_weight=bp_weight, device=device)
    for it in range(n_iter):
        st = ossart_step(st)
        if callback is not None:
            callback(it, st.x)
    return ossart_finalize(st)


def sirt(proj, geo, angles, n_iter: int = 20, lmbda: float = 1.0, **kw):
    return ossart(proj, geo, angles, n_iter=n_iter,
                  subset_size=len(np.asarray(angles)), lmbda=lmbda, **kw)


def sart(proj, geo, angles, n_iter: int = 20, lmbda: float = 1.0, **kw):
    return ossart(proj, geo, angles, n_iter=n_iter, subset_size=1,
                  lmbda=lmbda, **kw)
