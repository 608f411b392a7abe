"""CGLS -- conjugate gradient on the normal equations (paper SS3.2, coffee
bean reconstruction).  Requires the *matched* adjoint: with an unmatched
backprojector CG loses its convergence guarantees.

Port of ``repro/core/algorithms/cgls.py`` on tensors.  The vectors live
where the operator keeps its data (``op.data_device``: the device in plain
mode, host memory in stream mode); the recurrence scalars stay 0-d tensors
there, so a plain-mode step never waits for the device.

Step-wise form (``cgls_init`` / ``cgls_step``): the Krylov recurrence is
carried in a :class:`CGLSState`, so a caller can advance one iteration at
a time and checkpoint between iterations.  The one-shot :func:`cgls` runs
the identical recurrence.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..device import DeviceLike, as_f32, norm
from ..operator import CTOperator


@dataclasses.dataclass
class CGLSState:
    """Resumable CGLS Krylov state (x, residual, search direction)."""
    op: CTOperator
    b: torch.Tensor
    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    gamma: torch.Tensor
    it: int = 0


def _sq(v: torch.Tensor) -> torch.Tensor:
    v = v.reshape(-1)
    return torch.dot(v, v)


def cgls_init(proj, geo, angles, op: Optional[CTOperator] = None,
              x0=None, device: DeviceLike = None,
              **_ignored) -> CGLSState:
    angles = np.asarray(angles, np.float32)
    if op is None:
        op = CTOperator(geo, angles, mode="plain", bp_weight="matched",
                        device=device)
    dev = op.data_device
    b = as_f32(proj, dev)
    x = (torch.zeros(geo.n_voxel, dtype=torch.float32, device=dev)
         if x0 is None else as_f32(x0, dev))
    r = b - op.A(x)
    p = op.At(r, weight="matched")
    return CGLSState(op=op, b=b, x=x, r=r, p=p, gamma=_sq(p))


def cgls_step(st: CGLSState) -> CGLSState:
    """One CG iteration on the normal equations."""
    q = st.op.A(st.p)
    alpha = st.gamma / (_sq(q) + 1e-30)
    st.x = st.x + alpha * st.p
    st.r = st.r - alpha * q
    s = st.op.At(st.r, weight="matched")
    gamma_new = _sq(s)
    beta = gamma_new / (st.gamma + 1e-30)
    st.gamma = gamma_new
    st.p = s + beta * st.p
    st.it += 1
    return st


def cgls_finalize(st: CGLSState) -> torch.Tensor:
    return st.x


def cgls(proj, geo, angles, n_iter: int = 15,
         op: Optional[CTOperator] = None, x0=None,
         callback: Optional[Callable] = None,
         device: DeviceLike = None) -> torch.Tensor:
    st = cgls_init(proj, geo, angles, op=op, x0=x0, device=device)
    for it in range(n_iter):
        st = cgls_step(st)
        if callback is not None:
            callback(it, st.x, float(norm(st.r)))
    return cgls_finalize(st)
