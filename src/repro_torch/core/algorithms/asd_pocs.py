"""ASD-POCS (Sidky & Pan): alternate data consistency (OS-SART sweeps)
with TV steepest-descent minimisation (paper SS2.3's first regulariser),
with the adaptive step-size bookkeeping of the original algorithm
(simplified as in TIGRE's defaults).

Port of ``repro/core/algorithms/asd_pocs.py`` on tensors.  The data sweep
runs through the operator, so its vectors live where the operator keeps
its data (``op.data_device``: the device in plain mode, host memory in
stream mode).  The TV descent always runs on ``op.device``, through the
``tv_grad`` kernel: in stream mode the iterate is copied to the device
for it and back afterwards, as the reference holds the whole volume on
its device for this step.  That step is not split into slabs: at N=512 it
holds about three 512 MB volumes on the device whatever the memory
budget (streaming it through the halo-split ``dist_minimize_tv`` is ROADMAP
Queue A2).

Step-wise form (``asd_pocs_init`` / ``asd_pocs_step``): the adaptive
scalars (dtvg, dp_first, decaying lmbda) ride along in
:class:`ASDPOCSState` so a preempted job resumes with the exact same
step-size schedule; :func:`asd_pocs` wraps the same steps.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..device import DeviceLike, as_f32, norm
from ..operator import CTOperator
from ..regularization import minimize_tv
from .sart import OSSARTState, ossart_init, ossart_step


@dataclasses.dataclass
class ASDPOCSState:
    """Resumable ASD-POCS state (iterate + adaptive step-size scalars)."""
    op: CTOperator
    proj: torch.Tensor
    angles: np.ndarray
    subset_size: int
    lmbda: float
    lmbda_red: float
    tv_iters: int
    alpha: float
    alpha_red: float
    r_max: float
    x: torch.Tensor
    dtvg: Optional[float] = None
    dp_first: Optional[float] = None
    it: int = 0
    # cached OS-SART state: the normalisation factors are deterministic, so
    # computing them once (lazily, also after a checkpoint restore) gives
    # the same bits as a re-init every outer iteration
    data_state: Optional[OSSARTState] = None


def asd_pocs_init(proj, geo, angles, subset_size: int = 20,
                  lmbda: float = 1.0, lmbda_red: float = 0.99,
                  tv_iters: int = 20, alpha: float = 0.002,
                  alpha_red: float = 0.95, r_max: float = 0.95,
                  op: Optional[CTOperator] = None,
                  device: DeviceLike = None, **_ignored) -> ASDPOCSState:
    """With ``op=None`` a plain operator runs on the card, or on the CPU
    with ``device="cpu"``."""
    angles = np.asarray(angles, np.float32)
    if op is None:
        op = CTOperator(geo, angles, mode="plain", bp_weight="pmatched",
                        device=device)
    dev = op.data_device
    return ASDPOCSState(op=op, proj=as_f32(proj, dev), angles=angles,
                        subset_size=subset_size, lmbda=lmbda,
                        lmbda_red=lmbda_red, tv_iters=tv_iters, alpha=alpha,
                        alpha_red=alpha_red, r_max=r_max,
                        x=torch.zeros(geo.n_voxel, dtype=torch.float32,
                                      device=dev))


def asd_pocs_step(st: ASDPOCSState) -> ASDPOCSState:
    """One ASD-POCS iteration: OS-SART data sweep + adaptive TV descent."""
    x_prev = st.x
    if st.data_state is None:
        st.data_state = ossart_init(st.proj, st.op.geo, st.angles,
                                    subset_size=st.subset_size,
                                    lmbda=st.lmbda, op=st.op, x0=st.x)
    else:
        st.data_state.x = st.x
        st.data_state.lmbda = st.lmbda
    st.data_state = ossart_step(st.data_state)
    x = st.data_state.x
    st.lmbda *= st.lmbda_red

    dp = float(norm(x - x_prev))
    if st.dp_first is None:
        st.dp_first = dp
    if st.dtvg is None:
        st.dtvg = st.alpha * dp  # initial TV step from first data update

    x_before_tv = x.to(st.op.device)
    x_tv = minimize_tv(x_before_tv, hyper=st.dtvg, n_iters=st.tv_iters)
    dg = float(norm(x_tv - x_before_tv))

    # adaptive step (Sidky & Pan): if TV moved more than the data step,
    # shrink the TV step size
    if dg > st.r_max * dp and dp > 0.01 * st.dp_first:
        st.dtvg *= st.alpha_red
    st.x = x_tv.to(st.op.data_device)
    st.it += 1
    return st


def asd_pocs_finalize(st: ASDPOCSState) -> torch.Tensor:
    return st.x


def asd_pocs(proj, geo, angles, n_iter: int = 10, subset_size: int = 20,
             lmbda: float = 1.0, lmbda_red: float = 0.99,
             tv_iters: int = 20, alpha: float = 0.002,
             alpha_red: float = 0.95, r_max: float = 0.95,
             op: Optional[CTOperator] = None,
             callback: Optional[Callable] = None,
             device: DeviceLike = None) -> torch.Tensor:
    st = asd_pocs_init(proj, geo, angles, subset_size=subset_size,
                       lmbda=lmbda, lmbda_red=lmbda_red, tv_iters=tv_iters,
                       alpha=alpha, alpha_red=alpha_red, r_max=r_max, op=op,
                       device=device)
    for it in range(n_iter):
        st = asd_pocs_step(st)
        if callback is not None:
            callback(it, st.x)
    return asd_pocs_finalize(st)
