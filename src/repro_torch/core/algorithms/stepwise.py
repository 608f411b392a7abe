"""Step-wise algorithm registry: every algorithm as a resumable iterator

    state = alg.init(proj, geo, angles, op=op, **params)
    state = alg.step(state)          # one outer iteration
    image = alg.finalize(state)

Port of ``repro/core/algorithms/stepwise.py``.  The one-shot entry points
wrap the same step functions, so step-wise execution is bit-identical to
the one-shot path.  ``ckpt_fields`` names the resumable part of a state;
everything else is rebuilt by ``init``.  :func:`restore_state` also takes
the numpy dict the reference's ``checkpoint_state`` writes, which is how a
run carries over from the JAX package.

Every algorithm of the reference is registered: CGLS, OS-SART / SIRT /
SART, FISTA-TV (also as ``fista_tv``), ASD-POCS and FDK.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..operator import CTOperator
from .asd_pocs import asd_pocs_finalize, asd_pocs_init, asd_pocs_step
from .cgls import cgls_finalize, cgls_init, cgls_step
from .fdk import fdk
from .fista import fista_tv_finalize, fista_tv_init, fista_tv_step
from .sart import ossart_finalize, ossart_init, ossart_step


@dataclasses.dataclass(frozen=True)
class StepwiseAlgorithm:
    """A reconstruction algorithm as a resumable (init, step, finalize)."""
    name: str
    init: Callable[..., Any]
    step: Callable[[Any], Any]
    finalize: Callable[[Any], Any]
    ckpt_fields: Tuple[str, ...]
    iterative: bool = True
    # operator weighting the algorithm assumes: Krylov methods need the
    # exact adjoint
    default_bp_weight: str = "pmatched"
    # checkpointed scalars that are also valid ``init`` kwargs: fed back
    # on restore, they need not be recomputed
    resume_params: Tuple[str, ...] = ()


# ---- direct (single-step) algorithms ---------------------------------------

@dataclasses.dataclass
class FDKState:
    """One-shot FDK wrapped in the step-wise protocol (a single step)."""
    op: Any
    proj: Any
    geo: Any
    angles: np.ndarray
    x: Optional[torch.Tensor] = None
    it: int = 0


def fdk_init(proj, geo, angles, op=None, device=None,
             **_ignored) -> FDKState:
    if op is None:
        op = CTOperator(geo, np.asarray(angles, np.float32), mode="plain",
                        device=device)
    return FDKState(op=op, proj=proj, geo=geo,
                    angles=np.asarray(angles, np.float32))


def fdk_step(st: FDKState) -> FDKState:
    st.x = fdk(st.proj, st.geo, st.angles, op=st.op)
    st.it += 1
    return st


def fdk_finalize(st: FDKState):
    return st.x


# ---- aliases (SIRT / SART are OS-SART with fixed subset sizes) -------------

def _sirt_init(proj, geo, angles, **params):
    params["subset_size"] = len(np.asarray(angles))
    return ossart_init(proj, geo, angles, **params)


def _sart_init(proj, geo, angles, **params):
    params["subset_size"] = 1
    return ossart_init(proj, geo, angles, **params)


def _ossart(name: str, init: Callable) -> StepwiseAlgorithm:
    return StepwiseAlgorithm(name, init, ossart_step, ossart_finalize,
                             ckpt_fields=("x", "lmbda", "it"),
                             resume_params=("lmbda",))


REGISTRY: Dict[str, StepwiseAlgorithm] = {
    "ossart": _ossart("ossart", ossart_init),
    "sirt": _ossart("sirt", _sirt_init),
    "sart": _ossart("sart", _sart_init),
    "cgls": StepwiseAlgorithm(
        "cgls", cgls_init, cgls_step, cgls_finalize,
        ckpt_fields=("x", "r", "p", "gamma", "it"),
        default_bp_weight="matched"),
    "fista": StepwiseAlgorithm(
        "fista", fista_tv_init, fista_tv_step, fista_tv_finalize,
        ckpt_fields=("x", "y", "t", "L", "it"),
        default_bp_weight="matched", resume_params=("L",)),
    "asd_pocs": StepwiseAlgorithm(
        "asd_pocs", asd_pocs_init, asd_pocs_step, asd_pocs_finalize,
        ckpt_fields=("x", "lmbda", "dtvg", "dp_first", "it"),
        resume_params=("lmbda",)),
    "fdk": StepwiseAlgorithm(
        "fdk", fdk_init, fdk_step, fdk_finalize,
        ckpt_fields=("x", "it"), iterative=False),
}
REGISTRY["fista_tv"] = REGISTRY["fista"]


def get_algorithm(name: str) -> StepwiseAlgorithm:
    try:
        return REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown algorithm {name!r}; "
                         f"known: {sorted(REGISTRY)}") from None


def checkpoint_state(alg: StepwiseAlgorithm, state) -> Dict[str, Any]:
    """Snapshot the resumable fields as host (numpy) values — the same
    dict the reference writes."""
    out: Dict[str, Any] = {}
    for f in alg.ckpt_fields:
        v = getattr(state, f)
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        out[f] = v
    return out


def restore_state(alg: StepwiseAlgorithm, state, ckpt: Dict[str, Any]):
    """Overwrite a freshly init'ed state with checkpointed fields, moving
    arrays to the device the state's vectors live on (``op.data_device``).
    ``ckpt`` may come from this package or from the reference's
    ``checkpoint_state`` (numpy values either way)."""
    dev = state.op.data_device
    for f, v in ckpt.items():
        if isinstance(v, (np.ndarray, np.generic)) and \
                np.asarray(v).dtype != object:
            v = torch.as_tensor(np.array(v, copy=True)).to(dev)
        elif isinstance(v, torch.Tensor):
            v = v.to(dev)
        setattr(state, f, v)
    return state


__all__ = ["StepwiseAlgorithm", "REGISTRY", "get_algorithm",
           "checkpoint_state", "restore_state",
           "FDKState", "fdk_init", "fdk_step", "fdk_finalize"]
