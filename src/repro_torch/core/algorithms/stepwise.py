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

Only CGLS is ported; the other algorithms arrive with later slices
(ROADMAP Queue A 8-9).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from .cgls import cgls_finalize, cgls_init, cgls_step


@dataclasses.dataclass(frozen=True)
class StepwiseAlgorithm:
    """A reconstruction algorithm as a resumable (init, step, finalize)."""
    name: str
    init: Callable[..., Any]
    step: Callable[[Any], Any]
    finalize: Callable[[Any], Any]
    ckpt_fields: Tuple[str, ...]
    # operator weighting the algorithm assumes: Krylov methods need the
    # exact adjoint
    default_bp_weight: str = "pmatched"


REGISTRY: Dict[str, StepwiseAlgorithm] = {
    "cgls": StepwiseAlgorithm(
        "cgls", cgls_init, cgls_step, cgls_finalize,
        ckpt_fields=("x", "r", "p", "gamma", "it"),
        default_bp_weight="matched"),
}

#: the reference's catalogue, ported by later slices
NOT_YET_PORTED = ("ossart", "sirt", "sart", "fista", "fista_tv", "asd_pocs",
                  "fdk")


def get_algorithm(name: str) -> StepwiseAlgorithm:
    try:
        return REGISTRY[name]
    except KeyError:
        if name in NOT_YET_PORTED:
            raise ValueError(
                f"algorithm {name!r} is not ported yet (ROADMAP Queue A "
                f"8-9); ported: {sorted(REGISTRY)}") from None
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
           "checkpoint_state", "restore_state"]
