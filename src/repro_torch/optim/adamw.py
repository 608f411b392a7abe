"""AdamW on trees of tensors.

Port of ``repro/optim/adamw.py`` for one device.  A tree is a dict of
tensors (a model's ``named_parameters()``, or nested dicts of them); the
state holds float32 first and second moments of the same structure and an
int32 step.  Every step-dependent scalar (the bias corrections, a
scheduled learning rate) is a float32 tensor, as the reference's jnp
computes it, not a Python double.  The reference's ``zero1_spec`` (ZeRO-1:
the moments sharded over the data axis of a mesh) is not ported: it needs
several devices (ROADMAP A3.4).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

Tree = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def _map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of dict trees of one structure."""
    return {k: _map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
            else fn(v, *(r[k] for r in rest)) for k, v in tree.items()}


def _leaves(tree: Tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def adamw_init(params: Tree) -> Dict[str, Any]:
    """Zero float32 moments ``m`` and ``v`` shaped as ``params`` (on their
    devices) and the step, an int32 0-d tensor."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = next(_leaves(params)).device
    return {"m": _map(zeros, params), "v": _map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum over the leaves of their float32 squared sums."""
    total = 0
    for g in _leaves(tree):
        total = total + torch.sum(torch.square(g.float()))
    return torch.sqrt(total)


def clip_by_global_norm(tree: Tree, max_norm: float) -> Tuple[Tree,
                                                               torch.Tensor]:
    """(the leaves in float32 scaled by ``min(1, max_norm / (norm +
    1e-9))``, the norm)."""
    gn = global_norm(tree)
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return _map(lambda g: g.float() * scale, tree), gn


def adamw_update(params: Tree, grads: Tree, state: Dict[str, Any],
                 cfg: AdamWConfig,
                 lr: Optional[Union[float, torch.Tensor]] = None):
    """One AdamW step on gradients clipped to ``cfg.clip_norm``: decoupled
    weight decay on every leaf, bias-corrected moments, each new parameter
    computed in float32 and cast to its own type.  ``lr``: a float or a
    float32 tensor (a schedule's value), ``cfg.lr`` when None.  Returns
    (new params, new state, {"grad_norm": the norm before clipping}); the
    inputs are not modified."""
    grads, gn = clip_by_global_norm(grads, cfg.clip_norm)
    step = state["step"] + 1
    lr = cfg.lr if lr is None else lr
    stepf = step.float()
    b1c = 1.0 - torch.pow(cfg.b1, stepf)
    b2c = 1.0 - torch.pow(cfg.b2, stepf)

    def upd(p, g, m, v):
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        mh = m / b1c
        vh = v / b2c
        delta = mh / (torch.sqrt(vh) + cfg.eps) + \
            cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m, v

    out = _map(upd, params, grads, state["m"], state["v"])

    def pick(i):
        return _map(lambda t: t[i], out)
    return (pick(0), {"m": pick(1), "v": pick(2), "step": step},
            {"grad_norm": gn})
