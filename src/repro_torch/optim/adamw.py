"""AdamW on trees of tensors, on one device and on a mesh (ZeRO-1).

Port of ``repro/optim/adamw.py``.  A tree is a dict of tensors (a model's
``named_parameters()``, or nested dicts of them); the state holds float32
first and second moments of the same structure and an int32 step.  Every
step-dependent scalar (the bias corrections, a scheduled learning rate)
is a float32 tensor, as the reference's jnp computes it, not a Python
double.

On a mesh (:class:`~repro_torch.models.sharded_lm.ShardedLM`),
:func:`adamw_update_mesh` reduces each parameter's gradient over the
shards that hold its slice (the data replicas, and the model shards of a
leaf replicated over ``model``), takes the global norm over the logical
leaves (each slice counted once), clips, and updates.  With ZeRO-1
(:func:`zero1_spec`) each data replica keeps and updates one piece of
each slice's moments and the updated pieces are all-gathered; without it
every replica updates every piece.  The pieces, their sums and their
arithmetic are the same either way, so the two give the same bits.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
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


def _adamw_leaf(p, g, m, v, cfg: AdamWConfig, lr, b1c, b2c):
    """(new p in its type, new m, new v) of one leaf (or piece) from its
    clipped float32 gradient ``g``."""
    m = cfg.b1 * m + (1 - cfg.b1) * g
    v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
    mh = m / b1c
    vh = v / b2c
    delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.float()
    return (p.float() - lr * delta).to(p.dtype), m, v


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
        return _adamw_leaf(p, g, m, v, cfg, lr, b1c, b2c)

    out = _map(upd, params, grads, state["m"], state["v"])

    def pick(i):
        return _map(lambda t: t[i], out)
    return (pick(0), {"m": pick(1), "v": pick(2), "step": step},
            {"grad_norm": gn})


# --------------------------------------------------------------------------
# on a mesh
# --------------------------------------------------------------------------

def zero1_spec(param_spec: tuple, shape, data_axes=("data",),
               mesh=None) -> tuple:
    """Extend a parameter's partition spec to shard its optimizer moments
    over the data axes on the first dimension that is (a) unsharded and
    (b) divisible by the data axes' size (ZeRO-1).  Falls back to the
    parameter's spec when no dimension qualifies."""
    if mesh is None:
        return param_spec
    dsize = int(np.prod([mesh.shape[a] for a in data_axes]))
    entries = list(param_spec) + [None] * (len(shape) - len(param_spec))
    for i, (e, dim) in enumerate(zip(entries, shape)):
        if e is None and dim % dsize == 0:
            entries[i] = data_axes if len(data_axes) > 1 else data_axes[0]
            return tuple(entries)
    return param_spec


def _holders(model, name: str, s: int, owners=None) -> list:
    """The shards that hold model slice ``s`` of ``name``; with
    ``owners``, those among them of the data replicas ``owners``."""
    comm, lay = model.comm, model.layouts[name]
    n_model = comm.n_model
    return [k for k in range(len(comm))
            if (lay.model_dim is None or k % n_model == s) and
            (owners is None or k // n_model in owners)]


def _slices(lay, n_model: int) -> int:
    return n_model if lay.model_dim is not None else 1


def adamw_init_mesh(model, zero1: bool = True) -> Dict[str, Any]:
    """Zero float32 moments of a ``ShardedLM``'s parameters, and the step
    (an int32 0-d tensor on the first shard's device).  ``m`` and ``v``
    map each parameter's name to one list per shard of its pieces
    (:meth:`LeafLayout.pieces`), None where the shard does not update
    the piece."""
    comm = model.comm
    n_model, n_rep = comm.n_model, comm.n_rep

    def zeros():
        out = {}
        for name, lay in model.layouts.items():
            per = []
            for k in range(len(comm)):
                local = model.shard_param(k, name)
                per.append([torch.zeros(local[sl].shape, dtype=torch.float32,
                                        device=local.device)
                            if k // n_model in owners else None
                            for sl, owners in lay.pieces(n_rep, zero1)])
            out[name] = per
        return out
    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32,
                                device=comm.devices[0])}


def adamw_update_mesh(model, state: Dict[str, Any], cfg: AdamWConfig,
                      lr: Optional[Union[float, torch.Tensor]] = None,
                      zero1: bool = True):
    """One AdamW step of a ``ShardedLM`` from the gradients its shards'
    parameters hold (set to None after), in place; ``state`` from
    :func:`adamw_init_mesh` with the same ``zero1``.  Each piece's
    gradient is the float32 sum, in shard order, of the copies' gradients,
    rounded once to the parameter's type; the global norm sums each
    piece's float32 squares once.  Returns (new state, {"grad_norm": the
    norm before clipping}), the norm on the first shard's device."""
    comm = model.comm
    n_model, n_rep = comm.n_model, comm.n_rep
    dev0 = comm.devices[0]
    reduced, squares = [], []
    for name, lay in model.layouts.items():
        for s in range(_slices(lay, n_model)):
            pieces = lay.pieces(n_rep, zero1)
            members = _holders(model, name, s)
            params = [model.shard_param(k, name) for k in members]
            grads = [torch.zeros_like(p) if p.grad is None else p.grad
                     for p in params]
            for pi, (sl, owners) in enumerate(pieces):
                root = _holders(model, name, s, owners)[0]
                acc = None
                for k, g in zip(members, grads):
                    part = comm._copy(g[sl], k, root, "grad").float()
                    acc = part if acc is None else acc.add_(part)
                g = acc.to(lay.dtype)
                reduced.append((name, s, pi, root, g))
                squares.append(torch.sum(torch.square(g.float())).to(dev0))
            for p in params:
                p.grad = None
    total = 0
    for sq in squares:
        total = total + sq
    gn = torch.sqrt(total)
    scale = torch.clamp(cfg.clip_norm / (gn + 1e-9), max=1.0)
    step = state["step"] + 1
    lr = cfg.lr if lr is None else lr
    stepf = step.float()
    consts = {dev0: (scale, lr, 1.0 - torch.pow(cfg.b1, stepf),
                     1.0 - torch.pow(cfg.b2, stepf))}

    def on(dev):
        if dev not in consts:
            consts[dev] = tuple(c.to(dev) if torch.is_tensor(c) else c
                                for c in consts[dev0])
        return consts[dev]

    for name, s, pi, root, g in reduced:
        lay = model.layouts[name]
        sl, owners = lay.pieces(n_rep, zero1)[pi]
        members = _holders(model, name, s)
        holders = _holders(model, name, s, owners)
        new_p = None
        for k in holders:
            dev = comm.devices[k]
            sc, lr_k, b1c, b2c = on(dev)
            gk = g if k == root else comm._copy(g, root, k, "grad")
            p = model.shard_param(k, name).data[sl]
            new, m, v = _adamw_leaf(p, gk.float() * sc,
                                    state["m"][name][k][pi],
                                    state["v"][name][k][pi], cfg, lr_k,
                                    b1c, b2c)
            state["m"][name][k][pi], state["v"][name][k][pi] = m, v
            p.copy_(new)
            if new_p is None:
                new_p = (k, new)
        for k in members:
            if k not in holders:
                model.shard_param(k, name).data[sl].copy_(
                    comm._copy(new_p[1], new_p[0], k, "param"))
    state["step"] = step
    return state, {"grad_norm": gn}


def gather_opt_mesh(model, state: Dict[str, Any], zero1: bool = True,
                    device: Any = "cpu") -> Dict[str, Any]:
    """The mesh state as one device's: ``{"m", "v"}`` full float32 moments
    by parameter name, and the step, on ``device``."""
    comm = model.comm
    n_model, n_rep = comm.n_model, comm.n_rep
    out = {}
    for key in ("m", "v"):
        full = {}
        for name, lay in model.layouts.items():
            t = torch.empty(lay.shape, dtype=torch.float32, device=device)
            for s in range(_slices(lay, n_model)):
                for pi, (sl, owners) in enumerate(lay.pieces(n_rep, zero1)):
                    k = _holders(model, name, s, owners)[0]
                    t[lay.model_slice(s, n_model)][sl] = \
                        state[key][name][k][pi].to(device)
            full[name] = t
        out[key] = full
    out["step"] = state["step"].to(device)
    return out


def split_opt_mesh(model, full: Dict[str, Any],
                   zero1: bool = True) -> Dict[str, Any]:
    """:func:`gather_opt_mesh`'s inverse: a one-device state (full moments
    by name, the step; on any device, numpy arrays included) laid out
    on the model's mesh."""
    state = adamw_init_mesh(model, zero1)
    comm = model.comm
    n_model = comm.n_model
    for key in ("m", "v"):
        for name, lay in model.layouts.items():
            t = torch.as_tensor(full[key][name])
            for k, pieces in enumerate(state[key][name]):
                local = t[lay.model_slice(k % n_model, n_model)]
                for pi, (sl, _) in enumerate(lay.pieces(comm.n_rep, zero1)):
                    if pieces[pi] is not None:
                        pieces[pi].copy_(local[sl])
    state["step"] = torch.as_tensor(full["step"]).to(
        torch.int32).to(comm.devices[0])
    return state
