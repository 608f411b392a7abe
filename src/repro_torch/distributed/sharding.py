"""Sharding rules of the LM zoo on a mesh, and the layout of the port's
parameters on it.

Port of ``repro/distributed/sharding.py``.  Logical axis -> mesh axis:

    batch        -> ("pod", "data")   data parallelism (pod-major)
    embed        -> None              activations replicated on d_model
    heads/kv     -> "model"           tensor parallelism over heads
    heads_x_dim  -> "model"           flat (H*hd) projection outputs
    mlp          -> "model"           FFN hidden
    vocab        -> "model"           vocab-parallel embedding / logits
    expert       -> "model"           expert parallelism (MoE)
    inner        -> "model"           mamba/xlstm inner channels
    heads_inner  -> "model"           mamba SSD head axis
    seq_q        -> "model"           xlstm query-sequence parallelism
    layers       -> None              the stacked leaves' leading axis

Divisibility is checked per tensor by ``ShardingRules`` (an axis that
does not divide falls back to replication).  :func:`param_shardings` and
:func:`batch_sharding` give the reference's trees of shardings; the port
holds one tensor per layer where the reference stacks a pattern position
over its repeats, and :func:`leaf_layouts` gives each of the port's
leaves its slice of the reference's layout, ZeRO-1's included (which is
taken from the stacked shape: the data axis may split the repeats).
:func:`split_tree` and :func:`gather_tree` cut a tree of tensors into
per-shard slices by a tree of specs and put them back, bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.common import NamedSharding, P, ShardingRules, local_slices
from ..optim.adamw import zero1_spec


def batch_axes(mesh) -> tuple:
    """The mesh axes the batch is split over: ``pod`` and ``data``."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def make_lm_rules(mesh) -> ShardingRules:
    if mesh is None:
        return ShardingRules()
    axes = batch_axes(mesh)
    batch = axes if len(axes) > 1 else axes[0]
    rules = {
        "batch": batch,
        "embed": None,
        "heads": "model",
        "kv_heads": "model",
        "heads_x_dim": "model",
        "kv_x_dim": "model",
        "mlp": "model",
        "vocab": "model",
        "expert": "model",
        "inner": "model",
        "heads_inner": "model",
        "seq_q": "model",
        "seq_kv": "model",
        "layers": None,
    }
    return ShardingRules(mesh=mesh, rules=rules)


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def param_shardings(model, rules: ShardingRules, params_shape=None):
    """``NamedSharding`` tree of the parameters, in the reference's
    structure (divisibility checked against the stacked shapes).
    ``params_shape``: that tree of shapes (default: the model's
    :meth:`~repro_torch.models.lm.LM.param_shapes`)."""
    if params_shape is None:
        params_shape = model.param_shapes()
    axes = model.param_axes(params_shape)
    return _tree_map(lambda ax, shape: rules.named_sharding(ax, shape),
                     axes, params_shape)


def batch_sharding(rules: ShardingRules, spec_tree):
    """``NamedSharding`` tree of input batches given as ``{name: (shape,
    dtype)}`` (``repro_torch.configs.input_specs``): the leading axis over
    ("pod", "data"), the rest replicated; scalars replicated."""

    def one(s):
        shape = tuple(s[0])
        if not shape:
            return NamedSharding(rules.mesh, P())
        return rules.named_sharding(("batch",) + (None,) * (len(shape) - 1),
                                    shape)

    return {k: one(v) for k, v in spec_tree.items()}


# --------------------------------------------------------------------------
# the port's per-layer leaves on a mesh
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LeafLayout:
    """One parameter of the port's model on a mesh whose last axis is
    ``model``.  ``spec`` is the reference's spec of its leaf without the
    stacked ``layers`` entry; parameters are split over ``model`` at most
    (``model_dim``) and replicated over the data axes.  ZeRO-1 splits the
    optimizer moments of each model slice over the data replicas: in
    ``n_data`` equal pieces along ``z1_dim``, piece p held by replica p;
    or, where the reference's ZeRO-1 dimension is the stacked leaf's
    repeat axis, the whole slice held by replica ``z1_owner``; or,
    where no dimension qualifies, by every replica."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    spec: tuple
    model_dim: Optional[int]
    z1_dim: Optional[int]
    z1_owner: Optional[int]

    def model_slice(self, m: int, n_model: int) -> Tuple[slice, ...]:
        sl = [slice(None)] * len(self.shape)
        if self.model_dim is not None:
            n = self.shape[self.model_dim] // n_model
            sl[self.model_dim] = slice(m * n, (m + 1) * n)
        return tuple(sl)

    def pieces(self, n_data: int, zero1: bool
               ) -> List[Tuple[Tuple[slice, ...], Tuple[int, ...]]]:
        """ZeRO-1's pieces of a model slice: (the piece's slice of the
        local tensor, the data replicas that update it).  Without
        ``zero1`` every replica updates every piece; the pieces are the
        same, so a step gives the same bits either way."""
        every = tuple(range(n_data))
        if self.z1_dim is None:
            whole = tuple(slice(None) for _ in self.shape)
            owners = (self.z1_owner,) if zero1 and \
                self.z1_owner is not None else every
            return [(whole, owners)]
        n = self.shape[self.z1_dim] // n_data
        out = []
        for p in range(n_data):
            sl = [slice(None)] * len(self.shape)
            sl[self.z1_dim] = slice(p * n, (p + 1) * n)
            out.append((tuple(sl), (p,) if zero1 else every))
        return out


def leaf_layouts(model, rules: ShardingRules) -> Dict[str, LeafLayout]:
    """:class:`LeafLayout` of every parameter of the port's ``model`` (an
    ``LM``, on any device, the meta device included) under ``rules``, by
    its name in ``named_parameters()``."""
    mesh = rules.mesh
    if mesh.axis_names[-1] != "model":
        raise ValueError(f"the mesh's last axis must be model, got "
                         f"{mesh.axis_names}")
    daxes = batch_axes(mesh)
    n_data = int(np.prod([mesh.shape[a] for a in daxes]))
    shapes = model.param_shapes()
    specs = param_shardings(model, rules, shapes)
    n_rep = model.cfg.n_repeats
    out = {}
    for name, t in model.named_parameters():
        path, r = model.reference_leaf(name)
        node_s, node_shape = specs, shapes
        for key in path:
            node_s, node_shape = node_s[key], node_shape[key]
        spec = tuple(node_s.spec) + (None,) * (len(node_shape) -
                                               len(node_s.spec))
        z1 = tuple(zero1_spec(node_s.spec, node_shape, daxes, mesh))
        z1 = z1 + (None,) * (len(node_shape) - len(z1))
        off = 1 if r is not None else 0
        if any(e not in (None, "model") for e in spec):
            raise ValueError(f"{name}: a parameter split over {spec}")
        model_dims = [i - off for i, e in enumerate(spec) if e == "model"]
        if len(model_dims) > 1:
            raise ValueError(f"{name}: two dimensions on the model axis")
        z1_dims = [i for i, (a, b) in enumerate(zip(spec, z1)) if a != b]
        z1_dim = z1_owner = None
        if z1_dims and z1_dims[0] < off:
            z1_owner = r // (n_rep // n_data)
        elif z1_dims:
            z1_dim = z1_dims[0] - off
        out[name] = LeafLayout(tuple(t.shape), t.dtype, spec[off:],
                               model_dims[0] if model_dims else None,
                               z1_dim, z1_owner)
    return out


def split_tree(tree, specs, mesh) -> List[Any]:
    """A tree of full tensors cut by a tree of partition specs (the same
    structure, each a tuple) into one tree per shard, in mesh order, each
    slice copied to its shard's device."""
    coords = list(np.ndindex(*mesh.devices.shape))

    def one(coord, dev):
        return _tree_map(lambda t, spec: t[local_slices(
            spec, t.shape, mesh, coord)].to(dev, copy=True).contiguous(),
            tree, specs)
    return [one(c, torch.device(d)) for c, d in zip(coords,
                                                    mesh.devices.flat)]


def gather_tree(parts: List[Any], specs, shapes, mesh,
                device: Any = "cpu"):
    """:func:`split_tree`'s inverse: the full tensors (of ``shapes``, a tree
    of the same structure) on ``device``, each region from the first shard
    that holds it."""
    coords = list(np.ndindex(*mesh.devices.shape))

    def one(spec, shape, *leaves):
        out = None
        done = set()
        for coord, t in zip(coords, leaves):
            sl = local_slices(spec, shape, mesh, coord)
            key = tuple((s.start, s.stop) for s in sl)
            if key in done:
                continue
            done.add(key)
            if out is None:
                out = torch.empty(tuple(shape), dtype=t.dtype, device=device)
            out[sl] = t.to(device)
        return out
    return _tree_map(one, specs, shapes, *parts)
