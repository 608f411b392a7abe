"""Collectives between the shards of a mesh, in one process.

The port runs a sharded step as one autograd graph over lists of
per-shard tensors: shard ``k`` of a mesh is ``mesh.devices.flat[k]``, and
with the ``model`` axis last, shard ``k`` is model index ``k % M`` of data
replica ``k // M`` (the flattened ``pod`` and ``data`` coordinates, pod
major, as a ``NamedSharding`` over ``("pod", "data")`` orders them).  A
collective takes the parts of a group of shards, in group order, and
gives each member its result; each is a ``torch.autograd.Function`` whose
backward is its adjoint, so that ``loss.backward()`` through the whole
graph gives every shard's parameters their share of the gradient:

* :meth:`MeshComm.all_reduce`: every member gets the sum of the parts
  (backward: the all-reduce of the gradients);
* :meth:`MeshComm.regather`: each member gets a range of a dimension
  whose pieces other members own (backward: each owner gets the sum of
  the gradients of its pieces), an all-gather when every member wants
  the whole;
* :meth:`MeshComm.move`: one tensor copied from one shard to another
  (backward: the gradient copied back).

Sums run in group order on the group's first member, in float32 whatever
the parts' type, and are rounded once to that type: the result does not
depend on the devices, and a repeated step gives the same bits.  No
float atomics are used.  ``torch.distributed`` is not: NCCL refuses two
ranks on one GPU, and a mesh may repeat a device (four ``cuda:0`` shards
run a 2 x 2 mesh on one card).  Every copy goes to fresh storage, also
between two shards of one device.  Work runs on each device's current
stream; autograd runs each backward node on the stream of its forward,
and a copy between devices orders both devices' current streams.

:attr:`MeshComm.bytes` counts the bytes copied from one shard to another,
by kind (``embed``, ``qkv``, ``attn``, ``ffn``, ``seq``, ``norm`` (a
Mamba2 gated norm's sums of squares), ``mamba`` (its ``out_proj``
partials), ``loss``, ``logits``, ``grad``, ``param``), backward passes
and remat recomputes included.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch


class MeshComm:
    """The shards of a mesh whose last axis is ``model`` (the others
    ``pod`` and ``data``), and the collectives between them."""

    def __init__(self, mesh):
        names = tuple(mesh.axis_names)
        if not names or names[-1] != "model" or \
                any(a not in ("pod", "data") for a in names[:-1]):
            raise ValueError("a sharded step takes a mesh of axes (data, "
                             f"model) or (pod, data, model), got {names}")
        self.mesh = mesh
        self.devices = [torch.device(d) for d in mesh.devices.flat]
        self.n_model = mesh.shape["model"]
        self.n_rep = len(self.devices) // self.n_model
        self.bytes: Dict[str, int] = {}

    def __len__(self) -> int:
        return len(self.devices)

    def shard(self, rep: int, m: int) -> int:
        return rep * self.n_model + m

    def model_group(self, rep: int) -> List[int]:
        """The shards of data replica ``rep``, by model index."""
        return [self.shard(rep, m) for m in range(self.n_model)]

    def reset_bytes(self) -> None:
        self.bytes = {}

    def _copy(self, t: torch.Tensor, src: int, dst: int,
              kind: str) -> torch.Tensor:
        """``t`` of shard ``src`` in fresh storage on shard ``dst``."""
        out = t.to(self.devices[dst], copy=True)
        if src != dst:
            self.bytes[kind] = self.bytes.get(kind, 0) + \
                t.numel() * t.element_size()
        return out

    def _sum_broadcast(self, parts: Sequence[torch.Tensor],
                       group: Sequence[int], kind: str
                       ) -> Tuple[torch.Tensor, ...]:
        root = group[0]
        acc = parts[0].to(torch.float32, copy=True)
        for k, t in zip(group[1:], parts[1:]):
            acc.add_(self._copy(t, k, root, kind).float())
        out = acc.to(parts[0].dtype)
        return (out,) + tuple(self._copy(out, root, k, kind)
                              for k in group[1:])

    # ---- collectives --------------------------------------------------------
    def move(self, t: torch.Tensor, src: int, dst: int,
             kind: str) -> torch.Tensor:
        """Shard ``src``'s ``t`` copied to shard ``dst`` (differentiable)."""
        return _Move.apply(t, self, src, dst, kind)

    def all_reduce(self, parts: Sequence[torch.Tensor], group: Sequence[int],
                   kind: str) -> List[torch.Tensor]:
        """The sum of ``parts`` (one per member of ``group``, of one shape
        and type) for every member: summed in group order in float32 on
        the first member and rounded once to the parts' type.  A group of
        one gives its part back."""
        if len(group) == 1:
            return list(parts)
        return list(_AllReduce.apply(self, tuple(group), kind, *parts))

    def all_max(self, parts: Sequence[torch.Tensor], group: Sequence[int],
                kind: str) -> List[torch.Tensor]:
        """The elementwise maximum of ``parts`` for every member, outside
        autograd (a value held constant for the gradient)."""
        with torch.no_grad():
            root = group[0]
            out = parts[0].detach().clone()
            for k, t in zip(group[1:], parts[1:]):
                out = torch.maximum(out, self._copy(t.detach(), k, root,
                                                    kind))
            return [out] + [self._copy(out, root, k, kind)
                            for k in group[1:]]

    def regather(self, parts: Sequence[torch.Tensor], group: Sequence[int],
                 own: Sequence[Tuple[int, int]],
                 want: Sequence[Tuple[int, int]], dim: int,
                 kind: str) -> List[torch.Tensor]:
        """Member ``j`` holds the range ``own[j]`` of dimension ``dim`` of a
        logical tensor and gets the range ``want[j]``: from its own part
        where that part covers it, else concatenated from the members
        whose ranges meet it (a partition of the dimension).
        Differentiable: an owner's gradient sums the gradients of the
        pieces it gave."""
        outs = []
        for j, (c, e) in enumerate(want):
            a, b = own[j]
            if a <= c and e <= b:
                outs.append(parts[j] if (a, b) == (c, e)
                            else parts[j].narrow(dim, c - a, e - c))
                continue
            pieces, got = [], 0
            for i, (ai, bi) in enumerate(own):
                lo, hi = max(ai, c), min(bi, e)
                if lo >= hi:
                    continue
                piece = parts[i].narrow(dim, lo - ai, hi - lo)
                pieces.append(piece if i == j else
                              self.move(piece, group[i], group[j], kind))
                got += hi - lo
            if got != e - c:
                raise ValueError(f"regather: the ranges {list(own)} do not "
                                 f"partition [{c}, {e})")
            outs.append(torch.cat(pieces, dim))
        return outs


class _Move(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, comm, src, dst, kind):
        ctx.comm, ctx.src, ctx.dst, ctx.kind = comm, src, dst, kind
        return comm._copy(t, src, dst, kind)

    @staticmethod
    def backward(ctx, g):
        return (ctx.comm._copy(g, ctx.dst, ctx.src, ctx.kind), None, None,
                None, None)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, group, kind, *parts):
        ctx.comm, ctx.group, ctx.kind = comm, group, kind
        return comm._sum_broadcast(parts, group, kind)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, None) + ctx.comm._sum_broadcast(
            grads, ctx.group, ctx.kind)
