"""Sharded projection operators over a device mesh (paper SS2.1).

Port of ``repro/core/distributed.py``.  The reference runs each operator as
one ``shard_map`` over a JAX mesh; the port runs it in one process over a
:class:`~repro_torch.launch.mesh.Mesh` of ``torch.device``s, each shard's
work on a CUDA stream of its own (:class:`ShardStreams`), and moves data
between shards by explicit copies along the reference's hop patterns:

* forward projection: angles sharded over the ``data`` axis (the paper's
  "each GPU will compute a set of independent projections"), the volume's
  z slabs over the ``model`` axis; each shard's partial projection is
  reduced over ``model``;
* backprojection: projections sharded over ``data``, image slabs over
  ``model``; each shard's partial slab is reduced over ``data``.

The reductions are exact up to summation order because the operators are
additive over disjoint z slabs and angle sets.  The plan's
:class:`~repro_torch.core.plan.CommSchedule` picks the cross-shard
reduction (``"psum"``, ``"ring"`` or the two-level ``"hier"``,
:func:`~repro_torch.core.plan.choose_reduction`) and whether the FP angle
set is split by dominant axis on the host, so that each shard runs one
single-dominance kernel.

Each shard calls the backend's slab kernels (``bk.fp``, ``bk.bp``,
``bk.bp_matched``) with ``z0 = model_index * planes``: on the card, the
``fp_ray``, ``bp_voxel`` and ``bp_matched`` kernels.  The full-size input
and the result live on ``mesh.devices.flat[0]``, the port's stand-in for
the reference's global array.  Where the reference's ``out_specs`` keeps
one replica of an all-reduced value, the port computes only that one: the
sum on the first shard along the reduced axis.
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from .. import obs
from .backend import get_backend, resolve
from .device import as_f32
from .geometry import ConeGeometry, dominant_axis_mask
from .plan import choose_reduction, hier_group_size


# --------------------------------------------------------------------------
# shards: one stream each, explicit copies between them
# --------------------------------------------------------------------------

class ShardStreams:
    """One CUDA stream per shard (none on the CPU), and the copies that
    move tensors between shards.

    A tensor made on one shard's stream and read on another's is ordered
    by a stream wait and handed over with ``record_stream``, so the caching
    allocator does not reuse its memory early.  Every copy goes to fresh
    storage, also between two shards of one device, so a shard that
    updates its buffer in place never writes into a neighbour's."""

    def __init__(self, devices: Sequence[torch.device]):
        self.devices = [torch.device(d) for d in devices]
        kinds = {d.type for d in self.devices}
        if len(kinds) != 1 or not kinds <= {"cpu", "cuda"}:
            raise ValueError("a mesh's shards must all lie on CUDA devices "
                             f"or all on the CPU, got {self.devices}")
        self.cuda = kinds == {"cuda"}
        self.streams = ([torch.cuda.Stream(d) for d in self.devices]
                        if self.cuda else [None] * len(self.devices))

    def __len__(self):
        return len(self.devices)

    def fork(self) -> None:
        """Order every shard after the work the caller has queued."""
        if self.cuda:
            for d, s in zip(self.devices, self.streams):
                s.wait_stream(torch.cuda.current_stream(d))

    def on(self, k: int):
        """Context in which shard ``k``'s device and stream are current."""
        if not self.cuda:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.streams[k])

    def take(self, t: torch.Tensor, k: int) -> torch.Tensor:
        """The caller's tensor ``t`` for reading on shard ``k``: ``t``
        itself on the shard's device, else a copy there."""
        dev = self.devices[k]
        if t.device == dev:
            return t
        with self.on(k):
            return t.to(dev, non_blocking=True)

    def copy(self, t: torch.Tensor, src: int, dst: int) -> torch.Tensor:
        """Shard ``src``'s tensor ``t`` copied into fresh storage on shard
        ``dst``, after ``src``'s work so far."""
        dev = self.devices[dst]
        if not self.cuda:
            return t.to(dev, copy=True)
        s_src, s_dst = self.streams[src], self.streams[dst]
        with torch.cuda.stream(s_dst):
            out = torch.empty_like(t, device=dev)
            if t.device == dev:
                s_dst.wait_stream(s_src)
                out.copy_(t)
                t.record_stream(s_dst)
            else:
                # a cross-device copy runs on the source's current stream
                # and orders both devices' current streams around itself
                with torch.cuda.stream(s_src):
                    out.copy_(t, non_blocking=True)
        return out

    def join(self, outs: Sequence[torch.Tensor] = ()) -> None:
        """Order the caller after every shard's work and hand it ``outs``
        (tensors made on the shards' streams)."""
        if not self.cuda:
            return
        for d in set(self.devices):
            cur = torch.cuda.current_stream(d)
            for dd, s in zip(self.devices, self.streams):
                if dd == d:
                    cur.wait_stream(s)
        for t in outs:
            t.record_stream(torch.cuda.current_stream(t.device))

    def synchronize(self) -> None:
        """Wait on the host for every shard's work and the caller's."""
        if self.cuda:
            for d in set(self.devices):
                torch.cuda.synchronize(d)


def _grid(mesh) -> np.ndarray:
    """The mesh's devices as a (data, model) object array."""
    if tuple(mesh.axis_names) != ("data", "model"):
        raise ValueError("the distributed operators take a (data, model) "
                         f"mesh, got axes {mesh.axis_names}")
    return mesh.devices


def _upload(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` without waiting for the device: through
    pinned memory and an asynchronous copy on a GPU."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _slab_planes(geo: ConeGeometry, n_model: int) -> int:
    nz = geo.n_voxel[0]
    if nz % n_model:
        raise ValueError(f"Nz={nz} not divisible by model axis {n_model}")
    return nz // n_model


def _reduce_partial(parts: Sequence[torch.Tensor], schedule: str,
                    shards: ShardStreams,
                    ks: Sequence[int]) -> torch.Tensor:
    """The sum of the partial results ``parts`` (``parts[m]`` on shard
    ``ks[m]``) on the first shard ``ks[0]``: the one replica of the
    reference's all-reduce that its ``out_specs`` keeps, in the summation
    order the plan's schedule gives that shard.

    ``"psum"`` adds the parts in index order; ``"ring"`` adds them in the
    order the reference's ring brings them to the first shard, its left
    neighbour's first (``parts[0] + parts[n-1] + ... + parts[1]``);
    ``"hier"`` takes that ring sum within each contiguous group of
    :func:`hier_group_size` shards at the group's first shard, then adds
    the group sums at the first shard in the reference's group-stride
    order.  The three differ in summation order only.  Only the first
    shard's chain runs: ``n - 1`` copies, each from the shard that holds
    the partial."""
    if schedule not in ("psum", "ring", "hier"):
        raise ValueError(f"unknown reduction schedule {schedule!r} "
                         f"(have psum | ring | hier)")
    n = len(parts)
    if n == 1:
        return parts[0]

    def sum_at(head: int, order, vals) -> torch.Tensor:
        """``vals[head] + vals[order[0]] + ...`` on shard ``ks[head]``."""
        acc = vals[head]
        for m in order:
            add = shards.copy(vals[m], ks[m], ks[head])
            with shards.on(ks[head]):
                acc = acc + add
        return acc

    def ring_sum(head: int, size: int) -> torch.Tensor:
        """The ring sum of ``parts[head:head + size]`` at its head."""
        return sum_at(head, range(head + size - 1, head, -1), parts)

    if schedule == "psum":
        return sum_at(0, range(1, n), parts)
    if schedule == "ring":
        return ring_sum(0, n)
    g = hier_group_size(n)
    sums = {h: ring_sum(h, g) for h in range(0, n, g)}
    return sum_at(0, range(n - g, 0, -g), sums)


def _traced_dist(fn: Callable, op: str, n_data: int, n_model: int,
                 shards: ShardStreams, **extra) -> Callable:
    """Wrap a sharded op in a host-side compute span.  With tracing on, the
    span waits for its shards' streams, so it holds the op's device time;
    with tracing off the op runs as it is."""
    def traced(*args):
        if not obs.enabled():
            return fn(*args)
        with obs.span(op, "compute", op=op, data_shards=n_data,
                      model_shards=n_model, **extra):
            out = fn(*args)
            shards.synchronize()
        return out
    return traced


def _angles_np(angles) -> np.ndarray:
    if isinstance(angles, torch.Tensor):
        angles = angles.detach().cpu().numpy()
    return np.asarray(angles, np.float32)


def _dominance_groups(angles_np: np.ndarray):
    xm = dominant_axis_mask(angles_np)
    groups = [(True, np.nonzero(xm)[0]), (False, np.nonzero(~xm)[0])]
    return [(x, i) for x, i in groups if i.size]


# --------------------------------------------------------------------------
# forward projection
# --------------------------------------------------------------------------

def _fp_local_fn(geo: ConeGeometry, bk, device) -> Callable:
    """Partial FP of a z slab for an angle shard of any dominance mix:
    both single-dominance variants of the backend's slab FP, selected per
    angle (2x the local FP).  Only the fallback for
    ``dominance_split=False``; the default regroups the angles on the
    host (:func:`dist_forward_project`)."""
    fpx = bk.fp(geo, xdom=True, device=device)
    fpy = bk.fp(geo, xdom=False, device=device)

    def f(slab, angles, xmask, z0):
        return torch.where(xmask[:, None, None], fpx(slab, angles, z0),
                           fpy(slab, angles, z0))
    return f


def dist_forward_project(mesh, geo: ConeGeometry,
                         reduce: Optional[str] = None,
                         backend: Optional[str] = None,
                         dominance_split: Optional[bool] = None,
                         comm=None) -> Callable:
    """Build a sharded FP: ``f(vol, angles) -> proj``.

    ``vol`` is the full volume (moved to ``mesh.devices.flat[0]``),
    ``angles`` a host array whose length is a multiple of the data axis
    per dominance group; shard ``(i, j)`` projects z slab ``j`` for angle
    chunk ``i``, the partials are reduced over ``model`` and the result
    lands on ``mesh.devices.flat[0]``.

    ``reduce`` selects the cross-slab reduction (``"psum"`` | ``"ring"``
    | ``"hier"``; None reads ``comm.reduction``, else derives it from the
    model-axis size by :func:`choose_reduction`); ``dominance_split``
    (default from ``comm``, else on) regroups the angles by dominant axis
    on the host, so each group runs one single-dominance sharded call,
    built lazily, padded to the data axis by :func:`pad_angles` and
    scattered back to input order.  Unlike the reference, which skips the
    split on its ref backend (its per-angle ``lax.cond`` already runs one
    projector per angle), the port splits on every backend."""
    grid = _grid(mesh)
    n_data, n_model = grid.shape
    planes = _slab_planes(geo, n_model)
    if comm is not None:
        if reduce is None:
            reduce = comm.reduction
        if dominance_split is None:
            dominance_split = comm.dominance_split
    if reduce is None:
        reduce = choose_reduction(n_model)
    if dominance_split is None:
        dominance_split = True
    dev0 = grid[0, 0]
    bk = get_backend(resolve(backend, dev0))
    shards = ShardStreams(grid.ravel())
    nv, nu = geo.n_detector

    def sharded(fp_local):
        """``fp_local(slab, angles, xmask, z0)`` on every shard, reduced
        over ``model``, the rows gathered on the first device."""
        def call(vol, angles_np):
            if len(angles_np) % n_data:
                raise ValueError(f"{len(angles_np)} angles do not split "
                                 f"over a data axis of {n_data}")
            per = len(angles_np) // n_data
            vol = as_f32(vol, dev0)
            a_all = _upload(angles_np, dev0)
            x_all = _upload(dominant_axis_mask(angles_np), dev0)
            shards.fork()
            parts = [[None] * n_model for _ in range(n_data)]
            for i in range(n_data):
                rows = slice(i * per, (i + 1) * per)
                for j in range(n_model):
                    k = i * n_model + j
                    with shards.on(k):
                        slab = shards.take(
                            vol[j * planes:(j + 1) * planes], k)
                        parts[i][j] = fp_local(
                            slab, shards.take(a_all[rows], k),
                            shards.take(x_all[rows], k), j * planes)
            kept = [_reduce_partial(parts[i], reduce, shards,
                                    [i * n_model + j
                                     for j in range(n_model)])
                    for i in range(n_data)]
            shards.join(kept)
            return torch.cat([p.to(dev0) for p in kept])
        return call

    if not dominance_split:
        both = _traced_dist(sharded(_fp_local_fn(geo, bk, dev0)), "dist_fp",
                            n_data, n_model, shards, reduce=reduce)
        return lambda vol, angles: both(vol, _angles_np(angles))

    # one single-dominance sharded call per dominance group present, built
    # lazily: an all-one-dominance workload never fetches the other
    # kernel variant from the dispatch table
    fns = {}

    def fn_for(xdom: bool):
        if xdom not in fns:
            fp1 = bk.fp(geo, xdom=xdom, device=dev0)
            fns[xdom] = _traced_dist(
                sharded(lambda s, a, _xmask, z0: fp1(s, a, z0)), "dist_fp",
                n_data, n_model, shards, reduce=reduce, xdom=xdom)
        return fns[xdom]

    def call(vol, angles):
        angles_np = _angles_np(angles)
        vol = as_f32(vol, dev0)
        parts = []
        for xdom, idx in _dominance_groups(angles_np):
            padded, valid = pad_angles(angles_np[idx], n_data)
            outp = fn_for(xdom)(vol, padded)
            parts.append((idx, outp if valid.all() else outp[:idx.size]))
        if len(parts) == 1 and parts[0][0].size == len(angles_np):
            return parts[0][1]     # single dominance: rows already ordered
        out = torch.zeros((len(angles_np), nv, nu), dtype=torch.float32,
                          device=dev0)
        with obs.span("reduce", "reduce", op="dist_fp", schedule=reduce,
                      groups=len(parts),
                      bytes=int(len(angles_np)) * nv * nu * 4):
            for idx, p in parts:
                out.index_copy_(0, _upload(idx, dev0), p)
            if obs.enabled():
                shards.synchronize()
        return out
    return call


# --------------------------------------------------------------------------
# backprojection
# --------------------------------------------------------------------------

def _sharded_bp(bp: Callable, grid: np.ndarray, planes: int, reduce: str,
                shards: ShardStreams) -> Callable:
    """``f(proj, angles_np) -> vol``: shard ``(i, j)`` backprojects angle
    chunk ``i`` into z slab ``j``; the slabs are reduced over ``data``."""
    n_data, n_model = grid.shape
    dev0 = grid[0, 0]

    def call(proj, angles_np):
        if len(angles_np) % n_data:
            raise ValueError(f"{len(angles_np)} angles do not split over a "
                             f"data axis of {n_data}")
        per = len(angles_np) // n_data
        proj = as_f32(proj, dev0)
        a_all = _upload(angles_np, dev0)
        shards.fork()
        parts = [[None] * n_data for _ in range(n_model)]
        for i in range(n_data):
            rows = slice(i * per, (i + 1) * per)
            for j in range(n_model):
                k = i * n_model + j
                with shards.on(k):
                    parts[j][i] = bp(shards.take(proj[rows], k),
                                     shards.take(a_all[rows], k), j * planes)
        kept = [_reduce_partial(parts[j], reduce, shards,
                                [i * n_model + j for i in range(n_data)])
                for j in range(n_model)]
        shards.join(kept)
        return torch.cat([s.to(dev0) for s in kept])
    return call


def dist_backproject(mesh, geo: ConeGeometry, weight: str = "fdk",
                     backend: Optional[str] = None,
                     reduce: str = "psum") -> Callable:
    """Build a sharded voxel-driven BP: ``g(proj, angles) -> vol``.

    Shard ``(i, j)`` updates z slab ``j`` from angle chunk ``i`` (the
    angle count a multiple of the data axis); the partial slabs are
    reduced over ``data`` and the volume lands on
    ``mesh.devices.flat[0]``.  The voxel-driven BP is dominance-free, so
    no split applies.  ``reduce`` defaults to ``"psum"`` whatever the
    plan says, as in the reference, whose serving layer's bit-exact
    restore relies on that order."""
    grid = _grid(mesh)
    n_data, n_model = grid.shape
    planes = _slab_planes(geo, n_model)
    shards = ShardStreams(grid.ravel())
    bp = get_backend(resolve(backend, grid[0, 0])).bp(geo, planes=planes,
                                                      device=grid[0, 0],
                                                      weight=weight)
    fn = _sharded_bp(bp, grid, planes, reduce, shards)
    traced = _traced_dist(fn, "dist_bp", n_data, n_model, shards,
                          weight=weight)
    return lambda proj, angles: traced(proj, _angles_np(angles))


def dist_backproject_matched(mesh, geo: ConeGeometry,
                             backend: Optional[str] = None,
                             seg_chunk: Optional[int] = None) -> Callable:
    """Exact adjoint BP: ``f(proj, angles) -> vol``.

    Each shard adjoints its angle chunk's FP restricted to its z slab with
    the backend's single-dominance ``bp_matched``, one sharded call per
    dominance group present (padded to the data axis with duplicate
    angles and zeroed projection rows: BP is linear, so they add
    nothing), the slabs summed over ``data`` and the group volumes
    summed.  Linearity over disjoint angle sets makes the result the
    monolithic Aᵀ, so CGLS and FISTA keep their guarantees.  The
    reference's ref backend takes ``jax.vjp`` of its mixed-dominance shard
    FP instead; the port groups on every backend.  ``seg_chunk``: angles
    of the matched kernel's scratch (see :func:`~repro_torch.kernels.
    bp_matched.seg_chunk_for`)."""
    grid = _grid(mesh)
    n_data, n_model = grid.shape
    planes = _slab_planes(geo, n_model)
    dev0 = grid[0, 0]
    bk = get_backend(resolve(backend, dev0))
    shards = ShardStreams(grid.ravel())
    nv, nu = geo.n_detector
    fns = {}

    def fn_for(xdom: bool):
        if xdom not in fns:
            bm = bk.bp_matched(geo, planes=planes, xdom=xdom, device=dev0,
                               seg_chunk=seg_chunk)
            fns[xdom] = _traced_dist(
                _sharded_bp(bm, grid, planes, "psum", shards),
                "dist_bp_matched", n_data, n_model, shards, xdom=xdom)
        return fns[xdom]

    def call(proj, angles):
        angles_np = _angles_np(angles)
        proj = as_f32(proj, dev0)
        out = None
        for xdom, idx in _dominance_groups(angles_np):
            padded, valid = pad_angles(angles_np[idx], n_data)
            pj = proj.index_select(0, _upload(idx, dev0))
            if not valid.all():
                pj = torch.cat([pj, pj.new_zeros(
                    (len(padded) - idx.size, nv, nu))])
            part = fn_for(xdom)(pj, padded)
            out = part if out is None else out + part
        if out is None:
            out = torch.zeros(geo.n_voxel, dtype=torch.float32, device=dev0)
        return out
    return call


def pad_angles(angles: np.ndarray, multiple: int):
    """Pad the angle set to a multiple of the data-axis size.

    Padded entries repeat the last angle; callers must consume the returned
    ``valid`` mask -- drop the padded rows of a padded forward projection,
    and zero the padded rows before a backprojection (BP is linear, so zero
    rows add nothing to the slab sums).  ``CTOperator`` (mode="dist") does
    both for angle counts that are not a multiple of the data axis.
    """
    n = len(angles)
    n_pad = (-n) % multiple
    if n_pad == 0:
        return np.asarray(angles, np.float32), np.ones(n, bool)
    padded = np.concatenate([angles, np.full(n_pad, angles[-1])]).astype(
        np.float32)
    valid = np.concatenate([np.ones(n, bool), np.zeros(n_pad, bool)])
    return padded, valid


def halo_exchange(slabs: Sequence[torch.Tensor], depth: int,
                  shards: Optional[ShardStreams] = None
                  ) -> List[torch.Tensor]:
    """Exchange ``depth`` boundary planes between neighbouring z slabs
    (paper SS2.3).

    ``slabs[j]`` is shard ``j``'s slab ``(planes, ...)`` along one mesh
    axis; returns each padded to ``planes + 2 * depth`` with its
    neighbours' boundary planes (zeros at the global ends), in fresh
    storage on the shard's device.  One pair of copies per neighbour pair:
    the only communication of the split TV regularisers every ``N_in``
    inner iterations.  ``shards`` are the slabs' streams inside a sharded
    operator; without them the call orders itself after the caller's work
    and hands the padded slabs back to the caller's streams."""
    n = len(slabs)
    if any(depth > s.shape[0] for s in slabs):
        raise ValueError(f"halo depth {depth} exceeds a slab of "
                         f"{min(s.shape[0] for s in slabs)} planes")
    alone = shards is None
    if alone:       # a call of its own: ordered after and before the caller
        shards = ShardStreams([s.device for s in slabs])
        shards.fork()
    out = []
    for j in range(n):
        with shards.on(j):
            zeros = slabs[j].new_zeros((depth,) + tuple(slabs[j].shape[1:]))
            below = (shards.copy(slabs[j - 1][-depth:], j - 1, j)
                     if j > 0 else zeros)
            above = (shards.copy(slabs[j + 1][:depth], j + 1, j)
                     if j < n - 1 else zeros)
            out.append(torch.cat([below, slabs[j], above]))
    if alone:
        shards.join(out)
    return out


def model_devices(mesh) -> List[torch.device]:
    """The devices along the ``model`` axis at data index 0: one shard per
    z slab, for the operators whose data-axis replicas compute the same
    values (the halo-split regularisers)."""
    return list(_grid(mesh)[0])


def split_slabs(vol: torch.Tensor, shards: ShardStreams) -> List[torch.Tensor]:
    """``vol``'s equal z slabs, one per shard, for reading there."""
    n = len(shards)
    nz = vol.shape[0]
    if nz % n:
        raise ValueError(f"Nz={nz} not divisible by model axis {n}")
    planes = nz // n
    return [shards.take(vol[j * planes:(j + 1) * planes], j)
            for j in range(n)]

