"""Out-of-core streaming executors (paper Alg 1-2, Fig 3 / Fig 5).

Port of ``repro/core/streaming.py``.  The volume and the projections live
in *host* memory (pinned CPU tensors when the devices are GPUs); each
device only ever holds what the plan's
:class:`~repro_torch.core.plan.CommSchedule` stages.  Both executors
interpret the schedule's step list verbatim:

* ``h2d`` stages a slab (forward) or a projection chunk (backward).  A
  step marked ``prefetch`` is issued on a side copy stream and a CUDA event
  orders it before the compute step that consumes it — the paper's two
  projection buffers, which overlap the next transfer with the current
  compute.  Other staging runs on the device's compute stream.
* ``compute`` runs the backend's slab kernels.  A run of consecutive
  forward compute steps is issued on every device's stream first and then
  waited on, so the devices work at once (the paper's "executed for all
  available GPUs simultaneously"); a backward compute step waits at once.
* ``d2h`` copies a finished result back to the host.

Each device of ``devices`` gets a compute stream of its own, so two
entries on one card overlap as two cards would.  The forward projection
splits the angles over the devices (``plan.angle_ranges``, paper SS2.1),
each device streaming every slab into one accumulator per dominance group;
the backward projection gives each device its own queue of slabs
(``plan.device_of_slab``).  Accumulation keeps the reference's order
(forward: slabs in order; backward: chunks in order into each slab), so
every prefetch depth is bit-identical to ``with_prefetch(0)`` on every
device count.

A :class:`Timeline` bins wall time as the paper's Fig 9 does: ``staging``
(host-to-device), ``compute`` and ``other_memory`` (device-to-host).  The
spans match the reference's: ``staging`` (category ``h2d`` or
``prefetch``), ``fp_slab`` and ``compute`` (category ``compute``),
``other_memory`` (category ``d2h``).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .. import obs
from .backend import get_backend
from .device import DeviceLike, resolve_device
from .geometry import ConeGeometry, dominant_axis_mask
from .plan import CommSchedule, ExecutionPlan, _bp_comm_steps, _fp_comm_steps
from .projector import VOXEL_WEIGHTS
from .splitting import BackwardPlan, ForwardPlan
from ..kernels.bp_matched import seg_chunk_for


class Timeline:
    """Wall-clock bins mirroring paper Fig 9 (compute / staging / other)."""

    def __init__(self):
        self.bins: Dict[str, float] = defaultdict(float)
        self.events: List[tuple] = []

    def add(self, bin_name: str, seconds: float):
        self.bins[bin_name] += seconds
        self.events.append((bin_name, seconds))

    def fractions(self) -> Dict[str, float]:
        total = sum(self.bins.values()) or 1.0
        return {k: v / total for k, v in self.bins.items()}

    def __repr__(self):
        return f"Timeline({dict(self.bins)})"


# Timeline bin -> obs span category (paper Fig 9 bins -> span phases).
_BIN_CAT = {"staging": "h2d", "compute": "compute", "other_memory": "d2h"}


class _Timed:
    """Times one block into a Timeline bin *and* an obs span.

    The span (category from ``_BIN_CAT`` unless overridden: lookahead
    staging reports category ``"prefetch"`` while keeping the ``staging``
    bin) is only made when the process tracer is enabled, so the hot loop
    keeps its zero-overhead default path."""
    __slots__ = ("tl", "name", "sp", "t0")

    def __init__(self, tl, name, attrs, emit_span=True, cat=None):
        self.tl, self.name = tl, name
        self.sp = (obs.span(name, cat or _BIN_CAT.get(name, name), **attrs)
                   if emit_span else obs.trace._NULL)

    def __enter__(self):
        self.sp.__enter__()
        self.t0 = time.monotonic()
        return self

    def __exit__(self, *a):
        if self.tl is not None:
            self.tl.add(self.name, time.monotonic() - self.t0)
        self.sp.__exit__(*a)
        return False


def _timed(tl: Optional[Timeline], name: str, _span: bool = True,
           _cat: Optional[str] = None, **attrs):
    return _Timed(tl, name, attrs, emit_span=_span, cat=_cat)


def to_host(x, device: torch.device) -> torch.Tensor:
    """``x`` as a contiguous float32 CPU tensor, pinned when ``device`` is
    a GPU (so that its slices copy asynchronously)."""
    t = torch.as_tensor(x, dtype=torch.float32)
    t = t.to("cpu").contiguous()
    if device.type == "cuda" and not t.is_pinned():
        t = t.pin_memory()
    return t


def host_empty(shape, device: torch.device) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32,
                       pin_memory=device.type == "cuda")


class _Lane:
    """One device of a streamed run: its compute stream and a side copy
    stream for prefetches, ordered before their consumer by an event."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self.copy_stream = torch.cuda.Stream(device) if self.cuda else None

    def on(self):
        """Context in which this lane's device and compute stream are
        current."""
        if not self.cuda:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def stage(self, host: torch.Tensor, prefetch: bool):
        if not self.cuda:
            return host, None
        if not prefetch:
            with self.on():
                return host.to(self.device, non_blocking=True), None
        with torch.cuda.stream(self.copy_stream):
            dev = host.to(self.device, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self.copy_stream)
        # the compute stream uses (and frees) this buffer
        dev.record_stream(self.stream)
        return dev, ev

    def ready(self, event) -> None:
        """Make the compute stream wait for a staged copy."""
        if event is not None:
            self.stream.wait_event(event)

    def sync(self) -> None:
        if self.cuda:
            self.stream.synchronize()


def _lanes(devices: Optional[Sequence[DeviceLike]], device: DeviceLike,
           n_devices: int) -> List[_Lane]:
    """One lane per device the plan wants.  ``device`` is shorthand for
    ``devices=[device]``; with neither, the first ``n_devices`` GPUs (and
    an error without one)."""
    if devices is None:
        if device is not None:
            devices = [device]
        else:
            resolve_device(None)
            devices = [torch.device("cuda", i) for i in
                       range(min(n_devices, torch.cuda.device_count()))]
    if len(devices) < n_devices:
        raise ValueError(f"plan wants {n_devices} devices, "
                         f"got {len(devices)}")
    return [_Lane(resolve_device(d)) for d in devices[:n_devices]]


def _stage_cat(step) -> str:
    return "prefetch" if step.prefetch else "h2d"


# --------------------------------------------------------------------------
# forward projection streaming (paper Alg 1)
# --------------------------------------------------------------------------

def stream_forward(vol, geo: ConeGeometry, angles,
                   plan: Union[ExecutionPlan, ForwardPlan],
                   devices: Optional[Sequence[DeviceLike]] = None,
                   timeline: Optional[Timeline] = None,
                   backend: Optional[str] = None,
                   comm: Optional[CommSchedule] = None,
                   device: DeviceLike = None) -> torch.Tensor:
    """Out-of-core forward projection: an interpreter over the plan's FP
    step list.  ``vol`` is a host volume that may exceed device memory;
    only slab-sized pieces are staged.  The angles are split over
    ``devices`` (``device`` is shorthand for ``devices=[device]``; neither
    means the first GPUs); each device accumulates its angle range's
    partial projections on the device, slab by slab.  Returns the
    projections as a host tensor.  ``comm`` overrides the plan's schedule
    (for example ``plan.with_prefetch(0).comm``, the serial reference);
    ``timeline`` collects the Fig 9 bins."""
    if isinstance(plan, ExecutionPlan):
        if comm is None:
            comm = plan.comm
        plan = plan.forward
    lanes = _lanes(devices, device, plan.n_devices)
    bk = get_backend(backend, lanes[0].device)
    host = to_host(vol, lanes[0].device)
    angles = np.asarray(angles, np.float32)
    xmask = dominant_axis_mask(angles)
    nv, nu = geo.n_detector
    out = host_empty((len(angles), nv, nu), lanes[0].device)
    steps = (comm.fp_steps if comm is not None
             else _fp_comm_steps(plan, geo, len(angles), 1))

    # per device, per dominance group: an accumulator over the device's
    # whole angle range (the paper's "extra projection buffer ...
    # accumulated on the GPU")
    groups: List[list] = []
    for lane, (a0, a1) in zip(lanes, plan.angle_ranges):
        groups.append([])
        with lane.on():
            for xdom, idx in ((True, np.nonzero(xmask[a0:a1])[0] + a0),
                              (False, np.nonzero(~xmask[a0:a1])[0] + a0)):
                if idx.size:
                    groups[-1].append({
                        "fp": bk.fp(geo, xdom=xdom, device=lane.device),
                        "idx": torch.as_tensor(idx),
                        "angles": torch.from_numpy(angles[idx]).to(
                            lane.device),
                        "acc": torch.zeros((idx.size, nv, nu),
                                           dtype=torch.float32,
                                           device=lane.device)})

    staged: Dict[tuple, tuple] = {}    # (device, slab) -> (slab, event)
    i, n = 0, len(steps)
    while i < n:
        st = steps[i]
        if st.kind == "h2d":
            z0, z1 = plan.slab_ranges[st.slab]
            with _timed(timeline, "staging", _cat=_stage_cat(st), op="fp",
                        slab=st.slab, device=st.device, bytes=st.nbytes):
                staged[(st.device, st.slab)] = lanes[st.device].stage(
                    host[z0:z1], st.prefetch)
            i += 1
        elif st.kind == "compute":
            j = i
            while j < n and steps[j].kind == "compute":
                j += 1
            run = steps[i:j]
            # the bin wraps the whole run; the spans are the per-device
            # ones (_span=False avoids counting the run twice)
            with _timed(timeline, "compute", _span=False):
                handles = []
                for st2 in run:
                    lane = lanes[st2.device]
                    z0, _ = plan.slab_ranges[st2.slab]
                    handles.append(obs.begin("fp_slab", "compute", op="fp",
                                             slab=st2.slab,
                                             device=st2.device))
                    slab, ev = staged.pop((st2.device, st2.slab))
                    lane.ready(ev)
                    with lane.on():
                        for g in groups[st2.device]:
                            g["acc"].add_(g["fp"](slab, g["angles"], z0))
                for st2, h in zip(run, handles):
                    lanes[st2.device].sync()
                    obs.end(h)
            i = j
        else:  # d2h
            with _timed(timeline, "other_memory", op="fp", device=st.device,
                        bytes=st.nbytes):
                with lanes[st.device].on():
                    for g in groups[st.device]:
                        out[g["idx"]] = g["acc"].cpu()
            i += 1
    return out


# --------------------------------------------------------------------------
# backprojection streaming (paper Alg 2)
# --------------------------------------------------------------------------

def stream_backward(proj, geo: ConeGeometry, angles,
                    plan: Union[ExecutionPlan, BackwardPlan],
                    weight: str = "matched",
                    devices: Optional[Sequence[DeviceLike]] = None,
                    timeline: Optional[Timeline] = None,
                    backend: Optional[str] = None,
                    comm: Optional[CommSchedule] = None,
                    device: DeviceLike = None) -> torch.Tensor:
    """Out-of-core backprojection: an interpreter over the plan's BP step
    list.  Each device works through its own queue of slabs; every slab
    consumes the projection set in ``angle_chunk`` pieces while its
    accumulator stays on the device; when the schedule keeps every chunk
    resident (``bp_chunk_reuse``), a device's later slabs reuse the chunks
    staged for its first (the step list carries no h2d steps for them).
    Chunks are accumulated in increasing order per slab, so every prefetch
    depth gives the same bits.  ``weight="matched"`` runs the exact
    adjoint (one matched slab kernel per dominance subset of a chunk);
    ``"fdk"`` / ``"pmatched"`` / ``"none"`` the voxel-driven
    backprojector, one call per chunk.  ``devices`` / ``device`` /
    ``timeline`` as :func:`stream_forward`.  Returns the volume as a host
    tensor."""
    if weight != "matched" and weight not in VOXEL_WEIGHTS:
        raise ValueError(f"unknown weight {weight!r}")
    # bp_matched's scratch fits the headroom of an ExecutionPlan's memory
    # model; a bare BackwardPlan carries none (the kernel's default)
    seg_chunk = None
    if isinstance(plan, ExecutionPlan):
        if comm is None:
            comm = plan.comm
        seg_chunk = seg_chunk_for(geo, plan.memory)
        plan = plan.backward
    lanes = _lanes(devices, device, plan.n_devices)
    bk = get_backend(backend, lanes[0].device)
    host = to_host(proj, lanes[0].device)
    angles = np.asarray(angles, np.float32)
    n_angles = len(angles)
    vol_out = host_empty(geo.n_voxel, lanes[0].device)
    chunks = [(c, min(c + plan.angle_chunk, n_angles))
              for c in range(0, n_angles, plan.angle_chunk)]
    xmask = dominant_axis_mask(angles)
    if comm is not None:
        steps = comm.bp_steps
        # a schedule built for another angle count (a subset of the plan's
        # angles) is rebuilt for the angles passed, at the same depth
        sched_chunks = 1 + max((s.chunk for s in steps if s.chunk >= 0),
                               default=-1)
        if sched_chunks != len(chunks):
            steps = _bp_comm_steps(plan, geo, n_angles,
                                   comm.prefetch_depth)
    else:
        steps = _bp_comm_steps(plan, geo, n_angles, 1)

    # a staged chunk is dropped after its last compute use on its device
    last_use: Dict[tuple, int] = {}
    for idx, st in enumerate(steps):
        if st.kind == "compute":
            last_use[(st.device, st.chunk)] = idx

    # per device: the angle table (tiny: one upload, sliced per chunk) and
    # each chunk's dominance subsets as index tensors
    angles_on, subsets = [], []
    for lane in lanes:
        with lane.on():
            angles_on.append(torch.from_numpy(angles).to(lane.device))
            subsets.append([
                [(xdom, torch.as_tensor(sub, device=lane.device))
                 for xdom, sub in ((True, np.nonzero(xmask[c0:c1])[0]),
                                   (False, np.nonzero(~xmask[c0:c1])[0]))
                 if sub.size]
                for c0, c1 in chunks])

    staged: Dict[tuple, tuple] = {}   # (device, chunk) -> (proj, angles, ev)
    acc: Dict[int, torch.Tensor] = {}
    for idx, st in enumerate(steps):
        d = st.device
        lane = lanes[d]
        if st.kind == "h2d":
            c0, c1 = chunks[st.chunk]
            with _timed(timeline, "staging", _cat=_stage_cat(st), op="bp",
                        slab=st.slab, chunk=st.chunk, device=d,
                        bytes=st.nbytes):
                p_dev, ev = lane.stage(host[c0:c1], st.prefetch)
                staged[(d, st.chunk)] = (p_dev, angles_on[d][c0:c1], ev)
        elif st.kind == "compute":
            k, ci = st.slab, st.chunk
            z0, z1 = plan.slab_ranges[k]
            cur_p, cur_a, ev = staged[(d, ci)]
            lane.ready(ev)
            with _timed(timeline, "compute", op="bp", slab=k, chunk=ci,
                        device=d):
                with lane.on():
                    if k not in acc:
                        acc[k] = torch.zeros(
                            (z1 - z0,) + tuple(geo.n_voxel[1:]),
                            dtype=torch.float32, device=lane.device)
                    if weight == "matched":
                        for xdom, sub in subsets[d][ci]:
                            fn = bk.bp_matched(geo, planes=z1 - z0,
                                               xdom=xdom,
                                               seg_chunk=seg_chunk,
                                               device=lane.device)
                            acc[k].add_(fn(cur_p.index_select(0, sub),
                                           cur_a[sub], z0))
                    else:
                        fn = bk.bp(geo, planes=z1 - z0, weight=weight,
                                   device=lane.device)
                        acc[k].add_(fn(cur_p, cur_a, z0))
                lane.sync()
            if last_use.get((d, ci)) == idx:
                staged.pop((d, ci), None)
        else:  # d2h
            k = st.slab
            z0, z1 = plan.slab_ranges[k]
            with _timed(timeline, "other_memory", op="bp", slab=k,
                        device=d, bytes=st.nbytes):
                with lane.on():
                    vol_out[z0:z1] = acc.pop(k).cpu()
    return vol_out
