"""Out-of-core streaming executors (paper Alg 1-2, Fig 3 / Fig 5).

Port of ``repro/core/streaming.py``.  The volume and the projections live
in *host* memory (pinned CPU tensors when the device is a GPU); the device
only ever holds what the plan's :class:`~repro_torch.core.plan.CommSchedule`
stages.  Both executors interpret the schedule's step list verbatim:

* ``h2d`` stages a slab (forward) or a projection chunk (backward).  A
  step marked ``prefetch`` is issued on a side copy stream and a CUDA event
  orders it before the compute step that consumes it — the paper's two
  projection buffers, which overlap the next transfer with the current
  compute.  Other staging runs on the compute stream itself.
* ``compute`` runs the backend's slab kernels and waits for them.
* ``d2h`` copies a finished result back to the host.

Accumulation keeps the reference's order (forward: slabs in order into a
per-device accumulator that spans the device's whole angle range; backward:
chunks in order into each slab), so every prefetch depth is bit-identical
to ``with_prefetch(0)``.  The port streams on one device; several devices
arrive with the distributed slice.

Spans match the reference's: ``staging`` (category ``h2d`` or
``prefetch``), ``fp_slab`` and ``compute`` (category ``compute``),
``other_memory`` (category ``d2h``).
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from .. import obs
from .backend import get_backend
from .device import DeviceLike, resolve_device
from .geometry import ConeGeometry, dominant_axis_mask
from .plan import CommSchedule, ExecutionPlan, _bp_comm_steps, _fp_comm_steps
from .splitting import BackwardPlan, ForwardPlan


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


class _Stager:
    """Issues h2d copies: prefetches on a side stream, ordered before
    their consumer by an event; the rest on the compute stream."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.copy_stream = torch.cuda.Stream(device) if self.cuda else None

    def stage(self, host: torch.Tensor, prefetch: bool):
        if not self.cuda:
            return host, None
        if not prefetch:
            return host.to(self.device, non_blocking=True), None
        with torch.cuda.stream(self.copy_stream):
            dev = host.to(self.device, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self.copy_stream)
        # the compute stream uses (and frees) this buffer
        dev.record_stream(torch.cuda.current_stream(self.device))
        return dev, ev

    def ready(self, event) -> None:
        """Make the compute stream wait for a staged copy."""
        if event is not None:
            torch.cuda.current_stream(self.device).wait_event(event)

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.current_stream(self.device).synchronize()


def _one_device(n_devices: int) -> None:
    if n_devices != 1:
        raise ValueError(f"plan wants {n_devices} devices, got 1: the port "
                         "streams on one device (several arrive with the "
                         "distributed slice)")


def _stage_cat(step) -> str:
    return "prefetch" if step.prefetch else "h2d"


# --------------------------------------------------------------------------
# forward projection streaming (paper Alg 1)
# --------------------------------------------------------------------------

def stream_forward(vol, geo: ConeGeometry, angles,
                   plan: Union[ExecutionPlan, ForwardPlan],
                   device: DeviceLike = None, backend: Optional[str] = None,
                   comm: Optional[CommSchedule] = None) -> torch.Tensor:
    """Out-of-core forward projection: an interpreter over the plan's FP
    step list.  ``vol`` is a host volume that may exceed device memory;
    only slab-sized pieces are staged.  Returns the projections as a host
    tensor.  ``comm`` overrides the plan's schedule (for example
    ``plan.with_prefetch(0).comm``, the serial reference)."""
    if isinstance(plan, ExecutionPlan):
        if comm is None:
            comm = plan.comm
        plan = plan.forward
    _one_device(plan.n_devices)
    device = resolve_device(device)
    bk = get_backend(backend, device)
    host = to_host(vol, device)
    angles = np.asarray(angles, np.float32)
    xmask = dominant_axis_mask(angles)
    nv, nu = geo.n_detector
    out = host_empty((len(angles), nv, nu), device)
    steps = (comm.fp_steps if comm is not None
             else _fp_comm_steps(plan, geo, len(angles), 1))

    # device-resident accumulators over the device's whole angle range
    # (the paper's "extra projection buffer ... accumulated on the GPU")
    a0, a1 = plan.angle_ranges[0]
    groups = []
    for xdom, idx in ((True, np.nonzero(xmask[a0:a1])[0] + a0),
                      (False, np.nonzero(~xmask[a0:a1])[0] + a0)):
        if idx.size:
            groups.append({
                "fp": bk.fp(geo, xdom=xdom), "idx": torch.as_tensor(idx),
                "angles": torch.from_numpy(angles[idx]).to(device),
                "acc": torch.zeros((idx.size, nv, nu), dtype=torch.float32,
                                   device=device)})

    stager = _Stager(device)
    staged: Dict[int, tuple] = {}          # slab -> (device slab, event)
    i, n = 0, len(steps)
    while i < n:
        st = steps[i]
        if st.kind == "h2d":
            z0, z1 = plan.slab_ranges[st.slab]
            with obs.span("staging", _stage_cat(st), op="fp", slab=st.slab,
                          device=st.device, bytes=st.nbytes):
                staged[st.slab] = stager.stage(host[z0:z1], st.prefetch)
            i += 1
        elif st.kind == "compute":
            j = i
            while j < n and steps[j].kind == "compute":
                j += 1
            for st2 in steps[i:j]:
                z0, _ = plan.slab_ranges[st2.slab]
                h = obs.begin("fp_slab", "compute", op="fp", slab=st2.slab,
                              device=st2.device)
                slab, ev = staged.pop(st2.slab)
                stager.ready(ev)
                for g in groups:
                    g["acc"].add_(g["fp"](slab, g["angles"], z0))
                stager.sync()
                obs.end(h)
            i = j
        else:  # d2h
            with obs.span("other_memory", "d2h", op="fp", device=st.device,
                          bytes=st.nbytes):
                for g in groups:
                    out[g["idx"]] = g["acc"].cpu()
            i += 1
    return out


# --------------------------------------------------------------------------
# backprojection streaming (paper Alg 2)
# --------------------------------------------------------------------------

def stream_backward(proj, geo: ConeGeometry, angles,
                    plan: Union[ExecutionPlan, BackwardPlan],
                    weight: str = "matched", device: DeviceLike = None,
                    backend: Optional[str] = None,
                    comm: Optional[CommSchedule] = None) -> torch.Tensor:
    """Out-of-core exact-adjoint backprojection: an interpreter over the
    plan's BP step list.  Every slab consumes the projection set in
    ``angle_chunk`` pieces while its accumulator stays on the device; when
    the schedule keeps every chunk resident (``bp_chunk_reuse``), later
    slabs reuse the chunks staged for the first (the step list carries no
    h2d steps for them).  Chunks are accumulated in increasing order per
    slab.  Returns the volume as a host tensor.  Only ``weight="matched"``
    is ported; the voxel-driven weights arrive with the FDK / SART slice."""
    if weight != "matched":
        raise NotImplementedError(
            f"stream_backward(weight={weight!r}): the voxel-driven weights "
            "arrive with the FDK / OS-SART slice (ROADMAP Queue A 8)")
    if isinstance(plan, ExecutionPlan):
        if comm is None:
            comm = plan.comm
        plan = plan.backward
    _one_device(plan.n_devices)
    device = resolve_device(device)
    bk = get_backend(backend, device)
    host = to_host(proj, device)
    angles = np.asarray(angles, np.float32)
    n_angles = len(angles)
    vol_out = host_empty(geo.n_voxel, device)
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

    # a staged chunk is dropped after its last compute use
    last_use: Dict[int, int] = {}
    for idx, st in enumerate(steps):
        if st.kind == "compute":
            last_use[st.chunk] = idx

    # per chunk: the dominance subsets as device index tensors
    subsets = []
    for c0, c1 in chunks:
        m = xmask[c0:c1]
        subsets.append([(xdom, torch.as_tensor(sub, device=device))
                        for xdom, sub in ((True, np.nonzero(m)[0]),
                                          (False, np.nonzero(~m)[0]))
                        if sub.size])

    # the angle table is tiny: one upload, sliced per chunk
    angles_dev = torch.from_numpy(angles).to(device)
    stager = _Stager(device)
    staged: Dict[int, tuple] = {}   # chunk -> (proj, angles, event)
    acc: Dict[int, torch.Tensor] = {}
    for idx, st in enumerate(steps):
        if st.kind == "h2d":
            c0, c1 = chunks[st.chunk]
            with obs.span("staging", _stage_cat(st), op="bp", slab=st.slab,
                          chunk=st.chunk, device=st.device, bytes=st.nbytes):
                p_dev, ev = stager.stage(host[c0:c1], st.prefetch)
                staged[st.chunk] = (p_dev, angles_dev[c0:c1], ev)
        elif st.kind == "compute":
            k, ci = st.slab, st.chunk
            z0, z1 = plan.slab_ranges[k]
            if k not in acc:
                acc[k] = torch.zeros((z1 - z0,) + tuple(geo.n_voxel[1:]),
                                     dtype=torch.float32, device=device)
            cur_p, cur_a, ev = staged[ci]
            stager.ready(ev)
            with obs.span("compute", "compute", op="bp", slab=k, chunk=ci,
                          device=st.device):
                for xdom, sub in subsets[ci]:
                    fn = bk.bp_matched(geo, planes=z1 - z0, xdom=xdom)
                    acc[k].add_(fn(cur_p.index_select(0, sub), cur_a[sub],
                                   z0))
                stager.sync()
            if last_use.get(ci) == idx:
                staged.pop(ci, None)
        else:  # d2h
            k = st.slab
            z0, z1 = plan.slab_ranges[k]
            with obs.span("other_memory", "d2h", op="bp", slab=k,
                          device=st.device, bytes=st.nbytes):
                vol_out[z0:z1] = acc.pop(k).cpu()
    return vol_out
