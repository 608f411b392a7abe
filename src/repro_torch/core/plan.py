"""Unified execution-plan IR: one planner output for every executor.

The paper's central claim is that the splitting decisions — how the image
is cut into axial slabs, how angles are chunked and assigned to devices —
are independent of both the algorithm and the kernels that execute them
(TIGRE: "all of the GPU code is independent from the algorithm that uses
it").  :class:`ExecutionPlan` makes the partition/communication schedule a
first-class object: a single memoized :func:`plan` entry point produces one
IR that the executors consume verbatim (``CTOperator`` plain / stream
iterate the plan's slab ranges and angle chunks; the streaming executors
interpret its :class:`CommSchedule` step list).

The IR is pure Python/numpy (static), and because every field derives
deterministically from ``(geo, n_angles, n_devices, memory)`` the memo
table can be shared by every consumer in the process.

This module is the port's own copy of ``repro.core.plan``;
``tests/test_torch_core.py`` holds :func:`plan` equal to the reference's,
field by field, over a sweep of geometries and budgets.
"""

from __future__ import annotations

import dataclasses
import math
from functools import lru_cache
from typing import List, Optional, Tuple

from .geometry import ConeGeometry
from .splitting import (F32, BackwardPlan, ForwardPlan, MemoryModel,
                        plan_backward, plan_forward)


# --------------------------------------------------------------------------
# communication schedule (the paper's Fig 3 / Fig 5 timelines, reified)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CommStep:
    """One entry of a :class:`CommSchedule` step list.

    ``kind`` is ``"h2d"`` (stage host data onto a device), ``"compute"``
    (consume what is staged) or ``"d2h"`` (copy a finished result back).
    ``prefetch`` marks staging issued *ahead* of the step that consumes
    it — the overlap the paper's double buffers buy.  ``nbytes`` is the
    host<->device traffic of the step (0 for compute), so the schedule
    doubles as the transfer cost model.
    """

    kind: str              # "h2d" | "compute" | "d2h"
    op: str                # "fp" | "bp"
    device: int
    slab: int
    chunk: int = -1        # bp projection-chunk index; -1 for fp / d2h
    nbytes: int = 0
    prefetch: bool = False

    def __str__(self):
        tag = {"h2d": "h2d", "compute": "cmp", "d2h": "d2h"}[self.kind]
        if self.prefetch:
            tag += "*"
        loc = f"d{self.device} s{self.slab}"
        if self.chunk >= 0:
            loc += f" c{self.chunk}"
        return f"{tag}[{loc}]"


def _fp_comm_steps(fwd: ForwardPlan, geo: ConeGeometry, n_angles: int,
                   depth: int) -> Tuple[CommStep, ...]:
    """FP step list (paper Alg 1 / Fig 3): every device streams every
    slab; ``depth`` slabs are staged ahead of the one being computed
    (``depth=0`` is the serial single-buffer reference)."""
    _, ny, nx = geo.n_voxel
    nv, nu = geo.n_detector
    steps: List[CommStep] = []
    staged = 0
    for k in range(fwd.n_slabs):
        hi = min(fwd.n_slabs, k + 1 + max(0, depth))
        for t in range(max(staged, k), hi):
            z0, z1 = fwd.slab_ranges[t]
            for d in range(fwd.n_devices):
                steps.append(CommStep("h2d", "fp", d, t,
                                      nbytes=(z1 - z0) * ny * nx * F32,
                                      prefetch=(t > k)))
        staged = max(staged, hi)
        for d in range(fwd.n_devices):
            steps.append(CommStep("compute", "fp", d, k))
    for d, (a0, a1) in enumerate(fwd.angle_ranges):
        steps.append(CommStep("d2h", "fp", d, -1,
                              nbytes=(a1 - a0) * nv * nu * F32))
    return tuple(steps)


def _bp_comm_steps(bwd: BackwardPlan, geo: ConeGeometry, n_angles: int,
                   depth: int) -> Tuple[CommStep, ...]:
    """BP step list (paper Alg 2 / Fig 5): each slab's owner consumes the
    projection chunks through ``1 + depth`` staging buffers.  When every
    chunk fits in the buffers at once, a device's later slabs *reuse* the
    chunks staged for its first slab (no h2d steps are emitted)."""
    _, ny, nx = geo.n_voxel
    nv, nu = geo.n_detector
    chunks = [(c, min(c + bwd.angle_chunk, n_angles))
              for c in range(0, n_angles, bwd.angle_chunk)]
    reuse = len(chunks) <= 1 + max(0, depth)
    steps: List[CommStep] = []
    chunks_on: set = set()          # devices whose chunks stay resident
    for k, (z0, z1) in enumerate(bwd.slab_ranges):
        d = bwd.device_of_slab[k]
        stage = not (reuse and d in chunks_on)
        if reuse:
            chunks_on.add(d)
        staged = 0
        for ci, (c0, c1) in enumerate(chunks):
            if stage:
                hi = min(len(chunks), ci + 1 + max(0, depth))
                for t in range(max(staged, ci), hi):
                    t0, t1 = chunks[t]
                    steps.append(CommStep(
                        "h2d", "bp", d, k, chunk=t,
                        nbytes=(t1 - t0) * (nv * nu + 1) * F32,
                        prefetch=(t > ci)))
                staged = max(staged, hi)
            steps.append(CommStep("compute", "bp", d, k, chunk=ci))
        steps.append(CommStep("d2h", "bp", d, k,
                              nbytes=(z1 - z0) * ny * nx * F32))
    return tuple(steps)


def hier_group_size(n: int) -> int:
    """Largest divisor of ``n`` that is <= sqrt(n): the intra-group size
    of the hierarchical two-level reduction (1 for primes)."""
    g = 1
    for d in range(2, int(math.isqrt(n)) + 1):
        if n % d == 0:
            g = d
    return g


def choose_reduction(n_shards: int) -> str:
    """Cross-shard reduction schedule for ``n_shards`` model shards.

    ``"psum"`` for <= 2 shards (one hop; also the bit-exact baseline),
    ``"hier"`` (intra-group ring then cross-group hops — Petascale XCT's
    intra-node-before-inter-node shape) when the count factors into
    groups, ``"ring"`` otherwise (primes)."""
    if n_shards <= 2:
        return "psum"
    g = hier_group_size(n_shards)
    if g <= 1 or g >= n_shards:
        return "ring"
    return "hier"


@dataclasses.dataclass(frozen=True)
class CommSchedule:
    """When the bytes move: the explicit staging/compute/reduce schedule
    of one :class:`ExecutionPlan`.

    The streaming executors *interpret* ``fp_steps`` / ``bp_steps``
    verbatim (tests assert the interpreted result is bit-identical to the
    serial ``prefetch_depth=0`` reference), the dist operators read
    ``reduction`` / ``dominance_split``, and the serving layer prices
    transfers with :meth:`transfer_seconds` under a measured-bandwidth
    EMA.  Exactly one place decides when bytes move; everything else
    executes or prices it.
    """

    prefetch_depth: int          # slabs/chunks staged ahead of compute
    n_buffers: int               # staging buffers per device (1 + depth)
    reduction: str               # "psum" | "ring" | "hier" (dist FP)
    dominance_split: bool        # host-level single-dominance dist shards
    bp_chunk_reuse: bool         # later slabs reuse resident chunks
    fp_steps: Tuple[CommStep, ...]
    bp_steps: Tuple[CommStep, ...]

    def steps(self, op: str) -> Tuple[CommStep, ...]:
        return self.fp_steps if op == "fp" else self.bp_steps

    def bytes_moved(self, op: Optional[str] = None) -> int:
        """Total host<->device bytes the schedule moves (one ``A`` plus
        one ``At`` pass when ``op`` is None).  Reflects chunk reuse, so
        it can undercut the raw ``transfer_bytes_*`` upper bounds."""
        which = (self.fp_steps + self.bp_steps if op is None
                 else self.steps(op))
        return sum(s.nbytes for s in which)

    def transfer_seconds(self, bandwidth_bytes_per_s: float,
                         op: Optional[str] = None) -> float:
        """Schedule-derived transfer time of one pass at a measured
        effective bandwidth: the busiest device's staged bytes over the
        bandwidth (devices transfer concurrently; contention is already
        folded into the *measured* bandwidth the serving layer feeds
        in)."""
        if bandwidth_bytes_per_s <= 0:
            raise ValueError("bandwidth must be positive")
        which = (self.fp_steps + self.bp_steps if op is None
                 else self.steps(op))
        per_dev: dict = {}
        for s in which:
            per_dev[s.device] = per_dev.get(s.device, 0) + s.nbytes
        return max(per_dev.values(), default=0) / bandwidth_bytes_per_s

    def describe(self, max_steps: int = 8) -> str:
        """Step-list summary (docs / benchmarks): totals per op plus the
        first ``max_steps`` steps (``*`` marks prefetch)."""
        lines = [f"CommSchedule(depth={self.prefetch_depth}, "
                 f"buffers={self.n_buffers}, reduction={self.reduction}, "
                 f"dominance_split={self.dominance_split}, "
                 f"bp_chunk_reuse={self.bp_chunk_reuse})"]
        for op in ("fp", "bp"):
            steps = self.steps(op)
            shown = " ".join(str(s) for s in steps[:max_steps])
            if len(steps) > max_steps:
                shown += f" ... +{len(steps) - max_steps}"
            lines.append(f"  {op}: {len(steps)} steps, "
                         f"{self.bytes_moved(op)} B: {shown}")
        return "\n".join(lines)


def build_comm_schedule(geo: ConeGeometry, n_angles: int,
                        forward: ForwardPlan, backward: BackwardPlan,
                        prefetch_depth: int = 1) -> CommSchedule:
    """Derive the deterministic communication schedule of a plan."""
    depth = max(0, int(prefetch_depth))
    n_chunks = math.ceil(n_angles / backward.angle_chunk) if n_angles else 0
    return CommSchedule(
        prefetch_depth=depth,
        n_buffers=1 + depth,
        reduction=choose_reduction(max(forward.n_devices,
                                       backward.n_devices)),
        dominance_split=True,
        bp_chunk_reuse=n_chunks <= 1 + depth,
        fp_steps=_fp_comm_steps(forward, geo, n_angles, depth),
        bp_steps=_bp_comm_steps(backward, geo, n_angles, depth))


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """The partition/communication schedule for one (geometry, workload).

    One plan covers *both* operators: ``forward`` holds the FP schedule
    (paper Alg 1 — angles across devices, z-slabs sized to the budget)
    and ``backward`` the BP schedule (paper Alg 2 — slab queues across
    devices, angle-chunk double buffers).  Everything below is derived,
    so consumers never re-run the planners.
    """

    geo: ConeGeometry
    n_angles: int
    n_devices: int
    memory: MemoryModel
    forward: ForwardPlan
    backward: BackwardPlan
    #: the communication schedule (derived in __post_init__ when omitted,
    #: so direct constructions stay valid)
    comm: Optional[CommSchedule] = None

    def __post_init__(self):
        if self.comm is None:
            object.__setattr__(self, "comm", build_comm_schedule(
                self.geo, self.n_angles, self.forward, self.backward))

    def with_prefetch(self, depth: int) -> "ExecutionPlan":
        """Same partition, different overlap: a copy whose schedule
        stages ``depth`` slabs/chunks ahead (``0`` = the serial
        no-prefetch reference the parity tests and the bench's
        overlap-off arm use)."""
        return dataclasses.replace(self, comm=build_comm_schedule(
            self.geo, self.n_angles, self.forward, self.backward,
            prefetch_depth=depth))

    # ---- structure (what the executors iterate) ----------------------------

    @property
    def streams(self) -> bool:
        """True when either operator must split the volume: the workload
        cannot be held resident and belongs on the out-of-core path."""
        return self.forward.n_slabs > 1 or self.backward.n_slabs > 1

    @property
    def slab_ranges(self) -> List[Tuple[int, int]]:
        """Union schedule: the finer of the two operators' slab splits
        (forward and backward agree on (0, nz) when nothing splits)."""
        if self.forward.n_slabs >= self.backward.n_slabs:
            return list(self.forward.slab_ranges)
        return list(self.backward.slab_ranges)

    @property
    def device_of_slab(self) -> List[int]:
        """Backward-pass slab ownership (forward slabs stream on every
        device; backward slabs are round-robin queued, paper SS2.2)."""
        return list(self.backward.device_of_slab)

    @property
    def angle_ranges(self) -> List[Tuple[int, int]]:
        """Forward-pass per-device angle assignment (paper SS2.1)."""
        return list(self.forward.angle_ranges)

    # ---- cost model (what the serving layer prices with) -------------------

    @property
    def step_passes(self) -> float:
        """Relative cost of one outer iteration in units of an in-core
        iteration (= 1.0).  A streamed iteration re-stages the volume once
        per forward slab and the projections once per backward slab, so it
        costs ``(fp slabs + bp slabs) / 2`` — the one cost model shared by
        deadline admission, multi-pod routing and the stealing benefit
        check."""
        if not self.streams:
            return 1.0
        return (self.forward.n_slabs + self.backward.n_slabs) / 2.0

    @property
    def stream_bytes_on_device(self) -> int:
        """Per-device working set of the out-of-core executors: the larger
        of the two operators' ``slab + projection buffers`` budgets."""
        return max(
            self.forward.bytes_image_slab + self.forward.bytes_proj_buffers,
            self.backward.bytes_image_slab + self.backward.bytes_proj_buffers)

    @property
    def vol_bytes(self) -> int:
        nz, ny, nx = self.geo.n_voxel
        return nz * ny * nx * F32

    @property
    def proj_bytes(self) -> int:
        nv, nu = self.geo.n_detector
        return self.n_angles * nv * nu * F32

    @property
    def transfer_bytes_forward(self) -> int:
        """Host<->device bytes one FP pass moves: every device streams the
        whole volume slab by slab (paper Fig 3), and each device's partial
        projections come back once."""
        return self.n_devices * self.vol_bytes + self.proj_bytes

    @property
    def transfer_bytes_backward(self) -> int:
        """Host<->device bytes one BP pass moves: every slab's owner
        consumes the entire projection set through its double buffer
        (paper Fig 5), and each finished slab comes back once."""
        return self.backward.n_slabs * self.proj_bytes + self.vol_bytes

    @property
    def transfer_bytes(self) -> int:
        """One ``A`` plus one ``At`` pass (a gradient-like iteration)."""
        return self.transfer_bytes_forward + self.transfer_bytes_backward

    def describe(self) -> str:
        """Human-readable one-plan summary (docs / benchmarks)."""
        f, b = self.forward, self.backward
        return (f"ExecutionPlan(vol={self.geo.n_voxel}, "
                f"angles={self.n_angles}, devices={self.n_devices}, "
                f"streams={self.streams}, "
                f"fp: {f.n_slabs} slab(s) x chunk {f.angle_chunk}, "
                f"bp: {b.n_slabs} slab(s) x chunk {b.angle_chunk}, "
                f"passes/iter={self.step_passes:g}, "
                f"device bytes={self.stream_bytes_on_device}, "
                f"comm: depth={self.comm.prefetch_depth} "
                f"reduce={self.comm.reduction})")


@lru_cache(maxsize=1024)
def _plan_cached(geo: ConeGeometry, n_angles: int, n_devices: int,
                 memory: MemoryModel, angle_chunk_fp: int,
                 angle_chunk_bp: int, prefetch_depth: int) -> ExecutionPlan:
    fwd = plan_forward(geo, n_angles, n_devices, memory,
                       angle_chunk=angle_chunk_fp)
    bwd = plan_backward(geo, n_angles, n_devices, memory,
                        angle_chunk=angle_chunk_bp)
    return ExecutionPlan(
        geo=geo, n_angles=n_angles, n_devices=n_devices, memory=memory,
        forward=fwd, backward=bwd,
        comm=build_comm_schedule(geo, n_angles, fwd, bwd,
                                 prefetch_depth=prefetch_depth))


def plan(geo: ConeGeometry, n_angles: int, n_devices: int = 1,
         memory: Optional[MemoryModel] = None, angle_chunk_fp: int = 16,
         angle_chunk_bp: int = 32, prefetch_depth: int = 1) -> ExecutionPlan:
    """The single planning entry point (subsumes ``plan_forward`` /
    ``plan_backward``).  Memoized: every consumer in the process —
    operators, streaming executors, schedulers, routing, stealing,
    benchmarks — shares one plan object per (geometry, workload, budget),
    so the pure-python planners never re-run on a hot path.

    Raises :class:`MemoryError` (not cached) when even one image plane
    plus the projection buffers exceed the budget."""
    from .. import obs
    if not obs.enabled():
        return _plan_cached(geo, int(n_angles), int(n_devices),
                            memory or MemoryModel(),
                            int(angle_chunk_fp), int(angle_chunk_bp),
                            int(prefetch_depth))
    # Span only the memo *misses*: hits are sub-microsecond dict lookups
    # and the serving layer's load polling would flood the ring with them.
    # An abandoned begin() handle costs nothing (miss check is advisory
    # under concurrent planners).
    misses0 = _plan_cached.cache_info().misses
    h = obs.begin("plan", "plan", n_angles=int(n_angles),
                  n_devices=int(n_devices))
    out = _plan_cached(geo, int(n_angles), int(n_devices),
                       memory or MemoryModel(),
                       int(angle_chunk_fp), int(angle_chunk_bp),
                       int(prefetch_depth))
    if _plan_cached.cache_info().misses != misses0:
        obs.end(h)
    return out


def plan_cache_info():
    """Memo-table statistics (hits/misses/currsize) — the regression tests
    assert the serving layer's load polling stays on the cache."""
    return _plan_cached.cache_info()


def plan_cache_clear() -> None:
    _plan_cached.cache_clear()
