"""Multi-pod device pools: one scheduler per host group, mesh-aware routing.

Port of ``repro/serve/pool.py``.  A pod's slots are ``torch.device``s
(``PodSpec.devices``, or the current CUDA device for a pod without pins),
each on a CUDA stream of its own; several pods may share one card.  The
fleet manifest (``fleet.json``) is the reference's field for field and
records no devices, so each package restores the other's fleet snapshot.

A single :class:`~repro_torch.serve.scheduler.Scheduler` owns one
:class:`~repro_torch.serve.scheduler.DevicePool` — one host's devices.  A
site with several host groups (the paper's "arbitrarily large ... on whatever
devices a site has", scaled past one machine) runs one pool *per group*:
each group keeps its own scheduler, queue and device ledger, and only two
things cross the boundary — a routing decision at submit time, and parked
jobs moved by work stealing (:mod:`repro_torch.serve.steal`).

Topology comes from :mod:`repro_torch.launch.mesh`: a mesh with a
leading ``"pod"`` axis yields one :class:`Pod` per pod index
(:func:`pods_from_mesh`), while single-host rigs describe pods with
:class:`PodSpec` (device count + memory budget — pods may be
*heterogeneous*, e.g. one group of large-memory devices next to many
small ones).

Routing is mesh-aware in the planner sense: for every pod the job's
footprint is evaluated under *that pod's* memory model
(``plan_forward`` / ``plan_backward``), so the same volume may be
resident on a large-memory pod but need N streaming slabs on a small
one.  :meth:`MultiPodScheduler.submit` models the completion makespan on
each feasible pod — current per-device backlog plus the job's modeled
cost, where a streaming job's cost scales with its slab-pass count under
that pod's budget — and places the job on the pod that minimises it.
Oversized jobs therefore gravitate to the pod whose streaming plan is
cheapest, and small jobs to whichever pod is idlest.

Quick start (two pods on the current card, the second one bigger)::

    pods = [Pod(PodSpec("small", n_devices=2, memory=MemoryModel(...))),
            Pod(PodSpec("big", n_devices=1, memory=MemoryModel(...)))]
    # on the CPU: PodSpec(..., devices=(torch.device("cpu"),) * n)
    mps = MultiPodScheduler(pods, transfer_dir="/ckpt/steal")
    jid = mps.submit(job)              # routed by modeled makespan
    mps.run()                          # cooperative; steals between rounds
    image = mps.result(jid)

For true thread-per-device execution drive the same object with
:class:`repro_torch.serve.driver.MultiPodDriver`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from ..core.algorithms.stepwise import get_algorithm
from ..core.splitting import MemoryModel
from ..obs import fleet_event
from ..obs.calibration import CalibrationLedger
from .job import JobRecord, ReconJob
from .metrics import ServeMetrics, merge_metrics
from .scheduler import (DevicePool, Scheduler, _TERMINAL,
                        _atomic_write_json, _consume_transfer_copy)
from .steal import (StealPolicy, effective_units, fleet_units, pod_load,
                    steal_pass)

#: membership manifest at the root of a fleet snapshot directory
FLEET_MANIFEST = "fleet.json"


class DuplicatePodName(ValueError):
    """A pod name is already used by a live or retired pod.

    Distinct from plain :class:`ValueError` so retry loops that probe
    for a free name (``Autoscaler._next_pod``) can catch *exactly* the
    collision and surface every other admission failure."""


@dataclasses.dataclass(frozen=True)
class PodSpec:
    """Description of one pod (host group) for pool construction.

    ``devices`` pins the pod to devices (one slot each; overrides
    ``n_devices``); without pins the pod's ``n_devices`` slots lie on the
    current CUDA device, and building it raises without one (a pod never
    lands on the CPU unless its pins say so).  Several pods may share a
    card: each slot has a CUDA stream of its own."""
    name: str
    n_devices: int = 1
    memory: MemoryModel = MemoryModel()
    devices: Optional[Tuple[torch.device, ...]] = None
    max_jobs_per_device: Optional[int] = None
    placement: str = "spread"


class Pod:
    """One host group: a :class:`DevicePool` plus its :class:`Scheduler`."""

    def __init__(self, spec: PodSpec, guard=None,
                 snapshot_dir: Optional[str] = None):
        self.spec = spec
        self.pool = DevicePool(
            n_devices=spec.n_devices, memory=spec.memory,
            devices=spec.devices,
            max_jobs_per_device=spec.max_jobs_per_device,
            policy=spec.placement)
        self.scheduler = Scheduler(pool=self.pool, guard=guard,
                                   snapshot_dir=snapshot_dir,
                                   name=spec.name)
        # set by the autoscaler while the pod is being emptied: routing
        # and stealing skip a draining pod, so no new work lands on it
        self.draining = False

    @property
    def name(self) -> str:
        return self.spec.name

    @property
    def n_devices(self) -> int:
        return len(self.pool.slots)

    def __repr__(self) -> str:
        return (f"Pod({self.name!r}, devices={self.n_devices}, "
                f"usable={self.pool.memory.usable}B)")


@dataclasses.dataclass
class RetiredPodSummary:
    """Compact tombstone of a retired pod after its TTL expired.

    A retired :class:`Pod` keeps its whole scheduler — records with
    result arrays, executor caches — so ``owner()`` / ``result()`` stay
    answerable for jobs that completed there.  A server that scales down
    thousands of times would grow without bound, so after
    ``retired_pod_ttl_seconds`` the pod is folded into this summary:
    counters (:class:`ServeMetrics`), per-device busy clocks and each
    job's terminal status survive (fleet metrics and summaries stay
    exact); the result arrays and the scheduler are dropped.
    """
    name: str
    retired_at: float
    n_devices: int
    metrics: ServeMetrics
    device_busy: List[float]
    job_statuses: Dict[str, str]     # job_id -> terminal status value

    def summary(self) -> Dict:
        out = self.metrics.summary(device_busy=self.device_busy)
        out["compacted"] = True
        return out


def pods_from_mesh(mesh, memory: Optional[MemoryModel] = None,
                   pod_axis: str = "pod", **spec_kwargs) -> List[Pod]:
    """One :class:`Pod` per group along the mesh's ``pod_axis`` (the whole
    mesh as a single pod if the axis is absent), each pod's pool holding
    one slot per device in its group."""
    from ..launch.mesh import pod_device_groups
    groups = pod_device_groups(mesh, pod_axis)
    return [Pod(PodSpec(name=f"pod{i}", memory=memory or MemoryModel(),
                        devices=tuple(group), **spec_kwargs))
            for i, group in enumerate(groups)]


def modeled_job_seconds(job: ReconJob, pod: Pod,
                        unit: Optional[float] = None,
                        init: Optional[float] = None) -> Optional[float]:
    """Modeled cost of running ``job`` on ``pod``, or None if the job can
    never fit there (not even streamed).

    The unit cost is the pod's observed per-pass step EMA, scaled by the
    job's slab-pass multiplier under *that pod's* budget, so a pod with
    more memory per device models (and is) cheaper for oversized
    volumes.  Footprint and multiplier are read off the scheduler's
    memoized plan (:meth:`Scheduler.job_footprint` /
    :meth:`Scheduler.job_passes`, both backed by the shared
    :func:`repro_torch.core.plan.plan` memo) — routing a submission across N
    pods re-prices, never re-plans.  ``unit`` / ``init`` supply the
    fleet-wide fallback for a pod with no observations yet (see
    :func:`repro_torch.serve.steal.fleet_units`); with no fallback either, a
    cold pod costs 1.0 per pass."""
    try:
        fp = pod.scheduler.job_footprint(job)
    except Exception:
        return None
    passes = pod.scheduler.job_passes(job)
    if fp.bytes_on_device > pod.pool.fits_nowhere_bytes:
        return None
    alg = get_algorithm(job.algorithm)
    iters = max(1, job.n_iter) if alg.iterative else 1
    unit, init = effective_units(pod.scheduler, unit, init)
    if unit is None:
        unit = 1.0
    if init is None:
        init = 0.0
    # streamed jobs also pay the schedule-priced staging time per
    # iteration once the pod has measured a bandwidth (0.0 before)
    return init + iters * (passes * unit
                           + pod.scheduler.modeled_transfer_seconds(job))


class MultiPodScheduler:
    """Routes jobs across pods and (optionally) rebalances them by work
    stealing.  Membership is *dynamic*: pods can be added and retired at
    runtime (:meth:`add_pod` / :meth:`remove_pod`, driven by
    :class:`repro_torch.serve.autoscale.Autoscaler`), and every routing /
    stealing / reporting pass iterates a snapshot of the pod list taken
    under the fleet lock.

    Parameters
    ----------
    pods : the initial pod set (see :class:`Pod`, :func:`pods_from_mesh`).
    steal : enable work stealing between cooperative rounds (and in
        :class:`~repro_torch.serve.driver.MultiPodDriver`'s steal thread).
    transfer_dir : directory jobs move through (manifest + COMMIT, the
        durable-snapshot layout).  On a real cluster this is storage all
        host groups mount; defaults to a scratch tempdir.
    steal_policy : thresholds, see
        :class:`repro_torch.serve.steal.StealPolicy`.
    data_refs : job-id -> callable map letting *lazy* (data-ref) jobs be
        re-resolved on the thief pod; lazy jobs without an entry are
        never stolen.
    snapshot_root : fleet-level durable snapshot directory.  Each pod
        gets its own subdirectory (``<root>/pods/<pod_name>``) as its
        scheduler's ``snapshot_dir``, and a ``fleet.json`` membership
        manifest is kept at the root — :meth:`snapshot_fleet` /
        :meth:`drain_fleet` persist the whole fleet and
        :meth:`restore_fleet` rebuilds it (membership *and* parked jobs)
        after process death.
    retired_pod_ttl_seconds : fold a retired pod's full records into a
        compact :class:`RetiredPodSummary` once it has been retired this
        long (``None`` = keep forever).  Counters, busy clocks and job
        statuses survive compaction; result arrays do not — a long-lived
        autoscaled server stays bounded no matter how often it scales
        down.  Compaction runs opportunistically on every
        :meth:`remove_pod` / :meth:`metrics` / :meth:`summary` call (or
        explicitly via :meth:`compact_retired`).
    """

    def __init__(self, pods: Sequence[Pod], steal: bool = True,
                 transfer_dir: Optional[str] = None,
                 steal_policy: StealPolicy = StealPolicy(),
                 data_refs: Optional[Dict[str, Callable]] = None,
                 snapshot_root: Optional[str] = None,
                 retired_pod_ttl_seconds: Optional[float] = None):
        if not pods:
            raise ValueError("MultiPodScheduler needs at least one pod")
        names = [p.name for p in pods]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate pod names: {names}")
        self.steal = steal
        self.transfer_dir = transfer_dir or tempfile.mkdtemp(
            prefix="repro-steal-")
        self.snapshot_root = snapshot_root
        self.steal_policy = steal_policy
        self.data_refs = dict(data_refs or {})
        self.stolen_jobs: List[str] = []      # every job a pass moved
        self.restored_jobs: List[str] = []    # filled by restore_fleet
        self.recovered_jobs: List[str] = []   # filled by recover_transfers
        self._home: Dict[str, str] = {}       # job_id -> submit-time pod
        # fleet lock: guards pod membership (add/remove), the retired
        # list, and the pod-seconds ledger.  Every reader takes a
        # snapshot (`pods_snapshot`) instead of iterating `self.pods`
        # while another thread mutates it.
        self._fleet_lock = threading.RLock()
        # manifest writes run *outside* the fleet lock (disk I/O must
        # not serialize submissions); the generation counter makes the
        # race benign — a writer that captured older membership than
        # what already landed skips its write
        self._manifest_lock = threading.Lock()
        self._manifest_gen = 0        # bumped under the fleet lock
        self._manifest_written = 0    # guarded by the manifest lock
        # latest captured-but-unwritten (gen, spec); guarded by the
        # manifest lock.  Paths that mutate membership while already
        # holding the fleet lock re-entrantly (autoscaler scale-up from
        # submit) only *mark* and leave the flush to their outermost
        # caller, so the disk write never runs with the fleet lock held.
        self._pending_manifest: Optional[Tuple[int, Dict]] = None
        self.pods: List[Pod] = []
        self.retired_pods: List[Pod] = []
        self.retired_pod_ttl_seconds = retired_pod_ttl_seconds
        self.retired_summaries: List[RetiredPodSummary] = []
        self._retired_at: Dict[str, float] = {}
        # fleet gauges: scale events + pods-online timeline + the
        # *retired* pods' accumulated pod-seconds (live pods' seconds are
        # added on the fly in `metrics()`)
        self.fleet_metrics = ServeMetrics()
        self._pod_started: Dict[str, float] = {}
        # set by Autoscaler so `submit` can grow the fleet for a job that
        # fits no live pod (the `fits_nowhere_bytes` signal)
        self.autoscaler = None
        # a job mid-transfer (exported from the victim, not yet imported
        # by the thief) is in *no* scheduler; the flag + generation
        # counter keep `idle` honest so a driver cannot observe the
        # fleet as done and stop while the last job is on the wire.
        # Scale-down drains move jobs the same way and share the guard.
        self._stealing = threading.Event()
        self._steal_gen = 0
        now = time.monotonic()
        for p in pods:
            self._admit_pod(p, now)
        self.fleet_metrics.record_pods_online(now, len(self.pods))
        self._write_fleet_manifest()

    # ---- dynamic membership ------------------------------------------------

    def _admit_pod(self, pod: Pod, now: float) -> None:
        """Register one pod (fleet lock held by the caller where it
        matters): wire its snapshot subdirectory, check transfer-dir
        aliasing, start its pod-seconds clock."""
        if self.snapshot_root is not None and \
                pod.scheduler.snapshot_dir is None:
            pod.scheduler.snapshot_dir = os.path.join(
                self.snapshot_root, "pods", pod.name)
        sd = pod.scheduler.snapshot_dir
        if sd is not None and (os.path.abspath(sd)
                               == os.path.abspath(self.transfer_dir)):
            raise ValueError(
                f"transfer_dir {self.transfer_dir!r} aliases pod "
                f"{pod.name!r}'s snapshot_dir; hand-offs and durable "
                f"snapshots must use distinct directories")
        self.pods.append(pod)
        self._pod_started[pod.name] = now

    def pods_snapshot(self, live_only: bool = True) -> List[Pod]:
        """Membership snapshot under the fleet lock — the list every
        routing / stealing / reporting pass iterates.  With
        ``live_only`` (default) draining pods are excluded: no new work
        may land on a pod that is being emptied."""
        with self._fleet_lock:
            if live_only:
                return [p for p in self.pods if not p.draining]
            return list(self.pods)

    def add_pod(self, pod: Pod, flush_manifest: bool = True) -> Pod:
        """Grow the fleet at runtime (the autoscaler's scale-up).  The
        new pod is immediately visible to routing and stealing; a
        threaded fleet driver picks it up on its next membership sync.
        Names must be unique across live *and* retired pods (retired
        pods keep their completed-job records and their slice of the
        pod-seconds ledger) — collisions raise :class:`DuplicatePodName`.

        ``flush_manifest=False`` defers the manifest disk write to a
        later :meth:`_flush_manifest` — callers already holding the
        (re-entrant) fleet lock, like the autoscaler's scale-up, pass
        this so the I/O never runs with the lock held."""
        with self._fleet_lock:
            taken = {p.name for p in self.pods}
            taken.update(p.name for p in self.retired_pods)
            taken.update(s.name for s in self.retired_summaries)
            if pod.name in taken:
                raise DuplicatePodName(
                    f"pod name {pod.name!r} already used")
            self._admit_pod(pod, time.monotonic())
            self.fleet_metrics.record_pods_online(time.monotonic(),
                                                  len(self.pods))
            fleet_event("pod-add", pod=pod.name, n_pods=len(self.pods))
            self._mark_manifest_dirty()
        # manifest I/O outside the lock: scale_up_for runs add_pod from
        # inside `submit`, and a disk write under the fleet lock would
        # serialize every tenant's submission behind it
        if flush_manifest:
            self._flush_manifest()
        return pod

    def remove_pod(self, pod: Union[str, Pod]) -> Pod:
        """Retire an *empty* pod (the autoscaler's scale-down calls this
        after the drain moved every job to survivors).  The pod keeps
        its scheduler (completed-job records stay queryable through
        :meth:`owner` / :meth:`result`) but leaves the routing set, and
        its online time is folded into the pod-seconds ledger."""
        with self._fleet_lock:
            target = pod if isinstance(pod, Pod) else self._pod_by(pod)
            if not target.scheduler.idle:
                raise ValueError(
                    f"remove_pod: pod {target.name!r} still holds work "
                    f"(drain it first)")
            self.pods.remove(target)
            self.retired_pods.append(target)
            now = time.monotonic()
            self._retired_at[target.name] = now
            started = self._pod_started.pop(target.name, now)
            self.fleet_metrics.pod_seconds += now - started
            if target.scheduler.metrics.wall_end is None:
                target.scheduler.metrics.wall_end = now
            self.fleet_metrics.record_pods_online(now, len(self.pods))
            fleet_event("pod-remove", pod=target.name,
                        n_pods=len(self.pods))
            self._mark_manifest_dirty()
        self.compact_retired()
        self._flush_manifest()         # I/O outside the lock (see add_pod)
        return target

    def compact_retired(self, now: Optional[float] = None) -> int:
        """Fold retired pods whose TTL has expired into
        :class:`RetiredPodSummary` tombstones (see
        ``retired_pod_ttl_seconds``); returns how many pods were folded.
        After compaction a pod's job *results* are gone — :meth:`owner` /
        :meth:`result` raise a KeyError naming the compaction — but its
        counters, busy clocks and job statuses stay in the fleet
        metrics/summary forever."""
        if self.retired_pod_ttl_seconds is None:
            return 0
        now = time.monotonic() if now is None else now
        cutoff = now - self.retired_pod_ttl_seconds
        with self._fleet_lock:
            fold = [p for p in self.retired_pods
                    if self._retired_at.get(p.name, now) <= cutoff]
            for pod in fold:
                self.retired_pods.remove(pod)
                self.retired_summaries.append(RetiredPodSummary(
                    name=pod.name,
                    retired_at=self._retired_at.pop(pod.name, now),
                    n_devices=pod.n_devices,
                    metrics=pod.scheduler.metrics,
                    device_busy=list(pod.pool.busy_clocks()),
                    job_statuses={
                        jid: rec.status.value
                        for jid, rec in pod.scheduler.records.items()}))
        return len(fold)

    def record_scale_event(self, direction: str) -> None:
        with self._fleet_lock:
            if direction == "up":
                self.fleet_metrics.scale_up_events += 1
            elif direction == "down":
                self.fleet_metrics.scale_down_events += 1
            else:
                raise ValueError(f"unknown scale direction {direction!r}")

    @contextlib.contextmanager
    def transfer_guard(self):
        """Mark a job hand-off (steal or drain) in flight so
        :attr:`idle` cannot report "all done" while a job is on the wire
        between two schedulers."""
        self._stealing.set()
        self._steal_gen += 1
        try:
            yield
        finally:
            self._stealing.clear()

    # ---- submission / routing ---------------------------------------------

    def _pod_by(self, pod: Union[int, str, Pod]) -> Pod:
        if isinstance(pod, Pod):
            return pod
        if isinstance(pod, int):
            return self.pods[pod]
        for p in self.pods:
            if p.name == pod:
                return p
        raise KeyError(f"no pod named {pod!r} "
                       f"(have {[p.name for p in self.pods]})")

    def route(self, job: ReconJob) -> Optional[Pod]:
        """Pod with the minimal modeled completion makespan for ``job``:
        per-device backlog + the job's modeled cost under that pod's
        topology, all on the fleet-shared unit scale (a cold pod borrows
        the warm pods' EMAs, so an idle new pod is not mispriced against
        a warm loaded one; ties: fewer devices busy, then pod order).
        Draining pods are never candidates.  Returns None when no live
        pod can ever hold the job."""
        pods = self.pods_snapshot()
        unit, init = fleet_units(pods)
        best: Optional[Tuple[float, int, int]] = None
        chosen: Optional[Pod] = None
        for i, pod in enumerate(pods):
            cost = modeled_job_seconds(job, pod, unit=unit, init=init)
            if cost is None:
                continue
            backlog = pod_load(pod.scheduler, pod.n_devices,
                               unit=unit, init=init)
            busy = sum(1 for s in pod.pool.slots if s.jobs)
            score = (backlog + cost, busy, i)
            if best is None or score < best:
                best, chosen = score, pod
        return chosen

    def submit(self, job: ReconJob,
               pod: Optional[Union[int, str, Pod]] = None) -> str:
        """Submit ``job``, routed by modeled makespan — or pinned to
        ``pod`` (index / name / object), which is how static per-pod
        partitioning (tenant affinity) is expressed.

        Runs under the fleet lock so routing and membership changes
        cannot interleave (a job can never be routed onto a pod that is
        concurrently retired).  If no live pod can hold the job and an
        :class:`~repro_torch.serve.autoscale.Autoscaler` is attached, the
        autoscaler is asked to grow the fleet from its template pool
        (the ``fits_nowhere_bytes`` signal); failing that, the job goes
        to the largest-memory pod so its scheduler fails it with the
        canonical budget error."""
        with self._fleet_lock:
            if pod is not None:
                target = self._pod_by(pod)
            else:
                target = self.route(job)
                if target is None and self.autoscaler is not None:
                    target = self.autoscaler.scale_up_for(job)
                if target is None:
                    target = max(self.pods_snapshot() or self.pods,
                                 key=lambda p: p.pool.memory.usable)
            jid = target.scheduler.submit(job)
            self._home[jid] = target.name
        # an autoscaler scale-up above only *marked* the fleet manifest
        # dirty (we held the fleet lock); write it now the lock is free
        self._flush_manifest()
        return jid

    # ---- lookups across pods ----------------------------------------------

    def owner(self, job_id: str) -> Pod:
        """Pod currently holding the job's record (stealing moves it;
        retired pods keep the records of jobs that completed on them,
        until compaction — see :meth:`compact_retired`)."""
        with self._fleet_lock:
            pods = list(self.pods) + list(self.retired_pods)
            summaries = list(self.retired_summaries)
        for pod in pods:
            if job_id in pod.scheduler.records:
                return pod
        for s in summaries:
            if job_id in s.job_statuses:
                raise KeyError(
                    f"job {job_id} ({s.job_statuses[job_id]}) ran on "
                    f"retired pod {s.name!r}, whose records were "
                    f"compacted after the retired-pod TTL; its result is "
                    f"no longer held")
        raise KeyError(f"unknown job {job_id}")

    def home(self, job_id: str) -> str:
        """Name of the pod the job was *submitted* to (never changes)."""
        return self._home[job_id]

    def record(self, job_id: str) -> JobRecord:
        return self.owner(job_id).scheduler.records[job_id]

    def result(self, job_id: str):
        return self.owner(job_id).scheduler.result(job_id)

    @property
    def idle(self) -> bool:
        # valid only if no steal pass / scale-down drain was in flight at
        # any point during the pod scan: a hand-off could move a job from
        # a pod we check *later* to one we checked *earlier*, making
        # every pod look idle while the job is on the wire.  The flag
        # covers an active pass; the generation counter covers a pass
        # that started and finished entirely within our scan.
        gen = self._steal_gen
        if self._stealing.is_set():
            return False
        result = all(p.scheduler.idle
                     for p in self.pods_snapshot(live_only=False))
        if self._stealing.is_set() or self._steal_gen != gen:
            return False
        return result

    # ---- execution ---------------------------------------------------------

    def steal_pass(self) -> List[str]:
        """One explicit rebalancing pass (the cooperative loop and the
        threaded driver both call this).  Operates on the live
        (non-draining) membership snapshot.  Returns moved job ids."""
        if not self.steal:
            return []
        with self.transfer_guard():
            moved = steal_pass(self.pods_snapshot(), self.transfer_dir,
                               data_refs=self.data_refs,
                               policy=self.steal_policy)
        self.stolen_jobs.extend(moved)
        return moved

    def run(self, max_rounds: Optional[int] = None,
            autoscaler=None) -> ServeMetrics:
        """Cooperative fleet loop: each round steps every pod's scheduler
        one quantum, runs a steal pass so idle pods pick up other pods'
        parked surplus, then gives the autoscaler (the ``autoscaler``
        argument, or the one registered on this fleet) one control
        decision.  Single-threaded (one pod computes at a time); use
        :class:`repro_torch.serve.driver.MultiPodDriver` for real per-device
        overlap.  Returns the merged fleet metrics."""
        autoscaler = autoscaler if autoscaler is not None \
            else self.autoscaler
        rounds = 0
        while True:
            now = time.monotonic()
            for pod in self.pods_snapshot(live_only=False):
                if pod.scheduler.metrics.wall_start is None:
                    pod.scheduler.metrics.wall_start = now
            if self.idle:
                break
            if max_rounds is not None and rounds >= max_rounds:
                break
            for pod in self.pods_snapshot(live_only=False):
                pod.scheduler.step_quantum()
            self.steal_pass()
            if autoscaler is not None:
                autoscaler.step()
            rounds += 1
        now = time.monotonic()
        for pod in self.pods_snapshot(live_only=False):
            pod.scheduler.metrics.wall_end = now
        return self.metrics()

    # ---- reporting ---------------------------------------------------------

    def _gauge_metrics(self) -> ServeMetrics:
        """Snapshot of the fleet gauges with the *live* pods' online time
        added to the retired pods' accumulated pod-seconds."""
        with self._fleet_lock:
            g = ServeMetrics(
                scale_up_events=self.fleet_metrics.scale_up_events,
                scale_down_events=self.fleet_metrics.scale_down_events,
                pod_seconds=self.fleet_metrics.pod_seconds,
                pods_online=list(self.fleet_metrics.pods_online))
            now = time.monotonic()
            g.pod_seconds += sum(now - t0
                                 for t0 in self._pod_started.values())
        return g

    def metrics(self) -> ServeMetrics:
        """Merged fleet metrics over live and retired pods — compacted
        tombstones included, so scaling down (and compacting) never loses
        counters — plus the fleet gauges (scale events, pods-online
        timeline, pod-seconds)."""
        self.compact_retired()
        with self._fleet_lock:
            parts = [p.scheduler.metrics
                     for p in self.pods + self.retired_pods]
            parts += [s.metrics for s in self.retired_summaries]
        return merge_metrics(parts + [self._gauge_metrics()])

    def summary(self) -> Dict:
        """Fleet summary (merged counters, fleet-wide makespan over every
        device busy clock — retired pods included) plus a per-pod
        breakdown."""
        self.compact_retired()
        with self._fleet_lock:
            live = list(self.pods)
            retired = list(self.retired_pods)
            summaries = list(self.retired_summaries)
        busy: List[float] = []
        for pod in live + retired:
            busy.extend(pod.pool.busy_clocks())
        for s in summaries:
            busy.extend(s.device_busy)
        out = self.metrics().summary(device_busy=busy)
        out["pods"] = {p.name: p.scheduler.summary() for p in live}
        out["retired_pods"] = {p.name: p.scheduler.summary()
                               for p in retired}
        out["retired_pods"].update({s.name: s.summary() for s in summaries})
        out["jobs_stolen"] = len(self.stolen_jobs)
        # the fleet event log's calibration verdict: samples folded per
        # event kind and the pods whose cost models have EMA-drifted
        # stale (empty unless tracing was enabled during the run)
        led = CalibrationLedger.from_events()
        out["calibration_samples_by_kind"] = led.samples_by_kind()
        out["stale_pods"] = led.stale_pods()
        return out

    # ---- fleet-level durable snapshots -------------------------------------
    #
    # Layout under `snapshot_root`:
    #
    #   <root>/fleet.json            # membership manifest (atomic replace):
    #                                #   {"pods": [{name, n_devices, ...}],
    #                                #    "homes": {job_id: pod_name}}
    #   <root>/pods/<pod_name>/      # that pod scheduler's snapshot_dir
    #     jobs/<job_id>/...          #   (spec.json + manifest+COMMIT steps,
    #                                #    see scheduler.py)
    #
    # The manifest is rewritten on every membership change (ctor,
    # add_pod, remove_pod), so a kill -9 at any moment leaves a manifest
    # that matches the per-pod job directories next to it.  Device pins
    # are not persisted (the reference's manifest has no field for them,
    # and each package restores the other's): the manifest records
    # *budgets* only, and restore_fleet re-derives the pins from a mesh
    # passed at restore time (``mesh=`` / ``pod_axis=``, validated
    # group-by-group against the recorded device counts); without a mesh,
    # restored pods lie on the current CUDA device.

    def _mark_manifest_dirty(self) -> None:
        """Capture the current membership as the pending manifest.

        Called with the fleet lock held (cheap: no I/O).  The lock order
        is fleet -> manifest only; :meth:`_flush_manifest` never takes
        the fleet lock, so there is no deadlock against a concurrent
        writer."""
        if self.snapshot_root is None:
            return
        self._manifest_gen += 1
        spec = {
            "pods": [{
                "name": p.name,
                "n_devices": p.n_devices,
                "device_bytes": p.pool.memory.device_bytes,
                "usable_fraction": p.pool.memory.usable_fraction,
                "max_jobs_per_device": p.spec.max_jobs_per_device,
                "placement": p.spec.placement,
            } for p in self.pods],
            "homes": dict(self._home),
        }
        with self._manifest_lock:
            self._pending_manifest = (self._manifest_gen, spec)

    def _flush_manifest(self) -> None:
        """Write the pending manifest (if any) to disk.

        Must be called with the fleet lock *released* — every scale-up
        path (public ``add_pod``, ``Autoscaler.step``, ``submit`` via
        ``scale_up_for``) reaches here only after its last fleet-lock
        exit, so the disk write never serializes membership or
        submissions.  Generation-ordered: a flush that lost the race to
        a newer membership write skips (no stale overwrite)."""
        if self.snapshot_root is None:
            return
        with self._manifest_lock:
            pending = self._pending_manifest
            self._pending_manifest = None
            if pending is None:
                return
            gen, spec = pending
            if gen < self._manifest_written:
                return        # a newer membership already landed on disk
            self._manifest_written = gen
            os.makedirs(self.snapshot_root, exist_ok=True)
            _atomic_write_json(
                os.path.join(self.snapshot_root, FLEET_MANIFEST), spec)

    def _write_fleet_manifest(self) -> None:
        with self._fleet_lock:
            self._mark_manifest_dirty()
        self._flush_manifest()

    def snapshot_fleet(self, root: Optional[str] = None) -> int:
        """Persist the fleet durably: membership manifest + every pod's
        parked *and running* jobs (copy-on-checkpoint, see
        :meth:`Scheduler.snapshot`) under its own snapshot subdirectory.
        Returns the number of jobs persisted across pods."""
        root = root or self.snapshot_root
        if root is None:
            raise ValueError("snapshot_fleet: no snapshot_root configured")
        self._write_fleet_manifest()
        persisted = 0
        for pod in self.pods_snapshot(live_only=False):
            pod_dir = pod.scheduler.snapshot_dir or os.path.join(
                root, "pods", pod.name)
            persisted += pod.scheduler.snapshot(pod_dir)
        return persisted

    def drain_fleet(self, root: Optional[str] = None,
                    timeout: float = 60.0) -> int:
        """Park + persist every running job on every pod (the fleet-wide
        SIGTERM path): each pod's scheduler drains into its own snapshot
        subdirectory, and the membership manifest is rewritten.  Returns
        the number of jobs parked."""
        root = root or self.snapshot_root
        if root is None:
            raise ValueError("drain_fleet: no snapshot_root configured")
        self._write_fleet_manifest()
        parked = 0
        for pod in self.pods_snapshot(live_only=False):
            pod_dir = pod.scheduler.snapshot_dir or os.path.join(
                root, "pods", pod.name)
            parked += pod.scheduler.drain(pod_dir, timeout=timeout)
        return parked

    @classmethod
    def restore_fleet(cls, snapshot_root: str,
                      data_refs: Optional[Dict[str, Callable]] = None,
                      steal: bool = True,
                      transfer_dir: Optional[str] = None,
                      steal_policy: StealPolicy = StealPolicy(),
                      guard=None, mesh=None,
                      pod_axis: str = "pod") -> "MultiPodScheduler":
        """Rebuild a whole fleet — membership *and* parked jobs — from a
        fleet snapshot directory after process death.  Every pod named in
        ``fleet.json`` is reconstructed (device count, budget, placement
        policy) and its scheduler restored from its snapshot
        subdirectory; jobs resume bit-identically to an uninterrupted
        run.  The restored job ids are exposed as ``restored_jobs``.

        The manifest records *budgets* only, no devices.  Pass ``mesh``
        (a :class:`~repro_torch.launch.mesh.Mesh` with the pod axis named
        by ``pod_axis``) to restore onto its devices: the mesh's pod
        groups are re-derived exactly as :func:`pods_from_mesh` does and
        matched, in manifest order, against the recorded pods — group
        count and per-group device count must agree with the manifest, or
        the restore refuses loudly rather than silently re-pinning jobs
        onto a different topology.  Without a mesh, the pods are restored
        without pins: on the current CUDA device, and the restore raises
        when there is none (it never falls back to the CPU).

        If ``transfer_dir`` names the fleet's shared hand-off directory,
        :meth:`recover_transfers` runs after the per-pod restores: a
        crash between a steal's export and import leaves the job only in
        the transfer directory, and recovery re-adopts it (the ids land
        in ``recovered_jobs``).

        ``data_refs`` supplies projection callables for lazy-data jobs
        (refs cannot be persisted); ``guard`` is attached to every
        restored pod's scheduler.  Restore failures are loud (see
        :meth:`Scheduler.restore`)."""
        manifest_path = os.path.join(snapshot_root, FLEET_MANIFEST)
        if not os.path.isfile(manifest_path):
            raise FileNotFoundError(
                f"restore_fleet: no {FLEET_MANIFEST} under "
                f"{snapshot_root!r} (not a fleet snapshot?)")
        with open(manifest_path) as f:
            manifest = json.load(f)
        if not manifest.get("pods"):
            raise ValueError(f"restore_fleet: {manifest_path} lists no pods")
        groups = None
        if mesh is not None:
            from ..launch.mesh import pod_device_groups
            groups = pod_device_groups(mesh, pod_axis)
            if len(groups) != len(manifest["pods"]):
                raise ValueError(
                    f"restore_fleet: mesh yields {len(groups)} pod "
                    f"groups but {FLEET_MANIFEST} records "
                    f"{len(manifest['pods'])} pods — the restore mesh "
                    f"must match the snapshotted fleet shape")
            for group, p in zip(groups, manifest["pods"]):
                if len(group) != p["n_devices"]:
                    raise ValueError(
                        f"restore_fleet: mesh group for pod "
                        f"{p['name']!r} has {len(group)} devices but "
                        f"the manifest records {p['n_devices']}")
        pods = [Pod(PodSpec(
                    name=p["name"], n_devices=p["n_devices"],
                    memory=MemoryModel(
                        device_bytes=p["device_bytes"],
                        usable_fraction=p["usable_fraction"]),
                    devices=(tuple(groups[i]) if groups is not None
                             else None),
                    max_jobs_per_device=p["max_jobs_per_device"],
                    placement=p["placement"]),
                    guard=guard)
                for i, p in enumerate(manifest["pods"])]
        mps = cls(pods, steal=steal, transfer_dir=transfer_dir,
                  steal_policy=steal_policy, data_refs=data_refs,
                  snapshot_root=snapshot_root)
        homes = manifest.get("homes", {})
        # the ctor rewrote fleet.json while _home was still empty: put
        # the homes back (memory + disk) *before* the per-pod restores,
        # whose documented failure mode (e.g. a lazy job missing its
        # data_refs entry) is loud-and-retryable — a retry must not find
        # the homes metadata destroyed by the failed attempt
        with mps._fleet_lock:
            mps._home.update(homes)
        mps._write_fleet_manifest()
        restored: List[str] = []
        for pod in mps.pods:
            before = set(pod.scheduler.records)
            pod.scheduler.restore(pod.scheduler.snapshot_dir,
                                  data_refs=data_refs)
            for jid in set(pod.scheduler.records) - before:
                restored.append(jid)
                # manifest homes win (submit-time pod); a job missing
                # there (submitted after the last manifest rewrite)
                # falls back to the pod it was restored from
                if jid not in homes:
                    mps._home[jid] = pod.name
        mps.restored_jobs = sorted(restored)
        mps._write_fleet_manifest()   # persist any fallback homes
        if transfer_dir is not None:
            mps.recover_transfers()
        return mps

    def recover_transfers(self, transfer_dir: Optional[str] = None
                          ) -> Dict[str, List[str]]:
        """Re-adopt jobs stranded mid-hand-off by a crash.

        A steal / drain / migration moves a job through the shared
        transfer directory in two acts: the victim exports (job on disk,
        forgotten locally) and the thief imports (job adopted, copy
        consumed).  A kill between the two leaves the job owned by *no*
        scheduler — only the transfer copy survives.  This pass scans
        ``transfer_dir/jobs/*`` and sorts each copy into one of:

        * **torn export** (no ``spec.json``): the victim crashed before
          the spec landed, so it never forgot the job — its own snapshot
          still owns it.  Left alone.
        * **half-consumed import** (spec status terminal): the thief
          adopted it and crashed between the ``stolen`` spec flip and
          the directory delete.  Finished consuming, reported in
          ``dropped``.
        * **already owned** (job id present in some pod's records): a
          restore resurrected the victim's copy, or the import completed
          before persisting the tombstone.  The transfer copy is the
          duplicate — consumed, reported in ``dropped``.
        * **orphan** (live spec, committed step, owned by nobody): the
          crash hit the export/import gap.  Imported onto the first live
          pod that accepts it (resumes bit-identically from the
          travelling checkpoint); a fleet where *no* pod can adopt it
          raises rather than silently stranding the job.

        Returns ``{"imported": [...], "dropped": [...]}`` and appends
        the imported ids to ``recovered_jobs``.  Called automatically by
        :meth:`restore_fleet` when it was given a ``transfer_dir``."""
        tdir = transfer_dir or self.transfer_dir
        jobs_root = os.path.join(tdir, "jobs")
        imported: List[str] = []
        dropped: List[str] = []
        if not os.path.isdir(jobs_root):
            return {"imported": imported, "dropped": dropped}
        known = set()
        for pod in self.pods_snapshot(live_only=False):
            known.update(pod.scheduler.records)
        for jid in sorted(os.listdir(jobs_root)):
            job_dir = os.path.join(jobs_root, jid)
            spec_path = os.path.join(job_dir, "spec.json")
            if not os.path.isfile(spec_path):
                continue                      # torn export: victim owns it
            with open(spec_path) as f:
                status = json.load(f)["status"]
            if status in _TERMINAL or jid in known:
                _consume_transfer_copy(job_dir)
                dropped.append(jid)
                continue
            errors = []
            for pod in self.pods_snapshot():
                try:
                    pod.scheduler.import_job(tdir, jid,
                                             data_refs=self.data_refs)
                except Exception as exc:
                    errors.append(f"{pod.name}: {exc}")
                    continue
                with self._fleet_lock:
                    self._home.setdefault(jid, pod.name)
                imported.append(jid)
                break
            else:
                raise RuntimeError(
                    f"recover_transfers: job {jid} is stranded in "
                    f"{tdir!r} (exported by a crashed pod, imported by "
                    f"none) and no live pod could adopt it: "
                    f"{'; '.join(errors) or 'no live pods'}")
        if imported:
            self.recovered_jobs = sorted(set(self.recovered_jobs)
                                         | set(imported))
            self._write_fleet_manifest()      # persist the new homes
        return {"imported": imported, "dropped": dropped}
