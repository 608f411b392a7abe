"""Multi-tenant job scheduler: placement, fair-share interleaving, preemption.

Port of ``repro/serve/scheduler.py``.  The scheduling logic, the durable
snapshot layout and the write seams are the reference's; a slot is a
``torch.device`` with a CUDA stream of its own (see :class:`DevicePool`),
and a job's executor runs every call on that stream.

This is the serving layer the paper's planners make possible: because
the execution plan (:func:`repro_torch.core.plan.plan` — the same memoized IR
the executors run) can *predict* a reconstruction's
per-device footprint before any array is allocated, the scheduler can pack
several small jobs onto one device, route oversized jobs through the
out-of-core streaming path (whose working set is bounded by the device
budget no matter how large the volume), and know ahead of time that a
placement fits.

Execution model
---------------
Jobs advance in *quanta* of outer iterations.  Under the cooperative
:meth:`Scheduler.run` loop one thread steps every running job in turn;
under the threaded :class:`~repro_torch.serve.driver.AsyncDriver` one worker
thread per device claims and steps that device's resident jobs
concurrently (the paper's "executed for all available GPUs
simultaneously").  Either way the share is *weighted*: a job receives step
quanta proportional to ``1 + priority``, so a long low-priority
reconstruction cannot starve short jobs that land next to it, and urgent
work drains faster even when nothing needs evicting.

Priorities also order admission.  A high-priority arrival that does not
fit preempts strictly-lower-priority running work — but only on the single
device where evicting the cheapest victim set actually makes the arrival
fit (freed bytes on *different* devices never combine, so pool-wide
eviction would kill jobs to no effect).  A victim's resumable state (see
``repro_torch.core.algorithms.stepwise``) is checkpointed to host memory, its
device reservation is released, and it re-enters the queue with its
original position, resuming later with bit-identical results.

Deadline admission: a job may carry ``deadline_seconds``; at admission the
scheduler models its completion time from the observed init/step costs
(EMAs over previous jobs) and rejects it outright if the model says the
deadline cannot be met.

A :class:`~repro_torch.checkpoint.preemption.PreemptionGuard` can be attached;
when the guard fires (SIGTERM on a cloud host), the scheduler drains at
the next step boundary: all running jobs are checkpointed and requeued,
and — when a snapshot directory is configured — every parked job is
persisted through :mod:`repro_torch.checkpoint.sharded` (manifest + COMMIT
marker, one directory per job), so a *restarted process* rebuilds the
queue with :meth:`Scheduler.restore` and resumes bit-identically.

The device pool holds one slot per entry of its device list — several
slots may share one card (each on a stream of its own) or the CPU, which
is how the tests drive a "multi-GPU" pool on a CPU host; placement logic
is identical either way.

All public methods are thread-safe: one re-entrant lock guards every
mutation of the pool / records / running set (the job queue carries its
own lock); executor steps themselves run *outside* the lock so device
compute genuinely overlaps across worker threads.  Executor *init*
(data-ref resolution + operator build/JIT) also runs outside the lock:
admission reserves the slot's bytes under the lock, initialises
unlocked, then commits (or rolls back) the reservation — a first-seen
geometry's compile never stalls claims on other slots.  Jobs mid-init
are tracked by an in-flight counter so ``idle`` and ``drain`` cannot
observe them as "gone".

Admission can be paused (:meth:`Scheduler.pause_admission`): running
jobs keep stepping but parked jobs stay parked, which is how a
scale-down drain (the fleet's autoscaler) keeps the jobs it preempts
from being re-placed on the pod it is about to retire.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import shutil
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..checkpoint.sharded import (latest_step, manifest_target,
                                  restore_checkpoint, save_checkpoint)
from ..core.algorithms.stepwise import get_algorithm
from ..core.device import DeviceLike, resolve_device
from ..obs import fleet_event
from ..core.geometry import ConeGeometry
from ..core.plan import plan as plan_execution
from ..core.splitting import MemoryModel
from .executor import JobExecutor
from .job import JobRecord, JobStatus, ReconJob
from .metrics import ServeMetrics
from .queue import PriorityJobQueue

F32 = 4


def fair_share_weight(priority: int) -> int:
    """Step quanta awarded per scheduling round: proportional to priority
    (floor 1 so zero/negative priorities still make progress)."""
    return max(1, 1 + priority)

# Peak live arrays per algorithm: (volume-sized, projection-set-sized).
# Used for the *resident* footprint of in-core jobs; streaming jobs are
# bounded by the planner's slab + buffer working set instead.
_ALG_WORKSPACE = {
    "cgls": (3, 3),        # x, p, s  /  b, r, q
    "fista": (3, 2),       # x, y, z  /  b, A(y)
    "fista_tv": (3, 2),
    "ossart": (3, 3),      # x, upd, V / proj, resid, W
    "sirt": (3, 3),
    "sart": (3, 3),
    "asd_pocs": (4, 3),    # ossart set + x_prev
    "fdk": (2, 2),         # vol, acc / proj, filtered
}
_DEFAULT_WORKSPACE = (4, 3)


@dataclasses.dataclass(frozen=True)
class JobFootprint:
    """Planner-derived placement requirements for one job."""
    bytes_on_device: int
    streams: bool           # must run through the out-of-core executor


def estimate_job_footprint(job: ReconJob,
                           memory: MemoryModel) -> JobFootprint:
    """Per-device bytes the job needs under ``memory``, and whether it must
    stream.  Mirrors the paper's "check GPU memory / split" decision
    (Alg 1-2): if the plan would split the volume, the job cannot be held
    resident and is routed out-of-core.  All structure comes off the
    shared memoized :func:`repro_torch.core.plan.plan` — the same IR the
    executors run — so the scheduler prices exactly what would execute."""
    geo, n_angles = job.geo, job.n_angles
    p = plan_execution(geo, n_angles, 1, memory)
    streams = p.streams
    if job.mode == "plain":
        streams = False
    elif job.mode == "stream":
        streams = True

    if streams:
        bytes_needed = p.stream_bytes_on_device
    else:
        nz, ny, nx = geo.n_voxel
        nv, nu = geo.n_detector
        n_vol, n_proj = _ALG_WORKSPACE.get(job.algorithm,
                                           _DEFAULT_WORKSPACE)
        bytes_needed = (n_vol * nz * ny * nx * F32
                        + n_proj * n_angles * nv * nu * F32)
    if job.memory_hint_bytes:
        bytes_needed = job.memory_hint_bytes
    return JobFootprint(bytes_needed, streams)


@dataclasses.dataclass
class DeviceSlot:
    """One slot's capacity ledger: its device, and on a CUDA device a
    stream of its own on which its jobs run."""
    index: int
    memory: MemoryModel
    device: torch.device = torch.device("cpu")
    stream: Optional[torch.cuda.Stream] = None
    committed_bytes: int = 0
    busy_seconds: float = 0.0           # virtual per-device clock
    jobs: Set[str] = dataclasses.field(default_factory=set)

    @property
    def free_bytes(self) -> int:
        return self.memory.usable - self.committed_bytes


class DevicePool:
    """Homogeneous pool of device slots.

    ``devices`` lists each slot's device (it sets the slot count); None
    puts ``n_devices`` slots on the current CUDA device, and raises
    without one.  Each slot on a CUDA device gets a stream of its own, so
    several slots on one card overlap.

    ``policy`` selects the placement heuristic among the slots that fit:

    * ``"spread"`` (default): least-loaded first (fewest resident jobs,
      then most free bytes) — maximises device parallelism, the serving
      throughput choice.
    * ``"pack"``: tightest fit first — minimises fragmentation, keeps
      large holes open for large jobs.
    """

    def __init__(self, n_devices: int = 1,
                 memory: Optional[MemoryModel] = None,
                 devices: Optional[Sequence[DeviceLike]] = None,
                 max_jobs_per_device: Optional[int] = None,
                 policy: str = "spread"):
        if policy not in ("spread", "pack"):
            raise ValueError(f"unknown placement policy {policy!r}")
        self.memory = memory or MemoryModel()
        if devices is None:
            devices = [resolve_device(None)] * n_devices
        devs = [resolve_device(d) for d in devices]
        self.slots = [
            DeviceSlot(i, self.memory, d,
                       torch.cuda.Stream(d) if d.type == "cuda" else None)
            for i, d in enumerate(devs)]
        self.max_jobs_per_device = max_jobs_per_device
        self.policy = policy

    def best_fit(self, bytes_needed: int) -> Optional[DeviceSlot]:
        """Pick a slot that fits ``bytes_needed`` under the pool policy."""
        candidates = [
            s for s in self.slots
            if s.free_bytes >= bytes_needed
            and (self.max_jobs_per_device is None
                 or len(s.jobs) < self.max_jobs_per_device)]
        if not candidates:
            return None
        if self.policy == "pack":
            return min(candidates, key=lambda s: (s.free_bytes, s.index))
        return min(candidates,
                   key=lambda s: (len(s.jobs), -s.free_bytes, s.index))

    def commit(self, slot: DeviceSlot, job_id: str, nbytes: int) -> None:
        slot.committed_bytes += nbytes
        slot.jobs.add(job_id)

    def release(self, slot: DeviceSlot, job_id: str, nbytes: int) -> None:
        slot.committed_bytes -= nbytes
        slot.jobs.discard(job_id)

    def busy_clocks(self) -> List[float]:
        return [s.busy_seconds for s in self.slots]

    @property
    def fits_nowhere_bytes(self) -> int:
        """A job above this can never be placed, even on an empty pool."""
        return self.memory.usable


def modeled_step_passes(job: ReconJob, memory: MemoryModel) -> float:
    """Relative cost of one outer iteration of ``job`` under ``memory``,
    in units of an in-core iteration (= 1.0): the memoized
    :attr:`~repro_torch.core.plan.ExecutionPlan.step_passes` of the job's plan
    — the slab counts are exactly what the paper's Alg 1-2 choose for
    that budget, so a pod with more memory per device models (and is)
    cheaper for oversized volumes.  This is the one cost model shared by
    multi-pod routing and the work-stealing benefit check; raises if the
    job is unplannable under ``memory``."""
    fp = estimate_job_footprint(job, memory)
    if not fp.streams:     # honours a forced job.mode="plain"
        return 1.0
    return plan_execution(job.geo, job.n_angles, 1, memory).step_passes


@dataclasses.dataclass
class _Running:
    record: JobRecord
    executor: JobExecutor
    slot: DeviceSlot
    # -- async-driver bookkeeping (all mutated under the scheduler lock) --
    claimed: bool = False             # a worker thread is mid-step
    preempt_requested: bool = False   # park at the next step boundary
    vtime: float = 0.0                # stride-scheduling virtual time
    passes: float = 1.0               # slab-pass multiplier of one step
    # -- copy-on-checkpoint live snapshots (see Scheduler.snapshot): a
    # periodic snapshot that finds this job mid-step asks the worker to
    # capture the committed state at its next boundary instead of
    # waiting the step out under the lock
    snapshot_requested: bool = False
    boundary_checkpoint: Optional[Dict[str, Any]] = None
    boundary_iterations: int = -1     # iterations_done of that capture


class Scheduler:
    """Accepts :class:`ReconJob` submissions and drives them to completion.

    Usage::

        sched = Scheduler(n_devices=4, memory=MemoryModel(...))
        sched.submit(job_a); sched.submit(job_b)
        sched.run()
        rec = sched.records[job_a.job_id].result
    """

    def __init__(self, pool: Optional[DevicePool] = None,
                 n_devices: int = 1,
                 memory: Optional[MemoryModel] = None,
                 metrics: Optional[ServeMetrics] = None,
                 guard=None,
                 snapshot_dir: Optional[str] = None,
                 name: str = ""):
        self.pool = pool or DevicePool(n_devices, memory)
        # trace identity: the pod name in fleet event logs / span tracks
        # ("" for a standalone scheduler; Pod sets its spec name)
        self.name = name
        self.queue = PriorityJobQueue()
        self.records: Dict[str, JobRecord] = {}
        self.running: Dict[str, _Running] = {}
        self.metrics = metrics or ServeMetrics()
        self.guard = guard
        self.snapshot_dir = snapshot_dir
        self._seq = itertools.count()
        self._lock = threading.RLock()
        # in-flight admissions (slot reserved, executor init running
        # outside the lock); jobs in this window are in neither the queue
        # nor `running`, so idle/drain consult the counter and the load
        # model (`modeled_backlog_seconds`) still prices the records —
        # an invisible mid-admission job would make the pod look idle to
        # fleet routing/stealing and cause ping-pong moves
        self._admitting = 0
        self._admitting_recs: Dict[str, JobRecord] = {}
        self._admission_paused = False
        # admission-model cost estimates (EMAs over observed jobs)
        self._step_ema: Optional[float] = None
        self._init_ema: Optional[float] = None
        self._ema_alpha = 0.3
        # measured host<->device bandwidth (bytes/s): the CommSchedule's
        # modeled bytes per step divided by the staging phase seconds the
        # tracer attributed to it.  None until a traced streamed step has
        # been observed (phase spans only exist when tracing is on), in
        # which case transfer pricing is inactive and the unit EMA keeps
        # its historical all-inclusive meaning
        self._bandwidth_ema: Optional[float] = None
        # per-job progress fingerprint at last snapshot (dedups the
        # periodic snapshot's disk writes for unchanged parked jobs)
        self._snapshotted: Dict[str, tuple] = {}
        # job_id -> slab-pass multiplier / footprint under this pool's
        # fixed budget (memos for the oft-polled load signals).  Bounded:
        # fleet routing prices every submission on every pod, so without
        # a cap these would grow by one entry per job ever *considered*
        # here, not just per job run here; eviction is cheap because the
        # heavy planning underneath is memoized per geometry in
        # repro_torch.core.plan anyway
        self._passes_cache: Dict[str, float] = {}
        self._footprint_cache: Dict[str, JobFootprint] = {}

    # ---- client API --------------------------------------------------------

    def _cal_attrs(self, job: ReconJob) -> Dict[str, str]:
        """Cost-model identity attrs stamped on admit/step/reject/complete
        events so a calibration ledger can
        group modeled-vs-measured errors per
        (geometry, algorithm, backend, pod)."""
        nz, ny, nx = job.geo.n_voxel
        return {"geo": f"{nz}x{ny}x{nx}", "alg": job.algorithm,
                "backend": job.backend or "auto"}

    def submit(self, job: ReconJob) -> str:
        get_algorithm(job.algorithm)   # fail fast on unknown algorithms
        with self._lock:
            rec = JobRecord(job=job, seq=next(self._seq),
                            submit_time=time.monotonic())
            self.records[job.job_id] = rec
            self.queue.push(rec)
            self.metrics.submitted += 1
            fleet_event("submit", job=job.job_id, pod=self.name,
                        priority=job.priority)
        return job.job_id

    def cancel(self, job_id: str) -> bool:
        """Cancel a queued (not yet running) job."""
        with self._lock:
            ok = self.queue.cancel(job_id)
            if ok:
                self.metrics.cancelled += 1
                rec = self.records.get(job_id)
                if rec is not None:
                    # a snapshot may have persisted this job while parked;
                    # stale it out so restore() cannot resurrect it
                    self._mark_terminal_on_disk(rec)
            return ok

    def result(self, job_id: str):
        rec = self.records[job_id]
        if rec.status is not JobStatus.COMPLETED:
            raise RuntimeError(f"{job_id} is {rec.status.value}"
                               + (f": {rec.error}" if rec.error else ""))
        return rec.result

    @property
    def idle(self) -> bool:
        # a job mid-admission (slot reserved, init running outside the
        # lock) is in neither the queue nor `running`; the in-flight
        # counter keeps a concurrent waiter from observing "all done"
        # while an executor is still compiling
        with self._lock:
            return (not self.queue and not self.running
                    and self._admitting == 0)

    def pause_admission(self) -> None:
        """Stop placing queued jobs (running jobs keep stepping).  The
        scale-down drain pauses a pod so the jobs it parks stay parked
        until they are exported to a surviving pod instead of being
        re-placed on the pod about to retire."""
        with self._lock:
            self._admission_paused = True

    def resume_admission(self) -> None:
        with self._lock:
            self._admission_paused = False

    @property
    def admission_paused(self) -> bool:
        return self._admission_paused

    # ---- placement ---------------------------------------------------------

    def _fail(self, rec: JobRecord, msg: str) -> None:
        rec.status = JobStatus.FAILED
        rec.error = msg
        rec.end_time = time.monotonic()
        self.metrics.failed += 1
        fleet_event("fail", job=rec.job.job_id, pod=self.name, error=msg)
        self._mark_terminal_on_disk(rec)

    def _mark_terminal_on_disk(self, rec: JobRecord) -> None:
        """Flip a previously-snapshotted job's spec to its terminal status
        so a later :meth:`restore` does not resurrect stale parked state
        for work that already finished, and delete the job's step
        directories — the bulk of the payload (full projections arrays)
        has no reader once the spec is terminal, and a long-lived server
        would otherwise leak one checkpoint per job ever parked.  The
        terminal spec stays behind as a tombstone."""
        if self.snapshot_dir is None:
            return
        _stale_job_dir(os.path.join(self.snapshot_dir, "jobs",
                                    rec.job.job_id),
                       rec.status.value)

    def _reserve_next(self) -> Optional[Tuple[JobRecord, DeviceSlot,
                                              JobFootprint]]:
        """Under the lock: pop queued jobs in priority order until one
        gets a slot *reservation* (its bytes committed, executor not yet
        built) or the head job cannot be placed (strict priority order —
        no backfilling past the head; returns None).  Jobs consumed
        without a reservation (deadline rejection, unplannable,
        oversized) are failed in place."""
        if self._admission_paused:
            return None
        while True:
            if self.queue.peek_priority() is None:
                return None
            rec = self.queue.pop()
            if rec is None:
                return None
            if self._reject_for_deadline(rec):
                continue
            try:
                fp = estimate_job_footprint(rec.job, self.pool.memory)
            except Exception as e:   # bad geometry/budget: tenant's fault
                self._fail(rec, f"unplannable under device budget: {e!r}")
                continue
            if fp.bytes_on_device > self.pool.fits_nowhere_bytes:
                self._fail(rec, f"footprint {fp.bytes_on_device} B exceeds "
                                f"the device budget "
                                f"{self.pool.fits_nowhere_bytes} B "
                                f"even on an empty device")
                continue
            slot = self.pool.best_fit(fp.bytes_on_device)
            if slot is None and self._evict_for(rec, fp.bytes_on_device):
                slot = self.pool.best_fit(fp.bytes_on_device)
            if slot is None:
                # head job cannot be placed now: put it back and stop
                # admitting (deferred evictions land at step boundaries
                # and a later admission pass retries)
                self.queue.push(rec)
                return None
            # reserve the bytes *before* init: concurrent admissions and
            # eviction planning see the slot as taken while the executor
            # compiles outside the lock
            self.pool.commit(slot, rec.job.job_id, fp.bytes_on_device)
            self.metrics.memory_modeled_peak_bytes = max(
                self.metrics.memory_modeled_peak_bytes,
                fp.bytes_on_device)
            self._admitting += 1
            self._admitting_recs[rec.job.job_id] = rec
            fleet_event("place", job=rec.job.job_id, pod=self.name,
                        device=slot.index, bytes=fp.bytes_on_device,
                        streams=fp.streams)
            return rec, slot, fp

    def _commit_admission(self, rec: JobRecord, slot: DeviceSlot,
                          fp: JobFootprint,
                          executor: Optional[JobExecutor],
                          err: Optional[Exception]) -> None:
        """Under the lock: turn a reservation into a running job, or roll
        the reservation back if init failed."""
        self._admitting -= 1
        self._admitting_recs.pop(rec.job.job_id, None)
        if err is not None:
            self.pool.release(slot, rec.job.job_id, fp.bytes_on_device)
            self._fail(rec, f"init failed: {err!r}")
            return
        fleet_event("admit", job=rec.job.job_id, pod=self.name,
                    device=slot.index, measured_s=executor.init_seconds,
                    modeled_s=self._init_ema, **self._cal_attrs(rec.job))
        self.metrics.record_calibration("admit", self._init_ema,
                                        executor.init_seconds)
        self.metrics.record_phases(executor.take_phase_seconds())
        self._init_ema = (executor.init_seconds if self._init_ema is None
                          else self._ema_alpha * executor.init_seconds
                          + (1 - self._ema_alpha) * self._init_ema)
        rec.checkpoint = None
        rec.status = JobStatus.RUNNING
        rec.device = slot.index
        rec.footprint_bytes = fp.bytes_on_device
        rec.streamed = fp.streams
        if fp.streams:
            self.metrics.streamed_jobs += 1
        if rec.start_time is None:
            rec.start_time = time.monotonic()
        slot.busy_seconds += executor.init_seconds
        # join stride scheduling at the slot's current virtual time: a
        # newcomer starting at vtime 0 would monopolize the device until
        # it "caught up" with long-resident jobs
        peers = [r.vtime for r in self.running.values() if r.slot is slot]
        self.running[rec.job.job_id] = _Running(
            rec, executor, slot, vtime=min(peers, default=0.0),
            passes=self.job_passes(rec.job))

    def admit(self) -> None:
        """Thread-safe admission pass (the driver's scheduler loop calls
        this; the cooperative loop calls it at each quantum).

        Executor init (data-ref resolution + operator build/JIT) runs
        *outside* the scheduler lock: the critical section only reserves
        the slot's bytes, so a first-seen geometry's compile never stalls
        step claims on other slots; the reservation is committed or
        rolled back under the lock once init returns."""
        while True:
            with self._lock:
                reserved = self._reserve_next()
            if reserved is None:
                return
            rec, slot, fp = reserved
            executor: Optional[JobExecutor] = None
            err: Optional[Exception] = None
            try:
                # one tenant's bad geometry / data ref / algorithm params
                # must fail that job alone, never the scheduler serving
                # the others
                executor = JobExecutor(
                    rec.job, mode="stream" if fp.streams else "plain",
                    memory=self.pool.memory, devices=[slot.device],
                    stream=slot.stream,
                    labels={"pod": self.name or None,
                            "device": slot.index})
                executor.start(checkpoint=rec.checkpoint)
            except Exception as e:
                if executor is not None:
                    # start() may have built device state before raising --
                    # drop it so the buffers are reclaimed
                    executor.release()
                executor, err = None, e
            with self._lock:
                self._commit_admission(rec, slot, fp, executor, err)

    # ---- deadline admission ------------------------------------------------

    def modeled_transfer_seconds(self, job: ReconJob) -> float:
        """Schedule-priced host<->device staging seconds one outer
        iteration of ``job`` costs at the measured-bandwidth EMA: the
        plan's :meth:`~repro_torch.core.plan.CommSchedule.transfer_seconds`
        evaluated at the bandwidth observed from staging phase spans.
        0.0 for in-core jobs (operands stay resident) and until a
        bandwidth has been measured (untraced runs never measure one, so
        pricing degrades to the historical all-inclusive unit EMA)."""
        bw = self._bandwidth_ema
        if bw is None or bw <= 0.0:
            return 0.0
        try:
            if not self.job_footprint(job).streams:
                return 0.0
            p = plan_execution(job.geo, job.n_angles, 1, self.pool.memory)
        except Exception:
            return 0.0
        return p.comm.transfer_seconds(bw)

    def modeled_completion_seconds(self, rec: JobRecord) -> Optional[float]:
        """Modeled submit-to-completion time if ``rec`` were admitted now:
        elapsed queue wait + modeled (re)init + remaining iterations at
        the observed per-pass unit cost scaled by *this job's* slab-pass
        multiplier (:func:`modeled_step_passes` — the shared cost model),
        so a small in-core job is not priced at the cost of the streamed
        giants the EMA was observed on, plus the per-iteration transfer
        term for streamed jobs (:meth:`modeled_transfer_seconds`).
        ``None`` until a step has been observed."""
        if self._step_ema is None:
            return None
        elapsed = time.monotonic() - rec.submit_time
        return (elapsed + (self._init_ema or 0.0)
                + self._remaining_iters(rec)
                * (self._step_ema * self.job_passes(rec.job)
                   + self.modeled_transfer_seconds(rec.job)))

    def _reject_for_deadline(self, rec: JobRecord) -> bool:
        """True if the record was consumed by deadline admission control."""
        if rec.job.deadline_seconds <= 0:
            return False
        est = self.modeled_completion_seconds(rec)
        if est is not None and est > rec.job.deadline_seconds:
            self.metrics.deadline_rejected += 1
            # the refusal's full evidence goes on the event: the modeled
            # completion seconds that condemned the job, the deadline it
            # missed, and the cost-model identity — a deadline refusal
            # is auditable from the event log alone
            fleet_event("reject", job=rec.job.job_id, pod=self.name,
                        modeled_s=est,
                        deadline_s=rec.job.deadline_seconds,
                        priority=rec.job.priority,
                        queue_wait_s=time.monotonic() - rec.submit_time,
                        **self._cal_attrs(rec.job))
            self._fail(rec, f"deadline {rec.job.deadline_seconds:.3f}s "
                            f"unmeetable: modeled completion {est:.3f}s")
            return True
        return False

    # ---- preemption --------------------------------------------------------

    def _slot_eviction_plan(self, slot: DeviceSlot, rec: JobRecord,
                            needed: int) -> Optional[List[_Running]]:
        """Cheapest set of strictly-lower-priority victims on ``slot``
        whose eviction makes ``rec`` fit there, or None if no set does.
        Victims already flagged for preemption count as free-in-flight
        (their bytes will return at the next step boundary) and are never
        evicted twice."""
        free = slot.free_bytes
        n_jobs = len(slot.jobs)
        candidates = []
        for run in self.running.values():
            if run.slot is not slot:
                continue
            if run.preempt_requested:
                free += run.record.footprint_bytes
                n_jobs -= 1
            elif run.record.job.priority < rec.job.priority:
                candidates.append(run)
        # cheapest first: lowest priority, then latest arrival
        candidates.sort(key=lambda r: (r.record.job.priority,
                                       -r.record.seq))
        cap = self.pool.max_jobs_per_device

        def fits():
            return free >= needed and (cap is None or n_jobs < cap)

        victims: List[_Running] = []
        while not fits() and candidates:
            run = candidates.pop(0)
            victims.append(run)
            free += run.record.footprint_bytes
            n_jobs -= 1
        return victims if fits() else None

    def _evict_for(self, rec: JobRecord, needed: int) -> bool:
        """Per-device preemption: pick the slot where evicting the
        cheapest set of strictly-lower-priority victims makes ``rec``
        fit, and evict only those.  Jobs on devices that could never make
        room keep running.  Returns True when the evictions freed the
        bytes synchronously (the caller's ``best_fit`` retry will
        succeed); False when nothing can move now — either no slot has a
        viable victim set, or the only viable victims are mid-step (they
        are flagged, park at their step boundary, and a later admission
        pass retries the arrival)."""
        best: Optional[Tuple[tuple, DeviceSlot, List[_Running]]] = None
        for slot in self.pool.slots:
            victims = self._slot_eviction_plan(slot, rec, needed)
            if victims is None:
                continue
            if not victims:
                # fits once in-flight preemptions land: just wait
                return False
            score = (len(victims),
                     max(v.record.job.priority for v in victims),
                     slot.index)
            if best is None or score < best[0]:
                best = (score, slot, victims)
        if best is None:
            return False
        _, _, victims = best
        deferred = False
        for run in victims:
            if run.claimed:
                run.preempt_requested = True   # park at the step boundary
                deferred = True
            else:
                self._preempt(run)
        return not deferred

    def _preempt(self, run: _Running) -> None:
        rec = run.record
        rec.checkpoint = run.executor.checkpoint()
        rec.status = JobStatus.PREEMPTED
        rec.preemptions += 1
        self.metrics.preemptions += 1
        fleet_event("park", job=rec.job.job_id, pod=self.name,
                    device=run.slot.index, it=rec.iterations_done)
        run.executor.release()
        self.pool.release(run.slot, rec.job.job_id, rec.footprint_bytes)
        del self.running[rec.job.job_id]
        self.queue.push(rec)   # original seq: regains its queue position

    # ---- execution ---------------------------------------------------------

    def _complete(self, run: _Running) -> None:
        rec = run.record
        rec.result = run.executor.result()
        rec.status = JobStatus.COMPLETED
        rec.end_time = time.monotonic()
        self._mark_terminal_on_disk(rec)
        self.metrics.record_completion(rec.latency, rec.queue_wait)
        fleet_event("complete", job=rec.job.job_id, pod=self.name,
                    device=run.slot.index, measured_s=rec.latency,
                    it=rec.iterations_done,
                    queue_wait_s=rec.queue_wait,
                    priority=rec.job.priority,
                    deadline_s=rec.job.deadline_seconds,
                    **self._cal_attrs(rec.job))
        run.executor.release()
        self.pool.release(run.slot, rec.job.job_id, rec.footprint_bytes)
        del self.running[rec.job.job_id]

    def _observe_step(self, run: _Running, dt: float) -> None:
        run.slot.busy_seconds += dt
        self.metrics.record_step(dt)
        phases = run.executor.take_phase_seconds()
        self.metrics.record_phases(phases)
        modeled = (None if self._step_ema is None
                   else self._step_ema * max(run.passes, 1e-9)
                   + self.modeled_transfer_seconds(run.record.job))
        fleet_event("step", job=run.record.job.job_id, pod=self.name,
                    device=run.slot.index, measured_s=dt,
                    modeled_s=modeled,
                    **self._cal_attrs(run.record.job))
        self.metrics.record_calibration("step", modeled, dt)
        # measured-bandwidth feedback: the staging span seconds the obs
        # layer attributed to this step (critical-path h2d, lookahead
        # prefetch, d2h) against the CommSchedule's modeled bytes give an
        # effective bandwidth.  Once it exists, the staging time is
        # carved out of the unit EMA — the transfer term prices it
        # separately, and double-counting would overstate backlogs
        staging = sum(phases.get(k, 0.0) for k in ("h2d", "prefetch", "d2h"))
        nbytes = run.executor.step_transfer_bytes
        if staging > 0.0 and nbytes > 0:
            bw = nbytes / staging
            self._bandwidth_ema = (bw if self._bandwidth_ema is None
                                   else self._ema_alpha * bw
                                   + (1 - self._ema_alpha)
                                   * self._bandwidth_ema)
            self.metrics.bandwidth_ema_bytes_per_s = self._bandwidth_ema
            dt = max(dt - staging, 0.0)
        # the EMA tracks the *per-pass* unit cost: a streamed step's wall
        # time is divided by its slab-pass multiplier, so steps observed
        # on oversized jobs don't inflate the modeled cost of small ones
        # (deadline admission would otherwise reject in-core jobs whose
        # real steps are orders of magnitude cheaper than the mixed EMA)
        unit = dt / max(run.passes, 1e-9)
        self._step_ema = (unit if self._step_ema is None
                          else self._ema_alpha * unit
                          + (1 - self._ema_alpha) * self._step_ema)

    def _fail_running(self, run: _Running, err: Exception) -> None:
        rec = run.record
        self._fail(rec, f"step failed: {err!r}")
        run.executor.release()
        self.pool.release(run.slot, rec.job.job_id, rec.footprint_bytes)
        del self.running[rec.job.job_id]

    def step_quantum(self) -> int:
        """One cooperative scheduling quantum: admit (executor init runs
        outside the lock, see :meth:`admit`), then advance every running
        job by its fair share of outer iterations — step quanta
        proportional to ``1 + priority``.  Returns the number of iteration
        steps executed."""
        self.admit()
        with self._lock:
            executed = 0
            # deterministic order: device index, then submission order
            for run in sorted(self.running.values(),
                              key=lambda r: (r.slot.index, r.record.seq)):
                if run.record.job.job_id not in self.running:
                    continue   # evicted mid-quantum (defensive)
                rec = run.record
                for _ in range(fair_share_weight(rec.job.priority)):
                    if run.executor.done:
                        break
                    t0 = time.monotonic()
                    try:
                        rec.iterations_done = run.executor.step()
                    except Exception as e:
                        self._fail_running(run, e)
                        break
                    self._observe_step(run, time.monotonic() - t0)
                    executed += 1
                if rec.job.job_id in self.running and run.executor.done:
                    try:
                        self._complete(run)
                    except Exception as e:   # tenant finalize() failure
                        self._fail_running(run, e)
            return executed

    # ---- async-driver execution API ---------------------------------------

    def claim_step(self, slot: DeviceSlot) -> Optional[_Running]:
        """Claim the next job to step on ``slot`` for a worker thread.

        Weighted fair share via stride scheduling: each claim advances the
        job's virtual time by ``1 / weight(priority)``, and the runnable
        job with the smallest virtual time wins — so over any window a
        job's share of the device is proportional to its weight.  Returns
        None when nothing on the slot is runnable.  The caller MUST pair
        every claim with :meth:`finish_step`.
        """
        with self._lock:
            runnable = [r for r in self.running.values()
                        if r.slot is slot and not r.claimed
                        and not r.preempt_requested
                        and not r.executor.done]
            if not runnable:
                return None
            run = min(runnable, key=lambda r: (r.vtime, r.record.seq))
            run.claimed = True
            run.vtime += 1.0 / fair_share_weight(run.record.job.priority)
            return run

    def finish_step(self, run: _Running, dt: float,
                    err: Optional[Exception] = None) -> None:
        """Account for a completed worker step (taken *outside* the lock)
        and resolve any state transition that queued up during it:
        failure, deferred preemption, or completion."""
        with self._lock:
            run.claimed = False
            rec = run.record
            if rec.job.job_id not in self.running:     # defensive
                return
            if err is not None:
                self._fail_running(run, err)
                return
            rec.iterations_done = run.executor.iterations_done
            self._observe_step(run, dt)
            try:
                if run.executor.done:
                    # done wins over a pending preempt flag: parking a
                    # finished job would persist it as resumable work and
                    # pay a full re-init just to mark it done later
                    run.preempt_requested = False
                    self._complete(run)
                elif run.preempt_requested:
                    run.preempt_requested = False
                    self._preempt(run)
                elif run.snapshot_requested:
                    # copy-on-checkpoint: a periodic snapshot found this
                    # job mid-step and deferred to this boundary.  The
                    # state objects are replaced (never mutated) by
                    # step(), so the host copy taken here is exactly the
                    # committed iteration the job would resume from.
                    run.snapshot_requested = False
                    run.boundary_checkpoint = run.executor.checkpoint()
                    run.boundary_iterations = rec.iterations_done
            except Exception as e:
                # a tenant's finalize()/checkpoint() must fail that job
                # alone, never kill the worker thread servicing the slot
                if rec.job.job_id in self.running:
                    self._fail_running(run, e)

    # ---- cooperative loop / drain -----------------------------------------

    def run(self, max_quanta: Optional[int] = None) -> ServeMetrics:
        """Drive the system to completion on the calling thread (or until
        the guard fires / ``max_quanta``).  Safe to call again to resume.
        For true per-device overlap use
        :class:`repro_torch.serve.driver.AsyncDriver` instead."""
        if self.metrics.wall_start is None:
            self.metrics.wall_start = time.monotonic()
        quanta = 0
        while not self.idle:
            if self.guard is not None and self.guard.preempted:
                self.drain(self.snapshot_dir)
                break
            if max_quanta is not None and quanta >= max_quanta:
                break
            self.step_quantum()
            quanta += 1
        self.metrics.wall_end = time.monotonic()
        return self.metrics

    def park_job(self, job_id: str, timeout: float = 30.0) -> bool:
        """Preempt one *running* job at its next step boundary and leave
        it parked in the queue (checkpoint captured, status PREEMPTED) —
        the single-job analogue of :meth:`drain`, and the building block
        of the fleet's live migration.
        Every other job on the pod keeps running.

        Under the async driver a mid-step job is flagged and parks when
        its in-flight step completes; this call waits up to ``timeout``
        for that.  Returns True once the job is parked, False when it is
        not running here (already parked, terminal, or unknown — the
        caller re-checks what it actually wants) or the timeout expired
        with the step still in flight.  Callers that must keep the job
        parked (export it) pause admission first, or the admission loop
        may re-place it immediately."""
        deadline = time.monotonic() + timeout
        while True:
            with self._lock:
                run = self.running.get(job_id)
                if run is None:
                    rec = self.records.get(job_id)
                    return (rec is not None
                            and rec.status is JobStatus.PREEMPTED)
                if not run.claimed:
                    self._preempt(run)
                    return True
                run.preempt_requested = True
            if time.monotonic() > deadline:
                return False
            time.sleep(0.001)

    def drain(self, ckpt_dir: Optional[str] = None,
              timeout: float = 60.0) -> int:
        """Checkpoint + requeue every running job (host preemption path).

        Jobs mid-step under the async driver are flagged and park at
        their step boundary; this call waits (up to ``timeout``) for the
        running set to empty.  If ``ckpt_dir`` is given, every parked job
        is then persisted there (see :meth:`snapshot`), making the drain
        durable across process death.  Returns how many jobs were parked.
        """
        deadline = time.monotonic() + timeout
        before: Optional[Set[str]] = None
        while True:
            with self._lock:
                if before is None:
                    before = set(self.running)
                for run in list(self.running.values()):
                    if run.claimed:
                        run.preempt_requested = True
                    else:
                        self._preempt(run)
                # also wait out in-flight admissions: a job mid-init is in
                # neither the queue nor `running`, and draining past it
                # would lose it from the snapshot
                if not self.running and self._admitting == 0:
                    break
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"drain: {len(self.running)} jobs still mid-step (and "
                    f"{self._admitting} mid-admission) after {timeout}s")
            time.sleep(0.001)
        with self._lock:
            parked = sum(
                1 for jid in before
                if self.records[jid].status is JobStatus.PREEMPTED)
            fleet_event("drain", pod=self.name, parked=parked)
            if ckpt_dir is not None:
                self.snapshot(ckpt_dir)
        return parked

    # ---- durable snapshots / restore --------------------------------------

    def snapshot(self, ckpt_dir: str, include_running: bool = True) -> int:
        """Persist every *parked* job (queued, with or without a step-wise
        checkpoint) — and, by default, every *running* job's last
        committed step — under ``ckpt_dir``: one directory per job, each
        write going through :func:`repro_torch.checkpoint.sharded.
        save_checkpoint` (manifest + COMMIT marker, atomic rename), so a
        crash mid-snapshot can never corrupt an earlier snapshot of the
        same job.

        Running jobs are snapshotted **without parking them**
        (copy-on-checkpoint): a job at its step boundary (not claimed by
        a worker) has its state copied to host on the spot; a job
        mid-step is flagged and the worker captures the copy at its next
        boundary (``finish_step``), which the next periodic snapshot
        persists.  Algorithm states are replaced — never mutated — by
        ``step()``, so the copy is exactly the committed iteration the
        job would resume from; a kill -9 then replays nothing the last
        snapshot already saw.  The spec keeps its live ``running``
        status (non-terminal), which :func:`_load_job` restores as
        resumable preempted work.

        Only the payload *capture* holds the scheduler lock; the disk
        writes happen outside it, so worker threads keep stepping while a
        periodic snapshot streams arrays to disk.  A job whose persisted
        progress hasn't changed since the last snapshot from this
        scheduler is skipped (a parked job would otherwise rewrite its
        full projections array every period).  Returns the number of jobs
        persisted."""
        with self._lock:
            payloads = []
            for rec in self.queue.pending_records():
                fingerprint = (rec.iterations_done, rec.status.value,
                               rec.preemptions)
                if self._snapshotted.get(rec.job.job_id) == fingerprint:
                    continue
                payloads.append(_job_payload(rec) + (fingerprint, False))
            if include_running:
                for run in self.running.values():
                    rec = run.record
                    if not run.claimed and run.executor.started:
                        ckpt = run.executor.checkpoint()
                        iters = run.executor.iterations_done
                    elif run.boundary_checkpoint is not None:
                        ckpt = run.boundary_checkpoint
                        iters = run.boundary_iterations
                        # one-shot: drop the capture and re-request, so
                        # the next period persists fresh progress
                        # instead of re-offering this copy forever
                        run.boundary_checkpoint = None
                        run.boundary_iterations = -1
                        run.snapshot_requested = True
                    else:
                        # mid-step: ask the worker to capture at its
                        # boundary; the next periodic pass persists it
                        run.snapshot_requested = True
                        continue
                    fingerprint = (iters, rec.status.value,
                                   rec.preemptions)
                    if self._snapshotted.get(rec.job.job_id) \
                            == fingerprint:
                        continue
                    payloads.append(
                        _job_payload(rec, checkpoint=ckpt,
                                     iterations=iters)
                        + (fingerprint, True))
        for job_id, spec, tree, step, fingerprint, was_running in payloads:
            _write_job(ckpt_dir, job_id, spec, tree, step)
            with self._lock:
                self._snapshotted[job_id] = fingerprint
                # the write ran outside the lock: the job may have gone
                # terminal meanwhile (cancel / completion / export to
                # another pod, whose own stale-out no-opped because this
                # spec did not exist yet).  Re-stale it now, or a restart
                # would resurrect — and double-execute — finished work.
                rec = self.records.get(job_id)
                stale_status = None
                if rec is None:
                    stale_status = JobStatus.STOLEN.value   # exported
                elif rec.done:
                    stale_status = rec.status.value
            if stale_status is not None:
                _stale_job_dir(os.path.join(ckpt_dir, "jobs", job_id),
                               stale_status)
            elif was_running:
                fleet_event("live-snapshot", job=job_id, pod=self.name,
                            it=step)
        if payloads:
            fleet_event("snapshot", pod=self.name, jobs=len(payloads))
        return len(payloads)

    def restore(self, ckpt_dir: str,
                data_refs: Optional[Dict[str, Callable]] = None) -> int:
        """Rebuild queue + records from a snapshot directory after process
        death.  Each restored job re-enters the queue with its original
        sequence number and its persisted step-wise checkpoint, so it
        resumes bit-identically to an uninterrupted run.

        ``data_refs`` supplies projection callables for jobs whose data
        was a lazy ref at snapshot time (refs cannot be persisted).

        Failure is loud: a lazy job without a ``data_refs`` entry, a
        truncated job directory (spec.json but no committed step), or a
        job id this scheduler already knows all raise.  Jobs whose spec
        records a terminal status (completed / failed / cancelled /
        stolen) are skipped — they are finished or owned elsewhere, not
        resumable work.

        Two-phase: every job directory is loaded and validated before the
        scheduler is touched, so a validation failure (which raises)
        leaves it unchanged and the call can simply be retried.  Returns
        the number of jobs restored."""
        jobs_root = os.path.join(ckpt_dir, "jobs")
        if not os.path.isdir(jobs_root):
            return 0
        loaded = []
        for job_id in sorted(os.listdir(jobs_root)):
            rec = _load_job(os.path.join(jobs_root, job_id), data_refs or {})
            if rec is not None:
                loaded.append(rec)
        with self._lock:
            dupes = [r.job.job_id for r in loaded
                     if r.job.job_id in self.records]
            if dupes:
                raise ValueError(
                    f"restore: jobs already known to this scheduler: "
                    f"{dupes}")
            for rec in loaded:
                self.records[rec.job.job_id] = rec
                self.queue.push(rec)
                self.metrics.submitted += 1
            if loaded:
                current = next(self._seq)
                self._seq = itertools.count(
                    max(current, max(r.seq for r in loaded) + 1))
        return len(loaded)

    def summary(self) -> Dict:
        return self.metrics.summary(device_busy=self.pool.busy_clocks())

    # ---- multi-pod: load signals + job hand-off (work stealing) ------------

    @property
    def step_seconds_ema(self) -> Optional[float]:
        """Observed *per-pass* unit step cost (EMA; a streamed step's
        wall time is normalised by its slab-pass multiplier before it
        enters the average).  None before any step."""
        return self._step_ema

    @property
    def init_seconds_ema(self) -> Optional[float]:
        """Observed executor init cost (EMA), None before any admission."""
        return self._init_ema

    @property
    def bandwidth_ema(self) -> Optional[float]:
        """Measured host<->device bandwidth (bytes/s) from staging phase
        spans vs the CommSchedule's modeled bytes; None until a traced
        streamed step has been observed."""
        return self._bandwidth_ema

    def modeled_backlog_seconds(self, unit: Optional[float] = None,
                                init: Optional[float] = None) -> float:
        """Modeled seconds of work this scheduler still owes: remaining
        iterations of every queued + running job at the per-pass unit
        cost scaled by each job's slab-pass multiplier, plus a modeled
        (re)init per queued job.  This is the load signal multi-pod
        routing and work stealing balance against.

        ``unit`` / ``init`` override the local EMAs — fleet callers pass
        a *shared* unit so a cold pod (no observations, local fallback
        1.0) and a warm pod (real seconds) compare on the same scale;
        mixing the two would invert victim/thief decisions."""
        with self._lock:
            if unit is None:
                unit = self._step_ema if self._step_ema is not None else 1.0
            if init is None:
                init = self._init_ema or 0.0
            total = 0.0
            for rec in self.queue.pending_records():
                total += init + self._remaining_iters(rec) * (
                    unit * self.job_passes(rec.job)
                    + self.modeled_transfer_seconds(rec.job))
            # mid-admission records (init running outside the lock) are
            # in neither set but still owed work: leaving them out would
            # make the pod look idle to fleet routing/stealing for the
            # whole compile and invite ping-pong moves
            for rec in self._admitting_recs.values():
                total += init + self._remaining_iters(rec) * (
                    unit * self.job_passes(rec.job)
                    + self.modeled_transfer_seconds(rec.job))
            for run in self.running.values():
                total += self._remaining_iters(run.record) * (
                    unit * run.passes
                    + self.modeled_transfer_seconds(run.record.job))
            return total

    #: per-scheduler pricing-memo bound (entries are tiny; the cap only
    #: guards a long-lived server that prices millions of submissions)
    _PRICING_CACHE_MAX = 4096

    @staticmethod
    def _cache_put(cache: Dict, key: str, value) -> None:
        """Insert with FIFO eviction at the bound (python dicts preserve
        insertion order, so the oldest — coldest — entry goes first)."""
        if len(cache) >= Scheduler._PRICING_CACHE_MAX:
            cache.pop(next(iter(cache)))
        cache[key] = value

    def job_passes(self, job: ReconJob) -> float:
        """This job's slab-pass multiplier under the pool's budget (1.0
        when unplannable — the placement path reports that failure).
        Memoised per job id: the budget is fixed for this scheduler's
        lifetime and the load signal is polled often (the fleet steal
        thread), so the pure-python planners must not re-run per poll."""
        cached = self._passes_cache.get(job.job_id)
        if cached is not None:
            return cached
        try:
            passes = modeled_step_passes(job, self.pool.memory)
        except Exception:
            passes = 1.0
        self._cache_put(self._passes_cache, job.job_id, passes)
        return passes

    def job_footprint(self, job: ReconJob) -> JobFootprint:
        """Memoised :func:`estimate_job_footprint` under this pool's
        budget (same rationale as :meth:`job_passes`; raises for an
        unplannable job)."""
        fp = self._footprint_cache.get(job.job_id)
        if fp is None:
            fp = estimate_job_footprint(job, self.pool.memory)
            self._cache_put(self._footprint_cache, job.job_id, fp)
        return fp

    @staticmethod
    def _remaining_iters(rec: JobRecord) -> int:
        alg = get_algorithm(rec.job.algorithm)
        total = max(1, rec.job.n_iter) if alg.iterative else 1
        return max(0, total - rec.iterations_done)

    def steal_candidates(self) -> List[JobRecord]:
        """Parked records another pod could take, cheapest-to-steal last:
        the stealer works from the *tail* (lowest priority, latest
        arrival), so this pod's head-of-line work keeps its position."""
        with self._lock:
            return list(self.queue.pending_records())

    def export_job(self, job_id: str, transfer_dir: str) -> bool:
        """Hand a *parked* (queued or preempted-parked) job off to another
        pod: persist it under ``transfer_dir/jobs/<job_id>`` through
        :func:`repro_torch.checkpoint.sharded.save_checkpoint` (the same
        manifest + COMMIT layout snapshots use — on a real cluster this
        directory is the shared filesystem between hosts), then forget it
        locally.  Running and terminal jobs are never exported; neither
        are jobs whose projections are an unpersistable lazy ref (the
        importer may still supply ``data_refs``, so the *stealer* decides
        whether a lazy job is transferable).  Returns True if the job was
        exported.

        ``transfer_dir`` must not alias this scheduler's own
        ``snapshot_dir``: the periodic snapshot's stale-out pass treats
        any on-disk copy of a job it no longer owns as a stale snapshot,
        and would destroy a live hand-off written to the same path."""
        if (self.snapshot_dir is not None
                and os.path.abspath(self.snapshot_dir)
                == os.path.abspath(transfer_dir)):
            raise ValueError(
                f"export_job: transfer_dir {transfer_dir!r} aliases this "
                f"scheduler's snapshot_dir; hand-offs and durable "
                f"snapshots must use distinct directories")
        with self._lock:
            rec = self.queue.remove(job_id)
            if rec is None:
                return False
            payload = _job_payload(rec)
            del self.records[job_id]
            self._snapshotted.pop(job_id, None)
        try:
            _write_job(transfer_dir, *payload)
        except BaseException:
            with self._lock:      # failed hand-off: the job stays ours
                self.records[job_id] = rec
                self.queue.push(rec)
            raise
        with self._lock:
            self.metrics.stolen_out += 1
        fleet_event("export", job=job_id, pod=self.name,
                    it=rec.iterations_done)
        # a periodic snapshot may also have persisted this job under our
        # own snapshot_dir (distinct from transfer_dir, checked above);
        # flip that copy to "stolen" so a restart of *this* pod cannot
        # resurrect (and double-execute) it
        rec.status = JobStatus.STOLEN
        self._mark_terminal_on_disk(rec)
        return True

    def import_job(self, transfer_dir: str, job_id: str,
                   data_refs: Optional[Dict[str, Callable]] = None) -> str:
        """Adopt a job another pod exported with :meth:`export_job`: load
        its spec + latest committed step from ``transfer_dir`` and enqueue
        it here.  The step-wise checkpoint travels with it, so the job
        resumes on this pod bit-identically to never having moved.

        On success the transfer copy is *consumed*: its spec is flipped
        to ``stolen`` first (atomic replace — a crash before the delete
        cannot leave a resumable duplicate for a later restore over the
        transfer dir to double-execute) and the directory is then
        removed, so a long-lived fleet does not leak one full checkpoint
        per steal on the shared mount.  Failed imports (missing data
        ref, duplicate id) leave the copy intact for a retry.

        A scheduler with a ``snapshot_dir`` persists the adopted job
        there *before* consuming the transfer copy: the victim's own
        snapshot of the job is already a ``stolen`` tombstone, so
        without this a kill -9 after the steal (job admitted on the
        thief, never parked again) would lose the job from every
        snapshot on disk."""
        job_dir = os.path.join(transfer_dir, "jobs", job_id)
        rec = _load_job(job_dir, data_refs or {})
        if rec is None:
            raise ValueError(f"import_job: no resumable job at "
                             f"{transfer_dir}/jobs/{job_id}")
        with self._lock:
            if rec.job.job_id in self.records:
                raise ValueError(f"import_job: {rec.job.job_id} already "
                                 f"known to this scheduler")
            self.records[rec.job.job_id] = rec
            self.queue.push(rec)
            self.metrics.stolen_in += 1
            fleet_event("import", job=rec.job.job_id, pod=self.name,
                        it=rec.iterations_done)
            current = next(self._seq)
            self._seq = itertools.count(max(current, rec.seq + 1))
            snapshot_dir = self.snapshot_dir
            payload = _job_payload(rec) if snapshot_dir else None
            fingerprint = (rec.iterations_done, rec.status.value,
                           rec.preemptions)
        if payload is not None:
            _write_job(snapshot_dir, *payload)
            with self._lock:
                self._snapshotted[rec.job.job_id] = fingerprint
                # the write ran outside the lock: a fast job may have
                # been admitted and finished meanwhile, and its own
                # terminal stale-out no-opped (no spec on disk yet).
                # Re-stale now or a restart would re-execute it (same
                # discipline as snapshot()).
                stale_status = rec.status.value if rec.done else None
            if stale_status is not None:
                _stale_job_dir(os.path.join(snapshot_dir, "jobs",
                                            rec.job.job_id), stale_status)
        _consume_transfer_copy(job_dir)
        return rec.job.job_id

    def reclaim_export(self, transfer_dir: str, job_id: str,
                       data_refs: Optional[Dict[str, Callable]] = None
                       ) -> str:
        """Undo an :meth:`export_job` whose import on the thief failed:
        re-adopt the (intact) transfer copy ourselves and cancel the
        steal accounting, so the job is never stranded in no scheduler.
        The stealer calls this when the thief raises mid-transfer."""
        jid = self.import_job(transfer_dir, job_id, data_refs=data_refs)
        with self._lock:
            self.metrics.stolen_in -= 1
            self.metrics.stolen_out -= 1
        return jid


# --------------------------------------------------------------------------
# durable job persistence (one directory per job under <ckpt_dir>/jobs/)
#
#   jobs/<job_id>/
#     spec.json              # job spec + record metadata (atomic replace)
#     step_XXXXXXXX/         # save_checkpoint output: manifest + COMMIT
#       manifest.json        # {"step": N, "leaves": {key: file/shape/dtype}}
#       leaf_*.npy           # angles, projections, state.<field> leaves
#       COMMIT               # written last: the step's crash-safe marker
#
# The step directory is exactly what checkpoint/sharded.py writes: the
# manifest maps each flat tree key ("['angles']", "['projections']",
# "['state.x']", ...) to its leaf file, shape and dtype, and COMMIT is
# created only after every leaf + the manifest are on disk.  Restore
# trusts *only* committed steps: manifest_target() rebuilds the flat
# {name: zeros} tree from the manifest alone (a restarted process has no
# in-memory structure to validate against) and restore_checkpoint() then
# fills it, re-checking every leaf's shape.  State leaves carry a
# "state." prefix to keep them apart from the job's input data; python
# scalars among them record their type in spec.json ("scalar_types") so
# disk restore hands back exactly what the in-memory preemption path
# produces (np.save would widen an int into a 0-d int64 array).
#
# The step number is the job's completed iteration count, so repeated
# snapshots of a progressing job accumulate (GC keeps the latest two) and
# latest_step() always names the most advanced committed state.
#
# The same layout moves jobs *between* pods: export_job() writes one
# jobs/<job_id> directory under a transfer dir, import_job() reads it.
# --------------------------------------------------------------------------

_STATE_PREFIX = "state."
_TERMINAL = ("completed", "failed", "cancelled", "stolen")


def _scalar_tag(v) -> str:
    """Python-type tag for a checkpoint field, so disk restore hands back
    exactly the types the in-memory preemption path produces (np.save
    would otherwise widen e.g. a python int into a 0-d int64 array)."""
    if v is None:
        return "none"
    if isinstance(v, bool):
        return "bool"
    if isinstance(v, int):
        return "int"
    if isinstance(v, float):
        return "float"
    return "array"


def _job_payload(rec: JobRecord,
                 checkpoint: Optional[Dict[str, Any]] = None,
                 iterations: Optional[int] = None
                 ) -> Tuple[str, Dict, Dict[str, Any], int]:
    """Capture everything :func:`_write_job` needs, under the scheduler
    lock: a shallow copy of the checkpoint dict (the arrays themselves are
    never mutated, only replaced) so a concurrent re-admission clearing
    ``rec.checkpoint`` cannot race the disk write.

    ``checkpoint`` / ``iterations`` override the record's own parked
    state: a *running* job has ``rec.checkpoint is None`` (cleared at
    admission), so live snapshots pass the executor's step-boundary copy
    and its committed iteration count explicitly."""
    job = rec.job
    ckpt = rec.checkpoint if checkpoint is None else checkpoint
    iters = rec.iterations_done if iterations is None else iterations
    tree: Dict[str, Any] = {"angles": np.asarray(job.angles, np.float32)}
    projections_persisted = not callable(job.projections)
    if projections_persisted:
        # a tensor is copied to the host by the writer
        tree["projections"] = job.projections
    scalar_types: Dict[str, str] = {}
    if ckpt is not None:
        for k, v in ckpt.items():
            tag = _scalar_tag(v)
            scalar_types[k] = tag
            if tag != "none":      # None fields rebuilt from the tag alone
                tree[_STATE_PREFIX + k] = v
    spec = {
        "job_id": job.job_id,
        "algorithm": job.algorithm,
        "geo": dataclasses.asdict(job.geo),
        "n_iter": job.n_iter,
        "priority": job.priority,
        "params": job.params,
        "memory_hint_bytes": job.memory_hint_bytes,
        "mode": job.mode,
        "backend": job.backend,
        "deadline_seconds": job.deadline_seconds,
        "seq": rec.seq,
        "status": rec.status.value,
        "iterations_done": iters,
        "preemptions": rec.preemptions,
        "has_state": ckpt is not None,
        "scalar_types": scalar_types,
        "projections_persisted": projections_persisted,
    }
    return job.job_id, spec, tree, iters


def _write_job(ckpt_dir: str, job_id: str, spec: Dict,
               tree: Dict[str, Any], step: int) -> None:
    job_dir = os.path.join(ckpt_dir, "jobs", job_id)
    os.makedirs(job_dir, exist_ok=True)
    # step data commits before the spec: a crash in between leaves an old
    # spec next to a newer committed step (harmless — _load_job trusts the
    # committed step for progress), never a new spec pointing at state
    # that was never committed
    save_checkpoint(job_dir, step=step, tree=tree, keep=2)
    _atomic_write_json(os.path.join(job_dir, "spec.json"), spec)


def _atomic_write_json(path: str, obj: Dict) -> None:
    """Write ``obj`` as json via a temp file + atomic rename, so readers
    only ever see a complete document (the one spec-write discipline
    shared by snapshot, stale-out and transfer consumption)."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1)
    os.replace(tmp, path)


def _set_spec_status(job_dir: str, status: str) -> bool:
    """Atomically rewrite ``job_dir/spec.json`` with ``status``; False if
    there is no (readable) spec to rewrite."""
    spec_path = os.path.join(job_dir, "spec.json")
    if not os.path.isfile(spec_path):
        return False
    try:
        with open(spec_path) as f:
            spec = json.load(f)
        spec["status"] = status
        _atomic_write_json(spec_path, spec)
        return True
    except (OSError, ValueError):
        # dir vanished or spec corrupt: nothing trustworthy to rewrite
        return False


def _stale_job_dir(job_dir: str, status: str) -> None:
    """Best-effort retirement of a persisted job: terminal spec first
    (atomic — the moment it lands, no restore will resurrect the job),
    then reclaim the step directories' bytes.  Spec-less step data is
    ignored by :func:`_load_job`, so a crash between the two leaves
    nothing resumable either way."""
    if not _set_spec_status(job_dir, status):
        return
    try:
        for d in os.listdir(job_dir):
            if d.startswith("step_"):
                shutil.rmtree(os.path.join(job_dir, d), ignore_errors=True)
    except OSError:
        pass


def _consume_transfer_copy(job_dir: str) -> None:
    """Retire a successfully-imported transfer directory: mark the spec
    ``stolen`` (atomic), then delete the directory.  Best-effort — a
    shared-mount hiccup must not fail the import that already
    succeeded, and the terminal spec alone is enough to keep any later
    restore from resurrecting the copy."""
    if _set_spec_status(job_dir, "stolen"):
        shutil.rmtree(job_dir, ignore_errors=True)


#: a snapshot's backend name -> the port's: the reference's Pallas kernels
#: have the port's CUDA kernels as their counterparts
_SPEC_BACKENDS = {None: None, "auto": None, "ref": "ref", "cuda": "cuda",
                  "pallas": "cuda"}


def _backend_from_spec(spec: Dict) -> Optional[str]:
    name = spec.get("backend")
    if name not in _SPEC_BACKENDS:
        raise ValueError(
            f"restore: job {spec['job_id']} names backend {name!r}, which "
            f"the port does not know (known: "
            f"{sorted(k for k in _SPEC_BACKENDS if k)})")
    return _SPEC_BACKENDS[name]


def _geo_from_spec(d: Dict) -> ConeGeometry:
    return ConeGeometry(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in d.items()})


def _load_job(job_dir: str,
              data_refs: Dict[str, Callable]) -> Optional[JobRecord]:
    spec_path = os.path.join(job_dir, "spec.json")
    if not os.path.isfile(spec_path):
        return None
    with open(spec_path) as f:
        spec = json.load(f)
    if spec["status"] in _TERMINAL:
        return None
    step = latest_step(job_dir)
    if step is None:
        # the writer commits step data *before* the spec, so a live spec
        # with no committed step means the snapshot was truncated or
        # tampered with -- refuse loudly instead of silently dropping a
        # job the operator believes is parked safely on disk
        raise ValueError(
            f"restore: job {spec['job_id']} has spec.json but no committed "
            f"step directory under {job_dir} (missing/removed COMMIT?); "
            f"snapshot is truncated -- refusing to resume silently")
    tree = restore_checkpoint(job_dir, step, manifest_target(job_dir, step))
    angles = np.asarray(tree.pop("angles"), np.float32)
    if spec["projections_persisted"]:
        projections: Any = np.asarray(tree.pop("projections"))
    else:
        projections = data_refs.get(spec["job_id"])
        if projections is None:
            raise ValueError(
                f"restore: job {spec['job_id']} was submitted with a lazy "
                f"data ref, which cannot be persisted; pass "
                f"data_refs={{{spec['job_id']!r}: <callable>}}")
    ckpt: Optional[Dict[str, Any]] = None
    if spec["has_state"]:
        ckpt = {}
        for name, tag in spec["scalar_types"].items():
            if tag == "none":
                ckpt[name] = None
            elif tag == "bool":
                ckpt[name] = bool(tree[_STATE_PREFIX + name])
            elif tag == "int":
                ckpt[name] = int(tree[_STATE_PREFIX + name])
            elif tag == "float":
                ckpt[name] = float(tree[_STATE_PREFIX + name])
            else:
                ckpt[name] = np.asarray(tree[_STATE_PREFIX + name])
    job = ReconJob(spec["algorithm"], _geo_from_spec(spec["geo"]), angles,
                   projections, n_iter=spec["n_iter"],
                   priority=spec["priority"], params=spec["params"],
                   memory_hint_bytes=spec["memory_hint_bytes"],
                   mode=spec["mode"],
                   # absent in pre-backend snapshots: None = auto-resolve
                   backend=_backend_from_spec(spec),
                   deadline_seconds=spec["deadline_seconds"],
                   job_id=spec["job_id"])
    return JobRecord(
        job=job, seq=spec["seq"],
        status=JobStatus.PREEMPTED if ckpt is not None else JobStatus.PENDING,
        submit_time=time.monotonic(),
        # progress comes from the *committed* step, not the spec: the two
        # can disagree only across a crash window, and the step directory
        # is what the job will actually resume from
        iterations_done=step,
        preemptions=spec["preemptions"],
        checkpoint=ckpt)
