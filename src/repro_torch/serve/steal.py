"""Work stealing between pods: idle pods take parked jobs from loaded ones.

Port of ``repro/serve/steal.py``; the decisions are the reference's.  No
device tensor crosses pods: the victim's export copies the job's parked
state to the host and writes it to the transfer directory, and the
thief's import reads it back and builds the job's state afresh on its
own slot's device and stream at admission.

Static per-pod partitioning (each tenant pinned to "their" pod) strands
capacity the moment arrivals are imbalanced: one pod builds a backlog
while another sits idle.  The stealing protocol here closes that gap
without any central queue:

* each pod's :class:`~repro_torch.serve.scheduler.Scheduler` exposes a load
  signal (:meth:`Scheduler.modeled_backlog_seconds` — remaining iterations
  of queued + running work at the observed step cost, normalised per
  device) and a list of *parked* records a thief could take
  (:meth:`Scheduler.steal_candidates`);
* a :func:`steal_pass` ranks pods by that signal and moves jobs from the
  most loaded pod to the least loaded one while the imbalance exceeds
  :class:`StealPolicy` thresholds;
* the transfer is the *same* on-disk format durable snapshots use
  (:mod:`repro_torch.checkpoint.sharded` manifest + COMMIT, one directory per
  job under ``transfer_dir/jobs/``): the victim's
  :meth:`Scheduler.export_job` persists spec + latest step-wise
  checkpoint and forgets the job; the thief's
  :meth:`Scheduler.import_job` loads and enqueues it.  Because the
  checkpoint carries every recurrence variable and ``init`` is
  deterministic, the stolen job finishes **bit-identically** to never
  having moved (asserted in ``tests/test_torch_serve_pods.py``).

Steal victims are taken from the *tail* of the victim's queue (lowest
priority, latest arrival) — the classic deque discipline — so the
victim's head-of-line work keeps its position and only surplus moves.

Lazy data refs (callables) cannot be serialised; a lazy job is stolen
only when the stealer's ``data_refs`` can re-resolve it on the thief
(think: an object-store URI both hosts can read), otherwise it is
skipped.

On a real cluster ``transfer_dir`` is a filesystem both host groups
mount; on a single host it is just a scratch directory.  Either way the
COMMIT marker means a crash mid-transfer can never lose the job: the
victim forgets it only after the write commits, and an uncommitted
transfer directory is invisible to :meth:`Scheduler.import_job`.

The same transfer machinery also empties a whole pod:
:func:`drain_pod` is the autoscaler's scale-down path — pause the
pod's admission, preempt its running jobs at their step boundaries,
then export *everything* to the surviving pods (see
:mod:`repro_torch.serve.autoscale`).

For *extreme* imbalance the parked-only discipline is not enough: a
victim whose surplus is entirely running work has nothing parked to
steal.  :func:`migrate_once` generalizes the drain machinery to a
single job — preempt it at its step boundary, export, import on the
thief — gated by ``StealPolicy.migrate_min_imbalance_seconds`` and a
benefit check that also prices the one-off copy against the measured
bandwidth EMA.  The checkpoint travels, so a migrated job, too,
finishes bit-identically to never having moved.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..obs import fleet_event
from .scheduler import Scheduler


@dataclasses.dataclass(frozen=True)
class StealPolicy:
    """Thresholds that keep stealing from thrashing.

    A steal moves real bytes (checkpoint + projections) between pods, so
    it must only happen when the imbalance is worth the copy.
    """

    #: victim's per-device modeled backlog must exceed the thief's by this
    #: many modeled seconds before anything moves
    min_imbalance_seconds: float = 0.0
    #: victim must still have at least this many parked jobs *after* the
    #: steal (never steal a pod's last queued job out from under a device
    #: that is about to free up) — 0 allows draining the queue entirely
    min_victim_queue_after: int = 0
    #: at most this many jobs move per :func:`steal_pass` call.  The
    #: benefit check (a move must not invert the imbalance) is what
    #: stops a pass, so the default is generous: under CPU contention
    #: the stealing thread may get scheduled rarely, and the first pass
    #: must be allowed to balance the fleet in one go.
    max_jobs_per_pass: int = 16
    #: live-migration trigger (:func:`migrate_once`): when the pass's
    #: pinned (victim, thief) imbalance exceeds this many modeled
    #: seconds and no parked job moved, one *running* victim job is
    #: preempted at its step boundary and moved live.  None disables
    #: live migration — parked-only stealing, the historical behaviour.
    migrate_min_imbalance_seconds: Optional[float] = None


def fleet_units(pods: Sequence) -> Tuple[float, float]:
    """Fleet-wide fallback (per-pass unit cost, init cost) for pods with
    no local observations: the mean of the warm pods' EMAs, or (1.0, 0)
    on an entirely cold fleet.  Comparing a cold pod's constant-unit
    backlog against a warm pod's real-seconds backlog would invert
    victim/thief (and routing) decisions — e.g. ship work *to* the
    overloaded warm pod because its tiny EMA makes its backlog look
    smaller — so every fleet-level comparison shares these units."""
    emas = [p.scheduler.step_seconds_ema for p in pods
            if p.scheduler.step_seconds_ema is not None]
    inits = [p.scheduler.init_seconds_ema for p in pods
             if p.scheduler.init_seconds_ema is not None]
    unit = sum(emas) / len(emas) if emas else 1.0
    init = sum(inits) / len(inits) if inits else 0.0
    return unit, init


def effective_units(scheduler: Scheduler, default_unit: Optional[float],
                    default_init: Optional[float]
                    ) -> Tuple[Optional[float], Optional[float]]:
    """Resolve one pod's (unit, init): its own observed EMAs where it has
    them, the fleet-wide fallbacks otherwise.  The single place the
    warm-beats-fallback rule lives — every fleet comparison (backlog
    ranking, steal cost, routing) must resolve units through here or the
    shared-scale guarantee silently breaks."""
    unit = scheduler.step_seconds_ema
    init = scheduler.init_seconds_ema
    return (default_unit if unit is None else unit,
            default_init if init is None else init)


def pod_load(scheduler: Scheduler, n_devices: int,
             unit: Optional[float] = None,
             init: Optional[float] = None) -> float:
    """Per-device modeled backlog: the signal pods are ranked by.  Pass
    the :func:`fleet_units` fallbacks when comparing across pods; the
    pod's own EMAs still win where it has them."""
    unit, init = effective_units(scheduler, unit, init)
    return (scheduler.modeled_backlog_seconds(unit=unit, init=init)
            / max(1, n_devices))


def _stealable(rec, thief, data_refs: Dict[str, Callable]) -> bool:
    """Can this parked record run on the thief pod at all?"""
    if callable(rec.job.projections) and rec.job.job_id not in data_refs:
        return False               # lazy ref the thief cannot re-resolve
    try:
        fp = thief.scheduler.job_footprint(rec.job)   # memoised
    except Exception:
        return False               # unplannable under the thief's budget
    return fp.bytes_on_device <= thief.pool.fits_nowhere_bytes


def steal_once(victim, thief, transfer_dir: str,
               data_refs: Optional[Dict[str, Callable]] = None,
               policy: StealPolicy = StealPolicy(),
               exclude: Sequence[str] = (),
               units: Optional[Tuple[float, float]] = None) -> Optional[str]:
    """Move one parked job from the ``victim`` pod to the ``thief`` pod
    (each exposing ``.scheduler``, ``.pool``, ``.n_devices``) through
    ``transfer_dir``.  Scans the victim's queue from the tail for the
    first record the thief can hold, exports it (manifest + COMMIT) and
    imports it on the thief.  Returns the stolen job id, or None if
    nothing moved.

    A candidate is skipped when adopting it would load the thief past
    the victim's *current* load — a steal that inverts the imbalance
    would just be stolen back (ping-pong), moving bytes for nothing.
    ``exclude`` lists jobs a caller has already moved this pass;
    ``units`` is the :func:`fleet_units` pair (computed over this pod
    pair when not given) keeping cold/warm pods on one scale.

    If the thief's import fails after a successful export (transient
    shared-mount error, validation failure), the victim *reclaims* the
    intact transfer copy — a submitted job must never end up in no
    scheduler — and the original error propagates only if the reclaim
    itself also fails."""
    data_refs = data_refs or {}
    candidates = victim.scheduler.steal_candidates()
    if len(candidates) <= policy.min_victim_queue_after:
        return None
    default_unit, default_init = units or fleet_units((victim, thief))
    victim_load = pod_load(victim.scheduler, victim.n_devices,
                           unit=default_unit, init=default_init)
    thief_load = pod_load(thief.scheduler, thief.n_devices,
                          unit=default_unit, init=default_init)
    unit, init = effective_units(thief.scheduler, default_unit,
                                 default_init)
    for rec in reversed(candidates):       # tail first: surplus work
        jid = rec.job.job_id
        if jid in exclude:
            continue
        if not _stealable(rec, thief, data_refs):
            continue
        # the job's cost *on the thief*: remaining iterations scaled by
        # the slab-pass multiplier under the thief's budget (the same
        # memoised model routing uses — a job that is resident on the
        # victim may stream expensively on a smaller-memory thief) plus
        # a re-init
        passes = thief.scheduler.job_passes(rec.job)
        cost = init + Scheduler._remaining_iters(rec) * passes * unit
        if thief_load + cost / max(1, thief.n_devices) > victim_load:
            continue                       # would invert the imbalance
        # export can race a concurrent admission popping the record; a
        # False return just means the victim got to it first
        if not victim.scheduler.export_job(jid, transfer_dir):
            continue
        try:
            return thief.scheduler.import_job(transfer_dir, jid,
                                              data_refs=data_refs)
        except Exception:
            victim.scheduler.reclaim_export(transfer_dir, jid,
                                            data_refs=data_refs)
            return None
    return None


def migrate_once(victim, thief, transfer_dir: str,
                 data_refs: Optional[Dict[str, Callable]] = None,
                 policy: StealPolicy = StealPolicy(),
                 units: Optional[Tuple[float, float]] = None,
                 timeout: float = 30.0) -> Optional[str]:
    """Live migration: preempt one *running* job on the ``victim`` pod at
    its step boundary (:meth:`Scheduler.park_job` — the same machinery
    :func:`drain_pod` uses to empty a pod, applied to a single job while
    everything else keeps running) and move it to the ``thief`` through
    ``transfer_dir``.  Returns the migrated job id, or None.

    This is the extreme-imbalance escape hatch: ordinary stealing only
    moves *parked* work, so a victim whose whole backlog is already
    running (long jobs, deep queues drained) can never shed load even
    when the thief sits idle.  Candidates are tried lowest priority /
    latest arrival first, mirroring the queue-tail steal discipline.

    The anti-ping-pong benefit check prices the job on the thief via
    :func:`~repro_torch.serve.scheduler.modeled_step_passes` (remaining
    iterations x slab-pass multiplier under the *thief's* budget, plus
    the schedule-priced per-step staging time) **plus** the one-off
    migration copy itself — the job's device footprint over the
    measured bandwidth EMA (0 while no bandwidth has been observed): a
    move that would invert the imbalance, or whose copy costs more than
    it saves, is skipped.

    The victim's admission is paused for the park->export window (or the
    admission loop would immediately re-place the job it just parked);
    every other job on the victim keeps stepping throughout.  A failed
    import is reclaimed by the victim, exactly as in
    :func:`steal_once`."""
    data_refs = data_refs or {}
    vsched = victim.scheduler
    with vsched._lock:
        candidates = sorted((r.record for r in vsched.running.values()),
                            key=lambda r: (r.job.priority, -r.seq))
    if not candidates:
        return None
    default_unit, default_init = units or fleet_units((victim, thief))
    victim_load = pod_load(vsched, victim.n_devices,
                           unit=default_unit, init=default_init)
    thief_load = pod_load(thief.scheduler, thief.n_devices,
                          unit=default_unit, init=default_init)
    unit, init = effective_units(thief.scheduler, default_unit,
                                 default_init)
    bw = thief.scheduler.bandwidth_ema or vsched.bandwidth_ema
    for rec in candidates:
        jid = rec.job.job_id
        if not _stealable(rec, thief, data_refs):
            continue
        passes = thief.scheduler.job_passes(rec.job)
        cost = init + Scheduler._remaining_iters(rec) * (
            passes * unit
            + thief.scheduler.modeled_transfer_seconds(rec.job))
        move_cost = 0.0
        if bw is not None and bw > 0:
            try:
                move_cost = (vsched.job_footprint(rec.job).bytes_on_device
                             / bw)
            except Exception:
                move_cost = 0.0
        if (thief_load + (cost + move_cost) / max(1, thief.n_devices)
                > victim_load):
            continue                       # would invert the imbalance
        vsched.pause_admission()
        try:
            if not vsched.park_job(jid, timeout=timeout):
                continue   # finished (or failed) before it could park
            # park_job left the job queued; export can still race a
            # terminal transition, in which case there is nothing to move
            if not vsched.export_job(jid, transfer_dir):
                continue
            try:
                out = thief.scheduler.import_job(transfer_dir, jid,
                                                 data_refs=data_refs)
            except Exception:
                vsched.reclaim_export(transfer_dir, jid,
                                      data_refs=data_refs)
                return None
            fleet_event("migrate", job=jid, src=victim.name,
                        dst=thief.name, it=rec.iterations_done)
            return out
        finally:
            vsched.resume_admission()
    return None


def _best_survivor(rec, survivors: Sequence,
                   data_refs: Dict[str, Callable],
                   units: Tuple[float, float]):
    """Least-loaded survivor that can hold ``rec`` — load plus the job's
    modeled cost under that survivor's budget (the same slab-pass model
    routing and stealing use), all on the fleet unit scale.  None when no
    survivor can take the job."""
    default_unit, default_init = units
    best: Optional[float] = None
    chosen = None
    for s in survivors:
        if not _stealable(rec, s, data_refs):
            continue
        unit, init = effective_units(s.scheduler, default_unit,
                                     default_init)
        passes = s.scheduler.job_passes(rec.job)
        cost = init + Scheduler._remaining_iters(rec) * passes * unit
        load = pod_load(s.scheduler, s.n_devices,
                        unit=default_unit, init=default_init)
        score = load + cost / max(1, s.n_devices)
        if best is None or score < best:
            best, chosen = score, s
    return chosen


def drain_pod(pod, survivors: Sequence, transfer_dir: str,
              data_refs: Optional[Dict[str, Callable]] = None,
              timeout: float = 60.0) -> List[str]:
    """Empty one pod for retirement (the autoscaler's scale-down):

    1. **pause** the pod's admission, so jobs it parks stay parked
       instead of being re-placed on the pod about to go away;
    2. **preempt** every running job — each parks at its next step
       boundary with a step-wise checkpoint;
    3. **export** every parked job through ``transfer_dir`` (the durable
       manifest + COMMIT format) and import it on the least-loaded
       survivor that can hold it — the checkpoint travels, so each moved
       job resumes on its survivor *bit-identically* to never having
       been drained.

    The park/export loop repeats until the pod is empty, so a
    submission or steal that raced the drain is moved too.  If any job
    cannot move (a lazy-data job with no ``data_refs`` resolver, or a
    job no survivor can hold), the pod is returned to service
    (admission resumed, ``draining`` cleared) and ``RuntimeError``
    raised — it still owns every unmoved job and the caller must abort
    the scale-down.

    On success the pod is left **ready for retirement**: empty,
    ``draining`` set (fleet routing/stealing skip it) and admission
    still paused.  Pass it to ``MultiPodScheduler.remove_pod`` — or, to
    return it to service instead, clear ``draining`` and call
    ``resume_admission()``.  Returns the moved job ids."""
    data_refs = data_refs or {}
    sched = pod.scheduler
    had_draining = getattr(pod, "draining", None)
    if had_draining is not None:
        pod.draining = True       # no new work routed here from now on
    sched.pause_admission()
    moved: List[str] = []
    deadline = time.monotonic() + timeout
    try:
        while True:
            # park running (and mid-admission) work at step boundaries
            sched.drain(None, timeout=max(0.001,
                                          deadline - time.monotonic()))
            candidates = sched.steal_candidates()
            if not candidates:
                if sched.idle:
                    return moved
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"drain_pod: pod {pod.name!r} not empty after "
                        f"{timeout}s")
                continue
            units = fleet_units(list(survivors) + [pod])
            for rec in candidates:
                jid = rec.job.job_id
                target = _best_survivor(rec, survivors, data_refs, units)
                if target is None:
                    raise RuntimeError(
                        f"drain_pod: job {jid} cannot move to any "
                        f"survivor (lazy data ref without a resolver, or "
                        f"no surviving pod can hold it)")
                # export can race a terminal transition; False just means
                # there is nothing left to move for this id
                if not sched.export_job(jid, transfer_dir):
                    continue
                try:
                    target.scheduler.import_job(transfer_dir, jid,
                                                data_refs=data_refs)
                except Exception:
                    # failed hand-off: the job must never be stranded in
                    # no scheduler — the draining pod re-adopts it
                    sched.reclaim_export(transfer_dir, jid,
                                         data_refs=data_refs)
                    raise
                moved.append(jid)
    except BaseException:
        # aborted drain: the pod returns to service with whatever it holds
        sched.resume_admission()
        if had_draining is not None:
            pod.draining = False
        raise


def steal_pass(pods: Sequence, transfer_dir: str,
               data_refs: Optional[Dict[str, Callable]] = None,
               policy: StealPolicy = StealPolicy()) -> List[str]:
    """One rebalancing pass over a pod set (each pod exposing
    ``.scheduler``, ``.pool`` and ``.n_devices``): pair the most loaded
    pod with the least loaded one and move tail jobs from victim to
    thief while the modeled imbalance exceeds
    ``policy.min_imbalance_seconds``.  Jobs already moved this pass are
    never moved again.  Returns the ids of every job moved (possibly
    empty).

    The fleet units and the (victim, thief) pairing are computed
    **once** and pinned for the whole pass.  Re-ranking after every
    move would let a single steal flip the ordering — the former thief
    now tops the ranking by a hair and a job bounces straight back
    toward the pod it just left (under unit skew the bounce can even
    favor the warmer pod systematically).  Per-move load *levels*
    still update inside :func:`steal_once` (its benefit check prices
    each candidate against the live loads), so a pinned pair cannot
    overshoot; when the pinned pair has no more profitable moves the
    pass ends, and the caller's next pass re-ranks from scratch."""
    moved: List[str] = []
    if len(pods) < 2:
        return moved
    units = fleet_units(pods)
    unit, init = units
    ranked: List[Tuple[float, object]] = sorted(
        ((pod_load(p.scheduler, p.n_devices, unit=unit, init=init), p)
         for p in pods),
        key=lambda t: t[0])
    (lo, thief), (hi, victim) = ranked[0], ranked[-1]
    if victim is thief or hi - lo <= policy.min_imbalance_seconds:
        return moved
    for _ in range(policy.max_jobs_per_pass):
        jid = steal_once(victim, thief, transfer_dir,
                         data_refs=data_refs, policy=policy,
                         exclude=moved, units=units)
        if jid is None:
            break
        moved.append(jid)
    # extreme imbalance with nothing parked left to move: the victim's
    # surplus is all *running* — migrate one job live.  Gated on "no
    # parked job moved this pass" so cheap steals always win over a
    # preempt-and-copy, and on the (stricter) migrate threshold so
    # ordinary imbalance never pays a preemption
    if (not moved and policy.migrate_min_imbalance_seconds is not None
            and hi - lo > policy.migrate_min_imbalance_seconds):
        jid = migrate_once(victim, thief, transfer_dir,
                           data_refs=data_refs, policy=policy,
                           units=units)
        if jid is not None:
            moved.append(jid)
    return moved
