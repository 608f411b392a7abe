"""Elastic fleet autoscaling: grow and shrink a pod fleet from load.

Port of ``repro/serve/autoscale.py``; the decisions are the reference's.
A spawned pod's slots lie where a pod without pins lies (the current
CUDA device) unless the autoscaler is given a ``device``.

The paper's splitting strategy works "with any number of GPUs"; the
serving fleet should therefore not be *statically* sized either.  The
:class:`Autoscaler` is a control plane over
:class:`~repro_torch.serve.pool.MultiPodScheduler`: it watches the load
signals the schedulers already expose and changes the fleet's pod
membership at runtime.

Signals (all modeled, no new instrumentation):

* **backlog** — :meth:`Scheduler.modeled_backlog_seconds` per device,
  aggregated fleet-wide on the shared unit scale
  (:func:`repro_torch.serve.steal.fleet_units`, so a cold just-spawned pod
  and a warm pod compare in the same units);
* **queue depth** — queued jobs per live pod (optional trigger);
* **fits-nowhere** — a submission no live pod can hold
  (``fits_nowhere_bytes``) asks the autoscaler for a pod from the
  template pool *at submit time*, before the job would be failed
  (wired through ``MultiPodScheduler.submit``).

Decisions (one per :meth:`Autoscaler.step` call, made by
:class:`AutoscalePolicy`):

* **scale up** when the fleet backlog has stayed above the band's high
  watermark for ``up_window_seconds``: instantiate the
  :class:`~repro_torch.serve.pool.PodSpec` template that fits the most
  currently-queued jobs (cycling the pool when the queue is empty) and
  :meth:`~repro_torch.serve.pool.MultiPodScheduler.add_pod` it.  The new pod
  is cold — routing and stealing price it with the fleet's shared units
  (it borrows the warm pods' EMAs), so it is not mispriced against warm
  pods and starts taking work immediately.
* **scale down** when the backlog has stayed below the low watermark for
  ``down_window_seconds``: pick the least-loaded pod, **drain** it with
  :func:`repro_torch.serve.steal.drain_pod` — pause its admission, preempt
  its running jobs at their step boundaries, export every parked job through
  the durable-snapshot transfer format to the surviving pods
  (bit-identical resume) — and retire it only once empty
  (:meth:`~repro_torch.serve.pool.MultiPodScheduler.remove_pod`).  A drain
  that cannot complete (a job no survivor can hold) aborts cleanly: the
  pod resumes admission and stays.

Both directions respect ``min_pods`` / ``max_pods`` and a **cooldown**
between events; the watermark **windows** add hysteresis, so an
oscillating load trace cannot thrash the fleet (asserted in
``tests/test_torch_serve_autoscale.py``).

The autoscaler is *passive*: it only acts when someone calls
:meth:`step` — the cooperative loop (``MultiPodScheduler.run(...,
autoscaler=...)``) and the threaded
:class:`~repro_torch.serve.driver.MultiPodDriver` control thread both do.
``clock`` and ``load_fn`` are injectable so policy behaviour is testable
without wall-clock sleeps.

Every drained-and-moved job resumes bit-identically on its survivor
(``chip_smoke.py``'s ``phase_fleet`` holds it on the card at N=512).
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..core.device import DeviceLike
from ..obs import fleet_event
from ..obs.calibration import CalibrationLedger
from .pool import DuplicatePodName, MultiPodScheduler, Pod, PodSpec
from .scheduler import estimate_job_footprint
from .steal import drain_pod, fleet_units, pod_load


@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    """When to grow and when to shrink the fleet.

    The backlog band is in modeled seconds per device (the same units as
    :meth:`Scheduler.modeled_backlog_seconds` under the fleet's shared
    unit scale).  Hysteresis has two layers: the signal must *persist*
    for a window before either direction acts, and any scale event
    starts a cooldown during which no further event fires.
    """

    #: scale up while the fleet's per-device modeled backlog exceeds this
    scale_up_backlog_seconds: float = 1.0
    #: scale down while it is below this (must be < the high watermark)
    scale_down_backlog_seconds: float = 0.1
    #: the high signal must persist this long before a pod is added
    up_window_seconds: float = 0.0
    #: the low signal must persist this long before a pod is drained
    down_window_seconds: float = 0.5
    #: minimum spacing between *any* two scale events (thrash guard)
    cooldown_seconds: float = 1.0
    #: fleet never shrinks below / grows above these
    min_pods: int = 1
    max_pods: int = 4
    #: optional extra trigger: scale up when queued jobs per live pod
    #: exceed this (None disables)
    scale_up_queue_depth: Optional[int] = None
    #: how long a scale-down drain may take before it is aborted
    drain_timeout_seconds: float = 60.0
    #: predictive scale-up: trigger while the backlog is still *below*
    #: the high watermark when its observed growth rate projects it
    #: across within the fleet's init-EMA lead time — a new pod pays
    #: roughly one executor init before it does useful work, so by
    #: starting that early the pod is live as the band is crossed
    #: instead of an init after it.  Inactive until the fleet has
    #: observed an init (cold fleets have no lead time to hide).
    predictive_scale_up: bool = False
    #: pre-warm a scaled-up pod during its lead window: right after the
    #: pod is added (predictively or not), build the currently-queued
    #: jobs' operators + kernel dispatch entries under the new pod's
    #: memory budget into the shared executor caches, so the first job
    #: admitted there skips the operator and kernel-build stall the
    #: predictive trigger paid for in lead time
    prewarm: bool = False

    def __post_init__(self):
        if self.scale_down_backlog_seconds >= self.scale_up_backlog_seconds:
            raise ValueError(
                f"backlog band inverted: low watermark "
                f"{self.scale_down_backlog_seconds} must be below high "
                f"{self.scale_up_backlog_seconds}")
        if self.min_pods < 1 or self.max_pods < self.min_pods:
            raise ValueError(f"need 1 <= min_pods <= max_pods, got "
                             f"{self.min_pods}..{self.max_pods}")


@dataclasses.dataclass(frozen=True)
class ScaleEvent:
    """One membership change, for the audit trail / bench report."""
    t: float              # policy clock at the decision
    direction: str        # "up" | "down"
    pod: str              # pod added or retired
    load: float           # fleet per-device backlog that triggered it
    n_pods: int           # live pods *after* the event
    predicted: bool = False   # fired by the predictive (lead-time) path


class Autoscaler:
    """Grows and shrinks a :class:`MultiPodScheduler` fleet at runtime.

    Parameters
    ----------
    mps : the fleet to control.  The autoscaler registers itself on it
        so ``submit`` can request a pod for a job that fits nowhere.
    templates : :class:`PodSpec` pool scale-ups instantiate from; each
        spawned pod gets a unique ``<template>-as<N>`` name.  A
        backlog-triggered scale-up picks the template that *fits the
        most currently-queued jobs* (ties broken toward the smallest
        pod, so a giant template is not burned on small work); with an
        empty queue it falls back to cycling the pool in order, which
        keeps heterogeneous "big-memory pods first, small ones after"
        orderings meaningful.
    policy : see :class:`AutoscalePolicy`.
    clock : time source (injectable for tests; defaults to
        ``time.monotonic``).
    load_fn : override of the fleet load signal, called with the live
        pod snapshot (injectable for tests).
    guard : optional
        :class:`~repro_torch.checkpoint.preemption.PreemptionGuard`
        attached to every spawned pod's scheduler — without it, a fleet
        whose original (guarded) pods have all been retired would no
        longer see the host's SIGTERM.
    device : where every spawned pod's slots lie; None puts them where a
        pod without pins lies, on the current CUDA device (and a
        scale-up raises without one).  ``"cpu"`` runs the fleet's
        scale-ups on the CPU.

    Templates must not pin devices (``PodSpec.devices``): the template
    is instantiated repeatedly, and two live pods cloned from one pinned
    template would double-book the same devices with no shared memory
    accounting.  Pin devices by building the Pod yourself and calling
    :meth:`MultiPodScheduler.add_pod`.
    """

    def __init__(self, mps: MultiPodScheduler,
                 templates: Sequence[PodSpec],
                 policy: AutoscalePolicy = AutoscalePolicy(),
                 clock: Callable[[], float] = time.monotonic,
                 load_fn: Optional[Callable[[Sequence[Pod]], float]] = None,
                 guard=None, device: DeviceLike = None):
        if not templates:
            raise ValueError("Autoscaler needs at least one PodSpec "
                             "template to scale up from")
        pinned = [t.name for t in templates if t.devices is not None]
        if pinned:
            raise ValueError(
                f"Autoscaler templates must not pin devices; {pinned} "
                f"pin devices, and repeated scale-ups would double-book "
                f"them (build the Pod yourself and use "
                f"MultiPodScheduler.add_pod instead)")
        self.mps = mps
        self.templates = list(templates)
        self.guard = guard
        self.device = None if device is None else torch.device(device)
        self.policy = policy
        self.clock = clock
        self._load_fn = load_fn
        self._spawned = itertools.count()
        self._above_since: Optional[float] = None
        self._below_since: Optional[float] = None
        self._last_event: Optional[float] = None
        # previous (clock, load) observation: the predictive scale-up's
        # slope estimate (None until step() has observed once)
        self._last_obs: Optional[Tuple[float, float]] = None
        self.events: List[ScaleEvent] = []
        #: every job moved off a pod by a scale-down drain (the bench
        #: re-runs each one undrained and asserts bit-identity)
        self.drained_jobs: List[str] = []
        self.aborted_scale_downs = 0
        mps.autoscaler = self

    # ---- load signal -------------------------------------------------------

    def fleet_load(self, pods: Optional[Sequence[Pod]] = None) -> float:
        """Fleet-wide modeled backlog per device on the shared unit
        scale: total owed seconds across pods over total devices."""
        pods = list(self.mps.pods_snapshot() if pods is None else pods)
        if self._load_fn is not None:
            return self._load_fn(pods)
        if not pods:
            return 0.0
        unit, init = fleet_units(pods)
        total = sum(pod_load(p.scheduler, p.n_devices,
                             unit=unit, init=init) * p.n_devices
                    for p in pods)
        return total / max(1, sum(p.n_devices for p in pods))

    def _queue_depth_per_pod(self, pods: Sequence[Pod]) -> float:
        queued = sum(len(p.scheduler.queue) for p in pods)
        return queued / max(1, len(pods))

    # ---- control step ------------------------------------------------------

    def step(self) -> Optional[ScaleEvent]:
        """One control decision: observe the load, update the hysteresis
        windows, and scale at most one pod up or down.  Returns the
        event, or None."""
        now = self.clock()
        pods = self.mps.pods_snapshot()
        load = self.fleet_load(pods)
        p = self.policy

        want_up = load > p.scale_up_backlog_seconds
        if p.scale_up_queue_depth is not None:
            want_up = want_up or (self._queue_depth_per_pod(pods)
                                  > p.scale_up_queue_depth)
        # predictive trigger: the load is still inside the band, but its
        # observed growth rate crosses the high watermark within the
        # fleet's init-EMA lead time — exactly the time a new pod needs
        # before it does useful work, so start it now and it is live as
        # the band is crossed.  Windows and cooldown still apply.
        predicted = False
        prev, self._last_obs = self._last_obs, (now, load)
        if not want_up and p.predictive_scale_up and prev is not None:
            lead = fleet_units(pods)[1]
            if lead > 0 and now > prev[0]:
                slope = (load - prev[1]) / (now - prev[0])
                if (slope > 0
                        and load + slope * lead
                        > p.scale_up_backlog_seconds):
                    want_up = predicted = True
        want_down = load < p.scale_down_backlog_seconds and not want_up

        # window state is read into locals once updated: a submit-thread
        # scale_up_for may reset the attributes to None concurrently,
        # and computing `now - None` would kill the fleet control loop.
        # (Explicit None checks throughout: a window starting at clock
        # 0.0 is falsy but set.)
        if want_up:
            above = self._above_since
            if above is None:
                above = self._above_since = now
        else:
            above = self._above_since = None
        if want_down:
            below = self._below_since
            if below is None:
                below = self._below_since = now
        else:
            below = self._below_since = None

        last = self._last_event
        if last is not None and now - last < p.cooldown_seconds:
            return None
        if (want_up and len(pods) < p.max_pods
                and now - above >= p.up_window_seconds):
            return self._scale_up(now, load, predicted=predicted)
        if (want_down and len(pods) > p.min_pods
                and now - below >= p.down_window_seconds):
            return self._scale_down(now, load, pods)
        return None

    # ---- scale up ----------------------------------------------------------

    def _pick_template(self) -> Optional[int]:
        """Index of the template whose memory budget fits the most
        currently-queued jobs (footprints via the schedulers' shared
        plan-backed :func:`estimate_job_footprint`); ties break toward
        the *smallest* usable memory so a big-memory template is kept
        for the jobs that need it.  None when nothing is queued — the
        caller then falls back to cycling the template pool."""
        jobs = []
        for p in self.mps.pods_snapshot():
            try:
                jobs.extend(r.job
                            for r in p.scheduler.queue.pending_records())
            except Exception:
                continue        # a pod mid-retire: skip its queue
        if not jobs:
            return None
        best = None
        for i, spec in enumerate(self.templates):
            fits = 0
            for job in jobs:
                try:
                    fp = estimate_job_footprint(job, spec.memory)
                except Exception:
                    continue    # unplannable under this budget: no fit
                if fp.bytes_on_device <= int(spec.memory.usable):
                    fits += 1
            key = (-fits, int(spec.memory.usable), i)
            if best is None or key < best[0]:
                best = (key, i)
        return best[1]

    def _next_pod(self, template_index: Optional[int] = None) -> Pod:
        """Instantiate the next template as a uniquely-named pod.

        Only :class:`~repro_torch.serve.pool.DuplicatePodName` retries (a name
        collision, e.g. after a fleet restore re-seeded the counter's
        namespace, is fixed by the next counter value).  Any other error
        — a bad template the Pod constructor rejects, a scheduler init
        failure — propagates: this runs *inside the fleet lock*, and a
        blanket ``except ValueError: continue`` would spin forever
        there, wedging every submit/steal/snapshot in the process.
        The manifest write is deferred (``flush_manifest=False``)
        because the caller holds the fleet lock; the caller flushes
        after releasing it."""
        while True:
            k = next(self._spawned)
            spec = self.templates[(template_index if template_index
                                   is not None else k)
                                  % len(self.templates)]
            name = f"{spec.name}-as{k}"
            devices = (None if self.device is None
                       else (self.device,) * spec.n_devices)
            try:
                return self.mps.add_pod(
                    Pod(dataclasses.replace(spec, name=name,
                                            devices=devices),
                        guard=self.guard),
                    flush_manifest=False)
            except DuplicatePodName:
                continue    # name collision (e.g. after restore): next k

    def _scale_up(self, now: float, load: float,
                  template_index: Optional[int] = None,
                  predicted: bool = False) -> Optional[ScaleEvent]:
        # backlog-triggered scale-ups (no explicit template) pick by
        # queued-job footprint fit; done *before* the fleet lock — the
        # fit scan walks every pod's queue and prices footprints
        if template_index is None:
            template_index = self._pick_template()
        # the max_pods bound is re-checked *under the fleet lock*: the
        # control thread's step() and a submit thread's scale_up_for
        # both pass their own lock-free pre-checks, and without this one
        # the two adds together could exceed the cap.  The count
        # includes draining pods — a drain can still abort and return
        # its pod to service, and the cap is a hard resource bound.
        with self.mps._fleet_lock:
            if len(self.mps.pods_snapshot(live_only=False)) \
                    >= self.policy.max_pods:
                return None
            pod = self._next_pod(template_index)
        # the add above only *marked* the manifest dirty (we held the
        # fleet lock; disk I/O under it would stall the whole fleet) —
        # write it now the lock is released
        self.mps._flush_manifest()
        self.mps.record_scale_event("up")
        self._last_event = now
        self._above_since = None
        warmed = self._prewarm(pod) if self.policy.prewarm else 0
        ev = ScaleEvent(now, "up", pod.name, load,
                        len(self.mps.pods_snapshot()), predicted=predicted)
        # modeled_s: the fleet's init EMA — the modeled lead time before
        # the new pod does useful work (the quantity the predictive
        # trigger bet on); the calibration ledger folds it so scale-up
        # decisions are auditable on the same scale as admissions
        _, init = fleet_units(self.mps.pods_snapshot())
        fleet_event("scale-up", pod=pod.name, load=load, n_pods=ev.n_pods,
                    predicted=predicted, modeled_s=init, warmed=warmed)
        self.events.append(ev)
        return ev

    def _prewarm(self, pod: Pod) -> int:
        """Warm the new pod's operator path with the fleet's queued jobs.

        The executor operator cache is process-shared, so building the
        queued jobs' operators under the new pod's memory budget and on
        its device (the budget decides plain-vs-stream; both are in the
        cache key) means the work the pod was spawned to absorb admits
        without the kernel-build stall.  Best-effort: a job that cannot
        build fails later at its own admission, never the scale-up."""
        from .executor import prewarm_jobs
        jobs = []
        for p in self.mps.pods_snapshot():
            try:
                jobs.extend(r.job
                            for r in p.scheduler.queue.pending_records())
            except Exception:
                continue        # a pod mid-retire: skip its queue
        if not jobs:
            return 0
        return prewarm_jobs(jobs, pod.spec.memory,
                            devices=[pod.pool.slots[0].device])

    def scale_up_for(self, job) -> Optional[Pod]:
        """Submit-time hook (``MultiPodScheduler.submit``): a job fits no
        live pod — add the first template pod that could hold it, if the
        fleet may still grow.  This is the strongest scale-up signal, so
        it bypasses both the backlog window and the cooldown (the
        cooldown guards against load-signal thrash; here the
        alternative is failing a placeable job *permanently* with the
        budget error because of an unrelated earlier event) — only
        ``max_pods`` still bounds it.  Returns the new pod, or None
        (the job then takes the canonical budget failure)."""
        now = self.clock()
        p = self.policy
        if len(self.mps.pods_snapshot(live_only=False)) >= p.max_pods:
            return None
        for i, spec in enumerate(self.templates):
            try:
                fp = estimate_job_footprint(job, spec.memory)
            except Exception:
                continue
            if fp.bytes_on_device <= int(spec.memory.usable):
                ev = self._scale_up(now, self.fleet_load(),
                                    template_index=i)
                return self.mps._pod_by(ev.pod) if ev is not None else None
        return None

    # ---- scale down --------------------------------------------------------

    def _scale_down(self, now: float, load: float,
                    pods: Sequence[Pod]) -> Optional[ScaleEvent]:
        """Drain the least-loaded pod to the survivors and retire it."""
        unit, init = fleet_units(pods)
        victim = min(pods, key=lambda q: (pod_load(q.scheduler,
                                                   q.n_devices,
                                                   unit=unit, init=init),
                                          q.name))
        survivors = [q for q in pods if q is not victim]
        victim.draining = True        # routing/stealing skip it from here
        try:
            with self.mps.transfer_guard():
                moved = drain_pod(
                    victim, survivors, self.mps.transfer_dir,
                    data_refs=self.mps.data_refs,
                    timeout=self.policy.drain_timeout_seconds)
            self.mps.remove_pod(victim)
        except Exception:
            # aborted drain (unmovable job / timeout / a pinned submit
            # that slipped in before remove_pod): the pod stays in
            # service.  drain_pod resumes admission only when *it*
            # raised, so resume here too — a pod back in service with
            # admission still paused would strand its queue forever.
            victim.scheduler.resume_admission()
            victim.draining = False
            self.aborted_scale_downs += 1
            self._last_event = now    # still a cooldown: don't retry-spin
            self._below_since = None
            return None
        self.drained_jobs.extend(moved)
        self.mps.record_scale_event("down")
        self._last_event = now
        self._below_since = None
        ev = ScaleEvent(now, "down", victim.name, load,
                        len(self.mps.pods_snapshot()))
        fleet_event("scale-down", pod=victim.name, load=load,
                    n_pods=ev.n_pods, moved=len(moved))
        self.events.append(ev)
        return ev

    # ---- reporting ---------------------------------------------------------

    def summary(self) -> Dict:
        """Control-loop audit: the scale decisions taken plus the
        calibration ledger's verdict on the cost models those decisions
        rode on (samples folded per event kind, and the pods whose
        models have EMA-drifted stale).  The ledger reads the live
        fleet event log, so this is empty unless tracing was enabled."""
        led = CalibrationLedger.from_events()
        return {
            "scale_ups": sum(1 for e in self.events
                             if e.direction == "up"),
            "scale_downs": sum(1 for e in self.events
                               if e.direction == "down"),
            "predicted_scale_ups": sum(1 for e in self.events
                                       if e.predicted),
            "aborted_scale_downs": self.aborted_scale_downs,
            "drained_jobs": len(self.drained_jobs),
            "calibration_samples_by_kind": led.samples_by_kind(),
            "calibration_events_by_kind": led.events_by_kind(),
            "stale_pods": led.stale_pods(),
        }
