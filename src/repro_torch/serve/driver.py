"""Threaded serving driver: one worker thread per device slot.

Port of ``repro/serve/driver.py``: each worker makes its slot's device
and CUDA stream current for its whole loop, so two slots on one card step
their jobs on two streams at once, and so do two pods' slots.

The cooperative :meth:`Scheduler.run` loop steps every device's jobs from
a single thread, so on a real multi-accelerator host only one device
computes at a time.  The :class:`AsyncDriver` realises the paper's "each
of these instructions is executed for all available GPUs simultaneously"
at the serving layer:

* one **worker thread per** :class:`~repro_torch.serve.scheduler.DeviceSlot`
  claims that device's resident jobs (weighted fair share via stride
  scheduling — see :meth:`Scheduler.claim_step`) and steps them with the
  scheduler lock *released*, so devices genuinely overlap;
* a background **scheduler thread** handles admission, deadline checks
  and preemption, and — when a snapshot directory is configured — writes
  periodic durable snapshots of every parked job through
  :mod:`repro_torch.checkpoint.sharded`;
* the attached :class:`~repro_torch.checkpoint.preemption.PreemptionGuard`
  (SIGTERM) stops the loop; :meth:`AsyncDriver.run` then drains the
  scheduler, parking + persisting every running job so a restarted
  process resumes them bit-identically via :meth:`Scheduler.restore`.

Workers synchronise with the scheduler only at step boundaries — a job
mid-step is never checkpointed (its state would be torn); preemption and
drain requests are flagged and honoured when the step returns, which the
executor guarantees is a real synchronisation point (it synchronises
the slot's stream before returning).

:class:`MultiPodDriver` lifts the same model to a pod fleet
(:class:`~repro_torch.serve.pool.MultiPodScheduler`): one ``AsyncDriver``
per pod plus a background work-stealing / autoscaling thread
(:mod:`repro_torch.serve.steal`, :mod:`repro_torch.serve.autoscale`).

Usage::

    sched = Scheduler(n_devices=4, memory=MemoryModel(...),
                      snapshot_dir="/ckpt/serve")
    for job in jobs:
        sched.submit(job)
    AsyncDriver(sched).run()            # start + wait idle + stop
    image = sched.result(job_id)
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional

from .executor import on_device
from .metrics import ServeMetrics
from .scheduler import DeviceSlot, Scheduler


class AsyncDriver:
    """Drives a :class:`Scheduler` with one thread per device slot plus a
    background admission/snapshot thread.

    Parameters
    ----------
    scheduler : the (thread-safe) scheduler to drive.
    poll_seconds : idle back-off for the worker/scheduler loops.
    snapshot_dir : where periodic + drain snapshots go; defaults to
        ``scheduler.snapshot_dir`` (None disables persistence).
    snapshot_every_seconds : period of the background durable snapshots
        (0 disables; drain still persists).
    snapshot_running : include *running* jobs in the periodic snapshot
        (copy-on-checkpoint at step boundaries, see
        :meth:`Scheduler.snapshot`) so a kill -9 mid-run resumes each
        job from its last persisted completed step instead of its last
        parked state.  On by default; False restores the parked-only
        behaviour.
    """

    def __init__(self, scheduler: Scheduler, poll_seconds: float = 0.001,
                 snapshot_dir: Optional[str] = None,
                 snapshot_every_seconds: float = 0.0,
                 snapshot_running: bool = True):
        self.scheduler = scheduler
        self.poll_seconds = poll_seconds
        self.snapshot_dir = snapshot_dir or scheduler.snapshot_dir
        self.snapshot_every_seconds = snapshot_every_seconds
        self.snapshot_running = snapshot_running
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        # first *internal* error (scheduler/snapshot machinery, not tenant
        # code — tenant failures fail their job alone); stops the driver
        # so run()/wait() surface it instead of hanging forever
        self.error: Optional[BaseException] = None

    def _die(self, err: BaseException) -> None:
        if self.error is None:
            self.error = err
        self._stop.set()

    # ---- lifecycle ---------------------------------------------------------

    @property
    def started(self) -> bool:
        return bool(self._threads)

    def start(self) -> None:
        """Spawn the scheduler thread and one worker per device slot."""
        if self.started:
            raise RuntimeError("driver already started")
        self._stop.clear()
        m = self.scheduler.metrics
        if m.wall_start is None:
            m.wall_start = time.monotonic()
        self._threads = [threading.Thread(
            target=self._scheduler_loop, name="serve-scheduler", daemon=True)]
        for slot in self.scheduler.pool.slots:
            self._threads.append(threading.Thread(
                target=self._worker_loop, args=(slot,),
                name=f"serve-worker-{slot.index}", daemon=True))
        for t in self._threads:
            t.start()

    def stop(self) -> None:
        """Stop all threads at their next step boundary and join them.
        In-flight steps finish; nothing is lost or torn."""
        self._stop.set()
        for t in self._threads:
            t.join()
        self._threads = []
        self.scheduler.metrics.wall_end = time.monotonic()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the scheduler is idle (all jobs in a terminal
        state), the guard fires, or ``timeout`` elapses.  Returns True if
        idle was reached."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if self.scheduler.idle:
                return True
            if self.error is not None:
                return False
            guard = self.scheduler.guard
            if guard is not None and guard.preempted:
                return False
            if deadline is not None and time.monotonic() > deadline:
                return False
            time.sleep(self.poll_seconds)

    def run(self, timeout: Optional[float] = None) -> ServeMetrics:
        """start() + wait() + stop(), draining on guard preemption.

        The one-call equivalent of the cooperative ``Scheduler.run()``,
        with true per-device overlap.  If the guard fired (host SIGTERM),
        every running job is parked and — when a snapshot directory is
        configured — persisted durably before returning."""
        self.start()
        try:
            self.wait(timeout)
        finally:
            self.stop()
        if self.error is not None:
            raise RuntimeError(
                "AsyncDriver stopped on an internal error") from self.error
        guard = self.scheduler.guard
        if guard is not None and guard.preempted:
            self.scheduler.drain(self.snapshot_dir)
        return self.scheduler.metrics

    # ---- loops -------------------------------------------------------------

    def _scheduler_loop(self) -> None:
        sched = self.scheduler
        last_snap = time.monotonic()
        try:
            while not self._stop.is_set():
                guard = sched.guard
                if guard is not None and guard.preempted:
                    return      # run()/wait() own the drain
                sched.admit()
                if (self.snapshot_dir is not None
                        and self.snapshot_every_seconds > 0
                        and time.monotonic() - last_snap
                        >= self.snapshot_every_seconds):
                    sched.snapshot(self.snapshot_dir,
                                   include_running=self.snapshot_running)
                    last_snap = time.monotonic()
                time.sleep(self.poll_seconds)
        except BaseException as e:      # a dead loop would hang run()
            self._die(e)

    def _worker_loop(self, slot: DeviceSlot) -> None:
        try:
            with on_device(slot.device, slot.stream):
                self._step_slot(slot)
        except BaseException as e:      # a dead loop would hang run()
            self._die(e)

    def _step_slot(self, slot: DeviceSlot) -> None:
        sched = self.scheduler
        while not self._stop.is_set():
            run = sched.claim_step(slot)
            if run is None:
                time.sleep(self.poll_seconds)
                continue
            t0 = time.monotonic()
            err: Optional[Exception] = None
            try:
                # outside the scheduler lock: where devices overlap
                run.executor.step()
            except Exception as e:  # tenant failure, not ours
                err = e
            sched.finish_step(run, time.monotonic() - t0, err)


class MultiPodDriver:
    """Threaded fleet driver: one :class:`AsyncDriver` per pod plus a
    background control thread (work stealing + autoscaling + membership
    sync).

    Every pod's workers step their own devices concurrently (pods share
    nothing but the transfer directory).  The control thread
    periodically runs :meth:`MultiPodScheduler.steal_pass` so an idle
    pod's workers find stolen jobs in their scheduler's queue at their
    next admission pass, gives the attached
    :class:`~repro_torch.serve.autoscale.Autoscaler` (if any) one control
    decision, and *syncs membership*: a pod the autoscaler added gets
    its own ``AsyncDriver`` started, a retired pod's driver is stopped.
    Internal errors from any pod's driver (or from the steal /
    autoscale machinery) stop the whole fleet and are raised from
    :meth:`run` — a silently dead pod would strand its queue.

    ``snapshot_every_seconds`` > 0 turns on periodic durable snapshots
    on every pod driver (each pod persists parked jobs into its own
    snapshot subdirectory — see ``MultiPodScheduler.snapshot_root``), so
    a kill -9 mid-run loses at most one period of parked-state changes
    and :meth:`MultiPodScheduler.restore_fleet` rebuilds the fleet.  If
    a pod scheduler's guard fires (host SIGTERM), :meth:`run` drains the
    whole fleet into its snapshot root before returning.

    Usage::

        mps = MultiPodScheduler(pods, transfer_dir=...)
        for job in jobs:
            mps.submit(job)
        MultiPodDriver(mps).run()
        image = mps.result(job_id)
    """

    def __init__(self, mps, poll_seconds: float = 0.001,
                 steal_every_seconds: float = 0.002,
                 autoscaler=None,
                 snapshot_every_seconds: float = 0.0):
        self.mps = mps
        self.poll_seconds = poll_seconds
        self.steal_every_seconds = steal_every_seconds
        self.autoscaler = autoscaler
        self.snapshot_every_seconds = snapshot_every_seconds
        self._dlock = threading.RLock()
        self._drivers: dict = {}         # pod name -> AsyncDriver
        self._started = False
        self._stop = threading.Event()
        self._control_thread: Optional[threading.Thread] = None
        self.error: Optional[BaseException] = None
        for pod in mps.pods_snapshot(live_only=False):
            self.attach_pod(pod)

    @property
    def drivers(self):
        with self._dlock:
            return list(self._drivers.values())

    # ---- dynamic membership ------------------------------------------------

    def attach_pod(self, pod) -> AsyncDriver:
        """Give ``pod`` its own :class:`AsyncDriver` (started immediately
        if the fleet is already running).  The control thread calls this
        for pods the autoscaler adds; it is idempotent per pod name."""
        with self._dlock:
            d = self._drivers.get(pod.name)
            if d is not None:
                return d
            d = AsyncDriver(pod.scheduler, poll_seconds=self.poll_seconds,
                            snapshot_every_seconds=self.snapshot_every_seconds)
            self._drivers[pod.name] = d
            if self._started:
                d.start()
            return d

    def detach_pod(self, pod_name: str) -> None:
        """Stop and drop a retired pod's driver (its scheduler is empty
        by the time the autoscaler removes it from the fleet)."""
        with self._dlock:
            d = self._drivers.pop(pod_name, None)
        if d is not None and d.started:
            d.stop()

    def _sync_pods(self) -> None:
        """Reconcile the driver set with the fleet's current membership
        snapshot: attach new pods, detach retired ones."""
        live = {p.name: p
                for p in self.mps.pods_snapshot(live_only=False)}
        with self._dlock:
            known = set(self._drivers)
        for name in known - set(live):
            self.detach_pod(name)
        for name, pod in live.items():
            if name not in known:
                self.attach_pod(pod)

    # ---- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self._stop.clear()
        self._started = True
        self._sync_pods()
        for d in self.drivers:
            if not d.started:
                d.start()
        self._control_thread = threading.Thread(
            target=self._control_loop, name="serve-fleet-control",
            daemon=True)
        self._control_thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._control_thread is not None:
            self._control_thread.join()
            self._control_thread = None
        for d in self.drivers:
            if d.started:
                d.stop()
        self._started = False

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until every pod is idle, any pod errors, a guard fires,
        or ``timeout``."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if self.mps.idle:
                return True
            for d in self.drivers:
                if d.error is not None:
                    self.error = self.error or d.error
                    return False
            if self.error is not None:
                return False
            if self._guard_preempted():
                return False
            if deadline is not None and time.monotonic() > deadline:
                return False
            time.sleep(self.poll_seconds)

    def _guard_preempted(self) -> bool:
        for pod in self.mps.pods_snapshot(live_only=False):
            g = pod.scheduler.guard
            if g is not None and g.preempted:
                return True
        return False

    def run(self, timeout: Optional[float] = None) -> ServeMetrics:
        """start() + wait() + stop(); returns merged fleet metrics.  If a
        preemption guard fired (host SIGTERM) and the fleet has a
        snapshot root, every running job is parked and the whole fleet
        persisted durably (:meth:`MultiPodScheduler.drain_fleet`) before
        returning — a re-run restores with ``restore_fleet``."""
        self.start()
        try:
            self.wait(timeout)
        finally:
            self.stop()
        if self.error is not None:
            raise RuntimeError(
                "MultiPodDriver stopped on an internal error") from self.error
        if (self._guard_preempted()
                and getattr(self.mps, "snapshot_root", None) is not None):
            self.mps.drain_fleet()
        return self.mps.metrics()

    def _control_loop(self) -> None:
        try:
            while not self._stop.is_set():
                if self.mps.steal:
                    self.mps.steal_pass()
                # explicit autoscaler wins; otherwise the one that
                # registered itself on the fleet (Autoscaler.__init__
                # sets mps.autoscaler) — without the fallback a driver
                # built without `autoscaler=` would silently leave the
                # fleet half-wired (fits-nowhere hook live, backlog
                # scaling dead)
                asc = self.autoscaler or getattr(self.mps, "autoscaler",
                                                 None)
                if asc is not None:
                    asc.step()
                self._sync_pods()
                time.sleep(self.steal_every_seconds)
        except BaseException as e:      # surface, don't die silently
            self.error = e
            self._stop.set()
