"""Threaded serving driver: one worker thread per device slot.

Port of the single-pod half of ``repro/serve/driver.py``: each worker
makes its slot's device and CUDA stream current for its whole loop, so
two slots on one card step their jobs on two streams at once.

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
