"""Step-wise job executor: one placed job's operator + algorithm state.

Port of ``repro/serve/executor.py``.  The executor owns what the scheduler
placed on a device: it builds the :class:`~repro_torch.core.operator.
CTOperator` on the slot's device ("plain" for resident jobs packed next
to other tenants, "stream" for jobs routed through the paper's
out-of-core path), instantiates the algorithm's resumable state from the
step-wise registry, and advances it one outer iteration per call.  Between
any two calls the scheduler may checkpoint the executor (preemption) and
later rebuild it from the checkpoint — results are bit-identical to an
uninterrupted run because ``init`` is deterministic, the checkpoint
carries every recurrence variable and every kernel's repeat launch gives
the same bits.

On a CUDA slot every call runs with the slot's device and stream current
(:meth:`JobExecutor.on_slot`), whichever thread makes it: a job's tensors
are allocated and used on that one stream, and ``step`` returns once the
stream has finished the iteration.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from .. import obs
from ..core.algorithms.stepwise import (checkpoint_state, get_algorithm,
                                        restore_state)
from ..core.backend import resolve as resolve_backend
from ..core.device import resolve_device
from ..core.operator import CTOperator
from ..core.plan import plan as plan_execution
from ..core.splitting import MemoryModel
from ..kernels import autotune
from .job import ReconJob

# Operator cache shared across jobs: tenants with the same acquisition
# (geometry + angles + backend + weighting + budget + device) reuse one
# CTOperator, its dispatch entries and its uploaded angle tables.  Bounded
# LRU so a long-lived scheduler serving many distinct geometries cannot
# grow without limit.  Two slots on one card share an operator: what it
# holds on the device (angles, index and plane tables) is written once,
# by a synchronous copy, and only read after; a streamed call stages
# through buffers and streams of its own.
_OP_CACHE_MAX = 32
_op_cache: "OrderedDict[tuple, CTOperator]" = OrderedDict()
_op_cache_lock = threading.Lock()   # admission may run in several schedulers


def clear_operator_cache() -> None:
    """Drop all cached operators."""
    with _op_cache_lock:
        _op_cache.clear()


def _get_operator(geo, angles: np.ndarray, mode: str, bp_weight: str,
                  memory: MemoryModel, devices: Optional[Sequence],
                  backend: Optional[str] = None) -> CTOperator:
    device = resolve_device(devices[0] if devices else None)
    backend = resolve_backend(backend, device)   # None and its target share
    # autotune.fingerprint(): a retuned or reloaded tile table must not
    # reuse operators built under the previous tile configurations
    key = (geo, angles.tobytes(), mode, bp_weight, backend,
           memory.device_bytes, memory.usable_fraction,
           autotune.fingerprint(), str(device))
    with _op_cache_lock:
        op = _op_cache.get(key)
        if op is not None:
            _op_cache.move_to_end(key)
            return op
    op = CTOperator(geo, angles, mode=mode, bp_weight=bp_weight,
                    memory=memory, backend=backend, device=device)
    with _op_cache_lock:
        _op_cache[key] = op
        if len(_op_cache) > _OP_CACHE_MAX:
            _op_cache.popitem(last=False)
    return op


def prewarm_jobs(jobs: Sequence[ReconJob], memory: MemoryModel,
                 devices: Optional[Sequence] = None) -> int:
    """Warm the shared operator cache for ``jobs`` ahead of admission.

    Builds (or touches) each job's :class:`CTOperator` under the same
    cache key admission will use — mode mirrors the scheduler's
    ``stream-if-it-splits`` decision, weighting the algorithm's default —
    and builds and loads its kernels, so the first admitted job skips
    that stall.  Deduplicates by key, never raises (a job whose geometry
    cannot build fails admission later, with the error attributed to that
    job); returns the number of operators warmed.
    """
    from .scheduler import estimate_job_footprint
    warmed = 0
    seen = set()
    for job in jobs:
        try:
            alg = get_algorithm(job.algorithm)
            fp = estimate_job_footprint(job, memory)
            mode = "stream" if fp.streams else "plain"
            dedup = (job.geo, job.angles.tobytes(), mode,
                     alg.default_bp_weight, job.backend)
            if dedup in seen:
                continue
            seen.add(dedup)
            op = _get_operator(job.geo, job.angles, mode,
                               alg.default_bp_weight, memory, devices,
                               backend=job.backend)
            op.warmup()
            warmed += 1
        except Exception:
            continue
    return warmed


def operator_cache_keys() -> tuple:
    """Current operator-cache keys (regression tests assert pre-warm)."""
    with _op_cache_lock:
        return tuple(_op_cache)


def on_device(device, stream=None):
    """Context in which CUDA ``device`` and ``stream`` (when given) are
    current; a null context for any other device."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    stack.enter_context(torch.cuda.device(device))
    if stream is not None:
        stack.enter_context(torch.cuda.stream(stream))
    return stack


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def _block_on_state(state) -> None:
    """Wait until the current stream of every CUDA device that holds a
    tensor of ``state`` has finished its work.

    Kernel launches return as soon as the work is *enqueued*, so a
    wall-clock measurement around ``alg.step`` would time the enqueue, not
    the compute.  The step ran on the current stream (the slot's), so
    synchronising it makes the step boundary a real synchronisation
    point — step timings, per-device busy clocks and the modeled makespan
    all depend on it.  A state on the CPU needs none."""
    devices = {t.device for t in _tensors(vars(state)) if t.is_cuda}
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()


class JobExecutor:
    """Runs one :class:`ReconJob` step by step on its assigned backend.

    ``devices`` holds the slot's device (None: the current CUDA device)
    and ``stream`` the slot's CUDA stream (None: the caller's current
    stream)."""

    def __init__(self, job: ReconJob, mode: str,
                 memory: Optional[MemoryModel] = None,
                 devices: Optional[Sequence] = None,
                 labels: Optional[Dict[str, Any]] = None,
                 stream: Optional[torch.cuda.Stream] = None):
        self.job = job
        self.alg = get_algorithm(job.algorithm)
        self.mode = mode
        self.memory = memory or MemoryModel()
        self.devices = devices
        self.stream = stream
        # ambient trace identity (pod name, device slot) merged into every
        # span this executor's work opens — streaming-loop spans inherit
        # it without new plumbing through the operator call signatures
        self.labels = {k: v for k, v in (labels or {}).items()
                       if v is not None}
        self._state = None
        self.init_seconds = 0.0
        # span-category seconds from the most recent start()/step(),
        # drained by the scheduler into ServeMetrics.phase_seconds
        self._phase_delta: Dict[str, float] = {}

    def on_slot(self):
        """Context in which the slot's device and stream are current (a
        null context on the CPU)."""
        return on_device(resolve_device(self.devices[0] if self.devices
                                        else None), self.stream)

    def take_phase_seconds(self) -> Dict[str, float]:
        out, self._phase_delta = self._phase_delta, {}
        return out

    @property
    def step_transfer_bytes(self) -> int:
        """Schedule-modeled host<->device bytes one outer iteration of a
        *streamed* job moves (0 for in-core jobs — their operands stay
        resident).  Read off the plan's CommSchedule, so chunk reuse is
        reflected; the scheduler divides the step's observed staging
        phase seconds into this to feed its measured-bandwidth EMA."""
        if self.mode != "stream":
            return 0
        try:
            p = plan_execution(self.job.geo, len(self.job.angles), 1,
                               self.memory)
        except Exception:
            return 0
        return p.comm.bytes_moved()

    @staticmethod
    def _phase_diff(after: Dict[str, float],
                    before: Dict[str, float]) -> Dict[str, float]:
        return {k: v - before.get(k, 0.0) for k, v in after.items()
                if v - before.get(k, 0.0) > 0.0}

    @property
    def total_steps(self) -> int:
        return max(1, self.job.n_iter) if self.alg.iterative else 1

    @property
    def iterations_done(self) -> int:
        return 0 if self._state is None else int(self._state.it)

    @property
    def started(self) -> bool:
        return self._state is not None

    @property
    def done(self) -> bool:
        return self.started and self.iterations_done >= self.total_steps

    def start(self, checkpoint: Optional[Dict[str, Any]] = None) -> None:
        """Resolve data, build the operator, init (or restore) the state."""
        tracer = obs.get_tracer()
        before = (tracer.thread_phase_seconds() if tracer.enabled else None)
        t0 = time.monotonic()
        with self.on_slot(), \
                obs.context(job=self.job.job_id, **self.labels), \
                obs.span("init", "init", alg=self.job.algorithm,
                         mode=self.mode):
            proj = self.job.resolve_projections()
            op = _get_operator(self.job.geo, self.job.angles, self.mode,
                               self.alg.default_bp_weight, self.memory,
                               self.devices, backend=self.job.backend)
            kcfg = op.kernel_config()
            if kcfg:
                obs.event("kernel-config", backend=op.backend_name, **kcfg)
            params = dict(self.job.params)
            if checkpoint is not None:
                # feed checkpointed scalars back through init so restore
                # does not recompute them (e.g. FISTA's power-iteration L)
                for k in self.alg.resume_params:
                    if k in checkpoint:
                        params[k] = checkpoint[k]
            state = self.alg.init(proj, self.job.geo, self.job.angles,
                                  op=op, **params)
            if checkpoint is not None:
                state = restore_state(self.alg, state, checkpoint)
            _block_on_state(state)
        self._state = state
        self.init_seconds = time.monotonic() - t0
        if before is not None:
            self._phase_delta = self._phase_diff(
                tracer.thread_phase_seconds(), before)

    def step(self) -> int:
        """Advance one outer iteration; returns iterations done so far.

        Returns once the iteration's compute has actually finished (not
        just been enqueued), so the caller's ``dt`` around this call is
        honest compute time."""
        if self._state is None:
            raise RuntimeError(f"{self.job.job_id}: step() before start()")
        tracer = obs.get_tracer()
        with self.on_slot():
            if not tracer.enabled:
                self._state = self.alg.step(self._state)
                _block_on_state(self._state)
                return self.iterations_done
            # Trace path: ambient job/pod/device context tags every span
            # the operators open underneath.  Streamed jobs emit their own
            # h2d/compute/d2h leaf spans; plain (in-core) steps are
            # wrapped in one compute span so phase attribution covers
            # them too.
            before = tracer.thread_phase_seconds()
            with obs.context(job=self.job.job_id, **self.labels):
                if self.mode == "plain":
                    with obs.span("step", "compute",
                                  alg=self.job.algorithm,
                                  it=self.iterations_done):
                        self._state = self.alg.step(self._state)
                        _block_on_state(self._state)
                else:
                    self._state = self.alg.step(self._state)
                    _block_on_state(self._state)
        self._phase_delta = self._phase_diff(
            tracer.thread_phase_seconds(), before)
        return self.iterations_done

    def checkpoint(self) -> Dict[str, Any]:
        """Host-side snapshot of the resumable state (for preemption)."""
        if self._state is None:
            raise RuntimeError(f"{self.job.job_id}: no state to checkpoint")
        with self.on_slot():
            return checkpoint_state(self.alg, self._state)

    def result(self) -> np.ndarray:
        """The finished image, copied to the host."""
        with self.on_slot():
            return self.alg.finalize(self._state).detach().cpu().numpy()

    def release(self) -> None:
        """Drop the state so device buffers can be reclaimed."""
        self._state = None
