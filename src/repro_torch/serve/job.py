"""Job specification and lifecycle records for the serving layer.

Port of ``repro/serve/job.py``: the projections may also be a torch
tensor, and ``backend`` takes the port's names.

A :class:`ReconJob` is the unit of work accepted by the scheduler: one
reconstruction (geometry + angles + projection data + algorithm + iteration
budget), annotated with a priority and an optional memory hint.  The
projection data may be given as a concrete array or as a zero-argument
callable (a *data ref*) that is resolved lazily only when the job is
admitted — queued jobs then cost no host memory.

:class:`JobRecord` is the scheduler's bookkeeping for one job: status,
timing, placement, preemption count, and (once finished) the result.
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch

from ..core.geometry import ConeGeometry

Projections = Union[np.ndarray, torch.Tensor]


class JobStatus(enum.Enum):
    PENDING = "pending"        # queued, not yet placed
    RUNNING = "running"        # placed on a device, being stepped
    PREEMPTED = "preempted"    # checkpointed + requeued by a higher prio job
    COMPLETED = "completed"
    FAILED = "failed"
    CANCELLED = "cancelled"
    STOLEN = "stolen"          # exported to another pod (terminal *here*)


_job_counter = itertools.count()


@dataclasses.dataclass
class ReconJob:
    """One reconstruction request.

    Parameters
    ----------
    algorithm : registry name (``repro.core.algorithms.stepwise.REGISTRY``):
        "cgls", "ossart", "sirt", "sart", "fista", "asd_pocs", "fdk", ...
    geo, angles : acquisition geometry and gantry angles.
    projections : ``(n_angles, nv, nu)`` numpy array or torch tensor, **or**
        a zero-arg callable returning one (lazy data ref, resolved at
        admission).  A CUDA tensor is read on the stream of the slot the
        job is placed on, after the work queued before the submission on
        the submitting thread's stream.
    n_iter : outer-iteration budget (ignored for direct algorithms).
    priority : higher values are scheduled first and may preempt lower ones.
    params : extra keyword arguments for the algorithm's ``init``.
    memory_hint_bytes : optional override of the planner's footprint
        estimate (0 = use the estimate).
    mode : force the execution mode ("plain" | "stream"); ``None`` lets
        the scheduler choose from the footprint vs. the device budget.
    backend : kernel backend for the job's operators ("ref" | "cuda");
        ``None`` = "auto" (the CUDA kernels on a CUDA device, the plain
        versions on the CPU — see :mod:`repro_torch.core.backend`).
    deadline_seconds : SLO budget measured from submission (0 = none).  At
        admission the scheduler models the job's completion time from the
        observed init/step costs and *rejects* the job outright if the
        model says the deadline cannot be met — failing fast beats burning
        device time on a reconstruction that will be late anyway.
    """

    algorithm: str
    geo: ConeGeometry
    angles: np.ndarray
    projections: Union[Projections, Callable[[], Projections]]
    n_iter: int = 10
    priority: int = 0
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    memory_hint_bytes: int = 0
    mode: Optional[str] = None
    backend: Optional[str] = None
    deadline_seconds: float = 0.0
    job_id: str = ""

    #: event recorded at submission on the submitting thread's stream
    #: when the projections are a CUDA tensor (see :meth:`resolve_projections`)
    _ready: Optional[Any] = dataclasses.field(default=None, init=False,
                                              repr=False, compare=False)

    def __post_init__(self):
        if not self.job_id:
            self.job_id = f"job-{next(_job_counter):05d}"
        self.angles = np.asarray(self.angles, np.float32)
        if isinstance(self.projections, torch.Tensor) and \
                self.projections.is_cuda:
            self._ready = torch.cuda.Event()
            self._ready.record(
                torch.cuda.current_stream(self.projections.device))

    @property
    def n_angles(self) -> int:
        return len(self.angles)

    def resolve_projections(self) -> Projections:
        """The projections: a torch tensor as given (its producer's work
        ordered before the current stream), anything else as numpy."""
        proj = (self.projections() if callable(self.projections)
                else self.projections)
        if isinstance(proj, torch.Tensor):
            if self._ready is not None and proj is self.projections:
                torch.cuda.current_stream(proj.device).wait_event(
                    self._ready)
            return proj
        return np.asarray(proj)


@dataclasses.dataclass
class JobRecord:
    """Scheduler-side lifecycle record for one submitted job."""
    job: ReconJob
    seq: int                                  # submission order (FIFO tiebreak)
    status: JobStatus = JobStatus.PENDING
    submit_time: float = 0.0
    start_time: Optional[float] = None        # first admission
    end_time: Optional[float] = None
    iterations_done: int = 0
    preemptions: int = 0
    device: Optional[int] = None
    footprint_bytes: int = 0
    streamed: bool = False                    # routed through out-of-core path
    checkpoint: Optional[Dict[str, Any]] = None
    result: Optional[np.ndarray] = None       # on the host
    error: Optional[str] = None

    @property
    def latency(self) -> Optional[float]:
        """Submit-to-completion wall-clock seconds (None while in flight)."""
        if self.end_time is None:
            return None
        return self.end_time - self.submit_time

    @property
    def queue_wait(self) -> Optional[float]:
        if self.start_time is None:
            return None
        return self.start_time - self.submit_time

    @property
    def done(self) -> bool:
        return self.status in (JobStatus.COMPLETED, JobStatus.FAILED,
                               JobStatus.CANCELLED, JobStatus.STOLEN)
