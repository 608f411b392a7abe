"""``repro_torch.serve`` — multi-tenant reconstruction job serving.

Port of ``repro.serve``.  A :class:`ReconJob`
(geometry + data + algorithm + priority) is submitted to a
:class:`Scheduler`, which

* estimates the job's per-device footprint off the shared memoized
  execution plan (:func:`repro_torch.core.plan.plan` — the same IR the
  executors run),
* packs several small jobs per device and routes oversized jobs through
  the out-of-core streaming executors,
* interleaves one outer iteration per job per quantum (fair share) using
  the step-wise algorithm iterators in
  :mod:`repro_torch.core.algorithms.stepwise`,
* preempts lower-priority work for urgent arrivals — per device, evicting
  only the cheapest victim set on the one slot where eviction makes the
  arrival fit — checkpointing the evicted job's resumable state so it
  later finishes bit-identically,
* rejects jobs whose ``deadline_seconds`` cannot be met under the modeled
  completion time (observed init/step costs),
* exposes throughput / latency metrics (:class:`ServeMetrics`).

Two drivers share that scheduler core: the cooperative single-thread
``Scheduler.run()`` loop, and the threaded :class:`AsyncDriver` (one
worker per slot, each on its slot's CUDA stream, plus a background
admission/snapshot thread) whose durable snapshots +
:meth:`Scheduler.restore` survive process death.  The snapshot format is
the reference's: the port restores the reference's snapshots.

Past one pod, :mod:`repro_torch.serve.pool` runs one scheduler per *pod*
(a list of ``torch.device``s, optionally derived from a
``launch.mesh`` pod mesh): :class:`MultiPodScheduler` routes each
submission to the pod whose topology models the cheapest completion, and
:mod:`repro_torch.serve.steal` lets idle pods steal parked jobs from
loaded ones (and migrate running ones) through the durable-snapshot
format, so a moved job resumes bit-identically on the thief.
:class:`MultiPodDriver` threads the whole fleet, and :class:`Autoscaler`
(:mod:`repro_torch.serve.autoscale`) grows it from :class:`PodSpec`
templates under load and shrinks it by draining the least-loaded pod.
With a ``snapshot_root``, ``snapshot_fleet`` / ``drain_fleet`` persist
membership + parked jobs and ``MultiPodScheduler.restore_fleet`` rebuilds
the fleet (the reference's ``fleet.json``: each package restores the
other's).

Quick start::

    from repro_torch.serve import AsyncDriver, DevicePool, ReconJob, Scheduler
    from repro_torch.core.splitting import MemoryModel

    sched = Scheduler(pool=DevicePool(2, MemoryModel()))   # 2 slots, cuda
    jid = sched.submit(ReconJob("cgls", geo, angles, proj, n_iter=10,
                                priority=1))
    AsyncDriver(sched).run()
    image = sched.result(jid)        # numpy, on the host
"""

from .job import JobRecord, JobStatus, ReconJob
from .queue import PriorityJobQueue
from .executor import JobExecutor, clear_operator_cache
from .metrics import ServeMetrics, merge_metrics, percentile
from .scheduler import (DevicePool, DeviceSlot, JobFootprint, Scheduler,
                        estimate_job_footprint, fair_share_weight)
from .driver import AsyncDriver, MultiPodDriver
from .pool import (MultiPodScheduler, Pod, PodSpec, RetiredPodSummary,
                   modeled_job_seconds, pods_from_mesh)
from .steal import (StealPolicy, drain_pod, migrate_once, steal_once,
                    steal_pass)
from .autoscale import Autoscaler, AutoscalePolicy, ScaleEvent

__all__ = ["ReconJob", "JobRecord", "JobStatus", "PriorityJobQueue",
           "JobExecutor", "clear_operator_cache", "ServeMetrics",
           "merge_metrics", "percentile", "DevicePool", "DeviceSlot",
           "JobFootprint", "Scheduler", "estimate_job_footprint",
           "fair_share_weight", "AsyncDriver", "MultiPodDriver",
           "MultiPodScheduler", "Pod", "PodSpec", "RetiredPodSummary",
           "modeled_job_seconds",
           "pods_from_mesh", "StealPolicy", "drain_pod", "migrate_once",
           "steal_once", "steal_pass", "Autoscaler", "AutoscalePolicy",
           "ScaleEvent"]
