"""Serving metrics: throughput, latency percentiles, device utilisation.

Port of ``repro/serve/metrics.py`` (pure Python).

Wall-clock numbers are measured (``time.monotonic``); *modeled* numbers
additionally use the per-device busy clocks maintained by the pool, which
treat the pool's devices as executing in parallel — on a single-host CPU
test rig the devices are simulated, so the modeled makespan
(``max`` over device busy time) is the honest stand-in for real
multi-accelerator wall-clock, exactly like the paper's per-GPU timelines
(Fig 3/5).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


def percentile(xs: List[float], p: float) -> float:
    """Nearest-rank percentile (p in [0, 100]); 0.0 on empty input."""
    if not xs:
        return 0.0
    s = sorted(xs)
    k = max(0, min(len(s) - 1, int(round(p / 100.0 * (len(s) - 1)))))
    return s[k]


@dataclasses.dataclass
class ServeMetrics:
    """Counters + samples accumulated by one scheduler instance."""
    submitted: int = 0
    completed: int = 0
    failed: int = 0
    cancelled: int = 0
    preemptions: int = 0
    steps: int = 0
    streamed_jobs: int = 0
    deadline_rejected: int = 0      # jobs refused by deadline admission
    stolen_out: int = 0             # parked jobs exported to another pod
    stolen_in: int = 0              # parked jobs imported from another pod

    # -- fleet gauges (maintained by MultiPodScheduler / Autoscaler; zero
    #    on a single-pod scheduler) --
    scale_up_events: int = 0        # pods added by the autoscaler
    scale_down_events: int = 0      # pods drained + retired
    pod_seconds: float = 0.0        # sum over pods of online wall time
    # (monotonic timestamp, live pod count) after each membership change —
    # the pods-online timeline; bounded by the number of scale events
    pods_online: List[Tuple[float, int]] = dataclasses.field(
        default_factory=list)

    step_seconds: List[float] = dataclasses.field(default_factory=list)
    latencies: List[float] = dataclasses.field(default_factory=list)
    queue_waits: List[float] = dataclasses.field(default_factory=list)

    # -- phase-attributed seconds (h2d / compute / d2h / compile / ...),
    #    fed from the obs tracer's span categories by the executor; empty
    #    unless tracing was enabled during the run (zero-overhead default)
    phase_seconds: Dict[str, float] = dataclasses.field(default_factory=dict)

    # -- cost-model calibration gauges (fed by the scheduler at the same
    #    sites that emit the modeled-vs-measured fleet events) --
    # measured host<->device bandwidth the scheduler prices transfers
    # with; None until a traced streamed step has been observed
    bandwidth_ema_bytes_per_s: Optional[float] = None
    # event kind ("admit" / "step") -> signed errors (measured - modeled
    # seconds); positive bias = the cost model is optimistic
    calibration_errors_s: Dict[str, List[float]] = dataclasses.field(
        default_factory=dict)
    # largest single-job footprint the planner committed to a device —
    # the modeled side of the memory-margin gauge (the measured side
    # lives in the trace)
    memory_modeled_peak_bytes: int = 0

    wall_start: Optional[float] = None
    wall_end: Optional[float] = None

    def record_step(self, seconds: float) -> None:
        self.steps += 1
        self.step_seconds.append(seconds)

    def record_phases(self, phases: Dict[str, float]) -> None:
        """Fold one step's (or init's) span-category seconds in."""
        for k, v in phases.items():
            self.phase_seconds[k] = self.phase_seconds.get(k, 0.0) + v

    def record_pods_online(self, t: float, count: int) -> None:
        self.pods_online.append((t, count))

    def record_completion(self, latency: float, queue_wait: float) -> None:
        self.completed += 1
        self.latencies.append(latency)
        self.queue_waits.append(queue_wait)

    def record_calibration(self, kind: str, modeled: Optional[float],
                           measured: Optional[float]) -> None:
        """Fold one modeled-vs-measured observation; one-sided samples
        (cold EMAs model ``None``) are skipped, matching the ledger."""
        if modeled is None or measured is None:
            return
        self.calibration_errors_s.setdefault(kind, []).append(
            measured - modeled)

    # ---- summaries ---------------------------------------------------------

    @property
    def wall_seconds(self) -> float:
        if self.wall_start is None or self.wall_end is None:
            return 0.0
        return self.wall_end - self.wall_start

    @property
    def busy_seconds(self) -> float:
        """Total compute time across all steps (serial-equivalent time)."""
        return sum(self.step_seconds)

    def summary(self, device_busy: Optional[List[float]] = None) -> Dict:
        """Aggregate view; pass the pool's per-device busy clocks to get the
        modeled (device-parallel) makespan and throughput."""
        out = {
            "submitted": self.submitted,
            "completed": self.completed,
            "failed": self.failed,
            "preemptions": self.preemptions,
            "deadline_rejected": self.deadline_rejected,
            "steps": self.steps,
            "streamed_jobs": self.streamed_jobs,
            "stolen_out": self.stolen_out,
            "stolen_in": self.stolen_in,
            "wall_seconds": self.wall_seconds,
            "busy_seconds": self.busy_seconds,
            "latency_p50": percentile(self.latencies, 50),
            "latency_p95": percentile(self.latencies, 95),
            "queue_wait_p50": percentile(self.queue_waits, 50),
            "jobs_per_sec_wall": (self.completed / self.wall_seconds
                                  if self.wall_seconds > 0 else 0.0),
            "scale_up_events": self.scale_up_events,
            "scale_down_events": self.scale_down_events,
            "pod_seconds": self.pod_seconds,
            "pods_online": list(self.pods_online),
            "pods_online_peak": (max(n for _, n in self.pods_online)
                                 if self.pods_online else 0),
            "phase_seconds": dict(self.phase_seconds),
            "bandwidth_ema_bytes_per_s": self.bandwidth_ema_bytes_per_s,
            "staging_seconds": {
                k: self.phase_seconds.get(k, 0.0)
                for k in ("h2d", "prefetch", "d2h")},
            "memory_modeled_peak_bytes": self.memory_modeled_peak_bytes,
            "calibration": {
                kind: {
                    "samples": len(errs),
                    "bias_s": sum(errs) / len(errs),
                    "abs_p95_s": percentile([abs(e) for e in errs], 95),
                }
                for kind, errs in sorted(self.calibration_errors_s.items())
                if errs},
        }
        if device_busy is not None:
            makespan = max(device_busy) if device_busy else 0.0
            out["modeled_makespan_seconds"] = makespan
            out["device_busy_seconds"] = list(device_busy)
            out["jobs_per_sec_modeled"] = (self.completed / makespan
                                           if makespan > 0 else 0.0)
        return out


def merge_metrics(parts: List["ServeMetrics"]) -> "ServeMetrics":
    """Fleet-level view over per-pod metrics: counters sum, samples
    concatenate, and the wall-clock window spans the earliest start to the
    latest end across pods.

    A stolen job is ``submitted`` on its original pod and ``completed`` on
    the thief, so summed counters stay one-per-job; ``stolen_in`` /
    ``stolen_out`` cancel out in aggregate and are reported so the
    imbalance the stealing corrected stays visible per pod."""
    out = ServeMetrics()
    for m in parts:
        out.submitted += m.submitted
        out.completed += m.completed
        out.failed += m.failed
        out.cancelled += m.cancelled
        out.preemptions += m.preemptions
        out.steps += m.steps
        out.streamed_jobs += m.streamed_jobs
        out.deadline_rejected += m.deadline_rejected
        out.stolen_out += m.stolen_out
        out.stolen_in += m.stolen_in
        out.scale_up_events += m.scale_up_events
        out.scale_down_events += m.scale_down_events
        out.pod_seconds += m.pod_seconds
        out.pods_online.extend(m.pods_online)
        out.record_phases(m.phase_seconds)
        for kind, errs in m.calibration_errors_s.items():
            out.calibration_errors_s.setdefault(kind, []).extend(errs)
        out.memory_modeled_peak_bytes = max(out.memory_modeled_peak_bytes,
                                            m.memory_modeled_peak_bytes)
        out.step_seconds.extend(m.step_seconds)
        out.latencies.extend(m.latencies)
        out.queue_waits.extend(m.queue_waits)
        if m.wall_start is not None:
            out.wall_start = (m.wall_start if out.wall_start is None
                              else min(out.wall_start, m.wall_start))
        if m.wall_end is not None:
            out.wall_end = (m.wall_end if out.wall_end is None
                            else max(out.wall_end, m.wall_end))
    # fleet view of the measured bandwidth: mean over the pods that have
    # one (each pod's EMA stays the authoritative pricing input locally)
    bws = [m.bandwidth_ema_bytes_per_s for m in parts
           if m.bandwidth_ema_bytes_per_s is not None]
    if bws:
        out.bandwidth_ema_bytes_per_s = sum(bws) / len(bws)
    out.pods_online.sort()     # one chronological fleet timeline
    return out
