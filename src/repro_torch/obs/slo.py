"""SLO accounting: deadline attainment and latency percentiles per tier.

Port of ``repro/obs/slo.py``.

The serving layer's promise to a tenant is its ``deadline_seconds`` and
its priority tier; this module turns the fleet event log into the
operator's view of whether that promise held.  For each priority level
it reports

* **deadline attainment**: of the jobs that declared a deadline, the
  fraction that completed inside it — rejects (the model refused the
  job at admission) and late completions both count against it;
* **queue-wait** and **end-to-end latency** percentiles over completed
  jobs (the ``complete`` event carries both measurements directly).

All inputs come from the structured event stream
(:func:`repro_torch.obs.events.fleet_event_log`), so the report can be built
post-mortem from any traced run, or live by the metrics endpoint
(:mod:`repro_torch.obs.http`).  Pure stdlib, like the rest of ``obs``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional

from .events import fleet_event_log
from .trace import InstantEvent

__all__ = ["SLOTier", "slo_report", "slo_prometheus"]


def _percentile(xs: List[float], p: float) -> float:
    """Nearest-rank percentile; 0.0 on empty input (serve's convention,
    re-implemented here because obs cannot import serve)."""
    if not xs:
        return 0.0
    s = sorted(xs)
    k = max(0, min(len(s) - 1, int(round(p / 100.0 * (len(s) - 1)))))
    return s[k]


@dataclasses.dataclass
class SLOTier:
    """Accumulated outcomes for one priority level."""
    priority: int
    submitted: int = 0
    completed: int = 0
    failed: int = 0
    rejected: int = 0          # deadline admission refused the job
    deadline_jobs: int = 0     # jobs that declared a deadline
    deadline_met: int = 0
    deadline_missed: int = 0   # completed, but late (+ rejects, separately)
    latencies_s: List[float] = dataclasses.field(default_factory=list)
    queue_waits_s: List[float] = dataclasses.field(default_factory=list)

    @property
    def attainment(self) -> float:
        """Met deadlines / declared deadlines; 1.0 when no job declared
        one (an SLO nobody asked for is trivially held)."""
        if self.deadline_jobs == 0:
            return 1.0
        return self.deadline_met / self.deadline_jobs

    def as_dict(self) -> Dict:
        return {
            "priority": self.priority,
            "submitted": self.submitted,
            "completed": self.completed,
            "failed": self.failed,
            "rejected": self.rejected,
            "deadline_jobs": self.deadline_jobs,
            "deadline_met": self.deadline_met,
            "deadline_missed": self.deadline_missed,
            "attainment": self.attainment,
            "latency_p50_s": _percentile(self.latencies_s, 50),
            "latency_p95_s": _percentile(self.latencies_s, 95),
            "queue_wait_p50_s": _percentile(self.queue_waits_s, 50),
            "queue_wait_p95_s": _percentile(self.queue_waits_s, 95),
        }


def _tier(tiers: Dict[int, SLOTier], priority: int) -> SLOTier:
    t = tiers.get(priority)
    if t is None:
        t = tiers[priority] = SLOTier(priority)
    return t


def slo_report(events: Optional[Iterable[InstantEvent]] = None) -> Dict:
    """Fold the fleet event log into per-priority SLO outcomes.

    ``complete`` events carry ``measured_s`` (end-to-end latency),
    ``queue_wait_s``, ``deadline_s`` and ``priority`` directly;
    ``reject`` carries ``priority`` and ``deadline_s``.  Jobs whose
    events predate those attributes join through the ``submit`` event's
    ``priority`` and otherwise land in tier 0 — a half-instrumented
    stream degrades to coarser tiers, never to a crash.
    """
    if events is None:
        events = fleet_event_log()
    prio_of: Dict[str, int] = {}
    tiers: Dict[int, SLOTier] = {}
    for ev in events:
        a = ev.attrs
        job = a.get("job")
        if ev.name == "submit":
            p = int(a.get("priority", 0) or 0)
            if job:
                prio_of[job] = p
            _tier(tiers, p).submitted += 1
            continue
        if ev.name not in ("complete", "fail", "reject"):
            continue
        p = a.get("priority")
        if p is None:
            p = prio_of.get(job, 0)
        t = _tier(tiers, int(p))
        if ev.name == "fail":
            t.failed += 1
            continue
        deadline = a.get("deadline_s") or 0.0
        if ev.name == "reject":
            t.rejected += 1
            if deadline > 0:
                t.deadline_jobs += 1
                t.deadline_missed += 1
            continue
        t.completed += 1
        latency = a.get("measured_s")
        if isinstance(latency, (int, float)):
            t.latencies_s.append(float(latency))
        qw = a.get("queue_wait_s")
        if isinstance(qw, (int, float)):
            t.queue_waits_s.append(float(qw))
        if deadline > 0:
            t.deadline_jobs += 1
            if isinstance(latency, (int, float)) and latency <= deadline:
                t.deadline_met += 1
            else:
                t.deadline_missed += 1
    ordered = [tiers[p] for p in sorted(tiers)]
    total_decl = sum(t.deadline_jobs for t in ordered)
    total_met = sum(t.deadline_met for t in ordered)
    return {
        "tiers": [t.as_dict() for t in ordered],
        "overall_attainment": (total_met / total_decl if total_decl
                               else 1.0),
        "deadline_jobs": total_decl,
    }


def slo_prometheus(report: Optional[Dict] = None) -> str:
    """Prometheus text for the SLO families; headers always emitted."""
    if report is None:
        report = slo_report()
    lines = ["# HELP repro_slo_attainment_ratio met deadlines / declared "
             "deadlines per priority tier",
             "# TYPE repro_slo_attainment_ratio gauge"]
    tiers = report.get("tiers", [])
    for t in tiers:
        lines.append(f'repro_slo_attainment_ratio{{priority="'
                     f'{t["priority"]}"}} {t["attainment"]:.9g}')
    lines += ["# HELP repro_slo_latency_p95_seconds end-to-end latency "
              "p95 per priority tier",
              "# TYPE repro_slo_latency_p95_seconds gauge"]
    for t in tiers:
        lines.append(f'repro_slo_latency_p95_seconds{{priority="'
                     f'{t["priority"]}"}} {t["latency_p95_s"]:.9g}')
    lines += ["# HELP repro_slo_queue_wait_p95_seconds queue wait p95 "
              "per priority tier",
              "# TYPE repro_slo_queue_wait_p95_seconds gauge"]
    for t in tiers:
        lines.append(f'repro_slo_queue_wait_p95_seconds{{priority="'
                     f'{t["priority"]}"}} {t["queue_wait_p95_s"]:.9g}')
    lines += ["# HELP repro_slo_completed_total completed jobs per "
              "priority tier",
              "# TYPE repro_slo_completed_total counter"]
    for t in tiers:
        lines.append(f'repro_slo_completed_total{{priority="'
                     f'{t["priority"]}"}} {t["completed"]}')
    return "\n".join(lines) + "\n"
