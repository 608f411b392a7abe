"""Fleet event taxonomy: the structured log of serving-layer decisions.

Port of ``repro/obs/events.py`` over the port's own :mod:`.trace`.

Every scheduler/fleet decision lands as one :class:`~repro_torch.obs.trace.
InstantEvent` in the process tracer, tagged with a ``kind`` from
:data:`FLEET_EVENT_KINDS` plus whatever identity is known at the call
site (``job``, ``pod``, ``device``).  Cost-model events carry both the
*modeled* seconds (what the scheduler predicted from its EMAs /
ExecutionPlan) and the *measured* seconds, so autoscale thrash, steal
ping-pong, and preemption storms can be debugged from one ordered log
instead of test output archaeology.

Kinds
-----
``submit``      job accepted into a scheduler queue
``place``       job reserved a device slot (before executor init)
``admit``       executor init finished, job RUNNING
                (``measured_s`` = init seconds, ``modeled_s`` = init EMA)
``step``        one outer iteration finished
                (``measured_s`` = wall, ``modeled_s`` = step EMA x passes)
``park``        job preempted: checkpointed + requeued
``complete``    job finished (``measured_s`` = submit-to-done latency)
``fail``        job failed (``error`` attr)
``reject``      deadline model refused the job at admission
``export``      job serialized to the transfer dir (steal/drain egress)
``import``      job adopted from the transfer dir (steal/drain ingress)
``drain``       a scheduler parked all running jobs (shutdown/steal prep)
``pod-add``     pod joined the fleet
``pod-remove``  pod left the fleet
``scale-up``    autoscaler grew the fleet  (``load`` = backlog seconds)
``scale-down``  autoscaler shrank the fleet
``snapshot``    durable scheduler snapshot written
``live-snapshot`` a *running* job's committed step state persisted
                without parking it (``it`` = the committed iteration)
``migrate``     a running job preempted at its step boundary and moved
                live to another pod (``src``/``dst`` pods)
"""

from __future__ import annotations

from typing import List, Optional

from .trace import InstantEvent, event, get_tracer

__all__ = ["FLEET_EVENT_KINDS", "fleet_event", "fleet_event_log"]

FLEET_EVENT_KINDS = (
    "submit", "place", "admit", "step", "park", "complete", "fail",
    "reject", "export", "import", "drain", "pod-add", "pod-remove",
    "scale-up", "scale-down", "snapshot", "live-snapshot", "migrate",
)


def fleet_event(kind: str, **attrs) -> None:
    """Record one fleet event (no-op when tracing is disabled).

    ``kind`` must come from :data:`FLEET_EVENT_KINDS` — an unknown kind
    raises immediately so call sites cannot silently fork the taxonomy.
    """
    if kind not in FLEET_EVENT_KINDS:
        raise ValueError(f"unknown fleet event kind: {kind!r}")
    event(kind, **attrs)


def fleet_event_log(job: Optional[str] = None, kind: Optional[str] = None,
                    pod: Optional[str] = None) -> List[InstantEvent]:
    """The recorded fleet events, in order, optionally filtered."""
    out = [e for e in get_tracer().events()
           if e.name in FLEET_EVENT_KINDS]
    if kind is not None:
        out = [e for e in out if e.name == kind]
    if job is not None:
        out = [e for e in out if e.attrs.get("job") == job]
    if pod is not None:
        out = [e for e in out if e.attrs.get("pod") == pod]
    return out
