"""Observability for the port: the span/event recorder and its Chrome-trace
and Prometheus exporters (see :mod:`.trace`), and the fleet event log of
the serving layer (see :mod:`.events`)."""

from . import trace
from .events import FLEET_EVENT_KINDS, fleet_event, fleet_event_log
from .trace import (PHASE_CATEGORIES, InstantEvent, Span, SpanHandle,
                    Tracer, begin, chrome_trace, context, enabled, end,
                    event, get_tracer, incr, prometheus_snapshot,
                    set_tracer, span, write_chrome_trace)

__all__ = ["trace", "FLEET_EVENT_KINDS", "fleet_event", "fleet_event_log",
           "PHASE_CATEGORIES", "InstantEvent", "Span",
           "SpanHandle", "Tracer", "begin", "chrome_trace", "context",
           "enabled", "end", "event", "get_tracer", "incr",
           "prometheus_snapshot", "set_tracer", "span",
           "write_chrome_trace"]
