"""Observability for the port: the span/event recorder and its Chrome-trace
and Prometheus exporters (see :mod:`.trace`)."""

from . import trace
from .trace import (PHASE_CATEGORIES, InstantEvent, Span, SpanHandle,
                    Tracer, begin, chrome_trace, context, enabled, end,
                    event, get_tracer, incr, prometheus_snapshot,
                    set_tracer, span, write_chrome_trace)

__all__ = ["trace", "PHASE_CATEGORIES", "InstantEvent", "Span",
           "SpanHandle", "Tracer", "begin", "chrome_trace", "context",
           "enabled", "end", "event", "get_tracer", "incr",
           "prometheus_snapshot", "set_tracer", "span",
           "write_chrome_trace"]
