"""Observability for the port: the span/event recorder and its Chrome-trace
and Prometheus exporters (see :mod:`.trace`), the fleet event log of the
serving layer (see :mod:`.events`), the modeled-vs-measured calibration
ledger and memory-margin gauges (:mod:`.calibration`), deadline-attainment
accounting (:mod:`.slo`) and the live metrics endpoint (:mod:`.http`)."""

from . import trace
from .calibration import (CAL_EVENT_KINDS, CalibrationKey,
                          CalibrationLedger, CalibrationStat, MemoryMargin,
                          calibration_prometheus, memory_calibration)
from .events import FLEET_EVENT_KINDS, fleet_event, fleet_event_log
from .http import MetricsServer, metrics_text
from .slo import SLOTier, slo_prometheus, slo_report
from .trace import (PHASE_CATEGORIES, InstantEvent, Span, SpanHandle,
                    Tracer, begin, chrome_trace, context, enabled, end,
                    event, get_tracer, incr, prometheus_snapshot,
                    set_tracer, span, write_chrome_trace)

__all__ = [
    "trace",
    "CAL_EVENT_KINDS", "CalibrationKey", "CalibrationLedger",
    "CalibrationStat", "MemoryMargin", "calibration_prometheus",
    "memory_calibration", "MetricsServer", "metrics_text",
    "SLOTier", "slo_prometheus", "slo_report",
    "FLEET_EVENT_KINDS", "fleet_event", "fleet_event_log",
    "PHASE_CATEGORIES", "InstantEvent", "Span", "SpanHandle", "Tracer",
    "begin", "chrome_trace", "context", "enabled", "end", "event",
    "get_tracer", "incr", "prometheus_snapshot", "set_tracer", "span",
    "write_chrome_trace",
]
