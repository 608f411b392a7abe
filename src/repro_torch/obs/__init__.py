"""Observability for the port: the span recorder (see :mod:`.trace`)."""

from . import trace
from .trace import (Span, SpanHandle, Tracer, begin, enabled, end,
                    get_tracer, incr, set_tracer, span)

__all__ = ["trace", "Span", "SpanHandle", "Tracer", "begin", "enabled",
           "end", "get_tracer", "incr", "set_tracer", "span"]
