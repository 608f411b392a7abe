"""Process-wide, thread-safe span recorder (paper Fig 3/5 timelines).

The port's own copy of the span half of ``repro.obs.trace`` (pure
stdlib): the streaming executors and the dispatch table emit the same span
names and counters as the reference (``fp_slab``; ``h2d`` / ``prefetch`` /
``compute`` / ``d2h`` categories; ``dispatch_hits`` / ``dispatch_misses``).
Instant events, calibration, SLO accounting and the exporters arrive with
the serve slice.

* **Zero cost when disabled.**  :func:`span` / :func:`begin` check a single
  attribute and return a shared no-op object; no allocation, no lock, no
  clock read.
* **Lock-cheap when enabled.**  A span takes two ``time.monotonic()`` reads
  and one short critical section appending to a bounded ring buffer.
* **Cross-thread spans.**  ``h = begin(...)`` on one thread, ``end(h)`` on
  another.

Host clocks only: a span around asynchronous CUDA work measures the
enqueue unless the caller synchronises inside it.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Union

__all__ = ["Span", "SpanHandle", "Tracer", "get_tracer", "set_tracer",
           "span", "begin", "end", "incr", "enabled"]


@dataclasses.dataclass(frozen=True)
class Span:
    """One closed interval: ``[t0, t1]`` monotonic seconds."""
    name: str
    cat: str
    t0: float
    t1: float
    thread: int
    seq: int
    attrs: Dict[str, Any]

    @property
    def duration(self) -> float:
        return self.t1 - self.t0


class SpanHandle:
    """Open span returned by :meth:`Tracer.begin` (close with ``end``)."""
    __slots__ = ("name", "cat", "t0", "thread", "attrs", "_gen")

    def __init__(self, name: str, cat: str, t0: float, thread: int,
                 attrs: Dict[str, Any], gen: int):
        self.name, self.cat, self.t0 = name, cat, t0
        self.thread, self.attrs, self._gen = thread, attrs, gen


class _NullSpan:
    """Shared no-op context manager: the disabled-tracer fast path."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class _SpanCtx:
    """Live span context manager (only built when tracing is enabled)."""
    __slots__ = ("_tracer", "_name", "_cat", "_attrs", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 attrs: Dict[str, Any]):
        self._tracer = tracer
        self._name, self._cat, self._attrs = name, cat, attrs

    def __enter__(self):
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        self._tracer._finish_span(self._name, self._cat, self._t0,
                                  time.monotonic(), threading.get_ident(),
                                  self._attrs)
        return False


class Tracer:
    """Bounded, thread-safe recorder of spans and counters.

    ``capacity`` bounds the ring buffer; the aggregate counters
    (``phase_seconds``, span counts, ``incr`` counters) keep running after
    old records have been evicted.
    """

    def __init__(self, capacity: int = 1 << 16,
                 enabled: Optional[bool] = None):
        if enabled is None:
            enabled = os.environ.get("REPRO_TRACE", "") not in ("", "0")
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._records: deque = deque(maxlen=int(capacity))
        self._seq = itertools.count()
        self._gen = 0                   # bumped by clear(): orphans handles
        self._phase: Dict[str, float] = {}
        self._counters: Dict[str, int] = {}

    def enable(self) -> "Tracer":
        self.enabled = True
        return self

    def disable(self) -> "Tracer":
        self.enabled = False
        return self

    def clear(self) -> None:
        """Drop all records and counters (open handles become no-ops)."""
        with self._lock:
            self._records.clear()
            self._phase.clear()
            self._counters.clear()
            self._gen += 1

    def span(self, name: str, cat: Optional[str] = None,
             **attrs) -> Union[_SpanCtx, _NullSpan]:
        if not self.enabled:
            return _NULL
        return _SpanCtx(self, name, cat or name, attrs)

    def begin(self, name: str, cat: Optional[str] = None,
              **attrs) -> Optional[SpanHandle]:
        if not self.enabled:
            return None
        return SpanHandle(name, cat or name, time.monotonic(),
                          threading.get_ident(), attrs, self._gen)

    def end(self, handle: Optional[SpanHandle], **attrs) -> None:
        if handle is None or not self.enabled or handle._gen != self._gen:
            return
        merged = handle.attrs if not attrs else {**handle.attrs, **attrs}
        self._finish_span(handle.name, handle.cat, handle.t0,
                          time.monotonic(), handle.thread, merged)

    def _finish_span(self, name: str, cat: str, t0: float, t1: float,
                     thread: int, attrs: Dict[str, Any]) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._records.append(Span(name, cat, t0, t1, thread,
                                      next(self._seq), attrs))
            self._phase[cat] = self._phase.get(cat, 0.0) + (t1 - t0)

    def incr(self, name: str, n: int = 1) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def spans(self, cat: Optional[str] = None,
              name: Optional[str] = None) -> List[Span]:
        with self._lock:
            out = list(self._records)
        if cat is not None:
            out = [s for s in out if s.cat == cat]
        if name is not None:
            out = [s for s in out if s.name == name]
        return out

    def phase_seconds(self) -> Dict[str, float]:
        """Aggregate seconds per span category since the last clear()."""
        with self._lock:
            return dict(self._phase)

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)


# --------------------------------------------------------------------------
# module-level API over the process-wide tracer
# --------------------------------------------------------------------------

_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER


def set_tracer(tracer: Tracer) -> Tracer:
    """Swap the process-wide tracer (tests); returns the previous one."""
    global _TRACER
    prev, _TRACER = _TRACER, tracer
    return prev


def enabled() -> bool:
    return _TRACER.enabled


def span(name: str, cat: Optional[str] = None, **attrs):
    t = _TRACER
    if not t.enabled:
        return _NULL
    return t.span(name, cat, **attrs)


def begin(name: str, cat: Optional[str] = None, **attrs):
    t = _TRACER
    if not t.enabled:
        return None
    return t.begin(name, cat, **attrs)


def end(handle, **attrs) -> None:
    t = _TRACER
    if t.enabled:
        t.end(handle, **attrs)


def incr(name: str, n: int = 1) -> None:
    t = _TRACER
    if t.enabled:
        t.incr(name, n)
