"""Process-wide, thread-safe span/event tracing (paper Fig 3/5 timelines).

The port's own copy of ``repro.obs.trace`` (pure stdlib; the port imports
nothing of the JAX package).  The streaming executors, the distributed
operators and the dispatch table emit the same span names and counters as
the reference (``fp_slab``, ``dist_fp``, ``dist_bp``, ``dist_bp_matched``,
``reduce``; ``h2d`` / ``prefetch`` / ``compute`` / ``d2h`` / ``reduce``
categories; ``dispatch_hits`` / ``dispatch_misses``), and the exporters
write the same Chrome trace-event JSON (one track per device per pod,
loadable in Perfetto) and Prometheus text.

Design rules
------------
* **Zero cost when disabled.**  The module-level helpers (:func:`span`,
  :func:`event`, :func:`context`, :func:`begin`) check a single attribute
  and return a shared no-op object; no allocation, no lock, no clock read.
* **Lock-cheap when enabled.**  A span takes two ``time.monotonic()``
  reads and one short critical section appending to a bounded ring buffer
  (``deque(maxlen=...)``) and bumping the aggregate counters.
* **Monotonic clocks.**  All timestamps are ``time.monotonic()`` seconds;
  exports rebase to the earliest record so traces start near zero.
* **Cross-thread spans.**  ``h = begin("init", job=...)`` on one thread,
  ``end(h)`` on another; the span is attributed to the opening thread.
* **Ambient context.**  ``with context(job="job-3", pod="p0"): ...``
  merges attributes into every span/event opened on that thread.

Host clocks only: a span around asynchronous CUDA work measures the
enqueue unless the caller synchronises inside it.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Sequence, Union

__all__ = [
    "Span", "InstantEvent", "SpanHandle", "Tracer", "get_tracer",
    "set_tracer", "span", "event", "begin", "end", "context", "incr",
    "enabled", "chrome_trace", "write_chrome_trace", "prometheus_snapshot",
]

# Phase categories folded into ``phase_seconds`` accounting; spans with
# other categories are still recorded and exported, these are just the
# ones ServeMetrics surfaces (paper Fig 9 bins + compile).
# "prefetch" is CommSchedule lookahead staging (h2d issued ahead of the
# consuming compute; carries a bytes= attr so Perfetto shows effective
# bandwidth per transfer) and "reduce" the cross-shard combine of the
# dominance-split dist FP.
PHASE_CATEGORIES = ("h2d", "compute", "d2h", "compile", "plan",
                    "prefetch", "reduce")


def _jsonable(v: Any) -> Any:
    """Coerce attr values for JSON export (numpy scalars -> python)."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    item = getattr(v, "item", None)
    if item is not None:
        try:
            return item()
        except (TypeError, ValueError):
            pass
    return str(v)


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


@dataclasses.dataclass(frozen=True)
class InstantEvent:
    """One point event (the fleet event log's record type)."""
    name: str
    t: float
    thread: int
    seq: int
    attrs: Dict[str, Any]


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


class _CtxMgr:
    """Pushes ambient attrs onto the thread's context for its duration."""
    __slots__ = ("_tracer", "_attrs", "_saved")

    def __init__(self, tracer: "Tracer", attrs: Dict[str, Any]):
        self._tracer = tracer
        self._attrs = attrs

    def __enter__(self):
        tls = self._tracer._tls_state()
        self._saved = tls.ctx
        tls.ctx = {**tls.ctx, **self._attrs}
        return self

    def __exit__(self, *exc):
        self._tracer._tls_state().ctx = self._saved
        return False


class Tracer:
    """Bounded, thread-safe recorder of spans + instant events.

    ``capacity`` bounds the ring buffer; aggregate counters
    (``phase_seconds``, span/event counts) keep running even after old
    records have been evicted, so the Prometheus snapshot stays honest on
    long runs.
    """

    def __init__(self, capacity: int = 1 << 16,
                 enabled: Optional[bool] = None):
        if enabled is None:
            enabled = os.environ.get("REPRO_TRACE", "") not in ("", "0")
        self.enabled = bool(enabled)
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._records: deque = deque(maxlen=self.capacity)
        self._seq = itertools.count()
        self._gen = 0                   # bumped by clear(): orphans handles
        self._phase: Dict[str, float] = {}
        self._span_counts: Dict[str, int] = {}
        self._event_counts: Dict[str, int] = {}
        self._counters: Dict[str, int] = {}
        self._total_records = 0
        self._tls = threading.local()

    # -- lifecycle ---------------------------------------------------------

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
            self._span_counts.clear()
            self._event_counts.clear()
            self._counters.clear()
            self._total_records = 0
            self._gen += 1
        # thread-local phase totals are reset lazily per thread
        tls = self._tls_state()
        tls.phase = {}

    def _tls_state(self):
        tls = self._tls
        if not hasattr(tls, "ctx"):
            tls.ctx = {}
            tls.phase = {}
        return tls

    def _merged_attrs(self, attrs: Dict[str, Any]) -> Dict[str, Any]:
        ctx = self._tls_state().ctx
        if ctx:
            merged = dict(ctx)
            merged.update(attrs)
            return merged
        return attrs

    # -- recording ---------------------------------------------------------

    def span(self, name: str, cat: Optional[str] = None,
             **attrs) -> Union[_SpanCtx, _NullSpan]:
        if not self.enabled:
            return _NULL
        return _SpanCtx(self, name, cat or name, self._merged_attrs(attrs))

    def begin(self, name: str, cat: Optional[str] = None,
              **attrs) -> Optional[SpanHandle]:
        if not self.enabled:
            return None
        return SpanHandle(name, cat or name, time.monotonic(),
                          threading.get_ident(), self._merged_attrs(attrs),
                          self._gen)

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
        dur = t1 - t0
        with self._lock:
            seq = next(self._seq)
            self._records.append(Span(name, cat, t0, t1, thread, seq, attrs))
            self._total_records += 1
            self._phase[cat] = self._phase.get(cat, 0.0) + dur
            self._span_counts[cat] = self._span_counts.get(cat, 0) + 1
        phase = self._tls_state().phase
        phase[cat] = phase.get(cat, 0.0) + dur

    def event(self, name: str, **attrs) -> None:
        if not self.enabled:
            return
        merged = self._merged_attrs(attrs)
        with self._lock:
            seq = next(self._seq)
            self._records.append(InstantEvent(name, time.monotonic(),
                                              threading.get_ident(), seq,
                                              merged))
            self._total_records += 1
            self._event_counts[name] = self._event_counts.get(name, 0) + 1

    def incr(self, name: str, n: int = 1) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def context(self, **attrs) -> Union[_CtxMgr, _NullSpan]:
        if not self.enabled:
            return _NULL
        return _CtxMgr(self, attrs)

    # -- accessors ---------------------------------------------------------

    def records(self) -> List[Union[Span, InstantEvent]]:
        with self._lock:
            return list(self._records)

    def spans(self, cat: Optional[str] = None,
              name: Optional[str] = None) -> List[Span]:
        out = [r for r in self.records() if isinstance(r, Span)]
        if cat is not None:
            out = [s for s in out if s.cat == cat]
        if name is not None:
            out = [s for s in out if s.name == name]
        return out

    def events(self, kind: Optional[str] = None,
               job: Optional[str] = None) -> List[InstantEvent]:
        out = [r for r in self.records() if isinstance(r, InstantEvent)]
        if kind is not None:
            out = [e for e in out if e.name == kind]
        if job is not None:
            out = [e for e in out if e.attrs.get("job") == job]
        return out

    def phase_seconds(self) -> Dict[str, float]:
        """Aggregate seconds per span category since the last clear()."""
        with self._lock:
            return dict(self._phase)

    def thread_phase_seconds(self) -> Dict[str, float]:
        """Per-category seconds accumulated by the *calling thread* only
        (used by the executor to attribute phases to one job's step)."""
        return dict(self._tls_state().phase)

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def dropped(self) -> int:
        """Records evicted by the ring buffer since the last clear()."""
        with self._lock:
            return self._total_records - len(self._records)

    # -- exporters ---------------------------------------------------------

    def chrome_trace(self, records: Optional[Sequence] = None) -> dict:
        return chrome_trace(self.records() if records is None else records)

    def write_chrome_trace(self, path: str,
                           records: Optional[Sequence] = None) -> None:
        trace = self.chrome_trace(records)
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(trace, fh)

    def prometheus(self) -> str:
        with self._lock:
            phase = dict(self._phase)
            span_counts = dict(self._span_counts)
            event_counts = dict(self._event_counts)
            counters = dict(self._counters)
            dropped = self._total_records - len(self._records)
        lines = [
            "# HELP repro_phase_seconds_total wall seconds per span category",
            "# TYPE repro_phase_seconds_total counter",
        ]
        for k in sorted(phase):
            lines.append(f'repro_phase_seconds_total{{phase="{k}"}} '
                         f"{phase[k]:.9f}")
        lines += ["# HELP repro_spans_total closed spans per category",
                  "# TYPE repro_spans_total counter"]
        for k in sorted(span_counts):
            lines.append(f'repro_spans_total{{cat="{k}"}} {span_counts[k]}')
        lines += ["# HELP repro_events_total fleet events per kind",
                  "# TYPE repro_events_total counter"]
        for k in sorted(event_counts):
            lines.append(f'repro_events_total{{kind="{k}"}} '
                         f"{event_counts[k]}")
        for k in sorted(counters):
            lines += [f"# HELP repro_{k}_total incr() counter {k!r}",
                      f"# TYPE repro_{k}_total counter",
                      f"repro_{k}_total {counters[k]}"]
        lines += ["# HELP repro_trace_dropped_records ring-buffer evictions",
                  "# TYPE repro_trace_dropped_records gauge",
                  f"repro_trace_dropped_records {dropped}"]
        return "\n".join(lines) + "\n"


# --------------------------------------------------------------------------
# Chrome trace-event export (module-level so it works on raw record lists)
# --------------------------------------------------------------------------

def _track_of(rec) -> tuple:
    """(process label, thread label) for one record -> Perfetto track."""
    pod = rec.attrs.get("pod")
    proc = str(pod) if pod not in (None, "") else "proc"
    dev = rec.attrs.get("device")
    if dev is not None:
        return proc, f"device{dev}"
    return proc, f"thread-{rec.thread}"


def chrome_trace(records: Iterable[Union[Span, InstantEvent]]) -> dict:
    """Records -> Chrome trace-event JSON dict (Perfetto-loadable).

    One *process* per pod, one *thread* track per device (falling back to
    the OS thread for unattributed records): loading the file into
    ui.perfetto.dev reproduces the paper's Fig 3/5 per-GPU timelines.
    """
    recs = sorted(records, key=lambda r: r.seq)
    base = min((r.t0 if isinstance(r, Span) else r.t for r in recs),
               default=0.0)
    pids: Dict[str, int] = {}
    tids: Dict[tuple, int] = {}
    events: List[dict] = []
    meta: List[dict] = []
    for r in recs:
        proc, track = _track_of(r)
        if proc not in pids:
            pids[proc] = len(pids) + 1
            meta.append({"name": "process_name", "ph": "M",
                         "pid": pids[proc], "tid": 0,
                         "args": {"name": proc}})
        pid = pids[proc]
        tkey = (pid, track)
        if tkey not in tids:
            tids[tkey] = len(tids) + 1
            meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                         "tid": tids[tkey], "args": {"name": track}})
        tid = tids[tkey]
        args = {k: _jsonable(v) for k, v in r.attrs.items()}
        if isinstance(r, Span):
            events.append({"name": r.name, "cat": r.cat, "ph": "X",
                           "ts": (r.t0 - base) * 1e6,
                           "dur": r.duration * 1e6,
                           "pid": pid, "tid": tid, "args": args})
        else:
            events.append({"name": r.name, "cat": "event", "ph": "i",
                           "ts": (r.t - base) * 1e6, "s": "t",
                           "pid": pid, "tid": tid, "args": args})
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


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


def event(name: str, **attrs) -> None:
    t = _TRACER
    if t.enabled:
        t.event(name, **attrs)


def begin(name: str, cat: Optional[str] = None, **attrs):
    t = _TRACER
    if not t.enabled:
        return None
    return t.begin(name, cat, **attrs)


def end(handle, **attrs) -> None:
    t = _TRACER
    if t.enabled:
        t.end(handle, **attrs)


def context(**attrs):
    t = _TRACER
    if not t.enabled:
        return _NULL
    return t.context(**attrs)


def incr(name: str, n: int = 1) -> None:
    t = _TRACER
    if t.enabled:
        t.incr(name, n)


def write_chrome_trace(path: str) -> None:
    _TRACER.write_chrome_trace(path)


def prometheus_snapshot() -> str:
    return _TRACER.prometheus()
