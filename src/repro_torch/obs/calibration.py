"""Calibration ledger: are the serving cost models telling the truth?

Port of ``repro/obs/calibration.py``, the same semantics over the port's
own tracer and fleet event log.

Every scheduling decision — makespan routing, deadline admission,
steal/migrate benefit checks, predictive scale-up — rides on modeled
seconds (step/init EMAs, :meth:`~repro_torch.core.plan.CommSchedule.
transfer_seconds`) and modeled bytes (:class:`~repro_torch.core.plan.
ExecutionPlan` footprints).  The fleet event log
(:mod:`repro_torch.obs.events`) already records the modeled and measured
value side by side on each decision; this module folds that stream into
an *answer*: per ``(geometry, algorithm, backend, pod)`` and per event
kind, the signed bias (measured − modeled), absolute-error
percentiles, and an EMA-drift flag that names the pod whose cost model
has gone stale.

Memory is calibrated the same way: the staged ``bytes=`` attributes on
h2d/prefetch/d2h/reduce spans give a measured per-device high-water
mark, compared against the modeled footprint committed at placement
(``place`` events' ``bytes=``).  The ratio is exported as a
safety-margin gauge so an under-modeled footprint is visible *before*
it OOMs a real GPU.

Everything here is pure stdlib (no numpy, no torch) so the obs package
stays importable anywhere, and every reader tolerates a half-written stream:
events missing one side of the comparison still count as observed.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

from .events import fleet_event_log
from .trace import InstantEvent, Tracer, get_tracer

__all__ = [
    "CAL_EVENT_KINDS", "CalibrationKey", "CalibrationStat",
    "CalibrationLedger", "MemoryMargin", "memory_calibration",
    "calibration_prometheus",
]

#: Event kinds the ledger folds.  ``admit``/``step`` carry both sides of
#: the comparison; ``complete``/``reject``/``migrate``/``scale-up`` carry
#: one side (or none) and contribute observation counts + totals only.
CAL_EVENT_KINDS = ("admit", "step", "complete", "reject", "migrate",
                   "scale-up")

#: Span categories whose ``bytes=`` attrs are device-resident staging
#: traffic (the measured side of memory calibration).
_STAGING_CATS = ("h2d", "prefetch", "d2h", "reduce")


def _percentile(xs: List[float], p: float) -> float:
    """Nearest-rank percentile (p in [0, 100]); 0.0 on empty input.

    Duplicated from :mod:`repro_torch.serve.metrics` on purpose: serve imports
    obs, so obs cannot import serve back.
    """
    if not xs:
        return 0.0
    s = sorted(xs)
    k = max(0, min(len(s) - 1, int(round(p / 100.0 * (len(s) - 1)))))
    return s[k]


@dataclasses.dataclass(frozen=True)
class CalibrationKey:
    """One cost-model population: same geometry, algorithm, backend, pod.

    Events that predate the attribute enrichment (or kinds that have no
    job identity, like ``scale-up``) group under ``"-"`` placeholders
    rather than being dropped — a stale emitter is itself a calibration
    finding.
    """
    geometry: str = "-"
    algorithm: str = "-"
    backend: str = "-"
    pod: str = "-"

    @staticmethod
    def of(ev: InstantEvent) -> "CalibrationKey":
        a = ev.attrs
        pod = a.get("pod") or a.get("dst") or a.get("src") or "-"
        return CalibrationKey(
            geometry=str(a.get("geo", "-")),
            algorithm=str(a.get("alg", "-")),
            backend=str(a.get("backend") or "-"),
            pod=str(pod))


@dataclasses.dataclass
class CalibrationStat:
    """Accumulated modeled-vs-measured evidence for one (key, kind)."""
    key: CalibrationKey
    kind: str
    events: int = 0          # every event of this kind seen for the key
    samples: int = 0         # events carrying BOTH modeled_s and measured_s
    modeled_total_s: float = 0.0
    measured_total_s: float = 0.0
    errors_s: List[float] = dataclasses.field(default_factory=list)
    drift_ema: float = 0.0   # EMA of |relative error|
    drift: bool = False

    @property
    def bias_s(self) -> float:
        """Mean signed error (measured − modeled); + means the model is
        optimistic (work costs more than priced)."""
        if not self.errors_s:
            return 0.0
        return sum(self.errors_s) / len(self.errors_s)

    def abs_error_percentile(self, p: float) -> float:
        return _percentile([abs(e) for e in self.errors_s], p)

    def as_dict(self) -> Dict:
        return {
            "geometry": self.key.geometry,
            "algorithm": self.key.algorithm,
            "backend": self.key.backend,
            "pod": self.key.pod,
            "kind": self.kind,
            "events": self.events,
            "samples": self.samples,
            "modeled_total_s": self.modeled_total_s,
            "measured_total_s": self.measured_total_s,
            "bias_s": self.bias_s,
            "abs_p50_s": self.abs_error_percentile(50),
            "abs_p95_s": self.abs_error_percentile(95),
            "abs_max_s": self.abs_error_percentile(100),
            "drift_ema": self.drift_ema,
            "drift": self.drift,
        }


class CalibrationLedger:
    """Fold the fleet event stream into per-(key, kind) calibration stats.

    ``drift`` fires on a (key, kind) when the EMA of the *relative*
    absolute error (|measured − modeled| / max(modeled, eps)) exceeds
    ``drift_threshold`` after at least ``drift_min_samples`` two-sided
    samples — and clears again once accurate samples pull the EMA back
    under the threshold, so a one-off compile hiccup does not
    permanently condemn a pod.  :meth:`stale_pods` names the pods with
    any firing flag; that is the operator-facing output.
    """

    def __init__(self, drift_threshold: float = 0.5,
                 drift_min_samples: int = 4,
                 alpha: float = 0.3) -> None:
        if not (0.0 < alpha <= 1.0):
            raise ValueError("alpha must be in (0, 1]")
        self.drift_threshold = float(drift_threshold)
        self.drift_min_samples = int(drift_min_samples)
        self.alpha = float(alpha)
        self._stats: Dict[Tuple[CalibrationKey, str], CalibrationStat] = {}

    @classmethod
    def from_events(cls, events: Optional[Iterable[InstantEvent]] = None,
                    **kwargs) -> "CalibrationLedger":
        """Build a ledger from an event iterable (default: the process
        tracer's fleet event log, in order)."""
        led = cls(**kwargs)
        if events is None:
            events = fleet_event_log()
        for ev in events:
            led.fold(ev)
        return led

    def fold(self, ev: InstantEvent) -> None:
        """Fold one fleet event; non-calibration kinds are ignored."""
        if ev.name not in CAL_EVENT_KINDS:
            return
        key = CalibrationKey.of(ev)
        st = self._stats.get((key, ev.name))
        if st is None:
            st = self._stats[(key, ev.name)] = CalibrationStat(key, ev.name)
        st.events += 1
        modeled = ev.attrs.get("modeled_s")
        measured = ev.attrs.get("measured_s")
        if isinstance(modeled, (int, float)):
            st.modeled_total_s += float(modeled)
        if isinstance(measured, (int, float)):
            st.measured_total_s += float(measured)
        if not (isinstance(modeled, (int, float))
                and isinstance(measured, (int, float))):
            return
        err = float(measured) - float(modeled)
        st.samples += 1
        st.errors_s.append(err)
        rel = abs(err) / max(abs(float(modeled)), 1e-9)
        st.drift_ema = (rel if st.samples == 1
                        else self.alpha * rel
                        + (1 - self.alpha) * st.drift_ema)
        st.drift = (st.samples >= self.drift_min_samples
                    and st.drift_ema > self.drift_threshold)

    # ---- views -------------------------------------------------------------

    def entries(self) -> List[CalibrationStat]:
        """All stats, deterministically ordered (key fields, then kind)."""
        return sorted(self._stats.values(),
                      key=lambda s: (s.key.geometry, s.key.algorithm,
                                     s.key.backend, s.key.pod, s.kind))

    def samples_by_kind(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for st in self._stats.values():
            out[st.kind] = out.get(st.kind, 0) + st.samples
        return out

    def events_by_kind(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for st in self._stats.values():
            out[st.kind] = out.get(st.kind, 0) + st.events
        return out

    def stale_pods(self) -> List[str]:
        """Pods with at least one firing drift flag (sorted, deduped)."""
        return sorted({st.key.pod for st in self._stats.values()
                       if st.drift})

    def report(self) -> Dict:
        """JSON-able calibration report (what ``recon
        --calibration-report`` and ``bench_serve --json`` embed)."""
        return {
            "entries": [st.as_dict() for st in self.entries()],
            "samples_by_kind": self.samples_by_kind(),
            "events_by_kind": self.events_by_kind(),
            "stale_pods": self.stale_pods(),
            "drift_threshold": self.drift_threshold,
        }


# ---- memory calibration ----------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MemoryMargin:
    """Modeled-vs-staged bytes for one (pod, device) track.

    ``margin`` is modeled / measured: > 1 means the planner's footprint
    over-covers the observed staging high-water mark (safe); < 1 means a
    single staged transfer already exceeded the modeled footprint — the
    memory model is optimistic and a real GPU would be at OOM risk.
    """
    pod: str
    device: str
    modeled_bytes: int
    measured_bytes: int

    @property
    def margin(self) -> float:
        if self.measured_bytes <= 0:
            return float("inf")
        return self.modeled_bytes / self.measured_bytes

    def as_dict(self) -> Dict:
        m = self.margin
        return {"pod": self.pod, "device": self.device,
                "modeled_bytes": self.modeled_bytes,
                "measured_bytes": self.measured_bytes,
                "margin": (None if m == float("inf") else m)}


def memory_calibration(tracer: Optional[Tracer] = None) -> List[MemoryMargin]:
    """Per-(pod, device) memory margins from the current trace.

    Measured: the max ``bytes=`` attribute over staging-category spans on
    that device track.  Modeled: the max footprint committed there by
    ``place`` events.  Tracks with only one side known are still
    reported (modeled or measured 0) so a missing instrumentation leg is
    visible rather than silently fine.
    """
    tr = tracer if tracer is not None else get_tracer()
    measured: Dict[Tuple[str, str], int] = {}
    modeled: Dict[Tuple[str, str], int] = {}
    for sp in tr.spans():
        if sp.cat not in _STAGING_CATS:
            continue
        nbytes = sp.attrs.get("bytes")
        if not isinstance(nbytes, (int, float)):
            continue
        k = (str(sp.attrs.get("pod") or "-"),
             str(sp.attrs.get("device", "-")))
        measured[k] = max(measured.get(k, 0), int(nbytes))
    for ev in tr.events():
        if ev.name != "place":
            continue
        nbytes = ev.attrs.get("bytes")
        if not isinstance(nbytes, (int, float)):
            continue
        k = (str(ev.attrs.get("pod") or "-"),
             str(ev.attrs.get("device", "-")))
        modeled[k] = max(modeled.get(k, 0), int(nbytes))
    out = [MemoryMargin(pod, dev, modeled.get((pod, dev), 0),
                        measured.get((pod, dev), 0))
           for pod, dev in sorted(set(measured) | set(modeled))]
    return out


# ---- Prometheus exposition -------------------------------------------------


def _esc(v: object) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"')


def _labels(**kv) -> str:
    return ("{" + ",".join(f'{k}="{_esc(v)}"' for k, v in kv.items())
            + "}")


def calibration_prometheus(
        ledger: Optional[CalibrationLedger] = None,
        margins: Optional[List[MemoryMargin]] = None) -> str:
    """Prometheus text for the calibration + memory-margin families.

    Family headers are always emitted, even with zero series, so a
    scraper (and :mod:`tools.validate_trace`) can assert the families
    exist on an idle or serve-free process.
    """
    if ledger is None:
        ledger = CalibrationLedger.from_events()
    if margins is None:
        margins = memory_calibration()
    lines = [
        "# HELP repro_calibration_samples_total modeled-vs-measured "
        "samples folded per (geometry, algorithm, backend, pod, kind)",
        "# TYPE repro_calibration_samples_total counter",
    ]
    ents = ledger.entries()
    for st in ents:
        lines.append(
            "repro_calibration_samples_total"
            + _labels(geo=st.key.geometry, alg=st.key.algorithm,
                      backend=st.key.backend, pod=st.key.pod,
                      kind=st.kind)
            + f" {st.samples}")
    lines += ["# HELP repro_calibration_bias_seconds mean signed error "
              "(measured - modeled); positive = model optimistic",
              "# TYPE repro_calibration_bias_seconds gauge"]
    for st in ents:
        if st.samples:
            lines.append(
                "repro_calibration_bias_seconds"
                + _labels(geo=st.key.geometry, alg=st.key.algorithm,
                          backend=st.key.backend, pod=st.key.pod,
                          kind=st.kind)
                + f" {st.bias_s:.9g}")
    lines += ["# HELP repro_calibration_abs_p95_seconds p95 absolute "
              "modeled-vs-measured error",
              "# TYPE repro_calibration_abs_p95_seconds gauge"]
    for st in ents:
        if st.samples:
            lines.append(
                "repro_calibration_abs_p95_seconds"
                + _labels(geo=st.key.geometry, alg=st.key.algorithm,
                          backend=st.key.backend, pod=st.key.pod,
                          kind=st.kind)
                + f" {st.abs_error_percentile(95):.9g}")
    lines += ["# HELP repro_calibration_drift 1 when a pod's cost model "
              "EMA-drifted past the threshold",
              "# TYPE repro_calibration_drift gauge"]
    for pod in ledger.stale_pods():
        lines.append("repro_calibration_drift" + _labels(pod=pod) + " 1")
    lines += ["# HELP repro_memory_modeled_bytes max footprint committed "
              "at placement per (pod, device)",
              "# TYPE repro_memory_modeled_bytes gauge"]
    for m in margins:
        lines.append("repro_memory_modeled_bytes"
                     + _labels(pod=m.pod, device=m.device)
                     + f" {m.modeled_bytes}")
    lines += ["# HELP repro_memory_watermark_bytes max staged bytes "
              "observed per (pod, device)",
              "# TYPE repro_memory_watermark_bytes gauge"]
    for m in margins:
        lines.append("repro_memory_watermark_bytes"
                     + _labels(pod=m.pod, device=m.device)
                     + f" {m.measured_bytes}")
    lines += ["# HELP repro_memory_margin_ratio modeled / measured bytes; "
              "< 1 means the memory model is optimistic (OOM risk)",
              "# TYPE repro_memory_margin_ratio gauge"]
    for m in margins:
        if m.margin != float("inf"):
            lines.append("repro_memory_margin_ratio"
                         + _labels(pod=m.pod, device=m.device)
                         + f" {m.margin:.9g}")
    return "\n".join(lines) + "\n"
