"""The port's exporters (``repro_torch.obs.{calibration,slo,http}``) against
the reference's, on the CPU: the calibration ledger's report, the memory
margins and the SLO report over the same event streams, the whole
Prometheus exposition (``metrics_text``) of the same trace, the live
endpoint on port 0, and the ledger fed by a scheduled run.

Both packages are stdlib at this layer, so their outputs are compared
exactly (the same dicts, the same text)."""

import urllib.error
import urllib.request

import pytest
import torch

import repro.obs as jobs_
import repro.serve as jserve
from repro.core.geometry import ConeGeometry as JConeGeometry
from repro.core.splitting import MemoryModel as JMemoryModel
from repro_torch import obs
from repro_torch.core import phantoms
from repro_torch.core.geometry import ConeGeometry, circular_angles
from repro_torch.core.splitting import MemoryModel
from repro_torch.obs.calibration import (CalibrationKey, CalibrationLedger,
                                         calibration_prometheus,
                                         memory_calibration)
from repro_torch.obs.slo import slo_prometheus, slo_report
from repro_torch.obs.trace import InstantEvent
from repro_torch.serve import DevicePool, ReconJob, Scheduler

CPU = torch.device("cpu")
GEO = ConeGeometry.nice(16)
ANGLES = circular_angles(12)
PROJ = phantoms.sphere_projection_analytic(GEO, ANGLES)
KIB = 1024

REQUIRED_FAMILIES = (
    "repro_calibration_samples_total", "repro_calibration_bias_seconds",
    "repro_calibration_abs_p95_seconds", "repro_calibration_drift",
    "repro_memory_modeled_bytes", "repro_memory_watermark_bytes",
    "repro_memory_margin_ratio", "repro_slo_attainment_ratio",
    "repro_slo_latency_p95_seconds", "repro_slo_queue_wait_p95_seconds",
    "repro_slo_completed_total",
)


def _ev(mod, kind, seq=0, **attrs):
    """A synthetic fleet event of package ``mod`` (its trace module)."""
    return mod.InstantEvent(name=kind, t=float(seq), thread=0, seq=seq,
                            attrs=attrs)


def _both(stream):
    """The same stream as events of each package: (port's, reference's)."""
    return ([_ev(obs.trace, k, i, **a) for i, (k, a) in enumerate(stream)],
            [_ev(jobs_.trace, k, i, **a) for i, (k, a) in enumerate(stream)])


# --------------------------------------------------------------------------
# the ledger and the SLO report on synthetic streams
# --------------------------------------------------------------------------

_STEP = dict(pod="p0", geo="16x16x16", alg="cgls", backend="auto")
LEDGER_STREAMS = {
    # optimistic model: measured 1.5, 1.1, 1.2, 3.0 against 1.0
    "bias-and-percentiles": [("step", dict(_STEP, modeled_s=1.0,
                                           measured_s=1.0 + e))
                             for e in (0.5, 0.1, 0.2, 2.0)]
    + [("admit", dict(pod="p1", modeled_s=2.0, measured_s=1.0))],
    "one-sided": [("complete", dict(pod="p0", measured_s=3.0)),
                  ("scale-up", dict(pod="p1", modeled_s=0.5)),
                  ("migrate", dict(src="p0", dst="p1"))],
    # four samples 100 % off fire the drift flag, twenty right ones clear it
    "drift-fires-then-clears": [("step", dict(pod="bad", modeled_s=1.0,
                                              measured_s=2.0))] * 4
    + [("step", dict(pod="bad", modeled_s=1.0, measured_s=1.0))] * 20,
    "drift-fires": [("step", dict(pod="bad", modeled_s=1.0,
                                  measured_s=2.0))] * 4,
    "one-short-of-the-gate": [("step", dict(pod="p0", modeled_s=1.0,
                                            measured_s=2.0))] * 3,
    "keys-and-unknown-kinds": [
        ("step", dict(pod="p0", alg="cgls", modeled_s=1, measured_s=1)),
        ("step", dict(pod="p0", alg="sirt", modeled_s=1, measured_s=1)),
        ("step", dict(pod="p1", alg="cgls", modeled_s=1, measured_s=1)),
        ("park", dict(pod="p0"))],
}


@pytest.mark.parametrize("name", list(LEDGER_STREAMS))
def test_ledger_report_equals_the_reference(name):
    ours, theirs = _both(LEDGER_STREAMS[name])
    led = CalibrationLedger.from_events(ours)
    want = jobs_.CalibrationLedger.from_events(theirs)
    assert led.report() == want.report()
    assert calibration_prometheus(led, []) == \
        jobs_.calibration_prometheus(want, [])
    if name == "bias-and-percentiles":
        st = [s for s in led.entries() if s.kind == "step"][0]
        assert st.key == CalibrationKey("16x16x16", "cgls", "auto", "p0")
        assert st.bias_s == pytest.approx(0.7) and st.samples == 4
    if name == "drift-fires":
        assert led.stale_pods() == ["bad"]
    if name in ("drift-fires-then-clears", "one-short-of-the-gate",
                "one-sided"):
        assert led.stale_pods() == []


SLO_STREAMS = {
    "deadlines-rejects-and-tiers": [
        ("submit", dict(job="a", priority=1)),
        ("submit", dict(job="b", priority=1)),
        ("submit", dict(job="c", priority=0)),
        ("submit", dict(job="d", priority=1)),
        ("complete", dict(job="a", priority=1, deadline_s=5.0,
                          measured_s=2.0, queue_wait_s=0.5)),
        ("complete", dict(job="b", priority=1, deadline_s=5.0,
                          measured_s=9.0, queue_wait_s=4.0)),
        ("complete", dict(job="c", priority=0, measured_s=1.0,
                          queue_wait_s=0.1)),
        ("reject", dict(job="d", priority=1, deadline_s=1.0)),
        ("fail", dict(job="e"))],
    "priority-joined-via-submit": [
        ("submit", dict(job="x", priority=2)),
        ("complete", dict(job="x", deadline_s=10.0, measured_s=1.0))],
    "empty": [],
}


@pytest.mark.parametrize("name", list(SLO_STREAMS))
def test_slo_report_equals_the_reference(name):
    ours, theirs = _both(SLO_STREAMS[name])
    rep = slo_report(ours)
    assert rep == jobs_.slo_report(theirs)
    assert slo_prometheus(rep) == jobs_.slo_prometheus(rep)
    if name == "deadlines-rejects-and-tiers":
        assert rep["overall_attainment"] == pytest.approx(1 / 3)
    if name == "empty":
        assert rep["tiers"] == [] and rep["overall_attainment"] == 1.0


def test_family_headers_present_even_when_empty():
    text = (calibration_prometheus(CalibrationLedger(), [])
            + slo_prometheus(slo_report([])))
    for fam in REQUIRED_FAMILIES:
        assert f"# TYPE {fam} " in text, fam


# --------------------------------------------------------------------------
# one trace through both packages: memory margins and the full exposition
# --------------------------------------------------------------------------

def _record(mod):
    """The same trace in a fresh tracer of package ``mod``: staging spans
    with fixed clocks, fleet events and a counter."""
    tr = mod.Tracer(enabled=True)
    for i, (cat, nbytes, dev) in enumerate(
            (("h2d", 256, "device0"), ("h2d", 512, "device0"),
             ("d2h", 768, "device1"), ("compute", 999, "device0"))):
        tr._finish_span("stage", cat, 10.0 + i, 10.25 + i, 0,
                        dict(pod="p0", device=dev, bytes=nbytes))
    for kind, attrs in (
            ("submit", dict(job="j1", pod="p0", priority=1)),
            ("place", dict(job="j1", pod="p0", device="device0",
                           bytes=1024)),
            ("place", dict(job="j2", pod="p0", device="device1",
                           bytes=512)),
            ("place", dict(job="j3", pod="p1", device="device0", bytes=64)),
            ("admit", dict(_STEP, job="j1", modeled_s=None,
                           measured_s=0.5)),
            ("step", dict(_STEP, job="j1", modeled_s=0.25,
                          measured_s=0.5)),
            ("step", dict(_STEP, job="j1", modeled_s=0.5, measured_s=0.5)),
            ("complete", dict(_STEP, job="j1", priority=1, deadline_s=9.0,
                              measured_s=2.0, queue_wait_s=0.5))):
        tr.event(kind, **attrs)
    tr.incr("dispatch_hits", 3)
    return tr


def test_memory_margins_equal_the_reference():
    got = memory_calibration(_record(obs))
    want = jobs_.memory_calibration(_record(jobs_))
    assert [m.as_dict() for m in got] == [m.as_dict() for m in want]
    margins = {(m.pod, m.device): m for m in got}
    assert margins[("p0", "device0")].margin == pytest.approx(2.0)
    assert margins[("p0", "device1")].margin == pytest.approx(512 / 768)
    assert margins[("p1", "device0")].margin == float("inf")   # one-sided


def test_metrics_text_equals_the_reference():
    """``metrics_text()``: the tracer's families, the calibration,
    memory-margin and SLO ones, the same text for the same trace."""
    prev, jprev = obs.set_tracer(_record(obs)), \
        jobs_.set_tracer(_record(jobs_))
    try:
        text, want = obs.metrics_text(), jobs_.metrics_text()
    finally:
        obs.set_tracer(prev)
        jobs_.set_tracer(jprev)
    assert text == want
    for fam in REQUIRED_FAMILIES:
        assert f"# TYPE {fam} " in text, fam
    assert 'repro_slo_attainment_ratio{priority="1"} 1' in text
    assert 'repro_memory_margin_ratio{pod="p0",device="device0"} 2' in text


def test_http_round_trip_on_port_0():
    prev = obs.set_tracer(_record(obs))
    try:
        with obs.MetricsServer(port=0) as srv:
            assert srv.port > 0 and srv.url.endswith("/metrics")
            with urllib.request.urlopen(srv.url, timeout=10) as resp:
                assert resp.status == 200
                assert resp.headers["Content-Type"].startswith("text/plain")
                body = resp.read().decode("utf-8")
            with pytest.raises(urllib.error.HTTPError):
                urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.port}/nope", timeout=10)
            assert body == obs.metrics_text()
        assert srv._httpd is None              # stopped, thread joined
    finally:
        obs.set_tracer(prev)
    assert 'kind="step"' in body


# --------------------------------------------------------------------------
# the ledger fed by a scheduled run, as the reference's is
# --------------------------------------------------------------------------

def test_scheduled_run_feeds_the_ledger_as_the_reference():
    """Two CGLS jobs on one slot of each package, traced: the same event
    and sample counts per kind, the same keys."""
    tracer, jtracer = obs.Tracer(enabled=True), jobs_.Tracer(enabled=True)
    prev, jprev = obs.set_tracer(tracer), jobs_.set_tracer(jtracer)
    try:
        sched = Scheduler(pool=DevicePool(1, MemoryModel(220 * KIB, 1.0),
                                          devices=[CPU]), name="p0")
        jsched = jserve.Scheduler(
            n_devices=1, memory=JMemoryModel(220 * KIB, 1.0), name="p0")
        for _ in range(2):
            sched.submit(ReconJob("cgls", GEO, ANGLES, PROJ, n_iter=2))
            jsched.submit(jserve.ReconJob("cgls", JConeGeometry.nice(16),
                                          ANGLES, PROJ, n_iter=2))
        sched.run()
        jsched.run()
        led, want = CalibrationLedger.from_events(), \
            jobs_.CalibrationLedger.from_events()
    finally:
        obs.set_tracer(prev)
        jobs_.set_tracer(jprev)
    assert led.events_by_kind() == want.events_by_kind()
    assert led.samples_by_kind() == want.samples_by_kind()
    assert led.samples_by_kind()["step"] >= 2
    assert [vars(s.key) for s in led.entries()] == \
        [vars(s.key) for s in want.entries()]
    s = sched.summary()
    assert s["calibration"]["step"]["samples"] >= 2
