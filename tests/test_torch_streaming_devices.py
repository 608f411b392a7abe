"""The port's streaming executors on several devices, its Fig 9 timeline
and its trace exporters, against the JAX package.

The JAX side streams over two of the conftest's forced host devices; the
port side over ``devices=["cpu", "cpu"]``, where both lanes share one
device.  Inputs are drawn by numpy from seeds.  Bands are the reference's
(tests/test_streaming.py, tests/test_comm_schedule.py):

* streamed FP and BP on two devices against the in-core operator: rtol =
  atol = 1e-4; against the reference's streamed results the same for the
  BP and the kernel band (rtol 2e-4, atol 5e-3, tests/test_backend.py:23)
  for the FP, within which the port's in-core FP already agrees with the
  reference's at N=32;
* every prefetch depth bit-identical to ``with_prefetch(0)`` on two
  devices, for FP, the voxel-driven BP and the matched BP;
* fewer devices than the plan wants raises;
* the ``Timeline`` bins, and the same bin sequence as the reference's on
  the same plan;
* the Chrome-trace JSON and the Prometheus text of the port's copy of
  ``obs/trace.py`` equal the reference's for the same records.
"""

import json

import jax
import numpy as np
import pytest
import torch

from repro.core import streaming as jstream
from repro.core.geometry import ConeGeometry as JaxGeometry
from repro.core.operator import CTOperator as JaxOperator
from repro.core.plan import plan as jplan
from repro.core.splitting import MemoryModel as JaxMemoryModel
from repro.obs import trace as jtrace
from repro_torch import obs
from repro_torch.core.geometry import ConeGeometry, circular_angles
from repro_torch.core.operator import CTOperator
from repro_torch.core.plan import plan
from repro_torch.core.splitting import MemoryModel
from repro_torch.core.streaming import (Timeline, stream_backward,
                                        stream_forward)
from repro_torch.obs import trace as ttrace

GEO = ConeGeometry.nice(32)
ANGLES = circular_angles(12)
BAND = dict(rtol=1e-4, atol=1e-4)
BAND_KERNEL = dict(rtol=2e-4, atol=5e-3)
TWO = ["cpu", "cpu"]


def _rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _mem(kib=80, cls=MemoryModel):
    return cls(device_bytes=kib * 1024, usable_fraction=1.0)


def _plans(geo, n_angles, n_dev, kib=80, **kw):
    """The port's and the reference's plan for one case (equal field for
    field, tests/test_torch_core.py)."""
    jgeo = JaxGeometry.nice(32).with_voxels(geo.n_voxel)
    return (plan(geo, n_angles, n_dev, _mem(kib), **kw),
            jplan(jgeo, n_angles, n_dev, _mem(kib, JaxMemoryModel), **kw))


def _jax_devs(n):
    return jax.local_devices()[:n]


def test_stream_forward_multidevice():
    vol = _rand(2, GEO.n_voxel)
    pl, jpl = _plans(GEO, len(ANGLES), 2, angle_chunk_fp=4)
    assert pl.forward.n_slabs > 1 and len(pl.forward.angle_ranges) == 2
    got = stream_forward(vol, GEO, ANGLES, pl, devices=TWO, backend="cuda")
    want = jstream.stream_forward(vol, JaxGeometry.nice(32), ANGLES, jpl,
                                  devices=_jax_devs(2))
    np.testing.assert_allclose(got.numpy(), want, **BAND_KERNEL)
    plain = CTOperator(GEO, ANGLES, backend="cuda", device="cpu").A(vol)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **BAND)


@pytest.mark.parametrize("weight", ["fdk", "matched"])
def test_stream_backward_multidevice(weight):
    proj = _rand(3, (len(ANGLES),) + GEO.n_detector)
    pl, jpl = _plans(GEO, len(ANGLES), 2, angle_chunk_bp=4)
    assert set(pl.backward.device_of_slab) == {0, 1}
    got = stream_backward(proj, GEO, ANGLES, pl, weight=weight, devices=TWO,
                          backend="cuda")
    plain = CTOperator(GEO, ANGLES, backend="cuda", device="cpu").At(
        proj, weight=weight)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **BAND)
    if weight == "fdk":
        want = jstream.stream_backward(proj, JaxGeometry.nice(32), ANGLES,
                                       jpl, weight=weight,
                                       devices=_jax_devs(2))
        np.testing.assert_allclose(got.numpy(), want, **BAND)


def test_stream_rejects_fewer_devices_than_planned():
    vol = _rand(5, GEO.n_voxel)
    proj = _rand(6, (len(ANGLES),) + GEO.n_detector)
    pl, _ = _plans(GEO, len(ANGLES), 2, angle_chunk_fp=4, angle_chunk_bp=4)
    for kw in (dict(devices=["cpu"]), dict(device="cpu")):
        with pytest.raises(ValueError, match="plan wants 2 devices, got 1"):
            stream_forward(vol, GEO, ANGLES, pl, **kw)
        with pytest.raises(ValueError, match="plan wants 2 devices, got 1"):
            stream_backward(proj, GEO, ANGLES, pl, weight="fdk", **kw)


@pytest.mark.parametrize("weight", ["fdk", "matched"])
def test_stream_overlap_bit_identical_two_devices(weight):
    """The schedule changes when bytes move, never the accumulation
    order: every depth equals the serial schedule bit for bit, on an odd
    shape split into slabs in both directions."""
    geo = ConeGeometry.nice(16).with_voxels((10, 13, 13))
    angles = circular_angles(9)
    vol = _rand(7, geo.n_voxel)
    proj = _rand(8, (9,) + geo.n_detector)
    pl = plan(geo, 9, 2, _mem(10), angle_chunk_fp=4, angle_chunk_bp=4)
    assert pl.forward.n_slabs > 1 and pl.backward.n_slabs > 2
    serial = pl.with_prefetch(0)
    kw = dict(devices=TWO, backend="cuda")
    fp0 = stream_forward(vol, geo, angles, serial, **kw)
    bp0 = stream_backward(proj, geo, angles, serial, weight=weight, **kw)
    for depth in (1, 3):
        p = pl.with_prefetch(depth)
        assert torch.equal(stream_forward(vol, geo, angles, p, **kw), fp0)
        assert torch.equal(
            stream_backward(proj, geo, angles, p, weight=weight, **kw), bp0)


def test_device_shorthand_and_operator_devices():
    """``device=d`` is ``devices=[d]``, and a stream-mode operator on two
    devices plans for two, as the reference's does, and matches the
    in-core operator."""
    vol = _rand(9, GEO.n_voxel)
    pl, _ = _plans(GEO, len(ANGLES), 1, angle_chunk_fp=4)
    assert torch.equal(stream_forward(vol, GEO, ANGLES, pl, device="cpu"),
                       stream_forward(vol, GEO, ANGLES, pl, devices=["cpu"]))
    op = CTOperator(GEO, ANGLES, mode="stream", devices=TWO, memory=_mem(),
                    backend="cuda")
    jop = JaxOperator(JaxGeometry.nice(32), ANGLES, mode="stream",
                      devices=_jax_devs(2),
                      memory=_mem(80, JaxMemoryModel))
    assert op.plan.n_devices == 2 == jop.plan.n_devices
    assert op.plan.forward.slab_ranges == jop.plan.forward.slab_ranges
    assert op.data_device == torch.device("cpu")
    plain = CTOperator(GEO, ANGLES, backend="cuda", device="cpu")
    np.testing.assert_allclose(op.A(vol).numpy(), plain.A(vol).numpy(),
                               **BAND)


# --------------------------------------------------------------------------
# the Fig 9 timeline and the spans
# --------------------------------------------------------------------------

def test_timeline_bins():
    vol = _rand(4, GEO.n_voxel)
    pl, _ = _plans(GEO, len(ANGLES), 1, angle_chunk_fp=4)
    tl = Timeline()
    stream_forward(vol, GEO, ANGLES, pl, device="cpu", timeline=tl)
    fr = tl.fractions()
    assert set(fr) >= {"compute", "staging"}
    assert abs(sum(fr.values()) - 1.0) < 1e-6
    assert fr["compute"] > 0
    assert "compute" in repr(tl)


@pytest.mark.parametrize("op", ["fp", "bp"])
def test_timeline_attribution_matches_reference(op):
    """The same plan gives the same sequence of bins as the reference's
    run: one per h2d and d2h step, one per FP compute run and per BP
    compute step."""
    proj = _rand(10, (len(ANGLES),) + GEO.n_detector)
    vol = _rand(11, GEO.n_voxel)
    pl, jpl = _plans(GEO, len(ANGLES), 2, angle_chunk_fp=4,
                     angle_chunk_bp=4)
    tl, jtl = Timeline(), jstream.Timeline()
    jgeo = JaxGeometry.nice(32)
    if op == "fp":
        stream_forward(vol, GEO, ANGLES, pl, devices=TWO, timeline=tl,
                       backend="cuda")
        jstream.stream_forward(vol, jgeo, ANGLES, jpl, devices=_jax_devs(2),
                               timeline=jtl)
    else:
        stream_backward(proj, GEO, ANGLES, pl, weight="fdk", devices=TWO,
                        timeline=tl, backend="cuda")
        jstream.stream_backward(proj, jgeo, ANGLES, jpl, weight="fdk",
                                devices=_jax_devs(2), timeline=jtl)
    assert [b for b, _ in tl.events] == [b for b, _ in jtl.events]
    assert set(tl.bins) == set(jtl.bins)


def test_streaming_spans_carry_both_devices():
    vol = _rand(12, GEO.n_voxel)
    pl, _ = _plans(GEO, len(ANGLES), 2, angle_chunk_fp=4)
    tracer = obs.Tracer(enabled=True)
    prev = obs.set_tracer(tracer)
    try:
        stream_forward(vol, GEO, ANGLES, pl, devices=TWO, backend="cuda")
    finally:
        obs.set_tracer(prev)
    slabs = tracer.spans(name="fp_slab")
    assert {s.attrs["device"] for s in slabs} == {0, 1}
    assert len(slabs) == 2 * pl.forward.n_slabs
    assert {s.cat for s in tracer.spans(name="staging")} <= {"h2d",
                                                            "prefetch"}
    assert len(tracer.spans(cat="d2h")) == 2


# --------------------------------------------------------------------------
# the exporters: the port's copy of obs/trace.py against the reference's
# --------------------------------------------------------------------------

def _records(mod):
    attrs = {"device": 1, "pod": "p0", "bytes": np.int64(4096)}
    return [mod.Span("staging", "h2d", 10.0, 10.5, 7, 0, dict(attrs)),
            mod.Span("fp_slab", "compute", 10.5, 12.0, 7, 1,
                     {"device": 0, "slab": 2}),
            mod.InstantEvent("admit", 11.0, 8, 2, {"job": "job-1"}),
            mod.Span("reduce", "reduce", 12.0, 12.25, 9, 3, {})]


def _fill(mod):
    t = mod.Tracer(enabled=True)
    for r in _records(mod):
        if isinstance(r, mod.Span):
            t._finish_span(r.name, r.cat, r.t0, r.t1, r.thread, r.attrs)
    with t.context(job="job-2", pod="p1"):
        t.event("complete", ok=True)
    t.incr("dispatch_hits", 3)
    return t


def test_chrome_trace_and_prometheus_match_reference(tmp_path):
    assert ttrace.chrome_trace(_records(ttrace)) == \
        jtrace.chrome_trace(_records(jtrace))
    t, j = _fill(ttrace), _fill(jtrace)
    assert t.prometheus() == j.prometheus()
    assert t.events(kind="complete")[0].attrs == {"job": "job-2",
                                                 "pod": "p1", "ok": True}
    path = tmp_path / "trace.json"
    t.write_chrome_trace(str(path))
    got = json.loads(path.read_text())
    want = j.chrome_trace()
    for ev in got["traceEvents"] + want["traceEvents"]:
        ev.pop("ts", None)          # wall clocks of the two event() calls
    assert got == want
    assert ttrace.PHASE_CATEGORIES == jtrace.PHASE_CATEGORIES


def test_module_level_exporters(tmp_path):
    tracer = obs.Tracer(enabled=True)
    prev = obs.set_tracer(tracer)
    try:
        with obs.context(job="j"):
            with obs.span("compute", op="fp"):
                obs.event("step", n=1)
        path = tmp_path / "t.json"
        obs.write_chrome_trace(str(path))
        text = obs.prometheus_snapshot()
    finally:
        obs.set_tracer(prev)
    names = {e["name"] for e in json.loads(path.read_text())["traceEvents"]}
    assert {"compute", "step"} <= names
    assert 'repro_events_total{kind="step"} 1' in text
    assert tracer.spans()[0].attrs == {"job": "j", "op": "fp"}
