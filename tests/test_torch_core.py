"""The port's own copies of the reference's numpy-only modules, its span
recorder, and its import hygiene.

The port imports nothing of the JAX package, so it keeps its own copies of
``repro.core.{geometry,splitting,plan,phantoms}``.  These tests guard the
copies against drift: ``plan()`` equal to the reference's field by field
(slab ranges, angle chunks, step lists) over a sweep of geometries and
budgets, and the phantoms equal bit for bit.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core import geometry as jgeometry
from repro.core import phantoms as jphantoms
from repro.core import plan as jplan
from repro.core import splitting as jsplitting
from repro_torch import obs
from repro_torch.core import geometry, phantoms, plan, splitting

SRC = Path(__file__).resolve().parents[1] / "src"


def _pair(**kw):
    return jgeometry.ConeGeometry(**kw), geometry.ConeGeometry(**kw)


GEOMETRIES = [
    dict(),
    dict(n_voxel=(16, 16, 16), n_detector=(16, 16)),
    dict(n_voxel=(18, 24, 24), s_voxel=(200.0, 256.0, 256.0)),
    dict(n_voxel=(64, 48, 40), n_detector=(32, 64),
         s_detector=(204.8, 409.6), off_origin=(3.0, 0.0, 0.0)),
    dict(n_voxel=(512, 512, 512), n_detector=(512, 512)),
]
BUDGETS = [None, 40 * 1024, 80 * 1024, 1 << 20, 256 << 20, 2 << 30]


def _as_tuple(x):
    """A plan object as nested plain tuples (classes differ per package)."""
    if dataclasses.is_dataclass(x):
        return (type(x).__name__,) + tuple(
            _as_tuple(getattr(x, f.name)) for f in dataclasses.fields(x)
            if f.name != "geo")
    if isinstance(x, (list, tuple)):
        return tuple(_as_tuple(v) for v in x)
    return x


@pytest.mark.parametrize("gkw", GEOMETRIES)
def test_geometry_copy(gkw):
    jg, tg = _pair(**gkw)
    for f in dataclasses.fields(jg):
        assert getattr(jg, f.name) == getattr(tg, f.name)
    for prop in ("d_voxel", "d_detector", "magnification", "fan_half_angle",
                 "cone_half_angle"):
        assert getattr(jg, prop) == getattr(tg, prop)
    for ax in range(3):
        np.testing.assert_array_equal(jg.voxel_centers_1d(ax),
                                      tg.voxel_centers_1d(ax))
    angles = geometry.circular_angles(37)
    np.testing.assert_array_equal(angles, jgeometry.circular_angles(37))
    np.testing.assert_array_equal(geometry.dominant_axis_mask(angles),
                                  jgeometry.dominant_axis_mask(angles))
    with pytest.raises(ValueError, match="fan half-angle"):
        geometry.ConeGeometry(s_detector=(409.6, 4000.0))


@pytest.mark.parametrize("n_devices", [1, 2, 3])
@pytest.mark.parametrize("gkw", GEOMETRIES)
def test_plan_copy_matches_reference(gkw, n_devices):
    jg, tg = _pair(**gkw)
    for budget in BUDGETS:
        for n_angles in (1, 12, 97):
            for depth in (0, 1, 3):
                jm = jsplitting.MemoryModel() if budget is None else \
                    jsplitting.MemoryModel(device_bytes=budget,
                                           usable_fraction=1.0)
                tm = splitting.MemoryModel() if budget is None else \
                    splitting.MemoryModel(device_bytes=budget,
                                          usable_fraction=1.0)
                try:
                    want = jplan.plan(jg, n_angles, n_devices, jm,
                                      prefetch_depth=depth)
                except MemoryError:
                    with pytest.raises(MemoryError):
                        plan.plan(tg, n_angles, n_devices, tm,
                                  prefetch_depth=depth)
                    continue
                got = plan.plan(tg, n_angles, n_devices, tm,
                                prefetch_depth=depth)
                assert _as_tuple(got) == _as_tuple(want)
                assert got.describe() == want.describe()
                assert got.comm.describe() == want.comm.describe()
                for prop in ("streams", "slab_ranges", "device_of_slab",
                             "angle_ranges", "step_passes",
                             "stream_bytes_on_device", "transfer_bytes"):
                    assert getattr(got, prop) == getattr(want, prop), prop
                assert _as_tuple(got.with_prefetch(0)) == \
                    _as_tuple(want.with_prefetch(0))


def test_splitting_helpers_match_reference():
    for n in (1, 7, 64, 513):
        for k in (1, 2, 5):
            assert splitting.even_splits(n, k) == jsplitting.even_splits(n, k)
    assert splitting.paper_size_limits() == jsplitting.paper_size_limits()
    for n in (1, 2, 4, 6, 7, 8, 12):
        assert plan.choose_reduction(n) == jplan.choose_reduction(n)


@pytest.mark.parametrize("gkw", GEOMETRIES[1:4])
def test_phantoms_copy_bit_identical(gkw):
    jg, tg = _pair(**gkw)
    angles = geometry.circular_angles(5)
    for name in ("shepp_logan", "sphere"):
        np.testing.assert_array_equal(getattr(phantoms, name)(tg),
                                      getattr(jphantoms, name)(jg))
    for name in ("sphere_projection_analytic",
                 "shepp_logan_projection_analytic"):
        np.testing.assert_array_equal(getattr(phantoms, name)(tg, angles),
                                      getattr(jphantoms, name)(jg, angles))


def test_tracer_spans_counters_and_zero_cost_default():
    t = obs.Tracer(enabled=False)
    assert t.span("x") is obs.trace._NULL and t.begin("x") is None
    t.incr("c")
    assert t.counters() == {}
    t.enable()
    with t.span("staging", "h2d", bytes=8):
        pass
    h = t.begin("fp_slab", "compute", slab=0)
    t.end(h, done=True)
    t.incr("dispatch_hits", 2)
    (s1, s2) = t.spans()
    assert (s1.name, s1.cat, s1.attrs) == ("staging", "h2d", {"bytes": 8})
    assert s2.attrs == {"slab": 0, "done": True} and s2.duration >= 0
    assert set(t.phase_seconds()) == {"h2d", "compute"}
    assert t.counters() == {"dispatch_hits": 2}
    h = t.begin("orphan")
    t.clear()
    t.end(h)                       # a handle from before clear() is dropped
    assert t.spans() == [] and t.counters() == {}
    prev = obs.set_tracer(t)
    try:
        assert obs.enabled()
        with obs.span("compute"):
            pass
        obs.incr("dispatch_misses")
    finally:
        obs.set_tracer(prev)
    assert len(t.spans(cat="compute")) == 1
    assert t.counters() == {"dispatch_misses": 1}


def _port_modules():
    root = SRC / "repro_torch"
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(SRC).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_port_imports_neither_jax_nor_the_reference():
    """Every module of the port, imported in a fresh interpreter, leaves
    ``jax`` and ``repro`` out of ``sys.modules``; importing builds no
    kernel."""
    mods = list(_port_modules())
    assert "repro_torch.kernels.build" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or"
        " m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "from repro_torch.kernels import build\n"
        "assert not build._LIBS\n"
        "print('ok', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(SRC)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_port_sources_name_no_jax():
    for path in (SRC / "repro_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not (s.startswith(("import jax", "from jax",
                                      "import repro.", "from repro."))
                        or s == "import repro"), f"{path}: {line}"
