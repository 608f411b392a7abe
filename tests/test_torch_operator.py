"""The port's operator, backends and streaming executors.

* the adjoint identity <A x, y> == <x, A^T y> (relative defect <= 1e-4,
  fp64 dot products; tests/test_adjoint.py:36-50) in plain and stream mode
  and for both dominances;
* ``CTOperator.A`` / ``At(matched)`` against the JAX package's
  ``CTOperator(backend="pallas")`` (interpret mode) in plain mode and in
  stream mode under the tiny budget of tests/test_adjoint.py:53-58, within
  the kernel band rtol 2e-4, atol 5e-3;
* streaming invariants: every prefetch depth bit-identical to
  ``with_prefetch(0)`` in both directions, stream mode == plain mode;
* the backend registry: the cuda pair is an autograd Function whose
  backward is the matched kernel, and its matched path builds no ref
  operator;
* no hidden device: without ``device`` an entry point needs the card.

The ``"cuda"`` backend runs its kernels' plain versions here (the tensors
lie on the CPU), so the plumbing around the kernels is what is tested.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.geometry import ConeGeometry as JaxGeometry
from repro.core.operator import CTOperator as JaxOperator
from repro.core.splitting import MemoryModel as JaxMemoryModel
from repro_torch import kernels, obs
from repro_torch.core import backend as backend_mod
from repro_torch.core.backend import (available_backends,
                                      clear_dispatch_cache,
                                      dispatch_cache_info,
                                      dispatch_cache_keys, get_backend,
                                      resolve)
from repro_torch.core.geometry import (ConeGeometry, circular_angles,
                                       dominant_axis_mask)
from repro_torch.core.operator import CTOperator
from repro_torch.core.splitting import MemoryModel
from repro_torch.core.streaming import stream_backward, stream_forward

RTOL, ATOL = 2e-4, 5e-3
REL_TOL = 1e-4
GEO = ConeGeometry.nice(16)
ANGLES = circular_angles(8)          # mixed x/y dominance
SHAPES = [(16, 16, 16), (18, 24, 24), (20, 25, 25)]
CPU = "cpu"


def _tiny(geo, n_angles, cls=MemoryModel):
    """The budget of tests/test_adjoint.py:53-58: about a third of the
    volume plus room for the projection buffers."""
    nz, ny, nx = geo.n_voxel
    nv, nu = geo.n_detector
    return cls(device_bytes=(nz * ny * nx * 4) // 3 + 12 * n_angles * nv * nu,
               usable_fraction=1.0)


def _op(geo, angles, mode, backend="cuda"):
    kw = dict(mode=mode, bp_weight="matched", backend=backend, device=CPU)
    if mode == "stream":
        kw["memory"] = _tiny(geo, len(angles))
    return CTOperator(geo, angles, **kw)


def _data(shape, n_angles, seed=0):
    rng = np.random.default_rng(seed)
    geo = GEO.with_voxels(shape)
    x = rng.standard_normal(shape).astype(np.float32)
    y = rng.standard_normal((n_angles,) + geo.n_detector).astype(np.float32)
    return geo, x, y


def assert_adjoint_pair(A, At, x, y, rel_tol=REL_TOL):
    ax = np.asarray(A(torch.from_numpy(x)), np.float64)
    aty = np.asarray(At(torch.from_numpy(y)), np.float64)
    lhs = float(np.vdot(ax.ravel(), y.astype(np.float64).ravel()))
    rhs = float(np.vdot(x.astype(np.float64).ravel(), aty.ravel()))
    rel = abs(lhs - rhs) / max(abs(lhs), abs(rhs), 1e-30)
    assert rel < rel_tol, f"<Ax,y>={lhs:.8g} vs <x,At y>={rhs:.8g} ({rel:.3g})"


# --------------------------------------------------------------------------
# the adjoint identity
# --------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["ref", "cuda"])
@pytest.mark.parametrize("shape", SHAPES)
def test_adjoint_plain(backend, shape):
    geo, x, y = _data(shape, len(ANGLES))
    op = _op(geo, ANGLES, "plain", backend)
    assert_adjoint_pair(op.A, op.At, x, y)


@pytest.mark.parametrize("mode", ["plain", "stream"])
@pytest.mark.parametrize("dominance", ["x", "y"])
def test_adjoint_single_dominance(mode, dominance):
    mask = dominant_axis_mask(ANGLES)
    sub = ANGLES[mask if dominance == "x" else ~mask]
    geo, x, y = _data((16, 16, 16), len(sub), seed=1)
    op = _op(geo, sub, mode)
    assert_adjoint_pair(op.A, op.At, x, y)


@pytest.mark.parametrize("backend", ["ref", "cuda"])
@pytest.mark.parametrize("shape", SHAPES[:2])
def test_adjoint_stream(backend, shape):
    geo, x, y = _data(shape, len(ANGLES), seed=2)
    op = _op(geo, ANGLES, "stream", backend)
    assert op.plan.streams, "budget should force slab splitting"
    assert_adjoint_pair(op.A, op.At, x, y)


# --------------------------------------------------------------------------
# operator parity against the JAX package
# --------------------------------------------------------------------------

def _jax_op(shape, mode):
    jg = JaxGeometry.nice(16).with_voxels(shape)
    kw = {"memory": _tiny(jg, len(ANGLES), JaxMemoryModel)} \
        if mode == "stream" else {}
    return JaxOperator(jg, ANGLES, mode=mode, bp_weight="matched",
                       backend="pallas", **kw)


@pytest.mark.parametrize("shape", SHAPES)
def test_operator_plain_matches_jax_pallas(shape):
    geo, x, y = _data(shape, len(ANGLES), seed=3)
    jop = _jax_op(shape, "plain")
    op = _op(geo, ANGLES, "plain")
    np.testing.assert_allclose(op.A(x).numpy(),
                               np.asarray(jop.A(jnp.asarray(x))),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(op.At(y).numpy(),
                               np.asarray(jop.At(jnp.asarray(y),
                                                 weight="matched")),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", SHAPES[:2])
def test_operator_stream_matches_jax_pallas(shape):
    geo, x, y = _data(shape, len(ANGLES), seed=4)
    jop = _jax_op(shape, "stream")
    op = _op(geo, ANGLES, "stream")
    assert op.plan.streams and jop.plan.streams
    assert op.plan.forward.slab_ranges == jop.plan.forward.slab_ranges
    np.testing.assert_allclose(op.A(x).numpy(), np.asarray(jop.A(x)),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(op.At(y).numpy(),
                               np.asarray(jop.At(y, weight="matched")),
                               rtol=RTOL, atol=ATOL)


# --------------------------------------------------------------------------
# streaming invariants
# --------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_prefetch_depths_bit_identical(backend):
    geo, x, y = _data((18, 24, 24), len(ANGLES), seed=5)
    op = _op(geo, ANGLES, "stream", backend)
    want_a = stream_forward(x, geo, ANGLES, op.plan.with_prefetch(0),
                            device=CPU, backend=backend)
    want_t = stream_backward(y, geo, ANGLES, op.plan.with_prefetch(0),
                             device=CPU, backend=backend)
    for depth in (1, 2, 5):
        pl = op.plan.with_prefetch(depth)
        assert any(s.prefetch for s in pl.comm.fp_steps + pl.comm.bp_steps)
        assert torch.equal(stream_forward(x, geo, ANGLES, pl, device=CPU,
                                          backend=backend), want_a)
        assert torch.equal(stream_backward(y, geo, ANGLES, pl, device=CPU,
                                           backend=backend), want_t)


@pytest.mark.parametrize("shape", SHAPES[:2])
def test_stream_equals_plain(shape):
    geo, x, y = _data(shape, len(ANGLES), seed=6)
    plain, stream = _op(geo, ANGLES, "plain"), _op(geo, ANGLES, "stream")
    assert stream.plan.forward.n_slabs > 1 and stream.plan.backward.n_slabs > 1
    torch.testing.assert_close(stream.A(x), plain.A(x), rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(stream.At(y), plain.At(y), rtol=RTOL,
                               atol=ATOL)
    assert stream.data_device == torch.device("cpu")


def test_stream_rejects_a_multi_device_plan_and_fdk_weights():
    geo, x, y = _data((16, 16, 16), len(ANGLES))
    from repro_torch.core.plan import plan
    pl = plan(geo, len(ANGLES), 2, _tiny(geo, len(ANGLES)))
    with pytest.raises(ValueError, match="2 devices"):
        stream_forward(x, geo, ANGLES, pl, device=CPU)
    with pytest.raises(NotImplementedError, match="FDK"):
        stream_backward(y, geo, ANGLES, pl, weight="fdk", device=CPU)


def test_streaming_emits_the_reference_spans():
    geo, x, y = _data((16, 16, 16), len(ANGLES), seed=7)
    op = _op(geo, ANGLES, "stream")
    tracer = obs.Tracer(enabled=True)
    prev = obs.set_tracer(tracer)
    try:
        op.A(x)
        op.At(y)
    finally:
        obs.set_tracer(prev)
    n_fp = op.plan.forward.n_slabs
    assert len(tracer.spans(name="fp_slab")) == n_fp
    cats = {s.cat for s in tracer.spans(name="staging")}
    assert cats == {"h2d", "prefetch"}
    assert {s.cat for s in tracer.spans(name="other_memory")} == {"d2h"}
    assert tracer.spans(name="compute", cat="compute")
    c = tracer.counters()
    assert c.get("dispatch_hits", 0) > 0


# --------------------------------------------------------------------------
# backend registry
# --------------------------------------------------------------------------

def test_registry_resolve(monkeypatch):
    assert set(available_backends()) == {"ref", "cuda", "auto"}
    assert resolve("auto", CPU) == "ref"
    assert resolve(None, CPU) == "ref"
    assert resolve("auto", torch.device("cuda", 0)) == "cuda"
    assert resolve("cuda", CPU) == "cuda"
    with pytest.raises(ValueError, match="unknown kernel backend"):
        resolve("pallas", CPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve("auto")


@pytest.mark.parametrize("dominance", ["x", "y"])
def test_cuda_fp_backward_is_the_matched_kernel(dominance):
    """Autograd through the cuda backend's FP routes through bp_matched
    and equals the matched At of the cotangent."""
    mask = dominant_axis_mask(ANGLES)
    sub = torch.from_numpy(ANGLES[mask if dominance == "x" else ~mask])
    bk = get_backend("cuda")
    fp = bk.fp(GEO, xdom=dominance == "x")
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal(GEO.n_voxel).astype(np.float32))
    r = torch.from_numpy(rng.standard_normal(
        (len(sub),) + GEO.n_detector).astype(np.float32))
    x.requires_grad_(True)
    kernels.reset_counters()
    (fp(x, sub, 0) * r).sum().backward()
    assert kernels.counters()["bp_matched"]["plain_calls"] == 1
    want = bk.bp_matched(GEO, planes=GEO.n_voxel[0],
                         xdom=dominance == "x")(r, sub, 0)
    torch.testing.assert_close(x.grad, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["plain", "stream"])
def test_cuda_matched_path_builds_no_ref_operators(mode):
    clear_dispatch_cache()
    op = _op(GEO, ANGLES, mode)
    op.A(np.ones(GEO.n_voxel, np.float32))
    op.At(np.ones((len(ANGLES),) + GEO.n_detector, np.float32))
    keys = dispatch_cache_keys()
    assert keys and not [k for k in keys if k[0] == "ref"], keys
    kinds = {k[1] for k in keys}
    assert ("at_matched_mixed" if mode == "plain" else "bp_matched") in kinds
    info = dispatch_cache_info()
    assert info["currsize"] == len(keys)


def test_unported_paths_raise_and_name_the_later_slice():
    with pytest.raises(NotImplementedError, match="distributed slice"):
        CTOperator(GEO, ANGLES, mode="dist", device=CPU)
    op = _op(GEO, ANGLES, "plain")
    y = np.ones((len(ANGLES),) + GEO.n_detector, np.float32)
    for weight in ("fdk", "pmatched", "none"):
        with pytest.raises(NotImplementedError, match="FDK"):
            op.At(y, weight=weight)
    with pytest.raises(ValueError, match="unknown mode"):
        CTOperator(GEO, ANGLES, mode="nope", device=CPU)


def test_operator_surface():
    op = _op(GEO, ANGLES, "plain")
    jop = JaxOperator(JaxGeometry.nice(16), ANGLES, backend="ref")
    for a, b in zip(op.subset_indices(3), jop.subset_indices(3)):
        np.testing.assert_array_equal(a, b)
    assert op.kernel_config() == {}
    op.warmup()
    _op(GEO, ANGLES, "stream").warmup()
    lam = op.norm_squared_est(n_iter=4, seed=1)
    ref = _op(GEO, ANGLES, "plain", "ref").norm_squared_est(n_iter=4, seed=1)
    assert lam > 0 and abs(lam - ref) / ref < 1e-3
    # a subset of angles passed per call
    sub = ANGLES[:3]
    x = np.random.default_rng(9).standard_normal(GEO.n_voxel).astype(
        np.float32)
    torch.testing.assert_close(op.A(x, angles=sub), op.A(x)[:3])


# --------------------------------------------------------------------------
# no hidden device
# --------------------------------------------------------------------------

def test_entry_points_need_the_card_unless_asked_for_cpu(monkeypatch):
    from repro_torch.data import make_ct_dataset
    from repro_torch.launch.recon import reconstruct
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CTOperator(GEO, ANGLES)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_ct_dataset(GEO, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        reconstruct("cgls", n=16, n_angles=8, iters=1, verbose=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stream_forward(np.zeros(GEO.n_voxel, np.float32), GEO, ANGLES,
                       _op(GEO, ANGLES, "stream").plan)


def test_cpu_runs_touch_no_kernel():
    kernels.reset_counters()
    for mode in ("plain", "stream"):
        op = CTOperator(GEO, ANGLES, mode=mode, backend="cuda", device=CPU,
                        memory=_tiny(GEO, len(ANGLES)))
        op.At(op.A(np.ones(GEO.n_voxel, np.float32)))
    c = kernels.counters()
    assert c["fp_ray"]["launches"] == 0 and c["bp_matched"]["launches"] == 0
    assert c["fp_ray"]["plain_calls"] > 0 and c["bp_matched"]["plain_calls"] > 0
    assert backend_mod.get_backend("auto", CPU).name == "ref"
