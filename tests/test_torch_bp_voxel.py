"""The port's voxel-driven backprojector against the JAX package.

* ``bp_voxel_plain`` (the oracle of ``csrc/bp_voxel.cu``) against the
  reference's Pallas ``bp_voxel_pallas`` in interpret mode, for each weight,
  for whole volumes and z slabs, within the kernel band of
  tests/test_kernels.py:59 (rtol 2e-4, atol 2e-3);
* the port's ``projector.backproject_voxel`` (the ``"ref"`` backend)
  against the reference projector, prime shapes included: those are held
  against the reference projector, not the Pallas pad path;
* ``CTOperator.At(weight=...)`` in plain mode against the JAX operator on
  ``backend="pallas"``; streamed ``At`` against plain at 2e-3 and the same
  bits at every prefetch depth;
* the wrappers' dispatch, counters and refusals.

The CUDA kernel itself is held against ``bp_voxel_plain`` on the card by
tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.geometry import ConeGeometry as JaxGeometry
from repro.core.operator import CTOperator as JaxOperator
from repro.core.projector import backproject_voxel as jax_backproject_voxel
from repro.kernels.bp_voxel import bp_voxel_pallas
from repro_torch import kernels
from repro_torch.core import projector
from repro_torch.core.backend import clear_dispatch_cache, dispatch_cache_keys
from repro_torch.core.geometry import ConeGeometry, circular_angles
from repro_torch.core.operator import CTOperator
from repro_torch.core.splitting import MemoryModel
from repro_torch.core.streaming import stream_backward
from repro_torch.kernels.bp_voxel import (bp_voxel, bp_voxel_cuda,
                                          bp_voxel_plain)

RTOL, ATOL = 2e-4, 2e-3          # tests/test_kernels.py:59
STREAM_TOL = 2e-3                # tests/test_algorithms.py:77-78
WEIGHTS = ("fdk", "pmatched", "none")
CPU = "cpu"


def _case(n, n_angles, seed=0, geo_kw=None):
    """(JAX geometry, port geometry, angles, projections) from a numpy
    seed."""
    if geo_kw is None:
        jg, tg = JaxGeometry.nice(n), ConeGeometry.nice(n)
    else:
        jg, tg = JaxGeometry(**geo_kw), ConeGeometry(**geo_kw)
    angles = circular_angles(n_angles)
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((n_angles,) + tg.n_detector).astype(np.float32)
    return jg, tg, angles, y


def _slab(nz, part):
    return (0, nz) if part == "full" else (nz // 3, nz // 3 + nz // 2)


@pytest.mark.parametrize("part", ["full", "slab"])
@pytest.mark.parametrize("weight", WEIGHTS)
@pytest.mark.parametrize("n,n_angles", [(16, 8), (24, 12)])
def test_plain_matches_pallas(n, n_angles, weight, part):
    jg, tg, ang, y = _case(n, n_angles)
    z0, z1 = _slab(n, part)
    want = np.asarray(bp_voxel_pallas(
        jnp.asarray(y), jg, jnp.asarray(ang), z_block=z1 - z0,
        angle_chunk=4, weight=weight, interpret=True, z_start=z0,
        z_planes=z1 - z0))
    got = bp_voxel_plain(torch.from_numpy(y), tg, ang, weight, z0,
                         z1 - z0).numpy()
    assert got.shape == want.shape == (z1 - z0, n, n)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("part", ["full", "slab"])
def test_plain_matches_pallas_with_offsets(part):
    """Non-cubic volume, non-square detector, every offset non-zero."""
    kw = dict(n_voxel=(14, 20, 26), s_voxel=(200.0, 240.0, 260.0),
              n_detector=(18, 22), s_detector=(300.0, 380.0),
              off_origin=(6.0, -9.0, 7.0), off_detector=(11.0, -13.0))
    jg, tg, ang, y = _case(None, 8, seed=1, geo_kw=kw)
    z0, z1 = _slab(14, part)
    want = np.asarray(bp_voxel_pallas(
        jnp.asarray(y), jg, jnp.asarray(ang), z_block=z1 - z0,
        angle_chunk=8, weight="pmatched", interpret=True, z_start=z0,
        z_planes=z1 - z0))
    got = bp_voxel_plain(torch.from_numpy(y), tg, ang, "pmatched", z0,
                         z1 - z0).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    ref = projector.backproject_voxel(torch.from_numpy(y), tg, ang,
                                      "pmatched", z0, z1 - z0).numpy()
    np.testing.assert_allclose(ref, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("part", ["full", "slab"])
@pytest.mark.parametrize("weight", WEIGHTS)
@pytest.mark.parametrize("n,n_angles", [(16, 8), (13, 7)])
def test_projector_matches_reference_projector(n, n_angles, weight, part):
    """The ``"ref"`` backend's projector and, at prime shapes (N=13, 7
    angles), the kernel's oracle too, against the reference projector."""
    jg, tg, ang, y = _case(n, n_angles, seed=2)
    z0, z1 = _slab(n, part)
    want = np.asarray(jax_backproject_voxel(
        jnp.asarray(y), jg, jnp.asarray(ang), weight=weight, z_start=z0,
        z_planes=z1 - z0))
    yt = torch.from_numpy(y)
    got = projector.backproject_voxel(yt, tg, ang, weight, z0,
                                      z1 - z0).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    plain = bp_voxel_plain(yt, tg, ang, weight, z0, z1 - z0).numpy()
    np.testing.assert_allclose(plain, want, rtol=RTOL, atol=ATOL)


def test_slabs_and_angle_chunks_add_up():
    """z slabs of the plain version concatenate to the whole bit for bit
    (the same arithmetic per voxel); angle chunks sum to the whole."""
    _, tg, ang, y = _case(16, 8, seed=3)
    yt = torch.from_numpy(y)
    whole = bp_voxel_plain(yt, tg, ang, "pmatched")
    parts = [bp_voxel_plain(yt, tg, ang, "pmatched", z0, z1 - z0)
             for z0, z1 in ((0, 5), (5, 11), (11, 16))]
    assert torch.equal(torch.cat(parts), whole)
    chunks = (bp_voxel_plain(yt[:3], tg, ang[:3], "pmatched")
              + bp_voxel_plain(yt[3:], tg, ang[3:], "pmatched"))
    torch.testing.assert_close(chunks, whole, rtol=1e-5, atol=1e-5)


def test_wrapper_dispatch_counters_and_refusals():
    _, tg, ang, y = _case(16, 8)
    yt = torch.from_numpy(y)
    kernels.reset_counters()
    out = bp_voxel(yt, tg, ang, "none", 2, 5)
    assert torch.equal(out, bp_voxel_plain(yt, tg, ang, "none", 2, 5))
    c = kernels.counters()["bp_voxel"]
    assert c == {"launches": 0, "plain_calls": 2}
    with pytest.raises(ValueError, match="CUDA tensor"):
        bp_voxel_cuda(yt, tg, ang)
    with pytest.raises(ValueError, match="unknown weight"):
        bp_voxel(yt, tg, ang, "matched")
    with pytest.raises(ValueError, match="unknown weight"):
        projector.backproject_voxel(yt, tg, ang, "bogus")
    with pytest.raises(ValueError, match="projections must be"):
        bp_voxel(yt[:5], tg, ang)
    with pytest.raises(TypeError, match="float32"):
        bp_voxel(yt.double(), tg, ang)
    assert bp_voxel_cuda.launches == 0


def test_backproject_dispatch():
    _, tg, ang, y = _case(16, 8, seed=4)
    yt = torch.from_numpy(y)
    torch.testing.assert_close(projector.backproject(yt, tg, ang, "fdk"),
                               projector.backproject_voxel(yt, tg, ang))
    torch.testing.assert_close(projector.backproject(yt, tg, ang, "matched"),
                               projector.backproject_matched(yt, tg, ang))


# --------------------------------------------------------------------------
# the operator
# --------------------------------------------------------------------------

GEO, JGEO = ConeGeometry.nice(16), JaxGeometry.nice(16)
ANGLES = circular_angles(8)


def _tiny():
    """About a third of the volume plus room for the projection buffers
    (tests/test_adjoint.py:53-58)."""
    nz, ny, nx = GEO.n_voxel
    nv, nu = GEO.n_detector
    return MemoryModel(device_bytes=(nz * ny * nx * 4) // 3
                       + 12 * len(ANGLES) * nv * nu, usable_fraction=1.0)


@pytest.fixture(scope="module")
def y8():
    return _case(16, 8, seed=5)[3]


@pytest.mark.parametrize("weight", WEIGHTS)
@pytest.mark.parametrize("backend", ["cuda", "ref"])
def test_operator_at_matches_jax_pallas(y8, backend, weight):
    want = np.asarray(JaxOperator(JGEO, ANGLES, backend="pallas")
                      .At(jnp.asarray(y8), weight=weight))
    op = CTOperator(GEO, ANGLES, backend=backend, device=CPU)
    got = op.At(y8, weight=weight).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # a subset of the angles passed per call
    sub = CTOperator(GEO, ANGLES[:3], backend=backend, device=CPU)
    torch.testing.assert_close(op.At(y8[:3], ANGLES[:3], weight=weight),
                               sub.At(y8[:3], weight=weight))


@pytest.mark.parametrize("weight", ["pmatched", "fdk"])
def test_stream_at_matches_plain_at_every_depth(y8, weight):
    op = CTOperator(GEO, ANGLES, mode="stream", backend="cuda", device=CPU,
                    memory=_tiny())
    assert op.plan.streams and op.plan.backward.n_slabs > 1
    got = op.At(y8, weight=weight)
    plain = CTOperator(GEO, ANGLES, backend="cuda", device=CPU)
    torch.testing.assert_close(got, plain.At(y8, weight=weight),
                               rtol=STREAM_TOL, atol=STREAM_TOL)
    for depth in (0, 2, 5):
        again = stream_backward(y8, GEO, ANGLES, op.plan.with_prefetch(depth),
                                weight=weight, device=CPU, backend="cuda")
        assert torch.equal(again, got)
    # an OS subset rebuilds the step list for its angle count
    sub = stream_backward(y8[2:7], GEO, ANGLES[2:7], op.plan, weight=weight,
                          device=CPU, backend="cuda")
    torch.testing.assert_close(sub, plain.At(y8[2:7], ANGLES[2:7],
                                             weight=weight),
                               rtol=STREAM_TOL, atol=STREAM_TOL)


def test_voxel_weights_run_through_bp_voxel(y8):
    """Plain and streamed voxel-weight At go through the bp_voxel wrapper
    (its plain version here) and build no matched operator; warmup builds
    the bp entries."""
    clear_dispatch_cache()
    kernels.reset_counters()
    for mode in ("plain", "stream"):
        op = CTOperator(GEO, ANGLES, mode=mode, backend="cuda", device=CPU,
                        bp_weight="pmatched", memory=_tiny())
        op.warmup()
        op.At(y8)
    keys = dispatch_cache_keys()
    assert {k[1] for k in keys if k[0] == "cuda"} >= {"bp", "fp_mixed", "fp"}
    assert not [k for k in keys if k[1] in ("bp_matched", "at_matched_mixed")]
    c = kernels.counters()
    assert c["bp_voxel"]["plain_calls"] > 1
    assert c["bp_matched"] == {"launches": 0, "plain_calls": 0}
