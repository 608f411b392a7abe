"""The port's kernel modules against the JAX package's Pallas kernels.

Each kernel module of ``repro_torch.kernels`` holds a hand-written CUDA
kernel and its plain-PyTorch version.  Here, on the CPU, the plain versions
take the same numpy inputs as the reference's Pallas kernels (run in
interpret mode, as the reference's own tests run them) and its ref
projector, and must agree within the reference's kernel band: rtol 2e-4,
atol 5e-3 (tests/test_backend.py:23).  The CUDA kernels themselves are
held against their plain versions on the card by tests/test_torch_cuda.py.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.geometry import ConeGeometry as JaxGeometry
from repro.core.projector import forward_project_joseph as jax_fp_joseph
from repro.kernels.bp_matched import bp_matched_pallas
from repro.kernels.fp_ray import angle_constants as jax_angle_constants
from repro.kernels.fp_ray import fp_ray_pallas
from repro_torch import kernels
from repro_torch.core.geometry import (ConeGeometry, circular_angles,
                                       dominant_axis_mask)
from repro_torch.kernels import build
from repro_torch.kernels.bp_matched import (bp_matched, bp_matched_cuda,
                                            bp_matched_plain)
from repro_torch.kernels.fp_ray import (angle_constants, fp_ray, fp_ray_cuda,
                                        fp_ray_plain, plane_centers)

RTOL, ATOL = 2e-4, 5e-3
SHAPES = [(16, 16, 16), (18, 24, 24), (20, 25, 25)]
ANGLES = circular_angles(8)          # mixed x/y dominance


def _geos(shape):
    return (JaxGeometry.nice(16).with_voxels(shape),
            ConeGeometry.nice(16).with_voxels(shape))


def _case(shape, dom, seed=0):
    """Volume and angles as the x-dominant kernel sees them: y-dominant
    angles go through the backend's -90 deg rotation of the scene."""
    rng = np.random.default_rng(seed)
    vol = rng.standard_normal(shape).astype(np.float32)
    mask = dominant_axis_mask(ANGLES)
    ang = ANGLES[mask if dom == "x" else ~mask]
    if dom == "y":
        vol = np.ascontiguousarray(np.flip(vol.transpose(0, 2, 1), 1))
        ang = (ang - np.float32(math.pi / 2.0)).astype(np.float32)
    return vol, ang, rng


def _slab(shape, part):
    nz = shape[0]
    return (0, nz) if part == "full" else (nz // 3, (2 * nz) // 3 + 1)


@pytest.mark.parametrize("part", ["full", "slab"])
@pytest.mark.parametrize("dom", ["x", "y"])
@pytest.mark.parametrize("shape", SHAPES)
def test_fp_plain_matches_pallas(shape, dom, part):
    jg, tg = _geos(shape)
    vol, ang, _ = _case(shape, dom)
    z0, z1 = _slab(shape, part)
    want = np.asarray(fp_ray_pallas(jnp.asarray(vol[z0:z1]), jg,
                                    jnp.asarray(ang), slab_planes=8,
                                    interpret=True, z0=z0))
    got = fp_ray_plain(torch.from_numpy(vol[z0:z1]), tg, ang, z0).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("part", ["full", "slab"])
@pytest.mark.parametrize("dom", ["x", "y"])
def test_fp_plain_matches_ref_projector(dom, part):
    shape = (18, 24, 24)
    jg, tg = _geos(shape)
    rng = np.random.default_rng(1)
    vol = rng.standard_normal(shape).astype(np.float32)
    mask = dominant_axis_mask(ANGLES)
    ang = ANGLES[mask if dom == "x" else ~mask]
    z0, z1 = _slab(shape, part)
    want = np.asarray(jax_fp_joseph(jnp.asarray(vol[z0:z1]), jg,
                                    jnp.asarray(ang), xdom=dom == "x",
                                    z0=z0))
    # the port's cuda backend does the rotation; here the kernel's view
    v, a, _ = (vol, ang, None) if dom == "x" else _case(shape, "y", seed=1)
    got = fp_ray_plain(torch.from_numpy(np.ascontiguousarray(v[z0:z1])), tg,
                       a, z0).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("part", ["full", "slab"])
@pytest.mark.parametrize("dom", ["x", "y"])
@pytest.mark.parametrize("shape", SHAPES)
def test_bp_plain_matches_pallas(shape, dom, part):
    jg, tg = _geos(shape)
    _, ang, rng = _case(shape, dom)
    y = rng.standard_normal((len(ang),) + jg.n_detector).astype(np.float32)
    z0, z1 = _slab(shape, part)
    want = np.asarray(bp_matched_pallas(jnp.asarray(y), jg, jnp.asarray(ang),
                                        slab_planes=8, interpret=True,
                                        z0=z0, z_planes=z1 - z0))
    got = bp_matched_plain(torch.from_numpy(y), tg, ang, z0,
                           z1 - z0).numpy()
    assert got.shape == want.shape == (z1 - z0,) + shape[1:]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dom", ["x", "y"])
def test_plain_pair_is_adjoint(dom):
    """<fp(x), y> == <x, bp(y)> for the plain pair on a z slab, fp64 dots."""
    shape = (20, 25, 25)
    _, tg = _geos(shape)
    vol, ang, rng = _case(shape, dom, seed=2)
    z0, z1 = _slab(shape, "slab")
    x = torch.from_numpy(vol[z0:z1].copy())
    y = torch.from_numpy(rng.standard_normal(
        (len(ang),) + tg.n_detector).astype(np.float32))
    lhs = float((fp_ray_plain(x, tg, ang, z0).double() * y.double()).sum())
    rhs = float((x.double() * bp_matched_plain(y, tg, ang, z0, z1 - z0)
                 .double()).sum())
    assert abs(lhs - rhs) / max(abs(lhs), abs(rhs)) < 1e-4


def test_angle_constants_and_planes_match_reference():
    jg, tg = _geos((18, 24, 24))
    want = np.asarray(jax_angle_constants(jg, jnp.asarray(ANGLES)))
    got = angle_constants(tg, ANGLES).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-3)
    xc = plane_centers(tg, torch.device("cpu")).numpy()
    nx = tg.n_voxel[2]
    ref = np.asarray((np.arange(nx) - (nx - 1) / 2.0) * jg.d_voxel[2]
                     + jg.off_origin[2], np.float32)
    np.testing.assert_array_equal(xc, ref)


def test_wrappers_take_the_plain_version_on_cpu_tensors():
    _, tg = _geos((16, 16, 16))
    vol, ang, rng = _case((16, 16, 16), "x")
    kernels.reset_counters()
    p = fp_ray(torch.from_numpy(vol), tg, ang)
    bp_matched(p, tg, ang)
    c = kernels.counters()
    assert c == {"fp_ray": {"launches": 0, "plain_calls": 1},
                 "bp_matched": {"launches": 0, "plain_calls": 1}}
    np.testing.assert_array_equal(
        p.numpy(), fp_ray_plain(torch.from_numpy(vol), tg, ang).numpy())


def test_cuda_wrappers_refuse_cpu_tensors_and_bad_inputs():
    _, tg = _geos((16, 16, 16))
    vol, ang, _ = _case((16, 16, 16), "x")
    v = torch.from_numpy(vol)
    kernels.reset_counters()
    with pytest.raises(ValueError, match="CUDA tensor"):
        fp_ray_cuda(v, tg, ang)
    with pytest.raises(ValueError, match="CUDA tensor"):
        bp_matched_cuda(torch.zeros((len(ang),) + tg.n_detector), tg, ang)
    with pytest.raises(TypeError, match="float32"):
        fp_ray(v.double(), tg, ang)
    with pytest.raises(ValueError, match="volume slab"):
        fp_ray(v[:, :8], tg, ang)
    with pytest.raises(ValueError, match="projections must be"):
        bp_matched(torch.zeros((len(ang) + 1,) + tg.n_detector), tg, ang)
    assert fp_ray_cuda.launches == 0 and bp_matched_cuda.launches == 0


def test_build_locations_and_missing_nvcc(monkeypatch):
    """Libraries go under the checkout's git-ignored build/, named by a
    digest of their inputs; without nvcc the build raises."""
    root = build.CSRC.parents[3]
    assert build.build_dir() == root / "build" / "repro_torch_kernels"
    assert "build/" in (root / ".gitignore").read_text().split()
    assert "sm_90a" in " ".join(build.NVCC_FLAGS)
    assert "--use_fast_math" not in build.NVCC_FLAGS
    for name in build.SOURCES:
        path = build.library_path(name)
        assert path.parent == build.build_dir()
        assert path.name.startswith(f"lib{name}-")
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setattr(build.os.path, "exists", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()


def _offset_geos():
    """Non-cubic volume, non-square detector, every offset non-zero: the
    x-dominant kernels take any such geometry (only the y-dominant rotation
    trick needs a square, centred xy grid)."""
    kw = dict(n_voxel=(14, 20, 26), s_voxel=(200.0, 240.0, 260.0),
              n_detector=(18, 22), s_detector=(300.0, 380.0),
              off_origin=(6.0, -9.0, 7.0), off_detector=(11.0, -13.0))
    return JaxGeometry(**kw), ConeGeometry(**kw)


@pytest.mark.parametrize("part", ["full", "slab"])
def test_plain_pair_matches_pallas_with_offsets(part):
    jg, tg = _offset_geos()
    rng = np.random.default_rng(5)
    mask = dominant_axis_mask(ANGLES)
    ang = ANGLES[mask]
    z0, z1 = _slab(jg.n_voxel, part)
    vol = rng.standard_normal((z1 - z0,) + jg.n_voxel[1:]).astype(np.float32)
    y = rng.standard_normal((len(ang),) + jg.n_detector).astype(np.float32)
    want = np.asarray(fp_ray_pallas(jnp.asarray(vol), jg, jnp.asarray(ang),
                                    slab_planes=8, interpret=True, z0=z0))
    np.testing.assert_allclose(
        fp_ray_plain(torch.from_numpy(vol), tg, ang, z0).numpy(), want,
        rtol=RTOL, atol=ATOL)
    want = np.asarray(bp_matched_pallas(jnp.asarray(y), jg, jnp.asarray(ang),
                                        slab_planes=8, interpret=True,
                                        z0=z0, z_planes=z1 - z0))
    np.testing.assert_allclose(
        bp_matched_plain(torch.from_numpy(y), tg, ang, z0, z1 - z0).numpy(),
        want, rtol=RTOL, atol=ATOL)
