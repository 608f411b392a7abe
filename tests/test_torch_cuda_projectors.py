"""The redesigned ``fp_ray`` (u-part once per (u, plane), plane skip, short
z taps) and ``bp_voxel`` (windows of the projections staged in shared
memory, one reciprocal of the depth) on the card, each against its plain
version.

Every test here needs a CUDA device and ``nvcc`` (the kernels build at
first use) and skips without a device.  The file imports nothing of JAX,
so it runs where the port runs:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda_projectors.py -q

Bands: kernel vs plain rtol 2e-4, atol 5e-3 (``tests/test_backend.py:23``);
the adjoint identity of ``fp_ray`` against the unchanged ``bp_matched`` to
1e-4 with float64 dots (``tests/test_adjoint.py:29``); repeat launches bit
for bit.  The overflow geometry is the one
``tests/test_torch_projector_windows.py`` shows to take ``bp_voxel``'s
global-read path for some tiles and angles.
"""

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core.geometry import (ConeGeometry, circular_angles,
                                       dominant_axis_mask)
from repro_torch.kernels.bp_matched import bp_matched_cuda
from repro_torch.kernels.bp_voxel import bp_voxel_cuda, bp_voxel_plain
from repro_torch.kernels.fp_ray import fp_ray_cuda, fp_ray_plain
from test_torch_projector_windows import OVERFLOW_GEO

pytestmark = pytest.mark.cuda

RTOL, ATOL = 2e-4, 5e-3
ADJ_TOL = 1e-4
#: unequal detector axes, volume and detector offsets, prime sizes
OFFSET_GEO = ConeGeometry(
    n_voxel=(37, 41, 43), s_voxel=(185.0, 205.0, 215.0),
    n_detector=(53, 47), s_detector=(320.0, 300.0),
    off_origin=(6.0, -9.0, 7.0), off_detector=(21.0, -17.0))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only there)")
    return torch.device("cuda")


def _x_angles(n_angles):
    ang = circular_angles(n_angles)
    return torch.from_numpy(ang[dominant_axis_mask(ang)]).cuda()


def _randn(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32)).cuda()


def _close(got, want):
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


# --------------------------------------------------------------------------
# fp_ray
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", [61, 64, 128])
def test_fp_ray_matches_plain(cuda, n):
    geo = ConeGeometry.nice(n)
    a = _x_angles(48)
    vol = _randn(geo.n_voxel, n)
    kernels.reset_counters()
    _close(fp_ray_cuda(vol, geo, a), fp_ray_plain(vol, geo, a))
    assert fp_ray_cuda.launches == 1


def test_fp_ray_offsets_and_unequal_detector(cuda):
    a = _x_angles(30)
    vol = _randn(OFFSET_GEO.n_voxel, 1)
    _close(fp_ray_cuda(vol, OFFSET_GEO, a), fp_ray_plain(vol, OFFSET_GEO, a))


@pytest.mark.parametrize("z0,planes", [(0, 21), (20, 21), (45, 19)])
def test_fp_ray_slabs_and_ragged_tail(cuda, z0, planes):
    """Slabs of N = 64 with z0 > 0 and a ragged last slab (45 + 19 = 64),
    their tiles' planes skipped where no row reaches the slab."""
    geo = ConeGeometry.nice(64)
    a = _x_angles(40)
    slab = _randn((planes, 64, 64), z0)
    _close(fp_ray_cuda(slab, geo, a, z0=z0),
           fp_ray_plain(slab, geo, a, z0))


def test_fp_ray_slab_partials_add_up(cuda):
    geo = ConeGeometry.nice(64)
    a = _x_angles(40)
    vol = _randn(geo.n_voxel, 2)
    whole = fp_ray_cuda(vol, geo, a)
    parts = sum(fp_ray_cuda(vol[z0:z1].contiguous(), geo, a, z0=z0)
                for z0, z1 in ((0, 21), (21, 43), (43, 64)))
    torch.testing.assert_close(parts, whole, rtol=1e-5, atol=1e-4)


def test_fp_ray_adjoint_against_bp_matched(cuda):
    """<A x, y> = <x, A^T y> with the unchanged bp_matched, float64 dots,
    whole volume and a slab."""
    geo = ConeGeometry.nice(128)
    a = _x_angles(96)
    vol = _randn(geo.n_voxel, 3)
    for z0, z1 in ((0, 128), (40, 90)):
        x = vol[z0:z1].contiguous()
        fx = fp_ray_cuda(x, geo, a, z0=z0)
        y = _randn(tuple(fx.shape), 4)
        aty = bp_matched_cuda(y, geo, a, z0=z0, z_planes=z1 - z0)
        lhs = float((fx.double() * y.double()).sum())
        rhs = float((x.double() * aty.double()).sum())
        assert abs(lhs - rhs) / max(abs(lhs), abs(rhs)) <= ADJ_TOL


# --------------------------------------------------------------------------
# bp_voxel
# --------------------------------------------------------------------------

@pytest.mark.parametrize("weight", ["fdk", "pmatched", "none"])
@pytest.mark.parametrize("n", [61, 64, 128])
def test_bp_voxel_matches_plain(cuda, n, weight):
    geo = ConeGeometry.nice(n)
    a = torch.from_numpy(circular_angles(72)).cuda()
    y = _randn((72,) + geo.n_detector, n)
    kernels.reset_counters()
    _close(bp_voxel_cuda(y, geo, a, weight),
           bp_voxel_plain(y, geo, a, weight))
    assert bp_voxel_cuda.launches == 1


def test_bp_voxel_offsets_and_unequal_detector(cuda):
    a = torch.from_numpy(circular_angles(36)).cuda()
    y = _randn((36,) + OFFSET_GEO.n_detector, 5)
    for weight in ("fdk", "pmatched"):
        _close(bp_voxel_cuda(y, OFFSET_GEO, a, weight),
               bp_voxel_plain(y, OFFSET_GEO, a, weight))


@pytest.mark.parametrize("z_start,planes", [(0, 45), (45, 19), (13, 1)])
def test_bp_voxel_slabs_and_ragged_tail(cuda, z_start, planes):
    geo = ConeGeometry.nice(64)
    a = torch.from_numpy(circular_angles(40)).cuda()
    y = _randn((40,) + geo.n_detector, 6)
    got = bp_voxel_cuda(y, geo, a, "pmatched", z_start, planes)
    _close(got, bp_voxel_plain(y, geo, a, "pmatched", z_start, planes))
    # a plane's taps do not depend on where the slab starts
    whole = bp_voxel_cuda(y, geo, a, "pmatched")
    assert torch.equal(got, whole[z_start:z_start + planes])


def test_bp_voxel_os_sart_chunks_add_up(cuda):
    """Chunks of 64 angles (an OS-SART subset's size) each in band, and
    their slabs adding up to the backprojection of all angles."""
    geo = ConeGeometry.nice(128)
    a = torch.from_numpy(circular_angles(192)).cuda()
    y = _randn((192,) + geo.n_detector, 7)
    whole = bp_voxel_cuda(y, geo, a, "pmatched")
    parts = 0
    for c0 in (0, 64, 128):
        part = bp_voxel_cuda(y[c0:c0 + 64], geo, a[c0:c0 + 64], "pmatched")
        _close(part, bp_voxel_plain(y[c0:c0 + 64], geo, a[c0:c0 + 64],
                                    "pmatched"))
        parts = parts + part
    torch.testing.assert_close(parts, whole, rtol=1e-5, atol=1e-3)


# --------------------------------------------------------------------------
# both
# --------------------------------------------------------------------------

def test_repeat_launches_bit_identical(cuda):
    geo = ConeGeometry.nice(61)
    a_x = _x_angles(40)
    a = torch.from_numpy(circular_angles(40)).cuda()
    vol = _randn(geo.n_voxel, 8)
    y = _randn((40,) + geo.n_detector, 9)
    assert torch.equal(fp_ray_cuda(vol, geo, a_x), fp_ray_cuda(vol, geo, a_x))
    assert torch.equal(bp_voxel_cuda(y, geo, a, "fdk", 7, 30),
                       bp_voxel_cuda(y, geo, a, "fdk", 7, 30))


def test_window_overflow_geometry(cuda):
    """The geometry past bp_voxel's window buffers (its global-read path
    beside the staged one, within one launch), with large detector
    offsets: both kernels in band, whole volume and slab, repeats equal."""
    geo = OVERFLOW_GEO
    a_x = _x_angles(40)
    a = torch.from_numpy(circular_angles(40)).cuda()
    vol = _randn(geo.n_voxel, 10)
    y = _randn((40,) + geo.n_detector, 11)
    for z0, planes in ((0, geo.n_voxel[0]), (7, 29)):
        slab = vol[z0:z0 + planes].contiguous()
        got = fp_ray_cuda(slab, geo, a_x, z0=z0)
        _close(got, fp_ray_plain(slab, geo, a_x, z0))
        assert torch.equal(got, fp_ray_cuda(slab, geo, a_x, z0=z0))
        for weight in ("fdk", "pmatched", "none"):
            got = bp_voxel_cuda(y, geo, a, weight, z0, planes)
            _close(got, bp_voxel_plain(y, geo, a, weight, z0, planes))
            assert torch.equal(got, bp_voxel_cuda(y, geo, a, weight, z0,
                                                  planes))
