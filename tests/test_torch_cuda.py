"""The port on the card: each CUDA kernel against its plain version, and
the operator, streaming executor, CGLS, FDK and OS-SART running through
the kernels (the TV path's are in tests/test_torch_cuda_tv.py).

Every test here needs a CUDA device and ``nvcc`` (the kernels build at
first use) and skips without a device.  The file imports nothing of JAX,
so it runs where the port runs:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q

Bands: kernel vs plain rtol 2e-4, atol 5e-3 (tests/test_backend.py:23);
adjoint defect <= 1e-4; algorithm iterates 2e-3 (tests/test_adjoint.py:199).
"""

import math

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core.algorithms import cgls, fdk, ossart
from repro_torch.core.geometry import (ConeGeometry, circular_angles,
                                       dominant_axis_mask)
from repro_torch.core.operator import CTOperator
from repro_torch.core.splitting import MemoryModel
from repro_torch.core.streaming import stream_backward, stream_forward
from repro_torch.kernels.bp_matched import bp_matched_cuda, bp_matched_plain
from repro_torch.kernels.bp_voxel import bp_voxel_cuda, bp_voxel_plain
from repro_torch.kernels.fp_ray import fp_ray_cuda, fp_ray_plain

pytestmark = pytest.mark.cuda

RTOL, ATOL = 2e-4, 5e-3
SHAPE = (20, 25, 25)
GEO = ConeGeometry.nice(16).with_voxels(SHAPE)
ANGLES = circular_angles(8)          # mixed x/y dominance


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only there)")
    return torch.device("cuda")


def _tiny():
    nz, ny, nx = GEO.n_voxel
    nv, nu = GEO.n_detector
    usable = (nz * ny * nx * 4) // 3 + 12 * len(ANGLES) * nv * nu
    # those usable bytes (the plan's budget), with the default 5 %
    # headroom beside them, where bp_matched's scratch goes
    mem = MemoryModel(device_bytes=math.ceil(usable / 0.95))
    assert mem.usable == usable
    return mem


def _data(n_angles, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(SHAPE).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal(
        (n_angles,) + GEO.n_detector).astype(np.float32))
    return x, y


@pytest.mark.parametrize("part", ["full", "slab"])
@pytest.mark.parametrize("dom", ["x", "y"])
def test_kernels_match_plain(cuda, dom, part):
    mask = dominant_axis_mask(ANGLES)
    a = torch.from_numpy(ANGLES[mask if dom == "x" else ~mask])
    x, y = _data(len(a), seed=3)
    if dom == "y":           # the backend's -90 deg rotation of the scene
        x = torch.flip(x.transpose(1, 2), dims=(1,)).contiguous()
        a = a - math.pi / 2.0
    z0, z1 = (0, SHAPE[0]) if part == "full" else (6, 14)
    x = x[z0:z1].contiguous()
    fk = fp_ray_cuda(x.to(cuda), GEO, a.to(cuda), z0)
    torch.testing.assert_close(fk.cpu(), fp_ray_plain(x, GEO, a, z0),
                               rtol=RTOL, atol=ATOL)
    bk = bp_matched_cuda(y.to(cuda), GEO, a.to(cuda), z0, z1 - z0)
    torch.testing.assert_close(bk.cpu(),
                               bp_matched_plain(y, GEO, a, z0, z1 - z0),
                               rtol=RTOL, atol=ATOL)
    lhs = float((fk.double().cpu() * y.double()).sum())
    rhs = float((x.double() * bk.double().cpu()).sum())
    assert abs(lhs - rhs) / max(abs(lhs), abs(rhs)) < 1e-4
    assert torch.equal(fk, fp_ray_cuda(x.to(cuda), GEO, a.to(cuda), z0))
    assert torch.equal(bk, bp_matched_cuda(y.to(cuda), GEO, a.to(cuda), z0,
                                           z1 - z0))


@pytest.mark.parametrize("part", ["full", "slab"])
def test_kernels_match_plain_with_offsets(cuda, part):
    """Non-cubic volume, non-square detector and non-zero offsets: every
    term of the adjoint kernel's candidate search is exercised."""
    geo = ConeGeometry(n_voxel=(14, 20, 26), s_voxel=(200.0, 240.0, 260.0),
                       n_detector=(18, 22), s_detector=(300.0, 380.0),
                       off_origin=(6.0, -9.0, 7.0), off_detector=(11.0, -13.0))
    a = torch.from_numpy(ANGLES[dominant_axis_mask(ANGLES)])
    z0, z1 = (0, 14) if part == "full" else (4, 10)
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal(
        (z1 - z0,) + geo.n_voxel[1:]).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal(
        (len(a),) + geo.n_detector).astype(np.float32))
    fk = fp_ray_cuda(x.to(cuda), geo, a.to(cuda), z0)
    torch.testing.assert_close(fk.cpu(), fp_ray_plain(x, geo, a, z0),
                               rtol=RTOL, atol=ATOL)
    bk = bp_matched_cuda(y.to(cuda), geo, a.to(cuda), z0, z1 - z0)
    torch.testing.assert_close(bk.cpu(),
                               bp_matched_plain(y, geo, a, z0, z1 - z0),
                               rtol=RTOL, atol=ATOL)
    lhs = float((fk.double().cpu() * y.double()).sum())
    rhs = float((x.double() * bk.double().cpu()).sum())
    assert abs(lhs - rhs) / max(abs(lhs), abs(rhs)) < 1e-4


def test_entry_points_default_to_the_card(cuda):
    op = CTOperator(GEO, ANGLES)
    assert op.device.type == "cuda" and op.backend_name == "cuda"
    x, y = _data(len(ANGLES), seed=4)
    kernels.reset_counters()
    ax, aty = op.A(x), op.At(y)
    assert ax.device.type == "cuda" and aty.device.type == "cuda"
    c = kernels.counters()
    assert c["fp_ray"]["launches"] == 2 and c["bp_matched"]["launches"] == 2
    assert c["fp_ray"]["plain_calls"] == 0
    assert c["bp_matched"]["plain_calls"] == 0
    cpu = CTOperator(GEO, ANGLES, device="cpu", backend="cuda")
    torch.testing.assert_close(ax.cpu(), cpu.A(x), rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(aty.cpu(), cpu.At(y), rtol=RTOL, atol=ATOL)


def test_streaming_on_the_card(cuda):
    """Copy stream, events and pinned host buffers: every prefetch depth
    bit-identical to the serial schedule, and stream == plain."""
    x, y = _data(len(ANGLES), seed=5)
    op = CTOperator(GEO, ANGLES, mode="stream", memory=_tiny())
    assert op.plan.streams and op.data_device.type == "cpu"
    a, t = op.A(x), op.At(y)
    assert a.is_pinned() and t.is_pinned()
    for depth in (0, 2, 5):
        pl = op.plan.with_prefetch(depth)
        assert torch.equal(stream_forward(x, GEO, ANGLES, pl), a)
        assert torch.equal(stream_backward(y, GEO, ANGLES, pl), t)
    plain = CTOperator(GEO, ANGLES)
    torch.testing.assert_close(a, plain.A(x).cpu(), rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(t, plain.At(y).cpu(), rtol=RTOL, atol=ATOL)


def test_cgls_on_the_card_matches_the_cpu(cuda):
    from repro_torch.core import phantoms
    proj = phantoms.sphere_projection_analytic(GEO, ANGLES)
    want = cgls(proj, GEO, ANGLES, n_iter=6,
                op=CTOperator(GEO, ANGLES, device="cpu", backend="cuda"))
    for mode in ("plain", "stream"):
        op = CTOperator(GEO, ANGLES, mode=mode, memory=_tiny())
        got = cgls(proj, GEO, ANGLES, n_iter=6, op=op).cpu()
        torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)


# --------------------------------------------------------------------------
# the voxel-driven backprojector, FDK and OS-SART
# --------------------------------------------------------------------------

@pytest.mark.parametrize("part", ["full", "slab"])
@pytest.mark.parametrize("weight", ["fdk", "pmatched", "none"])
@pytest.mark.parametrize("geo,n_angles", [
    (GEO, 8), (ConeGeometry.nice(13), 7),
    (ConeGeometry(n_voxel=(14, 20, 26), s_voxel=(200.0, 240.0, 260.0),
                  n_detector=(18, 22), s_detector=(300.0, 380.0),
                  off_origin=(6.0, -9.0, 7.0), off_detector=(11.0, -13.0)),
     9)])
def test_bp_voxel_matches_plain(cuda, geo, n_angles, weight, part):
    nz = geo.n_voxel[0]
    z0, planes = (0, nz) if part == "full" else (nz // 3, nz // 2)
    a = torch.from_numpy(circular_angles(n_angles))
    rng = np.random.default_rng(7)
    y = torch.from_numpy(rng.standard_normal(
        (n_angles,) + geo.n_detector).astype(np.float32))
    got = bp_voxel_cuda(y.to(cuda), geo, a.to(cuda), weight, z0, planes)
    assert got.shape == (planes,) + geo.n_voxel[1:]
    torch.testing.assert_close(
        got.cpu(), bp_voxel_plain(y, geo, a, weight, z0, planes),
        rtol=RTOL, atol=ATOL)
    assert torch.equal(got, bp_voxel_cuda(y.to(cuda), geo, a.to(cuda),
                                          weight, z0, planes))


def test_fdk_and_ossart_on_the_card_match_the_cpu(cuda):
    from repro_torch.core import phantoms
    proj = phantoms.sphere_projection_analytic(GEO, ANGLES)
    cpu = CTOperator(GEO, ANGLES, device="cpu", backend="cuda")
    kernels.reset_counters()
    torch.testing.assert_close(fdk(proj, GEO, ANGLES).cpu(),
                               fdk(proj, GEO, ANGLES, op=cpu),
                               rtol=2e-3, atol=2e-3)
    want = ossart(proj, GEO, ANGLES, n_iter=2, subset_size=3, op=cpu)
    for mode in ("plain", "stream"):
        op = CTOperator(GEO, ANGLES, mode=mode, memory=_tiny())
        got = ossart(proj, GEO, ANGLES, n_iter=2, subset_size=3, op=op)
        torch.testing.assert_close(got.cpu(), want, rtol=2e-3, atol=2e-3)
    c = kernels.counters()
    assert c["bp_voxel"]["launches"] > 0 and c["fp_ray"]["launches"] > 0
    assert c["bp_matched"]["launches"] == 0
    y = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (len(ANGLES),) + GEO.n_detector).astype(np.float32))
    op = CTOperator(GEO, ANGLES, mode="stream", memory=_tiny())
    t = op.At(y, weight="pmatched")
    for depth in (0, 2):
        assert torch.equal(stream_backward(y, GEO, ANGLES,
                                           op.plan.with_prefetch(depth),
                                           weight="pmatched"), t)
