"""The port's multi-device layer on the card: the sharded operator, the
halo-split regularisers and the multi-device streaming executors, running
the CUDA kernels.

Every test here needs a CUDA device and ``nvcc`` (the kernels build at
first use) and skips without a device; the two-GPU cases skip with fewer
than two cards.  The file imports nothing of JAX, so it runs where the
port runs:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda_dist.py -q

Most meshes here put several shards on ``cuda:0``, each on a stream of
its own: they run every exchange and reduction of the path, and a shard
that aliased its neighbour's storage would corrupt it.  Bands: the sharded
operator vs the in-core one, rtol 2e-4, atol 5e-3 (tests/test_backend.py:23);
the reduction schedules among themselves 1e-6; TV rtol 1e-4, atol 1e-5,
ROF rtol 1e-3, atol 1e-5 (tests/test_regularization.py); the halo-split
gradient with n_inner 1 equals the monolithic ``tv_grad`` bit for bit.
"""

import pytest
import torch

from repro_torch import kernels
from repro_torch.core import regularization as reg
from repro_torch.core.algorithms import cgls
from repro_torch.core.distributed import (dist_forward_project,
                                          halo_exchange)
from repro_torch.core.geometry import ConeGeometry, circular_angles
from repro_torch.core.operator import CTOperator
from repro_torch.core.plan import plan
from repro_torch.core.splitting import MemoryModel
from repro_torch.core.streaming import (Timeline, stream_backward,
                                        stream_forward)
from repro_torch.kernels.fp_ray import fp_ray_cuda
from repro_torch.launch.mesh import make_host_mesh

pytestmark = pytest.mark.cuda

BAND = dict(rtol=2e-4, atol=5e-3)
GEO = ConeGeometry.nice(64)
ANGLES = circular_angles(48)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only there)")
    return torch.device("cuda", 0)


@pytest.fixture
def two_gpus(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    return [torch.device("cuda", 0), torch.device("cuda", 1)]


def _rand(seed, shape, device):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device)


def _same_card(data, model):
    return make_host_mesh(model, devices=["cuda:0"] * (data * model))


@pytest.mark.parametrize("data,model", [(2, 2), (1, 4), (4, 1)])
def test_dist_operator_on_one_card(cuda, data, model):
    """A and every Aᵀ of the sharded operator through the kernels, against
    the in-core operator; no plain version runs."""
    x = _rand(0, GEO.n_voxel, cuda)
    y = _rand(1, (len(ANGLES),) + GEO.n_detector, cuda)
    plain = CTOperator(GEO, ANGLES)
    kernels.reset_counters()
    op = CTOperator(GEO, ANGLES, mode="dist", mesh=_same_card(data, model))
    got = {"A": op.A(x)}
    for w in ("matched", "fdk", "pmatched"):
        got[w] = op.At(y, weight=w)
    torch.cuda.synchronize()
    c = kernels.counters()
    for name in ("fp_ray", "bp_matched", "bp_voxel"):
        assert c[name]["launches"] > 0 and c[name]["plain_calls"] == 0, c
    assert got["A"].device == cuda
    torch.testing.assert_close(got["A"], plain.A(x), **BAND)
    for w in ("matched", "fdk", "pmatched"):
        torch.testing.assert_close(got[w], plain.At(y, weight=w), **BAND)


def test_dist_pad_mask_and_adjoint_on_one_card(cuda):
    angles = circular_angles(13)
    op = CTOperator(GEO, angles, mode="dist", mesh=_same_card(2, 2))
    plain = CTOperator(GEO, angles)
    x = _rand(2, GEO.n_voxel, cuda)
    y = _rand(3, (13,) + GEO.n_detector, cuda)
    ax, aty = op.A(x), op.At(y)
    assert ax.shape[0] == 13
    torch.testing.assert_close(ax, plain.A(x), **BAND)
    torch.testing.assert_close(aty, plain.At(y), **BAND)
    lhs = float((ax.double() * y.double()).sum())
    rhs = float((x.double() * aty.double()).sum())
    assert abs(lhs - rhs) / max(abs(lhs), abs(rhs)) <= 1e-4


def test_reductions_agree_on_one_card(cuda):
    x = _rand(4, GEO.n_voxel, cuda)
    mesh = _same_card(1, 4)
    outs = {r: dist_forward_project(mesh, GEO, reduce=r)(x, ANGLES)
            for r in ("psum", "ring", "hier")}
    for r in ("ring", "hier"):
        torch.testing.assert_close(outs[r], outs["psum"], rtol=1e-6,
                                   atol=1e-6)
    again = dist_forward_project(mesh, GEO, reduce="ring")(x, ANGLES)
    assert torch.equal(again, outs["ring"])


def test_dist_cgls_on_one_card(cuda):
    proj = CTOperator(GEO, ANGLES).A(_rand(5, GEO.n_voxel, cuda))
    want = cgls(proj, GEO, ANGLES, n_iter=3, op=CTOperator(GEO, ANGLES))
    got = cgls(proj, GEO, ANGLES, n_iter=3,
               op=CTOperator(GEO, ANGLES, mode="dist",
                             mesh=_same_card(2, 2)))
    torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)


def test_halo_gradient_n_inner_1_is_bit_identical(cuda):
    """The halo-split gradient's owned planes equal the monolithic
    ``tv_grad`` kernel's output bit for bit (the kernel's arithmetic does
    not depend on where a plane lies)."""
    v = _rand(6, (64, 61, 45), cuda)
    mono = reg.tv_gradient(v)
    for n in (2, 4):
        slabs = list(v.split(64 // n))
        for j, vp in enumerate(halo_exchange(slabs, 1)):
            _, _, _, own = reg._halo_gradient(vp, 1, j, n, 1e-6)
            assert torch.equal(own, mono[j * (64 // n):(j + 1) * (64 // n)])


def test_halo_split_tv_and_rof_on_one_card(cuda):
    """Shards of one card update their padded slabs in place: the 2 x 2
    mesh equals the 1 x 1 mesh and the monolithic minimiser, the input
    stays as it was, and only the kernel computes gradients."""
    v = _rand(7, (64, 48, 48), cuda)
    before = v.clone()
    kernels.reset_counters()
    wide = reg.dist_minimize_tv(_same_card(2, 2), 0.1, 8, 2,
                                approx_norm=False)(v)
    one = reg.dist_minimize_tv(_same_card(1, 1), 0.1, 8, 2,
                               approx_norm=False)(v)
    c = kernels.counters()["tv_grad"]
    assert c["launches"] == 2 * 8 + 8 and c["plain_calls"] == 0
    assert torch.equal(v, before)
    torch.testing.assert_close(wide, one, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(wide, reg.minimize_tv(v, 0.1, 8), rtol=1e-4,
                               atol=1e-5)
    rof = reg.dist_rof_denoise(_same_card(2, 2), 10.0, 8, 4)(v)
    torch.testing.assert_close(rof, reg.rof_denoise(v, 10.0, 8), rtol=1e-3,
                               atol=1e-5)
    assert torch.equal(v, before)


def _stream_case():
    geo = ConeGeometry.nice(64)
    angles = circular_angles(24)
    # 400000 usable bytes, with the default 5 % headroom beside them,
    # where bp_matched's scratch goes
    mem = MemoryModel(device_bytes=421_053)
    assert mem.usable == 400_000
    return geo, angles, plan(geo, len(angles), 2, mem, angle_chunk_fp=4,
                             angle_chunk_bp=4)


def test_stream_two_lanes_on_one_card(cuda):
    geo, angles, pl = _stream_case()
    assert pl.forward.n_slabs > 1 and pl.backward.n_slabs > 1
    x = _rand(8, geo.n_voxel, cuda).cpu()
    y = _rand(9, (len(angles),) + geo.n_detector, cuda).cpu()
    devs = [cuda, cuda]
    tl = Timeline()
    a = stream_forward(x, geo, angles, pl, devices=devs, timeline=tl)
    t = stream_backward(y, geo, angles, pl, devices=devs)
    assert tl.bins["compute"] > 0 and a.is_pinned()
    serial = pl.with_prefetch(0)
    assert torch.equal(stream_forward(x, geo, angles, serial, devices=devs),
                       a)
    assert torch.equal(stream_backward(y, geo, angles, serial, devices=devs),
                       t)
    plain = CTOperator(geo, angles)
    torch.testing.assert_close(a, plain.A(x).cpu(), **BAND)
    torch.testing.assert_close(t, plain.At(y).cpu(), **BAND)


def test_stream_on_two_gpus(two_gpus):
    geo, angles, pl = _stream_case()
    x = _rand(10, geo.n_voxel, two_gpus[0]).cpu()
    a = stream_forward(x, geo, angles, pl, devices=two_gpus)
    assert torch.equal(a, stream_forward(x, geo, angles, pl.with_prefetch(0),
                                         devices=two_gpus))
    torch.testing.assert_close(a, CTOperator(geo, angles).A(x).cpu(),
                               **BAND)


def test_dist_on_two_gpus(two_gpus):
    mesh = make_host_mesh(2, devices=two_gpus)
    x = _rand(11, GEO.n_voxel, two_gpus[0])
    y = _rand(12, (len(ANGLES),) + GEO.n_detector, two_gpus[0])
    op = CTOperator(GEO, ANGLES, mode="dist", mesh=mesh)
    plain = CTOperator(GEO, ANGLES, device=two_gpus[0])
    torch.testing.assert_close(op.A(x), plain.A(x), **BAND)
    torch.testing.assert_close(op.At(y), plain.At(y), **BAND)
    tv = reg.dist_minimize_tv(mesh, 0.1, 4, 2, approx_norm=False)(x)
    torch.testing.assert_close(tv, reg.minimize_tv(x, 0.1, 4), rtol=1e-4,
                               atol=1e-5)


def test_kernel_launch_keeps_the_current_device(two_gpus):
    """A launch on cuda:1 leaves the thread's current device where the
    caller had it."""
    torch.cuda.set_device(0)
    x = _rand(13, (16, 16, 16), two_gpus[1])
    fp_ray_cuda(x, ConeGeometry.nice(16), torch.zeros(2, device=two_gpus[1]))
    assert torch.cuda.current_device() == 0
    reg.tv_gradient(x)
    assert torch.cuda.current_device() == 0
