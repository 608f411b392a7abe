"""The port's TV path on the card: the TV-gradient kernel against its
plain version, and ASD-POCS and FISTA-TV running through the kernels.

Every test here needs a CUDA device and ``nvcc`` (the kernels build at
first use) and skips without a device.  The file imports nothing of JAX,
so it runs where the port runs:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda_tv.py -q

Bands: tv_grad vs plain rtol 1e-5, atol 1e-5 (tests/test_kernels.py:70);
algorithm iterates 2e-3 (tests/test_adjoint.py:199).
"""

import math

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core.algorithms import asd_pocs, fista_tv
from repro_torch.core.geometry import ConeGeometry, circular_angles
from repro_torch.core.operator import CTOperator
from repro_torch.core.splitting import MemoryModel
from repro_torch.kernels.tv_grad import tv_grad_cuda, tv_grad_plain

pytestmark = pytest.mark.cuda

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


@pytest.mark.parametrize("shape", [(20, 25, 25), (61, 37, 45), (1, 64, 64),
                                   (2, 64, 64), (5, 1, 7), (3, 2, 1)])
def test_tv_grad_matches_plain(cuda, shape):
    """Random volumes and the piecewise-constant Shepp-Logan phantom (zero
    differences: m = eps), any shape, axes of size 1 and 2 included;
    repeat launches bit-identical."""
    from repro_torch.core import phantoms
    rng = np.random.default_rng(9)
    vols = [rng.standard_normal(shape).astype(np.float32)]
    if min(shape) > 2:
        vols.append(phantoms.shepp_logan(
            ConeGeometry.nice(16).with_voxels(shape)))
    kernels.reset_counters()
    for v in vols:
        t = torch.from_numpy(v)
        got = tv_grad_cuda(t.to(cuda))
        torch.testing.assert_close(got.cpu(), tv_grad_plain(t), rtol=1e-5,
                                   atol=1e-5)
        assert torch.equal(got, tv_grad_cuda(t.to(cuda)))
    assert kernels.counters()["tv_grad"]["launches"] == 2 * len(vols)


def test_asd_pocs_and_fista_on_the_card_match_the_cpu(cuda):
    from repro_torch.core import phantoms
    proj = phantoms.sphere_projection_analytic(GEO, ANGLES)
    cpu = CTOperator(GEO, ANGLES, device="cpu", backend="cuda")
    want_asd = asd_pocs(proj, GEO, ANGLES, n_iter=2, subset_size=3, op=cpu)
    want_fista = fista_tv(proj, GEO, ANGLES, n_iter=2, L=3e4, op=cpu)
    kernels.reset_counters()
    for mode in ("plain", "stream"):
        op = CTOperator(GEO, ANGLES, mode=mode, memory=_tiny())
        got = asd_pocs(proj, GEO, ANGLES, n_iter=2, subset_size=3, op=op)
        assert got.device == op.data_device
        torch.testing.assert_close(got.cpu(), want_asd, rtol=2e-3, atol=2e-3)
        got = fista_tv(proj, GEO, ANGLES, n_iter=2, L=3e4, op=op)
        torch.testing.assert_close(got.cpu(), want_fista, rtol=2e-3,
                                   atol=2e-3)
    c = kernels.counters()
    assert c["tv_grad"]["launches"] == 2 * 2 * 20
    for name in ("fp_ray", "bp_matched", "bp_voxel"):
        assert c[name]["launches"] > 0
    assert all(v["plain_calls"] == 0 for v in c.values())
