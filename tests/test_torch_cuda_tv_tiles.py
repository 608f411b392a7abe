"""The tiled ``tv_grad`` kernel on the card, against its plain version.

Every test here needs a CUDA device and ``nvcc`` (the kernels build at
first use) and skips without a device.  The file imports nothing of JAX,
so it runs where the port runs:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda_tv_tiles.py -q

The kernel must equal ``tv_grad_plain`` on the card bit for bit, and the
host's within the reference's band (rtol = atol = 1e-5,
``tests/test_kernels.py:70``), at the shapes of
``tests/test_torch_tv_tiles.py``, which cut its tiles and chunks at every
edge; on a volume that is not 16-byte aligned (the 4-byte copies, not
TMA, though Nx % 4 == 0); on a volume of more chunks than the grid's z
limit; and again on a repeat launch.  Its ``__frcp_rn(m)`` must give the
bits of ``__fdiv_rn(1, m)`` on the magnitudes that occur.
"""

import ctypes
import re
import subprocess

import numpy as np
import pytest
import torch

from repro_torch.core import phantoms
from repro_torch.core.geometry import ConeGeometry
from repro_torch.kernels import build
from repro_torch.kernels.tv_grad import _forward_diff, tv_grad_cuda, \
    tv_grad_plain

pytestmark = pytest.mark.cuda

SRC = (build.CSRC / "tv_grad.cu").read_text()
TX, WARPS, ROWS_PER, ZC = (
    int(re.search(rf"constexpr int {n} = (\d+);", SRC).group(1))
    for n in ("kTX", "kWarps", "kRowsPer", "kZC"))
TY = WARPS * ROWS_PER
EPS = 1e-6
#: the CPU emulation's shapes (tests/test_torch_tv_tiles.py)
SHAPES = [(ZC - 1, TY + 5, TX + 13), (ZC, 2 * TY, 2 * TX),
          (ZC + 1, 2 * TY + 1, TX + 8), (2 * ZC + 1, TY + 1, TX + 1),
          (1, 2 * TY + 4, TX + 8), (2, TY + 1, TX - 1), (5, 1, TX + 12),
          (6, TY + 3, 1), (3, 1, 1)]
GRID_Z = 65535

RCP_SRC = r"""
#include <cuda_runtime.h>
__global__ void rcp_div(const float* m, float* a, float* b, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    a[i] = __frcp_rn(m[i]);
    b[i] = __fdiv_rn(1.0f, m[i]);
  }
}
extern "C" int rcp_div_launch(const void* m, void* a, void* b, int n,
                              void* stream) {
  rcp_div<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const float*)m, (float*)a, (float*)b, n);
  return (int)cudaGetLastError();
}
"""


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only there)")
    return torch.device("cuda")


def _random(shape, seed=17):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _check(vol: torch.Tensor, dev_vol: torch.Tensor) -> None:
    """Bit for bit against the plain version on the card (IEEE float32
    throughout), within the band of the plain version on the host, whose
    vectorised float32 sqrt may round differently (PERF.md, PR 17)."""
    got = tv_grad_cuda(dev_vol)
    assert torch.equal(got, tv_grad_plain(dev_vol))
    torch.testing.assert_close(got.cpu(), tv_grad_plain(vol), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_kernel_equals_plain(cuda, shape):
    vol = _random(shape)
    _check(vol, vol.to(cuda))


@pytest.mark.parametrize("shape", [(ZC + 1, 3 * TY, TX + 8),
                                   (ZC - 1, 2 * TY + 4, TX + 13),
                                   (64, 64, 64)], ids=str)
def test_kernel_on_the_phantom(cuda, shape):
    """Zero differences over most voxels: m = eps, r = 1e6."""
    vol = torch.from_numpy(phantoms.shepp_logan(
        ConeGeometry.nice(16).with_voxels(shape)))
    _check(vol, vol.to(cuda))


def test_unaligned_volume(cuda):
    """A contiguous view one float into its storage: Nx % 4 == 0 but TMA
    cannot address it, so the 4-byte copies run."""
    shape = (ZC + 3, 2 * TY + 1, 2 * TX)
    flat = _random((1 + int(np.prod(shape)),))
    vol = flat[1:].view(shape)
    dev = flat.to(cuda)[1:].view(shape)
    assert dev.data_ptr() % 16 != 0 and dev.is_contiguous()
    _check(vol, dev)


def test_more_chunks_than_the_grid_holds(cuda):
    """More chunks of ZC planes than the grid's z limit: the blocks stride
    over them."""
    shape = (GRID_Z * ZC + 3 * ZC + 5, 1, 2)
    vol = _random(shape, seed=3)
    _check(vol, vol.to(cuda))


@pytest.mark.parametrize("shape", [(2 * ZC + 1, 37, 45), (96, 128, 128)],
                         ids=str)
def test_repeat_launches_are_bit_identical(cuda, shape):
    vol = _random(shape, seed=5).to(cuda)
    first = tv_grad_cuda(vol)
    for _ in range(3):
        assert torch.equal(tv_grad_cuda(vol), first)


def test_huge_plane_is_refused(cuda):
    """A plane of 2^31 voxels or more is refused before any launch (the
    kernel's in-plane offsets are 32-bit)."""
    v = torch.zeros(4, device=cuda)
    rc = build.entry("tv_grad")(
        v.data_ptr(), v.data_ptr(), 1, 65536, 32768, EPS * EPS,
        v.device.index or 0, torch.cuda.current_stream().cuda_stream)
    assert rc != 0


def test_frcp_equals_fdiv_on_the_magnitudes(cuda, tmp_path):
    """__frcp_rn(m) and __fdiv_rn(1, m) give the same bits on the m of a
    random volume, of the phantom (m = eps), and of 2^22 values spread over
    [eps, 1e6] and beyond (denormal reciprocals)."""
    so = tmp_path / "librcp.so"
    unit = tmp_path / "rcp.cu"
    unit.write_text(RCP_SRC)
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(so),
                    str(unit)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(so)).rcp_div_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ms = []
    for vol in (_random((40, 37, 45)), torch.from_numpy(phantoms.shepp_logan(
            ConeGeometry.nice(16).with_voxels((24, 40, 40))))):
        dz, dy, dx = (_forward_diff(vol, d) for d in range(3))
        ms.append(torch.sqrt(dz * dz + dy * dy + dx * dx + EPS * EPS)
                  .flatten())
    rng = np.random.default_rng(11)
    ms.append(torch.from_numpy(np.exp(rng.uniform(
        np.log(EPS), np.log(1e6), 1 << 22)).astype(np.float32)))
    ms.append(torch.tensor([EPS, 1.0, 3.0, 2.0 ** 126, 3.0e38],
                           dtype=torch.float32))
    m = torch.cat(ms).to(cuda)
    a, b = torch.empty_like(m), torch.empty_like(m)
    assert fn(m.data_ptr(), a.data_ptr(), b.data_ptr(), m.numel(),
              torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert torch.equal(b.cpu(), 1.0 / m.cpu())
