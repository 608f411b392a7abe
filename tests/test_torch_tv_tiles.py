"""The tiled ``tv_grad`` kernel's walk, emulated on the CPU and held against
its plain version bit for bit.

``csrc/tv_grad.cu``: a block of kTX x kWarps threads owns a tile of kTX
columns by kTY = kWarps * kRowsPer rows and walks a chunk of kZC planes; a
thread owns kRowsPer consecutive rows of one column.  Per plane the window
of rows y0-1 .. y0+kTY and columns x0-4 .. x0+kTX+3 comes into a ring of
kStages buffers, kStages - 2 planes ahead: as one TMA box (zeros off the
volume) where Nx % 4 == 0, else by 4-byte copies of columns x0-1 ..
x0+kTX.  Each thread forms r = 1/m and q = d * r once at each of its
voxels; q_y passes down its own rows in registers and across warps through
shared memory, q_x goes to the next lane by a shuffle, q_z stays for the
next plane (a chunk's prologue forms it for plane z0-1); warp 0 forms the
ring row y0-1's q_y and warp 1 the ring column x0-1's q_x.  g is summed as
((-(dz+dy+dx)*r + q_z) + q_y) + q_x, a term skipped at index 0.

The emulation does each of those steps in float32 torch ops, tile by tile
(vectorised over tiles), with the constants read out of the source so it
follows the kernel, and must equal ``tv_grad_plain`` bit for bit at shapes
that cut tiles and chunks at every edge.  Window columns the kernel never
stages, and stale ring buffers, hold NaN; a second run fills the window off
the volume with NaN instead of zeros, so the edges are shown to come from
the predicates alone.  No card, no JAX.
"""

import math
import re

import numpy as np
import pytest
import torch

from repro_torch.core import phantoms
from repro_torch.core.geometry import ConeGeometry
from repro_torch.kernels import build
from repro_torch.kernels.tv_grad import tv_grad_plain

SRC = (build.CSRC / "tv_grad.cu").read_text()
EPS = 1e-6


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


TX, WARPS, ROWS_PER, ZC, STAGES, MIN_BLOCKS = (_const(n) for n in (
    "kTX", "kWarps", "kRowsPer", "kZC", "kStages", "kMinBlocks"))
TY = WARPS * ROWS_PER
X0 = _const("kX0")                  # the window column of x0
assert re.search(r"constexpr int kW = kTX \+ 2 \* kX0;", SRC)
W = TX + 2 * X0
ROWS = TY + 2
THREADS = TX * WARPS
NAN = float("nan")

#: (Nz, Ny, Nx): Nz = ZC - 1, ZC, ZC + 1 and 2 ZC + 1 (three chunks); Ny, Nx
#: cutting the tiles or not, Nx % 4 == 0 (TMA) or not (4-byte copies); 1
#: and 2 planes; one row; one column; one voxel wide and high
SHAPES = [(ZC - 1, TY + 5, TX + 13), (ZC, 2 * TY, 2 * TX),
          (ZC + 1, 2 * TY + 1, TX + 8), (2 * ZC + 1, TY + 1, TX + 1),
          (1, 2 * TY + 4, TX + 8), (2, TY + 1, TX - 1), (5, 1, TX + 12),
          (6, TY + 3, 1), (3, 1, 1)]


def window_source(ny: int, nx: int, tma: bool):
    """Per tile, the in-plane offset each window element is staged from:
    >= 0 a voxel, -1 zero (the TMA box off the volume, or a 4-byte copy's
    zero fill), -2 never staged.  Window element (r, col) is (y0 - 1 + r,
    x0 - X0 + col).  TMA stages the whole box; the 4-byte copies stage
    columns X0 - 1 .. X0 + TX (x0-1 .. x0+TX), item i of a plane at row
    i // (TX + 2), column X0 - 1 + i % (TX + 2).  Shape (n_ty, n_tx, ROWS,
    W)."""
    n_ty, n_tx = -(-ny // TY), -(-nx // TX)
    src = np.full((n_ty, n_tx, ROWS, W), -2, np.int64)
    if tma:
        cells = [(r, col) for r in range(ROWS) for col in range(W)]
    else:
        cells = [(i // (TX + 2), X0 - 1 + i % (TX + 2))
                 for i in range(ROWS * (TX + 2))]
    for by in range(n_ty):
        for bx in range(n_tx):
            for r, col in cells:
                yg, xg = by * TY - 1 + r, bx * TX - X0 + col
                assert src[by, bx, r, col] == -2, "staged twice"
                src[by, bx, r, col] = yg * nx + xg \
                    if 0 <= yg < ny and 0 <= xg < nx else -1
    return src


def emulate(vol: torch.Tensor, fill: float = 0.0,
            order=("z", "y", "x")) -> torch.Tensor:
    """tv_grad_kernel on ``vol`` (float32, CPU); ``fill`` is what the
    window holds off the volume (the kernel's copies read zeros there);
    ``order`` the order of the backward terms."""
    nz, ny, nx = vol.shape
    n_ty, n_tx = -(-ny // TY), -(-nx // TX)
    src = torch.from_numpy(window_source(ny, nx, tma=nx % 4 == 0))
    flat = vol.reshape(nz, ny * nx)
    stale = torch.full((n_ty, n_tx, ROWS, W), NAN)

    def stage(p):
        w = flat[p][src.clamp(min=0)]
        w = torch.where(src == -1, torch.tensor(fill), w)
        return torch.where(src == -2, torch.tensor(NAN), w)

    # a thread (warp, lane) at row j = warp * ROWS_PER + k of its tile
    lane = torch.arange(TX)
    x = (torch.arange(n_tx)[:, None] * TX + lane).view(1, n_tx, 1, TX)
    y = (torch.arange(n_ty)[:, None] * TY + torch.arange(TY)).view(
        n_ty, 1, TY, 1)
    y0 = (torch.arange(n_ty) * TY).view(n_ty, 1, 1)
    k_of = (torch.arange(TY) % ROWS_PER).view(1, 1, TY, 1)
    zero = torch.zeros(())
    eps2 = EPS * EPS
    out = torch.full((nz, n_ty * TY, n_tx * TX), NAN)
    own = (..., slice(1, TY + 1), slice(X0, X0 + TX))   # window (y, x)

    def r_of(dz, dy, dx):
        return 1.0 / torch.sqrt(dz * dz + dy * dy + dx * dx + eps2)

    n_chunks = -(-nz // ZC)
    for chunk in range(n_chunks):
        z0 = chunk * ZC
        z1 = min(z0 + ZC, nz)
        zs = max(z0 - 1, 0)
        zl = min(z1, nz - 1)
        ring = [stale.clone() for _ in range(STAGES)]
        for k in range(STAGES - 1):
            if zs + k <= zl:
                ring[k] = stage(zs + k)
        s = 0
        c = qz = None
        for p in range(zs, z1):
            if p + STAGES - 1 <= zl:      # into the buffer of plane p-1
                ring[(s - 1) % STAGES] = stage(p + STAGES - 1)
            w0, w1 = ring[s], ring[(s + 1) % STAGES]
            zf = p + 1 < nz
            if p == zs:
                c = w0[own]
            fz = w1[own]
            # fy: the next row's carried value in the thread, the window
            # below its last row
            fy = torch.where(k_of + 1 < ROWS_PER,
                             torch.roll(c, -1, dims=2),
                             w0[..., 2:TY + 2, X0:X0 + TX])
            dz = fz - c if zf else torch.zeros_like(c)
            dy = torch.where(y + 1 < ny, fy - c, zero)
            dx = torch.where(x + 1 < nx,
                             w0[..., 1:TY + 1, X0 + 1:X0 + TX + 1] - c, zero)
            r = r_of(dz, dy, dx)
            qy, qx = dy * r, dx * r
            if p >= z0:
                # ring row (y0-1, x): q_y, by warp 0
                rc = w0[..., 0, X0:X0 + TX]
                rdz = w1[..., 0, X0:X0 + TX] - rc if zf else zero
                rdy = w0[..., 1, X0:X0 + TX] - rc
                rdx = torch.where(x.view(1, n_tx, TX) + 1 < nx,
                                  w0[..., 0, X0 + 1:X0 + TX + 1] - rc, zero)
                ring_qy = rdy * r_of(rdz, rdy, rdx)
                # ring column (y0+j, x0-1): q_x, by warp 1
                cc = w0[..., 1:TY + 1, X0 - 1]
                cdz = w1[..., 1:TY + 1, X0 - 1] - cc if zf else zero
                cdy = torch.where(y0 + torch.arange(TY) + 1 < ny,
                                  w0[..., 2:TY + 2, X0 - 1] - cc, zero)
                cdx = w0[..., 1:TY + 1, X0] - cc
                ring_qx = cdx * r_of(cdz, cdy, cdx)
                # q_y of row j-1: the thread's own row above (register),
                # else sqy[warp]: the ring row or warp-1's last row
                sqy = torch.cat([ring_qy.unsqueeze(2),
                                 qy[..., ROWS_PER - 1:TY - 1:ROWS_PER, :]], 2)
                qy_up = torch.where(k_of > 0, torch.roll(qy, 1, dims=2),
                                    sqy.repeat_interleave(ROWS_PER, dim=2))
                # q_x of lane-1 by shuffle; lane 0 the ring column's
                qx_left = torch.where(lane > 0, torch.roll(qx, 1, dims=3),
                                      ring_qx.unsqueeze(-1))
                terms = {"z": (p > 0, qz), "y": (y > 0, qy_up),
                         "x": (x > 0, qx_left)}
                g = -(dz + dy + dx) * r
                for axis in order:
                    cond, q = terms[axis]
                    if cond is True:
                        g = g + q
                    elif cond is not False:
                        g = torch.where(cond, g + q, g)
                out[p] = g.permute(0, 2, 1, 3).reshape(n_ty * TY, n_tx * TX)
            qz = dz * r
            c = fz
            s = (s + 1) % STAGES
    return out[:, :ny, :nx].contiguous()


def _random(shape, seed=17):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def test_constants_and_launch_bounds():
    """A tile row is one warp, the ring column fits warp 1, the launch
    bounds ask for at least 4 blocks an SM and that many fit the SM's
    threads and 227 KB of shared memory; the ring holds planes p and p+1
    and at least one more in flight; the TMA box's rows are a multiple of
    16 bytes, start on 16 bytes and are at most 256 elements a side."""
    assert TX == 32 and TY <= 32 and WARPS >= 2
    assert re.search(r"constexpr int kTY = kWarps \* kRowsPer;", SRC)
    assert re.search(r"constexpr int kThreads = kTX \* kWarps;", SRC)
    assert re.search(r"__launch_bounds__\(kThreads, kMinBlocks\)", SRC)
    assert MIN_BLOCKS >= 4 and THREADS * MIN_BLOCKS <= 2048
    buf = -(-ROWS * W * 4 // 128) * 128
    smem = STAGES * buf + 4 * (2 * WARPS * TX + 2 * TY) + 8 * STAGES
    assert smem * MIN_BLOCKS <= 232448
    assert STAGES >= 3 and max(ROWS, W) <= 256
    assert (X0 * 4) % 16 == 0 and (W * 4) % 16 == 0   # TMA box on 16 bytes


@pytest.mark.parametrize("tma", [True, False], ids=["tma", "4-byte"])
def test_staging_covers_the_window(tma):
    """Every window element the kernel reads (rows y0-1 .. y0+TY, columns
    x0-1 .. x0+TX) is staged exactly once, from the voxel at its place or
    as zero off the volume; the 4-byte copies leave the box's outer
    columns unstaged."""
    ny, nx = 2 * TY + 3, 2 * TX + (4 if tma else 5)
    src = window_source(ny, nx, tma)
    n_ty, n_tx = src.shape[:2]
    for by in range(n_ty):
        for bx in range(n_tx):
            for r in range(ROWS):
                for col in range(W):
                    yg, xg = by * TY - 1 + r, bx * TX - X0 + col
                    got = src[by, bx, r, col]
                    if not tma and not X0 - 1 <= col <= X0 + TX:
                        assert got == -2
                    elif 0 <= yg < ny and 0 <= xg < nx:
                        assert got == yg * nx + xg
                    else:
                        assert got == -1


@pytest.mark.parametrize("fill", [0.0, NAN], ids=["zero-fill", "nan-fill"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_tile_walk_equals_plain(shape, fill):
    """Seeded random values: the emulated walk equals tv_grad_plain bit for
    bit, whatever the window holds off the volume."""
    vol = _random(shape)
    got = emulate(vol, fill)
    assert torch.isfinite(got).all()
    assert torch.equal(got, tv_grad_plain(vol))


@pytest.mark.parametrize("shape", [(ZC + 1, 3 * TY, TX + 8),
                                   (ZC - 1, 2 * TY + 4, TX + 13)], ids=str)
def test_tile_walk_on_the_phantom(shape):
    """The piecewise-constant Shepp-Logan phantom (zero differences, so m =
    eps and r = 1e6 over most voxels)."""
    vol = torch.from_numpy(phantoms.shepp_logan(
        ConeGeometry.nice(16).with_voxels(shape)))
    assert torch.equal(emulate(vol), tv_grad_plain(vol))


def test_summation_order_is_seen():
    """The bit-for-bit check tells the order of the backward terms apart:
    q_x added before q_y changes outputs of random values."""
    vol = _random((ZC + 1, TY + 5, TX + 13), seed=4)
    want = tv_grad_plain(vol)
    assert torch.equal(emulate(vol), want)
    wrong = emulate(vol, order=("z", "x", "y"))
    assert not torch.equal(wrong, want)
    assert math.isclose(float((wrong - want).abs().max()), 0.0,
                        abs_tol=1e-3)
