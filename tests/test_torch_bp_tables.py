"""The table-driven ``bp_matched`` (``csrc/bp_matched.cu``), emulated on the
CPU and held against ``bp_matched_plain``.

The kernel gathers each voxel's taps off per-plane tables that a block
fills once per angle: the window of u whose taps reach its tile of rows,
each u's u-part, each row's list of u hits, each u's window of v and the
run of v hits of each plane.  Its argument rests on three facts the
emulation below checks as it goes, in float32 arithmetic op for op as
``joseph_common.cuh`` writes it (numpy rounds each float32 operation as
the ``__f*_rn`` intrinsics do):
* every hit of a tile lies in the inverted, widened windows;
* k0i never falls as v rises (so a plane's hits are a run), and a row's
  u hits are few;
* the gather adds (gs * wz) * wy with gs = g * seg, u and v in order.
The emulation's result must lie within the projector band of the plain
version (rtol 2e-4, atol 5e-3, ``tests/test_backend.py:23``).  The table
sizes are read from the kernel's source, and at the main shape (N = 512,
512 angles) the windows and hit lists must fit them, so that the kernel
takes its table path there.  No card, no JAX.
"""

import re

import numpy as np
import pytest
import torch

from repro_torch.core.geometry import (ConeGeometry, circular_angles,
                                       dominant_axis_mask)
from repro_torch.kernels import build
from repro_torch.kernels.bp_matched import bp_matched_plain
from repro_torch.kernels.fp_ray import angle_constants, plane_centers

SRC = (build.CSRC / "bp_matched.cu").read_text()
F = np.float32


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


def _config0() -> list:
    """The knobs of configuration 0, the first row of the kernel's tile
    table ``kConfigs`` ({block_k, angles})."""
    row = re.search(r"kConfigs\[\]\[\d+\] = \{\{([\d, ]+)\}", SRC).group(1)
    return [int(x) for x in row.split(",")]


BLOCK_J, BLOCK_K = _const("kBlockJ"), _config0()[0]
U_CAP, RUN = _const("kUCap"), _const("kRun")
V_CAP = BLOCK_K + int(re.search(r"kVCap = kBlockK \+ (\d+);", SRC).group(1))
WIDEN_U, WIDEN_V = _const("kWidenU"), _const("kWidenV")


class Geom:
    """The float32 scalars of make_geom() (joseph_common.cuh)."""

    def __init__(self, geo: ConeGeometry, planes: int, z0: int):
        self.nz, self.ny, self.nx = geo.n_voxel
        self.nv, self.nu = geo.n_detector
        self.planes = planes
        self.dz, self.dy, self.dx = (F(d) for d in geo.d_voxel)
        self.dv, self.du = (F(d) for d in geo.d_detector)
        self.offz, self.offy = F(geo.off_origin[0]), F(geo.off_origin[1])
        self.offv, self.offu = (F(o) for o in geo.off_detector)
        self.cz, self.cy = F((self.nz - 1) / 2.0), F((self.ny - 1) / 2.0)
        self.cv, self.cu = F((self.nv - 1) / 2.0), F((self.nu - 1) / 2.0)
        self.z0 = F(z0)


def joseph_u(c, iu, x, g):
    sx, sy, _, dcx, dcy, eux, euy = c
    u = (iu.astype(F) - g.cu) * g.du + g.offu
    d_x = (dcx + u * eux) - sx
    d_y = (dcy + u * euy) - sy
    inv_dx = F(1) / np.where(np.abs(d_x) < F(1e-9), F(1e-9), d_x)
    s_par = (x - sx) * inv_dx
    fj = ((sy + s_par * d_y) - g.offy) / g.dy + g.cy
    j0 = np.floor(fj)
    return dict(s_par=s_par, j0i=j0.astype(np.int64), wj=fj - j0,
                mask=(s_par > 0) & (s_par <= 1), dxy2=d_x * d_x + d_y * d_y,
                adx=np.maximum(np.abs(d_x), F(1e-9)))


def joseph_v(c, s_par, iv, g):
    sz = c[2]
    d_z = ((iv.astype(F) - g.cv) * g.dv + g.offv) - sz
    fk = (((sz + s_par * d_z) - g.offz) / g.dz + g.cz) - g.z0
    k0 = np.floor(fk)
    return k0.astype(np.int64), fk - k0, d_z


def window(f0, f1, n, widen):
    """candidate_range(): the widened, clamped index interval."""
    if not (np.isfinite(f0) and np.isfinite(f1)):
        return 0, n - 1
    a = min(max(min(f0, f1), -4.0), n + 4.0)
    b = min(max(max(f0, f1), -4.0), n + 4.0)
    return max(0, int(np.floor(a)) - widen), min(n - 1, int(np.ceil(b)) + widen)


def emulate(proj: np.ndarray, geo: ConeGeometry, angles, z0: int,
            planes: int):
    """The kernel's algorithm; returns the slab (planes, Ny, Nx) and the
    largest u window, v window and row hit list it met."""
    g = Geom(geo, planes, z0)
    consts = angle_constants(geo, torch.as_tensor(angles)).numpy()
    xc = plane_centers(geo, torch.device("cpu")).numpy()
    out = np.zeros((planes, g.ny, g.nx), F)
    most = dict(u=0, v=0, hits=0)
    iu_all, iv_all = np.arange(g.nu), np.arange(g.nv)
    for a, c in enumerate(consts[:, :7]):
        # 0. gs = g * seg per ray
        su0 = joseph_u(c, iu_all, F(0), g)
        d_z = joseph_v(c, F(1), iv_all, g)[2]
        norm = np.sqrt(su0["dxy2"][None, :] + d_z[:, None] * d_z[:, None])
        gs = proj[a] * ((norm / su0["adx"][None, :]) * g.dx)
        sx, sy, sz, dcx, dcy, eux, euy = (float(t) for t in c)
        for p, x in enumerate(xc):
            acc = out[:, :, p]
            for jb in range(0, g.ny, BLOCK_J):
                # 1. the u window of the tile's rows
                inv = []
                for yt in ((jb - 1 - g.cy) * g.dy + g.offy,
                           (min(jb + BLOCK_J, g.ny) - g.cy) * g.dy + g.offy):
                    r = (yt - sy) / (x - sx)
                    u = ((dcy - sy) - r * (dcx - sx)) / (r * eux - euy)
                    inv.append((u - g.offu) / g.du + g.cu)
                u0, u1 = window(*inv, g.nu, WIDEN_U)
                qs = np.arange(u0, u1 + 1)
                most["u"] = max(most["u"], len(qs))
                su = joseph_u(c, qs, x, g)
                # every ray of this plane that hits the tile's rows lies
                # in the window
                hits_all = joseph_u(c, iu_all, x, g)
                reach = hits_all["mask"] & (hits_all["j0i"] >= jb - 1) & (
                    hits_all["j0i"] < min(jb + BLOCK_J, g.ny))
                assert np.all((iu_all[reach] >= u0) & (iu_all[reach] <= u1))
                for kb in range(0, planes, BLOCK_K):
                    k_hi = min(kb + BLOCK_K, planes)
                    zt = [((kb - 1) + g.z0 - g.cz) * g.dz + g.offz,
                          (k_hi + g.z0 - g.cz) * g.dz + g.offz]
                    # 2-3. each u's v window, its z taps and gs * wz
                    rows = {}
                    for q in np.nonzero(su["mask"])[0]:
                        s = su["s_par"][q]
                        f = [((sz + (z - sz) / s) - g.offv) / g.dv + g.cv
                             for z in zt]
                        v0, v1 = window(*f, g.nv, WIDEN_V)
                        iv = np.arange(v0, v1 + 1)
                        most["v"] = max(most["v"], len(iv))
                        k0, wk, _ = joseph_v(c, s, iv, g)
                        assert np.all(np.diff(k0) >= 0)    # runs
                        # every row v whose z taps reach the tile's planes
                        # lies in the window
                        k_all = joseph_v(c, s, iv_all, g)[0]
                        reach = (k_all >= kb - 1) & (k_all < k_hi)
                        assert np.all((iv_all[reach] >= v0) &
                                      (iv_all[reach] <= v1))
                        col = gs[iv, qs[q]]
                        rows[q] = (k0, col * (F(1) - wk), col * wk)
                    # 4. each voxel's hits, u then v in order
                    for j in range(jb, min(jb + BLOCK_J, g.ny)):
                        hit = su["mask"] & ((su["j0i"] == j) |
                                            (su["j0i"] + 1 == j))
                        hq = np.nonzero(hit)[0]
                        most["hits"] = max(most["hits"], len(hq))
                        for k in range(kb, k_hi):
                            for q in hq:
                                wy = F(1) - su["wj"][q] if su["j0i"][q] == j \
                                    else su["wj"][q]
                                k0, g_lo, g_hi = rows[q]
                                for e in np.nonzero((k0 == k - 1) |
                                                    (k0 == k))[0]:
                                    w = g_hi[e] if k0[e] == k - 1 else g_lo[e]
                                    acc[k, j] = acc[k, j] + w * wy
    return out, most


def _data(geo, n_angles, seed):
    ang = circular_angles(n_angles)
    a = ang[dominant_axis_mask(ang)]
    y = np.random.default_rng(seed).standard_normal(
        (len(a),) + geo.n_detector).astype(F)
    return a, y


@pytest.mark.parametrize("geo,n_angles,z0,planes", [
    (ConeGeometry.nice(16), 17, 0, 16),
    (ConeGeometry.nice(13), 37, 4, 6),
    (ConeGeometry(n_voxel=(14, 20, 26), s_voxel=(200.0, 240.0, 260.0),
                  n_detector=(18, 22), s_detector=(300.0, 380.0),
                  off_origin=(6.0, -9.0, 7.0), off_detector=(11.0, -13.0)),
     21, 5, 7),
], ids=["n16", "n13-slab", "offsets-slab"])
def test_table_algorithm_matches_plain(geo, n_angles, z0, planes):
    a, y = _data(geo, n_angles, seed=7)
    got, _ = emulate(y, geo, a, z0, planes)
    want = bp_matched_plain(torch.from_numpy(y), geo, a, z0, planes)
    torch.testing.assert_close(torch.from_numpy(got), want, rtol=2e-4,
                               atol=5e-3)


@pytest.mark.parametrize("angle_slice", [slice(0, None, 2), slice(1, None, 2)])
def test_main_shape_fits_the_tables(angle_slice):
    """N = 512, 512 angles (the x-dominant half, alternate angles per
    case), every 16th plane and every tile of rows: the u window, each
    u's v window over a tile of planes and each row's hit list fit the
    kernel's tables, so no launch at the main shape leaves them."""
    geo = ConeGeometry.nice(512)
    ang = circular_angles(512)
    a = ang[dominant_axis_mask(ang)][angle_slice]
    g = Geom(geo, 512, 0)
    consts = angle_constants(geo, torch.as_tensor(a)).numpy()
    xc = plane_centers(geo, torch.device("cpu")).numpy()
    iu = np.arange(g.nu)
    most_u = most_v = most_hits = 0
    for c in consts[:, :7]:
        sx, sy, sz, dcx, dcy, eux, euy = (float(t) for t in c)
        for x in xc[::16]:
            su = joseph_u(c, iu, x, g)
            j0 = su["j0i"][su["mask"]]
            j0 = j0[(j0 >= -1) & (j0 < g.ny)]
            n = np.bincount(j0 + 1, minlength=g.ny + 1)
            most_hits = max(most_hits, int((n[1:] + n[:-1]).max()))
            for jb in range(0, g.ny, BLOCK_J):
                inv = []
                for yt in ((jb - 1 - g.cy) * g.dy + g.offy,
                           (min(jb + BLOCK_J, g.ny) - g.cy) * g.dy + g.offy):
                    r = (yt - sy) / (x - sx)
                    u = ((dcy - sy) - r * (dcx - sx)) / (r * eux - euy)
                    inv.append((u - g.offu) / g.du + g.cu)
                u0, u1 = window(*inv, g.nu, WIDEN_U)
                most_u = max(most_u, u1 - u0 + 1)
            # the widest v window: the smallest s_par, the widest z span
            s = float(su["s_par"][su["mask"]].min())
            span = (BLOCK_K + 1) * float(g.dz) / (s * float(g.dv))
            most_v = max(most_v, int(np.ceil(span)) + 3 + 2 * WIDEN_V)
    assert most_u <= U_CAP, most_u
    assert most_v <= V_CAP, most_v
    assert most_hits <= RUN, most_hits
