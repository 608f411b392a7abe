"""The redesigned ``fp_ray`` and ``bp_voxel`` kernels, emulated on the CPU
and held against their plain versions.

``fp_ray`` (``csrc/fp_ray.cu``): a thread computes the u-part once per
(u, plane) for its rows, skips a plane when the z taps of its first row
lie above the slab or those of its last row below it, and sums the taps of
each row with the reference's bounds tests and blend.  The emulation does
the same in float32, op for op as ``joseph_common.cuh`` writes it, and must
equal ``fp_ray_plain`` bit for bit: taps, weights and sums.  The skip rests
on k0i never falling as v rises, checked at the main shape.

``bp_voxel`` (``csrc/bp_voxel.cu``): one reciprocal of the depth per
(column, angle), fv affine in the plane's index in the volume, the floor by adding 1.5 * 2^23
rounding down, the blend as three lerps, and the taps from a window of the
projection staged per (tile, angle) from the tile's 8 corners.  The
emulation (fused multiply-adds rounded once from float64) must stay within
the projector band of ``bp_voxel_plain`` (rtol 2e-4, atol 5e-3,
``tests/test_backend.py:23``), every column must find its taps in its
tile's window, and at the main shape (N = 512, 512 angles) every window
must fit the buffer the kernel declares.  The geometry the card tests use
to force the kernel's global-read path must leave the windows.  No card,
no JAX.
"""

import re

import numpy as np
import pytest
import torch

from repro_torch.core.geometry import (ConeGeometry, circular_angles,
                                       dominant_axis_mask)
from repro_torch.kernels import build
from repro_torch.kernels.bp_voxel import WEIGHTS, bp_voxel_plain
from repro_torch.kernels.fp_ray import (angle_constants, fp_ray_plain,
                                        plane_centers)

F = np.float32
FP_SRC = (build.CSRC / "fp_ray.cu").read_text()
BP_SRC = (build.CSRC / "bp_voxel.cu").read_text()


def _const(src: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _config0(src: str) -> list:
    """The knobs of a kernel's configuration 0, the first row of its tile
    table ``kConfigs``."""
    row = re.search(r"kConfigs\[\]\[\d+\] = \{\{([\d, ]+)\}", src).group(1)
    return [int(x) for x in row.split(",")]


ROWS_PER = _config0(FP_SRC)[0]                 # {rows_per, warps}
TZ, TY = _config0(BP_SRC)                      # {tile_z, tile_y}
TX, WIDEN = (_const(BP_SRC, n) for n in ("kTX", "kWiden"))
# the window buffer of configuration 0: kRows = kTZ * a / b rows of
# kStride floats (the wide stride above a tile_y bound)
_a, _b = re.search(r"kRows = kTZ \* (\d+) / (\d+);", BP_SRC).groups()
ROWS = TZ * int(_a) // int(_b)
_bound, _wide, _narrow = (int(x) for x in re.search(
    r"kStride = kTY > (\d+) \? (\d+) : (\d+);", BP_SRC).groups())
STRIDE = _wide if TY > _bound else _narrow
MAGIC = F(12582912.0)                # 1.5 * 2^23
COORD_MAX = F(1048576.0)             # 2^20

#: the geometry that drives bp_voxel's global-read path: detector rows of
#: 0.92 mm under 1 mm voxels make the window of a tile's 32 planes (~50
#: rows at a magnification of 1.5) taller than a buffer for some tiles and
#: angles, not for all; with large detector offsets.  The card tests hold
#: both kernels to their plain versions on it (fp_ray stages no windows)
OVERFLOW_GEO = ConeGeometry(
    DSD=1536.0, DSO=1000.0, n_voxel=(40, 36, 44),
    s_voxel=(40.0, 36.0, 44.0), n_detector=(76, 41),
    s_detector=(70.0, 82.0), off_detector=(9.0, -13.0))


def fma(a, b, c):
    """float32 fused multiply-add (the product exact in float64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(F)


def floor_magic(x):
    """The kernel's floor: x + 1.5 * 2^23 rounded down, minus 1.5 * 2^23."""
    x = np.asarray(x, np.float64)
    s = x + np.float64(MAGIC)
    err = x - (s - np.float64(MAGIC))        # s + err == x + MAGIC exactly
    t = s.astype(F)
    td = t.astype(np.float64)
    down = (td > s) | ((td == s) & (err < 0))
    t = np.where(down, np.nextafter(t, F(-np.inf)), t)
    return (t - MAGIC).astype(F), (t.view(np.int32)
                                   - np.array(MAGIC, F).view(np.int32))


# --------------------------------------------------------------------------
# fp_ray
# --------------------------------------------------------------------------

class JGeom:
    """The float32 scalars of make_geom() (joseph_common.cuh)."""

    def __init__(self, geo: ConeGeometry, nz_slab: int, z0: int):
        self.nz, self.ny, self.nx = geo.n_voxel
        self.nv, self.nu = geo.n_detector
        self.nz_slab = nz_slab
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


def joseph_dz(c, iv, g):
    return ((iv.astype(F) - g.cv) * g.dv + g.offv) - c[2]


def joseph_v_tap_dz(c, s_par, d_z, g):
    fk = (((c[2] + s_par * d_z) - g.offz) / g.dz + g.cz) - g.z0
    k0 = np.floor(fk)
    return k0.astype(np.int64), fk - k0


def fp_emulate(vol: np.ndarray, geo: ConeGeometry, angles, z0: int):
    """fp_ray_kernel: per (angle, u, plane) the u-part once; per thread of
    ROWS_PER rows the skip by its first and last rows; per row the taps,
    blended in the plain version's order.  Returns the sums before the seg
    factor, the projections and the number of (thread, plane) skips."""
    g = JGeom(geo, vol.shape[0], z0)
    consts = angle_constants(geo, torch.as_tensor(angles)).numpy()
    xc = plane_centers(geo, torch.device("cpu")).numpy()
    vol_t = np.ascontiguousarray(vol.transpose(2, 0, 1))   # (Nx, nz, Ny)
    n_rows = -(-g.nv // ROWS_PER) * ROWS_PER                # virtual rows too
    iu, iv = np.arange(g.nu), np.arange(n_rows)
    out = np.zeros((len(consts), g.nv, g.nu), F)
    sums = np.zeros_like(out)
    skips = 0
    for a, c in enumerate(consts[:, :7]):
        d_z = joseph_dz(c, iv, g)[:, None]                  # (rows, 1)
        acc = np.zeros((n_rows, g.nu), F)
        for p, x in enumerate(xc):
            su = joseph_u(c, iu, x, g)
            j0, wj = su["j0i"], su["wj"]
            okj0 = (j0 >= 0) & (j0 < g.ny)
            okj1 = (j0 + 1 >= 0) & (j0 + 1 < g.ny)
            k0, wk = joseph_v_tap_dz(c, su["s_par"][None, :], d_z, g)
            # the skip: no row of a thread reaches [0, nz_slab)
            kt = k0.reshape(-1, ROWS_PER, g.nu)
            skip = (kt[:, -1] < -1) | (kt[:, 0] > g.nz_slab - 1)
            reach = ((kt >= -1) & (kt <= g.nz_slab - 1)).any(axis=1)
            assert not np.any(skip & reach & su["mask"][None, :])
            live = su["mask"] & (okj0 | okj1)
            skips += int((skip & live[None, :]).sum())
            wy0 = np.where(okj0, F(1) - wj, F(0))
            wy1 = np.where(okj1, wj, F(0))
            okk0 = (k0 >= 0) & (k0 < g.nz_slab)
            okk1 = (k0 + 1 >= 0) & (k0 + 1 < g.nz_slab)
            plane = vol_t[p]
            jc0, jc1 = np.clip(j0, 0, g.ny - 1), np.clip(j0 + 1, 0, g.ny - 1)
            kc0 = np.clip(k0, 0, g.nz_slab - 1)
            kc1 = np.clip(k0 + 1, 0, g.nz_slab - 1)

            def col(kc, ok):
                v0 = np.where(okj0, plane[kc, jc0], F(0))
                v1 = np.where(okj1, plane[kc, jc1], F(0))
                return np.where(ok, v0 * wy0 + v1 * wy1, F(0))

            wz0 = np.where(okk0, F(1) - wk, F(0))
            wz1 = np.where(okk1, wk, F(0))
            add = col(kc0, okk0) * wz0 + col(kc1, okk1) * wz1
            acc = np.where(live[None, :] & (okk0 | okk1), acc + add, acc)
        s0 = joseph_u(c, iu, xc[0], g)
        seg = (np.sqrt(s0["dxy2"][None, :] + d_z * d_z)
               / s0["adx"][None, :]) * g.dx
        sums[a] = acc[:g.nv]
        out[a] = (acc * seg)[:g.nv]
    return sums, out, skips


def _fp_taps_plain(geo, angles, z0):
    """fp_ray_plain's taps at every plane, from its own expressions
    (kernels/fp_ray.py _rays, _plane_sample): (j0, wj, k0, wk) stacked."""
    from repro_torch.kernels.fp_ray import _rays
    nz, ny, _ = geo.n_voxel
    dz, dy, _ = geo.d_voxel
    offz, offy, _ = geo.off_origin
    consts = angle_constants(geo, torch.as_tensor(angles))
    (sx, sy, sz), d_y, d_z, inv_dx, _ = _rays(geo, consts)
    taps = []
    for x in plane_centers(geo, torch.device("cpu")):
        s_par = (x - sx) * inv_dx
        fj = ((sy + s_par * d_y) - offy) / dy + (ny - 1) / 2.0
        fk = ((sz + s_par * d_z - offz) / dz + (nz - 1) / 2.0) - z0
        taps.append((torch.floor(fj), fj - torch.floor(fj), torch.floor(fk),
                     fk - torch.floor(fk)))
    return taps


FP_CASES = [
    (ConeGeometry.nice(16), 17, 0, None),
    (ConeGeometry.nice(13), 29, 4, 6),
    (ConeGeometry(n_voxel=(17, 23, 29), s_voxel=(170.0, 230.0, 290.0),
                  n_detector=(19, 31), s_detector=(300.0, 420.0),
                  off_origin=(6.0, -9.0, 7.0), off_detector=(11.0, -13.0)),
     23, 5, 7),
    (ConeGeometry.nice(24, n_detector=(32, 20)), 16, 0, None),
]


@pytest.mark.parametrize("geo,n_angles,z0,planes", FP_CASES,
                         ids=["n16", "n13-slab", "prime-offsets-slab",
                              "unequal-detector"])
def test_fp_emulation_is_plain_bit_for_bit(geo, n_angles, z0, planes):
    """The kernel's algorithm (the u-part once per (u, plane), the z taps
    from the kept d_z, the skip) has the plain version's taps and, blended
    in the plain version's order, its sums over the planes bit for bit, on
    x-dominant angles of whole volumes and slabs; times seg (one ulp apart
    in a few rays: joseph_seg()'s sqrt and division against torch's) the
    projections agree to float32 rounding."""
    from repro_torch.kernels.fp_ray import _plane_sample, _rays
    ang = circular_angles(n_angles)
    a = ang[dominant_axis_mask(ang)]
    planes = geo.n_voxel[0] if planes is None else planes
    vol = np.random.default_rng(3).standard_normal(
        (planes,) + tuple(geo.n_voxel[1:])).astype(F)
    sums, got, _ = fp_emulate(vol, geo, a, z0)
    consts = angle_constants(geo, torch.as_tensor(a))
    src, d_y, d_z, inv_dx, _ = _rays(geo, consts)
    xc = plane_centers(geo, torch.device("cpu"))
    want = torch.zeros(sums.shape)
    for p in range(geo.n_voxel[2]):
        want = want + _plane_sample(torch.from_numpy(vol[:, :, p]), geo, src,
                                    d_y, d_z, inv_dx, xc[p], z0)
    assert np.array_equal(sums, want.numpy())
    torch.testing.assert_close(torch.from_numpy(got),
                               fp_ray_plain(torch.from_numpy(vol), geo, a, z0),
                               rtol=1e-6, atol=1e-6)
    g = JGeom(geo, planes, z0)
    c = consts.numpy()[0, :7]
    d_zr = joseph_dz(c, np.arange(g.nv), g)[:, None]
    for p, (j0, wj, k0, wk) in enumerate(_fp_taps_plain(geo, a, z0)):
        su = joseph_u(c, np.arange(g.nu), xc[p].numpy(), g)
        k, w = joseph_v_tap_dz(c, su["s_par"][None, :], d_zr, g)
        assert np.array_equal(su["j0i"], j0[0, 0].numpy())
        assert np.array_equal(su["wj"], wj[0, 0].numpy())
        assert np.array_equal(k, k0[0].numpy())
        assert np.array_equal(w, wk[0].numpy())


def test_fp_slab_skips_planes_and_partials_add_up():
    """A slab of a third of the planes skips most (thread, plane) pairs,
    and the emulated partial projections of three slabs add up to the
    whole within float32 summation."""
    geo = ConeGeometry.nice(24)
    ang = circular_angles(12)
    a = ang[dominant_axis_mask(ang)]
    vol = np.random.default_rng(5).standard_normal(geo.n_voxel).astype(F)
    _, whole, none_skipped = fp_emulate(vol, geo, a, 0)
    parts, skipped = np.zeros_like(whole), 0
    for z0, z1 in ((0, 8), (8, 16), (16, 24)):
        _, part, s = fp_emulate(np.ascontiguousarray(vol[z0:z1]), geo, a, z0)
        parts += part
        skipped += s
    np.testing.assert_allclose(parts, whole, rtol=1e-5, atol=1e-5)
    assert skipped > none_skipped


def test_fp_k_taps_rise_with_v_at_main_shape():
    """The skip's premise at N = 512 (every 8th x-dominant angle, every
    16th plane, every u): k0i never falls as v rises."""
    geo = ConeGeometry.nice(512)
    ang = circular_angles(512)
    a = ang[dominant_axis_mask(ang)][::8]
    g = JGeom(geo, 512, 0)
    consts = angle_constants(geo, torch.as_tensor(a)).numpy()
    xc = plane_centers(geo, torch.device("cpu")).numpy()
    iu, iv = np.arange(g.nu), np.arange(g.nv)
    for c in consts[:, :7]:
        d_z = joseph_dz(c, iv, g)[:, None]
        for x in xc[::16]:
            su = joseph_u(c, iu, x, g)
            s = su["s_par"][su["mask"]][None, :]
            k0, _ = joseph_v_tap_dz(c, s, d_z, g)
            assert np.all(np.diff(k0, axis=0) >= 0)


# --------------------------------------------------------------------------
# bp_voxel
# --------------------------------------------------------------------------

class VGeom:
    """The float32 scalars bp_voxel_launch() forms (csrc/bp_voxel.cu)."""

    def __init__(self, geo: ConeGeometry, z_start: int):
        self.nz, self.ny, self.nx = geo.n_voxel
        self.nv, self.nu = geo.n_detector
        self.dz, self.dy, self.dx = (F(d) for d in geo.d_voxel)
        self.offz, self.offy, self.offx = (F(o) for o in geo.off_origin)
        dv, du = (F(d) for d in geo.d_detector)
        offv, offu = (F(o) for o in geo.off_detector)
        self.cz, self.cy, self.cx = (F((n - 1) / 2.0) for n in geo.n_voxel)
        self.dso, self.dsd = F(geo.DSO), F(geo.DSD)
        self.dso_over_dsd = F(geo.DSO / geo.DSD)
        self.z_start = F(z_start)
        self.inv_du = F(1.0 / float(du))
        self.inv_dv = F(1.0 / float(dv))
        self.fu_c = F((self.nu - 1) / 2.0 - float(offu) / float(du))
        self.fv_c = F((self.nv - 1) / 2.0
                      - float(F(geo.off_detector[0] / geo.d_detector[0])))


def column_terms(g, X, Y, cth, sth, code):
    p = fma(X, cth, Y * sth)
    q = fma(Y, cth, -(X * sth))
    depth = g.dso - p
    rd = (1.0 / depth.astype(np.float64)).astype(F)
    mag = g.dsd * rd
    fvs = mag * g.inv_dv
    fu = fma(q * mag, g.inv_du, g.fu_c)
    fv0 = fma(g.offz, fvs, g.fv_c)               # fv = gz * dfv + fv0
    dfv = g.dz * fvs
    if code == 0:
        w2d = (g.dso * rd) * (g.dso * rd)
    elif code == 1:
        w2d = (mag * mag) * g.dso_over_dsd
    else:
        w2d = np.ones_like(mag)
    return fu, fv0, dfv, w2d, depth > 0


def column_x(g, ix):
    return fma(ix.astype(F) - g.cx, g.dx, g.offx)


def column_y(g, iy):
    return fma(iy.astype(F) - g.cy, g.dy, g.offy)


def plane_g(g, kz0):
    """gz of a tile's first plane: its index in the volume less cz."""
    return (kz0.astype(F) + g.z_start) - g.cz


def windows(g, cth, sth, ix0, iy0, kz0):
    """compute_window() for every tile (iy0 x ix0 x kz0 grids, broadcast):
    (u0, nch, v0, rows, ok)."""
    Xs = [column_x(g, ix0), column_x(g, ix0 + TX - 1)]
    Ys = [column_y(g, iy0), column_y(g, iy0 + TY - 1)]
    gz0 = plane_g(g, kz0)
    fus, fvs, good = [], [], True
    for X in Xs:
        for Y in Ys:
            fu, fv0, dfv, _, front = column_terms(g, X, Y, cth, sth, 2)
            for k in (F(0), F(TZ - 1)):
                fv = fma(gz0 + k, dfv, fv0)
                good = good & front & (np.abs(fu) < COORD_MAX) & (
                    np.abs(fv) < COORD_MAX)
                fus.append(fu)
                fvs.append(fv)
    fus, fvs = np.broadcast_arrays(*fus), np.broadcast_arrays(*fvs)
    umin, umax = np.min(fus, axis=0), np.max(fus, axis=0)
    vmin, vmax = np.min(fvs, axis=0), np.max(fvs, axis=0)
    u0 = (np.floor(umin).astype(np.int64) - WIDEN) & ~3
    u1 = np.floor(umax).astype(np.int64) + 1 + WIDEN
    v0 = np.floor(vmin).astype(np.int64) - WIDEN
    v1 = np.floor(vmax).astype(np.int64) + 1 + WIDEN
    nch = (u1 - u0) // 4 + 1
    rows = v1 - v0 + 1
    ok = good & (4 * nch <= STRIDE) & (rows <= ROWS)
    return u0, nch, v0, rows, ok


def bp_emulate(proj: np.ndarray, geo: ConeGeometry, angles, weight: str,
               z_start: int, planes: int):
    """bp_voxel_kernel's arithmetic; returns the slab and the share of
    (column, angle) pairs whose taps lie in their tile's staged window."""
    g = VGeom(geo, z_start)
    code = WEIGHTS[weight]
    consts = angle_constants(geo, torch.as_tensor(angles)).numpy()
    pad = lambda n, t: -(-n // t) * t                       # noqa: E731
    nzp, nyp, nxp = pad(planes, TZ), pad(g.ny, TY), pad(g.nx, TX)
    ix, iy = np.arange(nxp), np.arange(nyp)
    kk = np.arange(nzp)
    kz0 = (kk // TZ) * TZ
    X, Y = column_x(g, ix)[None, None, :], column_y(g, iy)[None, :, None]
    gz0 = plane_g(g, kz0)[:, None, None]
    gz = (gz0 + (kk % TZ).astype(F)[:, None, None]).astype(F)
    # padded projections: a tap off the detector reads zero
    P = np.zeros((len(consts), g.nv + 4, g.nu + 4), F)
    P[:, 2:-2, 2:-2] = proj
    acc = np.zeros((nzp, nyp, nxp), F)
    fast = 0
    for a, c in enumerate(consts):
        sth, cth = -c[5], c[6]
        fu, fv0, dfv, w2d, front = column_terms(g, X, Y, cth, sth, code)
        fu_c = np.clip(fu, -COORD_MAX, COORD_MAX)
        fi0, i0 = floor_magic(fu_c)
        wu = fu_c - fi0
        fv = np.clip(fma(gz, dfv, fv0), -COORD_MAX, COORD_MAX)
        fj, j0 = floor_magic(fv)
        wv = fv - fj
        # the window of each voxel's tile, and whether its column's taps
        # over the tile's planes lie in it (the kernel's fast path)
        u0, nch, v0, rows, ok = windows(
            g, cth, sth, (ix // TX * TX)[None, None, :],
            (iy // TY * TY)[None, :, None], kz0[:, None, None])
        _, jf = floor_magic(np.clip(fma(gz0, dfv, fv0), -COORD_MAX,
                                    COORD_MAX))
        _, jl = floor_magic(np.clip(fma(gz0 + F(TZ - 1), dfv, fv0),
                                    -COORD_MAX, COORD_MAX))
        inside = (ok & front & (i0 >= u0) & (i0 + 1 < u0 + 4 * nch)
                  & (np.minimum(jf, jl) >= v0)
                  & (np.maximum(jf, jl) + 1 < v0 + rows))
        fast += int(inside[::TZ].sum())
        jj = np.clip(j0, -2, g.nv) + 2
        ii = np.clip(i0, -2, g.nu) + 2
        p00, p01 = P[a][jj, ii], P[a][jj, ii + 1]
        p10, p11 = P[a][jj + 1, ii], P[a][jj + 1, ii + 1]
        r0 = fma(wu, p01 - p00, p00)
        r1 = fma(wu, p11 - p10, p10)
        acc = fma(fma(wv, r1 - r0, r0), w2d, acc)
    share = fast / (len(consts) * (nzp // TZ) * nyp * nxp)
    return acc[:planes, :g.ny, :g.nx], share


BP_GEOS = {
    "n16": (ConeGeometry.nice(16), 0, None),
    "n13-slab": (ConeGeometry.nice(13), 4, 6),
    "prime-offsets-slab": (ConeGeometry(
        n_voxel=(37, 23, 29), s_voxel=(370.0, 230.0, 290.0),
        n_detector=(19, 31), s_detector=(300.0, 420.0),
        off_origin=(6.0, -9.0, 7.0), off_detector=(11.0, -13.0)), 3, 33),
}


@pytest.mark.parametrize("weight", ["fdk", "pmatched", "none"])
@pytest.mark.parametrize("name", list(BP_GEOS))
def test_bp_emulation_within_band(name, weight):
    """The one-reciprocal arithmetic and the lerp blend stay within the
    projector band of bp_voxel_plain (every angle, any dominance), and a
    slab is the whole volume's planes bit for bit.  At these
    small volumes a tile of 32 x 8 x 32 voxels is larger than the volume,
    and its virtual voxels widen its windows past a buffer for some angles:
    such columns take the global-read path, with the same arithmetic."""
    geo, z_start, planes = BP_GEOS[name]
    planes = geo.n_voxel[0] if planes is None else planes
    a = circular_angles(23)
    y = np.random.default_rng(11).standard_normal(
        (len(a),) + geo.n_detector).astype(F)
    got, share = bp_emulate(y, geo, a, weight, z_start, planes)
    want = bp_voxel_plain(torch.from_numpy(y), geo, a, weight, z_start,
                          planes)
    torch.testing.assert_close(torch.from_numpy(got), want, rtol=2e-4,
                               atol=5e-3)
    assert share > 0.5
    if planes < geo.n_voxel[0]:
        # a plane's taps do not depend on where the slab starts
        whole, _ = bp_emulate(y, geo, a, weight, 0, geo.n_voxel[0])
        assert np.array_equal(got, whole[z_start:z_start + planes])


def test_bp_emulation_within_band_at_n64_with_os_sart_chunk():
    """N = 64 with a 64-angle chunk (an OS-SART subset's size), the
    pmatched weight, phantom-like smooth projections and random ones."""
    geo = ConeGeometry.nice(64)
    a = circular_angles(512)[::8]
    rng = np.random.default_rng(2)
    v, u = np.meshgrid(np.linspace(-1, 1, 64), np.linspace(-1, 1, 64),
                       indexing="ij")
    smooth = (100.0 * np.exp(-(u * u + v * v) * 3.0)).astype(F)
    for y in (np.broadcast_to(smooth, (len(a), 64, 64)).copy(),
              rng.standard_normal((len(a), 64, 64)).astype(F)):
        got, share = bp_emulate(y, geo, a, "pmatched", 0, 64)
        want = bp_voxel_plain(torch.from_numpy(y), geo, a, "pmatched")
        torch.testing.assert_close(torch.from_numpy(got), want, rtol=2e-4,
                                   atol=5e-3)
        assert share == 1.0


@pytest.mark.parametrize("offset", [0, 1])
def test_bp_main_shape_windows_fit(offset):
    """N = 512, every other angle of 512 (alternate ones per case), every
    tile: the window of each (tile, angle) fits a buffer of the kernel."""
    geo = ConeGeometry.nice(512)
    g = VGeom(geo, 0)
    consts = angle_constants(geo, torch.as_tensor(
        circular_angles(512)[offset::2])).numpy()
    ix0 = np.arange(0, 512, TX)[None, None, :]
    iy0 = np.arange(0, 512, TY)[None, :, None]
    kz0 = np.arange(0, 512, TZ)[:, None, None]
    most_w = most_r = 0
    for c in consts:
        u0, nch, v0, rows, ok = windows(g, c[6], -c[5], ix0, iy0, kz0)
        assert ok.all()
        most_w = max(most_w, int((4 * nch).max()))
        most_r = max(most_r, int(rows.max()))
    assert most_w <= STRIDE and most_r <= ROWS, (most_w, most_r)


def test_bp_main_shape_columns_in_window():
    """N = 512 at 8 angles spread over the circle, every column and tile of
    planes: each column's taps lie in its tile's window, so the kernel
    never reads global memory at the main shape."""
    geo = ConeGeometry.nice(512)
    a = circular_angles(512)[::64] + 0.1
    y = np.zeros((len(a), 1, 1), F)         # unused: only the share counts
    g = VGeom(geo, 0)
    consts = angle_constants(geo, torch.as_tensor(a)).numpy()
    ix = np.arange(512)[None, None, :]
    iy = np.arange(512)[None, :, None]
    kz0 = np.arange(0, 512, TZ)[:, None, None]
    X, Y, gz0 = column_x(g, ix), column_y(g, iy), plane_g(g, kz0)
    del y
    for c in consts:
        sth, cth = -c[5], c[6]
        fu, fv0, dfv, _, front = column_terms(g, X, Y, cth, sth, 1)
        _, i0 = floor_magic(fu)
        _, jf = floor_magic(fma(gz0, dfv, fv0))
        _, jl = floor_magic(fma(gz0 + F(TZ - 1), dfv, fv0))
        u0, nch, v0, rows, ok = windows(g, cth, sth, ix // TX * TX,
                                        iy // TY * TY, kz0)
        inside = (ok & front & (i0 >= u0) & (i0 + 1 < u0 + 4 * nch)
                  & (jf >= v0) & (jl + 1 < v0 + rows))
        assert inside.all()


def test_overflow_geometry_leaves_the_windows():
    """The card tests' overflow geometry: bp_voxel's windows are taller
    than a buffer for some tiles and angles, not for all, so one launch
    takes both the staged and the global-read path, and the emulation
    stays in band."""
    geo = OVERFLOW_GEO
    a = circular_angles(16)
    y = np.random.default_rng(4).standard_normal(
        (len(a),) + geo.n_detector).astype(F)
    got, share = bp_emulate(y, geo, a, "fdk", 0, geo.n_voxel[0])
    assert 0.0 < share < 1.0, share
    want = bp_voxel_plain(torch.from_numpy(y), geo, a, "fdk")
    torch.testing.assert_close(torch.from_numpy(got), want, rtol=2e-4,
                               atol=5e-3)


@pytest.mark.parametrize("dz", [0.5, 256.0 / 13, 0.1, 3.0])
def test_reciprocal_division_is_the_rounded_quotient(dz):
    """joseph_div(), fp_ray's division by dy and dz: q0 = a * r, q = q0 +
    r * (a - b * q0) with r = 1 / b rounded, by fused multiply-adds, is
    a / b correctly rounded (what __fdiv_rn returns) over normal numerators
    of world coordinates' magnitudes (the residual is exact; the last step
    is rounded from long double, 64 bits)."""
    rng = np.random.default_rng(1)
    zw = np.concatenate([rng.uniform(-300, 300, 100000),
                         rng.uniform(-1e-3, 1e-3, 20000),
                         np.exp(rng.uniform(-60, 60, 20000))]).astype(F)
    zw = zw[zw != 0]
    b = F(dz)
    r = F(1.0 / float(b))                    # correctly rounded reciprocal
    L = np.longdouble
    q0 = (zw * r).astype(F)
    res = (zw.astype(L) - b.astype(L) * q0.astype(L)).astype(F)
    assert np.array_equal(res.astype(L), zw.astype(L) - b.astype(L) * q0)
    q = (q0.astype(L) + r.astype(L) * res.astype(L)).astype(F)
    assert np.array_equal(q, (zw.astype(np.float64) / float(b)).astype(F))


def test_floor_magic_is_floor():
    """The kernel's floor (add 1.5 * 2^23 rounding down, subtract) equals
    floorf and its int for |x| < 2^22, integers and their neighbours too."""
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.uniform(-4e6, 4e6, 20000), rng.uniform(-600, 600, 20000),
        np.arange(-1000, 1000, dtype=np.float64)]).astype(F)
    x = np.concatenate([x, np.nextafter(x, F(np.inf)),
                        np.nextafter(x, F(-np.inf)), [F(-0.0), F(0.0)]])
    f, i = floor_magic(x)
    assert np.array_equal(f, np.floor(x))
    assert np.array_equal(i, np.floor(x).astype(np.int64))
