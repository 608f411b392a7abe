"""Synthetic phantoms with analytic forward projections.

The sphere phantom has a closed-form cone-beam line integral (chord length
through a ball), giving a ground-truth oracle for the projectors that is
independent of any discretisation.  The Shepp-Logan-like ellipsoid phantom is
used for reconstruction-quality benchmarks (paper SS3.2 stand-in, since the
measured coffee-bean/ichthyosaur data is not redistributable).

The port's own copy of ``repro.core.phantoms`` (numpy only); the phantoms
are held equal to the reference's, bit for bit, by
``tests/test_torch_core.py``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from .geometry import ConeGeometry


# Each ellipsoid: (value, (cx, cy, cz), (ax, ay, az), phi_deg) -- rotation
# about the z axis only (enough structure, keeps the analytic FP simple).
Ellipsoid = Tuple[float, Tuple[float, float, float], Tuple[float, float, float], float]

# A compact Shepp-Logan-like set, coordinates in units of half-volume-extent.
SHEPP_LIKE: Sequence[Ellipsoid] = (
    (1.00, (0.0, 0.0, 0.0), (0.69, 0.92, 0.81), 0.0),
    (-0.80, (0.0, -0.0184, 0.0), (0.6624, 0.874, 0.78), 0.0),
    (-0.20, (0.22, 0.0, 0.0), (0.11, 0.31, 0.22), -18.0),
    (-0.20, (-0.22, 0.0, 0.0), (0.16, 0.41, 0.28), 18.0),
    (0.10, (0.0, 0.35, -0.15), (0.21, 0.25, 0.41), 0.0),
    (0.10, (0.0, 0.1, 0.25), (0.046, 0.046, 0.05), 0.0),
    (0.10, (-0.08, -0.605, 0.0), (0.046, 0.023, 0.02), 0.0),
    (0.10, (0.06, -0.605, -0.1), (0.023, 0.046, 0.02), 90.0),
)


def _world_grids(geo: ConeGeometry):
    z = geo.voxel_centers_1d(0)
    y = geo.voxel_centers_1d(1)
    x = geo.voxel_centers_1d(2)
    return np.meshgrid(z, y, x, indexing="ij")


def sphere(geo: ConeGeometry, center=(0.0, 0.0, 0.0), radius: float | None = None,
           value: float = 1.0) -> np.ndarray:
    """A uniform ball; ``center`` in world (x, y, z), radius in world units."""
    if radius is None:
        radius = 0.35 * min(geo.s_voxel)
    zz, yy, xx = _world_grids(geo)
    cx, cy, cz = center
    r2 = (xx - cx) ** 2 + (yy - cy) ** 2 + (zz - cz) ** 2
    return (value * (r2 <= radius * radius)).astype(np.float32)


def sphere_projection_analytic(geo: ConeGeometry, angles: np.ndarray,
                               center=(0.0, 0.0, 0.0), radius: float | None = None,
                               value: float = 1.0) -> np.ndarray:
    """Exact cone-beam line integrals of the ball: chord length * value.

    For a ray  p(t) = S + t d  (d unit) and ball (c, R):
        chord = 2 sqrt(R^2 - b^2),  b = || (S - c) - ((S - c).d) d ||.
    """
    if radius is None:
        radius = 0.35 * min(geo.s_voxel)
    angles = np.asarray(angles, dtype=np.float64)
    n_angles = angles.shape[0]
    nv, nu = geo.n_detector
    u = geo.detector_coords_1d(1)  # (Nu,)
    v = geo.detector_coords_1d(0)  # (Nv,)
    cx, cy, cz = center
    out = np.zeros((n_angles, nv, nu), dtype=np.float64)
    for a, th in enumerate(angles):
        cth, sth = np.cos(th), np.sin(th)
        S = np.array([geo.DSO * cth, geo.DSO * sth, 0.0])
        det_c = np.array([-(geo.DSD - geo.DSO) * cth, -(geo.DSD - geo.DSO) * sth, 0.0])
        e_u = np.array([-sth, cth, 0.0])
        e_v = np.array([0.0, 0.0, 1.0])
        P = (det_c[None, None, :]
             + u[None, :, None] * e_u[None, None, :]
             + v[:, None, None] * e_v[None, None, :])
        D = P - S[None, None, :]
        D = D / np.linalg.norm(D, axis=-1, keepdims=True)
        SC = S - np.array([cx, cy, cz])
        proj_len = D @ SC  # (Nv, Nu)
        b2 = (SC @ SC) - proj_len ** 2
        chord2 = radius * radius - b2
        out[a] = 2.0 * value * np.sqrt(np.maximum(chord2, 0.0))
    return out.astype(np.float32)


def shepp_logan(geo: ConeGeometry, ellipsoids: Sequence[Ellipsoid] = SHEPP_LIKE) -> np.ndarray:
    """Rasterise the ellipsoid set onto the voxel grid (additive values).

    The reference's arithmetic on broadcast axes instead of full meshgrids:
    the in-plane terms are formed once on a (Ny, Nx) grid and the z term
    added per plane, the same operations in the same order on the same
    values (so the same bits), with one volume-sized temporary instead of
    a dozen (over a minute of host time at 512^3 otherwise)."""
    z = geo.voxel_centers_1d(0)[:, None, None]
    y = geo.voxel_centers_1d(1)[None, :, None]
    x = geo.voxel_centers_1d(2)[None, None, :]
    half = np.array([geo.s_voxel[2], geo.s_voxel[1], geo.s_voxel[0]]) / 2.0
    vol = np.zeros(geo.n_voxel, dtype=np.float32)
    for value, (cx, cy, cz), (ax, ay, az), phi_deg in ellipsoids:
        phi = np.deg2rad(phi_deg)
        c, s = np.cos(phi), np.sin(phi)
        # normalised coords
        xn = x / half[0] - cx
        yn = y / half[1] - cy
        zn = z / half[2] - cz
        xr = c * xn + s * yn
        yr = -s * xn + c * yn
        inside = (xr / ax) ** 2 + (yr / ay) ** 2 + (zn / az) ** 2 <= 1.0
        vol += value * inside.astype(np.float32)
    return vol


def shepp_logan_projection_analytic(geo: ConeGeometry, angles: np.ndarray,
                                    ellipsoids: Sequence[Ellipsoid] = SHEPP_LIKE
                                    ) -> np.ndarray:
    """Exact line integrals of the ellipsoid set (sum of per-ellipsoid chords).

    Each ellipsoid is mapped to the unit ball by an affine transform; the
    chord length in world space is the parametric interval length where the
    transformed ray intersects the unit sphere.
    """
    angles = np.asarray(angles, dtype=np.float64)
    nv, nu = geo.n_detector
    u = geo.detector_coords_1d(1)
    v = geo.detector_coords_1d(0)
    half = np.array([geo.s_voxel[2], geo.s_voxel[1], geo.s_voxel[0]]) / 2.0
    out = np.zeros((angles.shape[0], nv, nu), dtype=np.float64)
    for a, th in enumerate(angles):
        cth, sth = np.cos(th), np.sin(th)
        S = np.array([geo.DSO * cth, geo.DSO * sth, 0.0])
        det_c = np.array([-(geo.DSD - geo.DSO) * cth, -(geo.DSD - geo.DSO) * sth, 0.0])
        e_u = np.array([-sth, cth, 0.0])
        e_v = np.array([0.0, 0.0, 1.0])
        P = (det_c[None, None, :]
             + u[None, :, None] * e_u[None, None, :]
             + v[:, None, None] * e_v[None, None, :])
        D = P - S[None, None, :]
        Dn = D / np.linalg.norm(D, axis=-1, keepdims=True)
        for value, (cx, cy, cz), (ax, ay, az), phi_deg in ellipsoids:
            phi = np.deg2rad(phi_deg)
            c, s = np.cos(phi), np.sin(phi)
            R = np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]])
            scale = 1.0 / (np.array([ax, ay, az]) * half)
            ctr = np.array([cx, cy, cz]) * half
            S_t = (R @ (S - ctr)) * scale
            D_t = np.einsum("ij,uvj->uvi", R, Dn) * scale[None, None, :]
            A = np.sum(D_t * D_t, axis=-1)
            B = 2.0 * np.sum(D_t * S_t[None, None, :], axis=-1)
            C = float(S_t @ S_t) - 1.0
            disc = B * B - 4.0 * A * C
            ok = disc > 0
            dt = np.where(ok, np.sqrt(np.maximum(disc, 0.0)) / A, 0.0)
            out[a] += value * dt  # world chord = |t1-t0| since Dn is unit
    return out.astype(np.float32)
