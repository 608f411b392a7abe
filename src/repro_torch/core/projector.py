"""Plain-PyTorch cone-beam projectors: the ``"ref"`` backend and the oracle.

Port of ``repro/core/projector.py`` (the Joseph part):

* ``forward_project_joseph`` -- Joseph's method with a per-angle dominant
  axis: sample planes coincide with voxel planes of the marching axis, so
  slab decomposition is exact (paper's splitting claim).  y-dominant angles
  rotate the scene by -90 deg and become x-dominant.
* ``forward_project`` -- an arbitrary mix of angles, split by dominance.
* ``backproject_voxel`` -- voxel-driven backprojection with the fdk /
  pmatched / none depth weights (paper SS2.2);
* ``backproject_matched`` -- the *exact* adjoint of ``forward_project``,
  taken with ``torch.func.vjp`` as the reference takes it with ``jax.vjp``;
* ``backproject`` -- the dispatch between the two.

The gather formulation is kept: the only scatter is the one autograd makes
for the adjoint.  Volumes are ``(Nz, Ny, Nx)`` float32, projections
``(n_angles, Nv, Nu)`` float32, angles a float32 tensor.  The interpolated
oracle projector ``forward_project_interp`` is not ported yet (ROADMAP
Queue A).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from .geometry import ConeGeometry, dominant_axis_mask

#: the weights of the voxel-driven backprojector
VOXEL_WEIGHTS = ("fdk", "pmatched", "none")


def bilinear_gather(img: torch.Tensor, fi: torch.Tensor,
                    fj: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of ``img[(Ni, Nj)]`` at float indices; 0 outside."""
    ni, nj = img.shape
    i0 = torch.floor(fi)
    j0 = torch.floor(fj)
    wi = fi - i0
    wj = fj - j0
    i0 = i0.long()
    j0 = j0.long()

    def tap(ii, jj, w):
        valid = (ii >= 0) & (ii < ni) & (jj >= 0) & (jj < nj)
        v = img[ii.clamp(0, ni - 1), jj.clamp(0, nj - 1)]
        return torch.where(valid, v * w, 0.0)

    return (tap(i0, j0, (1 - wi) * (1 - wj))
            + tap(i0, j0 + 1, (1 - wi) * wj)
            + tap(i0 + 1, j0, wi * (1 - wj))
            + tap(i0 + 1, j0 + 1, wi * wj))


def _pixel_world_positions(geo: ConeGeometry, theta: torch.Tensor):
    """Source positions (A, 3) and pixel positions (A, Nv, Nu, 3)."""
    nv, nu = geo.n_detector
    dv, du = geo.d_detector
    offv, offu = geo.off_detector
    dev = theta.device
    cth, sth = torch.cos(theta), torch.sin(theta)
    zero, one = torch.zeros_like(cth), torch.ones_like(cth)
    src = torch.stack([geo.DSO * cth, geo.DSO * sth, zero], -1)
    det_c = torch.stack([-(geo.DSD - geo.DSO) * cth,
                         -(geo.DSD - geo.DSO) * sth, zero], -1)
    e_u = torch.stack([-sth, cth, zero], -1)
    e_v = torch.stack([zero, zero, one], -1)
    uu = (torch.arange(nu, device=dev) - (nu - 1) / 2.0) * du + offu
    vv = (torch.arange(nv, device=dev) - (nv - 1) / 2.0) * dv + offv
    pix = (det_c[:, None, None, :]
           + uu[None, None, :, None] * e_u[:, None, None, :]
           + vv[None, :, None, None] * e_v[:, None, None, :])
    return src, pix


def _rotate_vol_90(vol: torch.Tensor) -> torch.Tensor:
    """Volume of the scene rotated by -90 deg about z.

    f'(x', y', z) = f(-y', x', z)  =>  vol' = flip(transpose(vol, (0,2,1)), 1)
    Requires Nx == Ny and dx == dy (checked by the caller).
    """
    return torch.flip(vol.transpose(1, 2), dims=(1,))


def _unrotate_vol_90(vol: torch.Tensor) -> torch.Tensor:
    """Inverse (and adjoint) of :func:`_rotate_vol_90`."""
    return torch.flip(vol, dims=(1,)).transpose(1, 2)


def check_rotation_trick(geo: ConeGeometry) -> None:
    """Preconditions of the -90 deg rotation (projector.py:238-244)."""
    nz, ny, nx = geo.n_voxel
    if nx != ny or abs(geo.d_voxel[1] - geo.d_voxel[2]) > 1e-12:
        raise ValueError("y-dominant transpose trick needs square xy grid")
    if any(abs(o) > 0 for o in geo.off_origin[1:]):
        raise ValueError("xy origin offsets unsupported with rotation trick")


def _joseph_xdom(vol: torch.Tensor, geo: ConeGeometry, theta: torch.Tensor,
                 x_centers: torch.Tensor, z0: int = 0) -> torch.Tensor:
    """Joseph x-dominant line integrals at the angles ``theta`` (A,).

    Marches the x planes whose world coords are ``x_centers``, bilinearly
    interpolating each (z, y) slice.  ``vol`` may be a slab of z planes
    ``[z0, z0 + vol.shape[0])``: interpolation taps outside it evaluate to
    zero, so slab results over a disjoint partition sum to the whole.
    """
    dz, dy, dx = geo.d_voxel
    offz, offy, offx = geo.off_origin
    nz_full = geo.n_voxel[0]
    ny = vol.shape[1]
    n_planes = vol.shape[2]

    src, pix = _pixel_world_positions(geo, theta)
    d = pix - src[:, None, None, :]                      # (A, Nv, Nu, 3)
    norm = torch.linalg.norm(d, dim=-1)
    # arc length per unit x: |d| / |d_x|
    seg = norm / torch.clamp(d[..., 0].abs(), min=1e-9) * dx
    inv_dx_ray = 1.0 / torch.where(d[..., 0].abs() < 1e-9,
                                   torch.full_like(norm, 1e-9), d[..., 0])
    sx, sy, sz = (src[:, i, None, None] for i in range(3))
    acc = torch.zeros(norm.shape, dtype=torch.float32, device=vol.device)
    for p in range(n_planes):
        s = (x_centers[p] - sx) * inv_dx_ray             # (A, Nv, Nu)
        y = sy + s * d[..., 1]
        z = sz + s * d[..., 2]
        fj = (y - offy) / dy + (ny - 1) / 2.0
        fk = (z - offz) / dz + (nz_full - 1) / 2.0 - z0
        # forward ray only (sample between source and detector)
        w = ((s > 0.0) & (s <= 1.0)).to(vol.dtype)
        acc = acc + bilinear_gather(vol[:, :, p], fk, fj) * w
    return acc * seg


def forward_project_joseph(vol: torch.Tensor, geo: ConeGeometry,
                           angles: torch.Tensor, xdom: bool = True,
                           z0: int = 0,
                           x_planes: Optional[Tuple[int, int]] = None
                           ) -> torch.Tensor:
    """Joseph projector for angles that are all x-dominant (``xdom=True``)
    or all y-dominant (``xdom=False``; handled by rotating the scene -90
    deg, which maps the angle to ``theta - pi/2`` and transposes the
    volume).

    ``z0`` / ``x_planes`` select a volumetric slab: ``vol`` then holds only
    z planes ``[z0, z0+vol.shape[0])`` and/or marching planes
    ``[x_planes[0], x_planes[1])``; the result is that slab's *partial*
    projection (sum over slabs == monolithic).
    """
    nz, ny, nx = geo.n_voxel
    angles = torch.as_tensor(angles, dtype=torch.float32).to(vol.device)
    if not xdom:
        check_rotation_trick(geo)
        vol = _rotate_vol_90(vol)
        angles = angles - math.pi / 2.0
    p0, p1 = (0, nx) if x_planes is None else x_planes
    x_centers = torch.as_tensor(
        (np.arange(p0, p1) - (nx - 1) / 2.0) * geo.d_voxel[2]
        + geo.off_origin[2], dtype=torch.float32).to(vol.device)
    return _joseph_xdom(vol, geo, angles, x_centers, z0=z0)


def forward_project(vol: torch.Tensor, geo: ConeGeometry, angles,
                    xdom_mask: Optional[np.ndarray] = None) -> torch.Tensor:
    """Full Joseph forward projection for an arbitrary mix of angles.

    The dominant axis is a static property of each angle (numpy decision):
    the angle set splits into its x- and y-dominant subsets, each projected
    with the specialised path, and the results scatter back (TIGRE's
    independent per-GPU angle sets, paper SS2.1).
    """
    angles_t = torch.as_tensor(angles, dtype=torch.float32).to(vol.device)
    if xdom_mask is None:
        xdom_mask = dominant_axis_mask(angles_t.cpu().numpy())
    xdom_mask = np.asarray(xdom_mask, bool)
    nv, nu = geo.n_detector
    out = torch.zeros((len(xdom_mask), nv, nu), dtype=torch.float32,
                      device=vol.device)
    for xdom, idx in ((True, np.nonzero(xdom_mask)[0]),
                      (False, np.nonzero(~xdom_mask)[0])):
        if idx.size:
            ii = torch.as_tensor(idx, device=vol.device)
            out = out.index_copy(0, ii, forward_project_joseph(
                vol, geo, angles_t[ii], xdom=xdom))
    return out


def backproject_matched(proj: torch.Tensor, geo: ConeGeometry,
                        angles) -> torch.Tensor:
    """Exact adjoint of ``forward_project`` via ``torch.func.vjp``:
    <Ax, y> == <x, A^T y> to float precision (CGLS/FISTA rely on it)."""
    mask = dominant_axis_mask(
        torch.as_tensor(angles, dtype=torch.float32).cpu().numpy())
    zeros = torch.zeros(geo.n_voxel, dtype=torch.float32, device=proj.device)
    _, vjp = torch.func.vjp(
        lambda v: forward_project(v, geo, angles, mask), zeros)
    return vjp(proj)[0]


def backproject_voxel(proj: torch.Tensor, geo: ConeGeometry, angles,
                      weight: str = "fdk", z_start=0,
                      z_planes: Optional[int] = None) -> torch.Tensor:
    """Voxel-driven backprojection (paper SS2.2).

    ``weight``:
      * ``"fdk"``      -- (DSO / (DSO - p))^2 depth weights (FDK);
      * ``"pmatched"`` -- TIGRE's "pseudo-matched" weighting
        (DSD / (DSO - p))^2 * DSO / DSD;
      * ``"none"``     -- plain smearing.

    ``z_start`` + ``z_planes`` select an axial slab; the angle axis is
    additive, so backprojecting angle chunks and summing reproduces the
    whole.  Returns the un-normalised accumulation over angles, the
    detector position of each voxel taken as ``fv = (Z * mag - offv) / dv
    + (nv - 1) / 2`` as in the reference projector."""
    if weight not in VOXEL_WEIGHTS:
        raise ValueError(f"unknown weight {weight!r}")
    nz, ny, nx = geo.n_voxel
    dz, dy, dx = geo.d_voxel
    dv, du = geo.d_detector
    offz, offy, offx = geo.off_origin
    offv, offu = geo.off_detector
    nv, nu = geo.n_detector
    planes = nz if z_planes is None else int(z_planes)
    dev = proj.device
    angles = torch.as_tensor(angles, dtype=torch.float32).to(dev)

    f32 = dict(dtype=torch.float32, device=dev)
    xs = (torch.arange(nx, **f32) - (nx - 1) / 2.0) * dx + offx
    ys = (torch.arange(ny, **f32) - (ny - 1) / 2.0) * dy + offy
    zs = (torch.arange(planes, **f32) + z_start - (nz - 1) / 2.0) * dz + offz
    X = xs[None, None, :]
    Y = ys[None, :, None]
    Z = zs[:, None, None]
    out = torch.zeros((planes, ny, nx), dtype=torch.float32, device=dev)
    for theta, p2d in zip(angles, proj):
        cth, sth = torch.cos(theta), torch.sin(theta)
        p = X * cth + Y * sth                  # depth along the source axis
        q = -X * sth + Y * cth
        depth = geo.DSO - p
        mag = geo.DSD / depth
        fu = (q * mag - offu) / du + (nu - 1) / 2.0
        fv = (Z * mag - offv) / dv + (nv - 1) / 2.0
        # broadcast (planes,1,1) x (1,Ny,Nx) index fields to the slab
        val = bilinear_gather(p2d, fv + 0.0 * fu, fu + 0.0 * fv)
        if weight == "fdk":
            w = (geo.DSO / depth) ** 2
        elif weight == "pmatched":
            w = (geo.DSD / depth) ** 2 * (geo.DSO / geo.DSD)
        else:
            w = torch.ones_like(depth)
        out = out + val * w
    return out


def backproject(proj: torch.Tensor, geo: ConeGeometry, angles,
                weight: str = "fdk") -> torch.Tensor:
    """Dispatch: ``weight='matched'`` takes the exact adjoint, any other
    weight the voxel-driven backprojector."""
    if weight == "matched":
        return backproject_matched(proj, geo, angles)
    return backproject_voxel(proj, geo, angles, weight=weight)
