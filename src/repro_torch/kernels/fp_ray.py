"""Joseph forward projector A for x-dominant angles: kernel and plain version.

Port of ``repro/kernels/fp_ray.py``.  Three callables share one contract,
``f(vol, geo, angles, z0=0) -> proj``:

* :func:`fp_ray_cuda` launches the hand-written CUDA kernel
  (``csrc/fp_ray.cu``, replacing the Pallas ``_fp_kernel``) on a CUDA
  tensor, and raises for anything else;
* :func:`fp_ray_plain` is the same function in plain PyTorch, one gather
  pass per marching plane as ``_fp_kernel`` does it: the oracle of the
  kernel, and what runs on the CPU;
* :func:`fp_ray` picks between them by the tensor's device alone.

The kernel is compiled in several tile configurations (rows a thread owns,
warps a block: ``build.configs("fp_ray")``); ``config`` picks one by its
index, 0 the default.  Every configuration gives the same bits, and the
plain version has no tiles, so it takes no config.

``vol`` holds the z planes ``[z0, z0 + vol.shape[0])`` of ``geo``'s volume;
the result is that slab's partial projection, and partial projections of
disjoint slabs sum to the whole.  The kernel handles x-dominant angles
only: callers rotate the scene by -90 deg for the others
(:mod:`repro_torch.core.backend`).

``fp_ray_cuda.launches`` counts kernel launches and ``fp_ray_plain.calls``
calls of the plain version (see :func:`repro_torch.kernels.reset_counters`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.geometry import ConeGeometry
from . import build


def angle_constants(geo: ConeGeometry, angles) -> torch.Tensor:
    """(A, 8) per-angle table: src(3), det_c(2), e_u(2), pad.

    Built with torch ops on the device ``angles`` lives on, so a device
    tensor of angles costs no host round trip."""
    a = torch.as_tensor(angles, dtype=torch.float32)
    c, s = torch.cos(a), torch.sin(a)
    z = torch.zeros_like(a)
    return torch.stack([
        geo.DSO * c,                    # Sx
        geo.DSO * s,                    # Sy
        z,                              # Sz
        -(geo.DSD - geo.DSO) * c,       # det_c x
        -(geo.DSD - geo.DSO) * s,       # det_c y
        -s,                             # e_u x
        c,                              # e_u y
        z,
    ], dim=-1).contiguous()


@functools.lru_cache(maxsize=64)
def plane_centers(geo: ConeGeometry, device: torch.device) -> torch.Tensor:
    """World x of the Nx marching planes, computed in float64 and rounded
    to float32 exactly as the reference's ``xc`` table."""
    nx = geo.n_voxel[2]
    xc = np.asarray((np.arange(nx) - (nx - 1) / 2.0) * geo.d_voxel[2]
                    + geo.off_origin[2], np.float32)
    return torch.from_numpy(xc).to(device)


# --------------------------------------------------------------------------
# plain version (the oracle)
# --------------------------------------------------------------------------

def _rays(geo: ConeGeometry, consts: torch.Tensor):
    """Per-ray terms of ``_fp_kernel`` (fp_ray.py:86-96), batched over
    angles: d_x, d_y, inv_dx as (A, 1, Nu), d_z as (1, Nv, 1), seg as
    (A, Nv, Nu)."""
    nv, nu = geo.n_detector
    dv, du = geo.d_detector
    offv, offu = geo.off_detector
    dev = consts.device
    sx, sy, sz, dcx, dcy, eux, euy = (consts[:, i].view(-1, 1, 1)
                                      for i in range(7))
    u = (torch.arange(nu, dtype=torch.float32, device=dev)
         - (nu - 1) / 2.0) * du + offu
    v = (torch.arange(nv, dtype=torch.float32, device=dev)
         - (nv - 1) / 2.0) * dv + offv
    u = u.view(1, 1, nu)
    d_x = dcx + u * eux - sx                       # (A, 1, Nu)
    d_y = dcy + u * euy - sy                       # (A, 1, Nu)
    d_z = v.view(1, nv, 1) - sz                    # (A, Nv, 1)
    norm = torch.sqrt(d_x ** 2 + d_y ** 2 + d_z ** 2)
    seg = norm / torch.clamp(d_x.abs(), min=1e-9) * geo.d_voxel[2]
    inv_dx = 1.0 / torch.where(d_x.abs() < 1e-9,
                               torch.full_like(d_x, 1e-9), d_x)
    return (sx, sy, sz), d_y, d_z, inv_dx, seg


def _plane_sample(plane: torch.Tensor, geo: ConeGeometry, src, d_y, d_z,
                  inv_dx, x, z0) -> torch.Tensor:
    """One marching plane of ``_fp_kernel`` (fp_ray.py:100-135) for every
    angle: ``plane`` is (nz_slab, Ny), the result the masked bilinear
    samples (A, Nv, Nu), before the ``seg`` factor."""
    nz, ny, _ = geo.n_voxel
    dz, dy, _ = geo.d_voxel
    offz, offy, _ = geo.off_origin
    nz_slab = plane.shape[0]
    sx, sy, sz = src
    s_par = (x - sx) * inv_dx                      # (A, 1, Nu)
    yw = sy + s_par * d_y
    fj = (yw - offy) / dy + (ny - 1) / 2.0         # (A, 1, Nu)
    fk = ((sz + s_par * d_z - offz) / dz
          + (nz - 1) / 2.0) - z0                   # (A, Nv, Nu), slab-local

    # y interpolation: gather two columns per u, blend
    j0 = torch.floor(fj)
    wj = fj - j0
    j0i = j0.long()
    j0c = j0i.clamp(0, ny - 1)[:, 0]               # (A, Nu)
    j1c = (j0i + 1).clamp(0, ny - 1)[:, 0]
    wy0 = torch.where((j0i >= 0) & (j0i < ny), 1.0 - wj, 0.0)[:, 0]
    wy1 = torch.where((j0i + 1 >= 0) & (j0i + 1 < ny), wj, 0.0)[:, 0]
    col0 = plane[:, j0c].permute(1, 0, 2)          # (A, nz_slab, Nu)
    col1 = plane[:, j1c].permute(1, 0, 2)
    colz = col0 * wy0[:, None, :] + col1 * wy1[:, None, :]

    # z interpolation: 2-tap gather along the slab's z
    k0 = torch.floor(fk)
    wk = fk - k0
    k0i = k0.long()
    k0c = k0i.clamp(0, nz_slab - 1)
    k1c = (k0i + 1).clamp(0, nz_slab - 1)
    t0 = torch.gather(colz, 1, k0c)                # (A, Nv, Nu)
    t1 = torch.gather(colz, 1, k1c)
    val = (t0 * torch.where((k0i >= 0) & (k0i < nz_slab), 1.0 - wk, 0.0)
           + t1 * torch.where((k0i + 1 >= 0) & (k0i + 1 < nz_slab), wk, 0.0))
    w = ((s_par > 0.0) & (s_par <= 1.0)).to(val.dtype)
    return val * w


def fp_ray_plain(vol: torch.Tensor, geo: ConeGeometry, angles,
                 z0: int = 0) -> torch.Tensor:
    """Plain-PyTorch forward projection of the x-dominant ``angles`` (the
    kernel's oracle): ``vol`` is the slab of z planes ``[z0, z0 +
    vol.shape[0])``, the result its partial projection (A, Nv, Nu)."""
    fp_ray_plain.calls += 1
    return _fp_plain(vol, geo, angles, z0)


fp_ray_plain.calls = 0


def _fp_plain(vol, geo, angles, z0):
    _check_vol(vol, geo)
    nv, nu = geo.n_detector
    consts = angle_constants(geo, angles).to(vol.device)
    src, d_y, d_z, inv_dx, seg = _rays(geo, consts)
    xc = plane_centers(geo, vol.device)
    acc = torch.zeros((consts.shape[0], nv, nu), dtype=torch.float32,
                      device=vol.device)
    for p in range(geo.n_voxel[2]):
        acc = acc + _plane_sample(vol[:, :, p], geo, src, d_y, d_z, inv_dx,
                                  xc[p], z0)
    return acc * seg


# --------------------------------------------------------------------------
# the CUDA kernel's wrapper
# --------------------------------------------------------------------------

def launch(name: str, lead: tuple, consts: torch.Tensor, geo: ConeGeometry,
           nz_slab: int, z0) -> None:
    """Launch Joseph kernel ``name`` on PyTorch's current stream: its C
    entry takes ``lead`` (the addresses of its tensors, then any counts of
    its own), then ``consts``'s angle count and the geometry
    (:func:`build.launch`: the caller's current device is kept, and a
    nonzero ``cudaGetLastError()`` raises)."""
    nz, ny, nx = geo.n_voxel
    nv, nu = geo.n_detector
    dz, dy, dx = geo.d_voxel
    dv, du = geo.d_detector
    offz, offy, _ = geo.off_origin
    offv, offu = geo.off_detector
    dev = consts.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.launch(
        name, dev, *lead, consts.shape[0], nz, ny, nx, nz_slab, nv, nu,
        dz, dy, dx, dv, du, offz, offy, offv, offu, float(z0),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        stream)


def _check_vol(vol: torch.Tensor, geo: ConeGeometry) -> None:
    if vol.dtype != torch.float32:
        raise TypeError(f"volume must be float32, got {vol.dtype}")
    if vol.dim() != 3 or tuple(vol.shape[1:]) != tuple(geo.n_voxel[1:]):
        raise ValueError(f"volume slab must be (planes, {geo.n_voxel[1]}, "
                         f"{geo.n_voxel[2]}), got {tuple(vol.shape)}")


def _check_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what} must be a CUDA tensor, got {t.device}")


def fp_ray_cuda(vol: torch.Tensor, geo: ConeGeometry, angles,
                z0: int = 0, config: int = 0) -> torch.Tensor:
    """Launch the CUDA forward projector, in tile configuration
    ``config``, on a CUDA ``vol``; see :func:`fp_ray_plain` for the
    contract."""
    _check_cuda(vol, "volume")
    _check_vol(vol, geo)
    nv, nu = geo.n_detector
    consts = angle_constants(geo, torch.as_tensor(angles).to(vol.device))
    out = torch.empty((consts.shape[0], nv, nu), dtype=torch.float32,
                      device=vol.device)
    if consts.shape[0] == 0:
        return out
    # marching-plane layout (Nx, nz_slab, Ny), as fp_ray.py:176
    vol_t = vol.permute(2, 0, 1).contiguous()
    xc = plane_centers(geo, vol.device)
    launch("fp_ray", (vol_t.data_ptr(), consts.data_ptr(), xc.data_ptr(),
                      out.data_ptr(), int(config)),
           consts, geo, vol.shape[0], z0)
    fp_ray_cuda.launches += 1
    return out


fp_ray_cuda.launches = 0


def fp_ray(vol: torch.Tensor, geo: ConeGeometry, angles, z0: int = 0,
           config: int = 0) -> torch.Tensor:
    """Forward projection on ``vol``'s device: the CUDA kernel in tile
    configuration ``config`` for a CUDA tensor, the plain version (no
    tiles) for a CPU tensor, and an error otherwise."""
    if vol.device.type == "cpu":
        return fp_ray_plain(vol, geo, angles, z0)
    return fp_ray_cuda(vol, geo, angles, z0, config)
