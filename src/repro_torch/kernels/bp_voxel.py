"""Voxel-driven backprojector: kernel and plain version.

Port of ``repro/kernels/bp_voxel.py``.  Three callables share one contract,
``f(proj, geo, angles, weight="fdk", z_start=0, z_planes=None) -> slab``:
the slab ``(z_planes, Ny, Nx)`` holds planes ``[z_start, z_start +
z_planes)`` of ``geo``'s volume (default: the whole volume), each voxel the
sum over ``angles`` of a 4-tap bilinear sample of the projections at its
detector position, times the depth weight ``weight``:

* ``"fdk"``      -- (DSO / depth)^2;
* ``"pmatched"`` -- (DSD / depth)^2 * DSO / DSD, TIGRE's pseudo-matched
  weighting;
* ``"none"``     -- 1.

The sum is un-normalised (the algorithms apply their constants), and it is
additive over the angles, so backprojecting angle chunks and adding the
slabs gives the whole.  Any dominance of angles is taken in one call.

* :func:`bp_voxel_cuda` launches the hand-written CUDA kernel
  (``csrc/bp_voxel.cu``, replacing the Pallas ``_bp_kernel``) on a CUDA
  tensor, and raises for anything else;
* :func:`bp_voxel_plain` is the same function in plain PyTorch, a loop
  over angles vectorised over the slab with ``_bp_kernel``'s arithmetic:
  the oracle of the kernel, and what runs on the CPU;
* :func:`bp_voxel` picks between them by the tensor's device alone.

The kernel is compiled in several tile configurations (planes a thread
sums, columns in y of a block: ``build.configs("bp_voxel")``); ``config``
picks one by its index, 0 the default.  Every configuration gives the same
bits, and the plain version has no tiles, so it takes no config.

``bp_voxel_cuda.launches`` counts kernel launches and
``bp_voxel_plain.calls`` calls of the plain version (see
:func:`repro_torch.kernels.reset_counters`).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.geometry import ConeGeometry
from . import build
from .bp_matched import _check_proj
from .fp_ray import _check_cuda, angle_constants

#: the weight argument of the C entry
WEIGHTS = {"fdk": 0, "pmatched": 1, "none": 2}


def _weight_code(weight: str) -> int:
    try:
        return WEIGHTS[weight]
    except KeyError:
        raise ValueError(f"unknown weight {weight!r} (have "
                         f"{sorted(WEIGHTS)})") from None


def _planes(geo: ConeGeometry, z_planes: Optional[int]) -> int:
    return geo.n_voxel[0] if z_planes is None else int(z_planes)


# --------------------------------------------------------------------------
# plain version (the oracle)
# --------------------------------------------------------------------------

def bp_voxel_plain(proj: torch.Tensor, geo: ConeGeometry, angles,
                   weight: str = "fdk", z_start=0,
                   z_planes: Optional[int] = None) -> torch.Tensor:
    """Plain-PyTorch voxel-driven backprojection (the kernel's oracle),
    following ``_bp_kernel`` (bp_voxel.py:52-101) expression by
    expression: per angle the in-plane fields, then every plane of the
    slab at once."""
    bp_voxel_plain.calls += 1
    code = _weight_code(weight)
    nz, ny, nx = geo.n_voxel
    nv, nu = geo.n_detector
    dz, dy, dx = geo.d_voxel
    dv, du = geo.d_detector
    offz, offy, offx = geo.off_origin
    offv, offu = geo.off_detector
    planes = _planes(geo, z_planes)
    dev = proj.device
    consts = angle_constants(geo, angles).to(dev)
    _check_proj(proj, geo, consts.shape[0])

    f32 = dict(dtype=torch.float32, device=dev)
    X = ((torch.arange(nx, **f32) - (nx - 1) / 2.0) * dx + offx)[None, :]
    Y = ((torch.arange(ny, **f32) - (ny - 1) / 2.0) * dy + offy)[:, None]
    zs = (((torch.arange(planes, **f32) + float(z_start)) - (nz - 1) / 2.0)
          * dz + offz)[:, None, None]
    acc = torch.zeros((planes, ny, nx), **f32)
    for a in range(consts.shape[0]):
        sth, cth = -consts[a, 5], consts[a, 6]
        p = X * cth + Y * sth                              # (Ny, Nx)
        q = -X * sth + Y * cth
        depth = geo.DSO - p
        mag = geo.DSD / depth
        fu = (q * mag - offu) / du + (nu - 1) / 2.0
        fv_scale = mag / dv
        if code == 0:
            w2d = (geo.DSO / depth) ** 2
        elif code == 1:
            w2d = (geo.DSD / depth) ** 2 * (geo.DSO / geo.DSD)
        else:
            w2d = torch.ones_like(depth)
        i0 = torch.floor(fu)
        wu = fu - i0
        i0i = i0.long()
        fv = zs * fv_scale - (offv / dv) + (nv - 1) / 2.0  # (planes, Ny, Nx)
        j0 = torch.floor(fv)
        wv = fv - j0
        j0i = j0.long()
        flat = proj[a].reshape(-1)

        def tap(jj, ii, w):
            ok = (jj >= 0) & (jj < nv) & (ii >= 0) & (ii < nu)
            idx = jj.clamp(0, nv - 1) * nu + ii.clamp(0, nu - 1)
            return torch.where(ok, flat[idx] * w, 0.0)

        val = (tap(j0i, i0i, (1 - wv) * (1 - wu))
               + tap(j0i, i0i + 1, (1 - wv) * wu)
               + tap(j0i + 1, i0i, wv * (1 - wu))
               + tap(j0i + 1, i0i + 1, wv * wu))
        acc += val * w2d
    return acc


bp_voxel_plain.calls = 0


# --------------------------------------------------------------------------
# the CUDA kernel's wrapper
# --------------------------------------------------------------------------

def bp_voxel_cuda(proj: torch.Tensor, geo: ConeGeometry, angles,
                  weight: str = "fdk", z_start=0,
                  z_planes: Optional[int] = None,
                  config: int = 0) -> torch.Tensor:
    """Launch the CUDA voxel-driven backprojector, in tile configuration
    ``config``, on a CUDA ``proj``; see :func:`bp_voxel_plain` for the
    contract."""
    _check_cuda(proj, "projections")
    code = _weight_code(weight)
    nz, ny, nx = geo.n_voxel
    nv, nu = geo.n_detector
    dz, dy, dx = geo.d_voxel
    dv, du = geo.d_detector
    offz, offy, offx = geo.off_origin
    offv, offu = geo.off_detector
    planes = _planes(geo, z_planes)
    dev = proj.device
    consts = angle_constants(geo, torch.as_tensor(angles).to(dev))
    _check_proj(proj, geo, consts.shape[0])
    out = torch.empty((planes, ny, nx), dtype=torch.float32, device=dev)
    if consts.shape[0] == 0 or planes == 0:
        return out.zero_()
    proj = proj.contiguous()
    build.launch(
        "bp_voxel", dev, proj.data_ptr(), consts.data_ptr(), out.data_ptr(),
        consts.shape[0], nz, ny, nx, planes, nv, nu,
        dz, dy, dx, dv, du, offz, offy, offx, offv / dv, offu,
        geo.DSO, geo.DSD, geo.DSO / geo.DSD, float(z_start), code,
        int(config),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream)
    bp_voxel_cuda.launches += 1
    return out


bp_voxel_cuda.launches = 0


def bp_voxel(proj: torch.Tensor, geo: ConeGeometry, angles,
             weight: str = "fdk", z_start=0,
             z_planes: Optional[int] = None,
             config: int = 0) -> torch.Tensor:
    """Voxel-driven backprojection on ``proj``'s device: the CUDA kernel
    in tile configuration ``config`` for a CUDA tensor, the plain version
    (no tiles) for a CPU tensor, and an error otherwise."""
    if proj.device.type == "cpu":
        return bp_voxel_plain(proj, geo, angles, weight, z_start, z_planes)
    return bp_voxel_cuda(proj, geo, angles, weight, z_start, z_planes,
                         config)
