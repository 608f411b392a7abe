"""Exact transpose A^T of the Joseph slab projector: kernel and plain version.

Port of ``repro/kernels/bp_matched.py``.  The contract is
``f(proj, geo, angles, z0=0, z_planes=None) -> slab`` with the slab
``(z_planes, Ny, Nx)`` such that for any slab ``x`` and projections ``y``::

    <fp_ray(x, geo, angles, z0=z0), y> == <x, bp_matched(y, geo, angles,
                                            z0=z0, z_planes=x.shape[0])>

to fp32 summation tolerance.

* :func:`bp_matched_cuda` launches the hand-written CUDA kernel
  (``csrc/bp_matched.cu``, replacing the Pallas ``_bp_matched_kernel``): a
  deterministic gather, one thread per output voxel, replaying fp_ray's
  tap arithmetic through the shared ``joseph_common.cuh``;
* :func:`bp_matched_plain` is the vjp of the plain forward projector,
  taken plane by plane (the forward is a sum of independent per-plane
  terms, so the per-plane vjps are the rows of the whole vjp, and the
  memory stays that of one plane);
* :func:`bp_matched` picks between them by the tensor's device alone.

``bp_matched_cuda.launches`` / ``bp_matched_plain.calls`` count launches
and plain calls.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.geometry import ConeGeometry
from .fp_ray import (_check_cuda, _plane_sample, _rays, angle_constants,
                     launch, plane_centers)


def _check_proj(proj: torch.Tensor, geo: ConeGeometry, n_angles: int):
    if proj.dtype != torch.float32:
        raise TypeError(f"projections must be float32, got {proj.dtype}")
    want = (n_angles,) + tuple(geo.n_detector)
    if tuple(proj.shape) != want:
        raise ValueError(f"projections must be {want}, got "
                         f"{tuple(proj.shape)}")


def bp_matched_plain(proj: torch.Tensor, geo: ConeGeometry, angles,
                     z0: int = 0,
                     z_planes: Optional[int] = None) -> torch.Tensor:
    """Plain-PyTorch exact adjoint (the kernel's oracle): the vjp of
    :func:`~repro_torch.kernels.fp_ray.fp_ray_plain` with respect to the
    slab of ``z_planes`` planes at ``z0`` (default: the whole volume)."""
    bp_matched_plain.calls += 1
    nz, ny, nx = geo.n_voxel
    planes = nz if z_planes is None else int(z_planes)
    consts = angle_constants(geo, angles).to(proj.device)
    _check_proj(proj, geo, consts.shape[0])
    src, d_y, d_z, inv_dx, seg = _rays(geo, consts)
    xc = plane_centers(geo, proj.device)
    g_seg = proj * seg                 # cotangent of the final ``acc * seg``
    out = torch.empty((planes, ny, nx), dtype=torch.float32,
                      device=proj.device)
    zeros = torch.zeros((planes, ny), dtype=torch.float32,
                        device=proj.device)
    for p in range(nx):
        _, vjp = torch.func.vjp(
            lambda plane: _plane_sample(plane, geo, src, d_y, d_z, inv_dx,
                                        xc[p], z0), zeros)
        out[:, :, p] = vjp(g_seg)[0]
    return out


bp_matched_plain.calls = 0


def bp_matched_cuda(proj: torch.Tensor, geo: ConeGeometry, angles,
                    z0: int = 0,
                    z_planes: Optional[int] = None) -> torch.Tensor:
    """Launch the CUDA exact adjoint on a CUDA ``proj``; see
    :func:`bp_matched_plain` for the contract."""
    _check_cuda(proj, "projections")
    nz, ny, nx = geo.n_voxel
    planes = nz if z_planes is None else int(z_planes)
    consts = angle_constants(geo, torch.as_tensor(angles).to(proj.device))
    _check_proj(proj, geo, consts.shape[0])
    if consts.shape[0] == 0:
        return torch.zeros((planes, ny, nx), dtype=torch.float32,
                           device=proj.device)
    # kernel writes the marching-plane layout (Nx, planes, Ny)
    out_t = torch.empty((nx, planes, ny), dtype=torch.float32,
                        device=proj.device)
    launch("bp_matched", proj.contiguous(), consts,
           plane_centers(geo, proj.device), out_t, geo, planes, z0)
    bp_matched_cuda.launches += 1
    return out_t.permute(1, 2, 0).contiguous()


bp_matched_cuda.launches = 0


def bp_matched(proj: torch.Tensor, geo: ConeGeometry, angles, z0: int = 0,
               z_planes: Optional[int] = None) -> torch.Tensor:
    """Exact adjoint on ``proj``'s device: the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor, and an error otherwise."""
    if proj.device.type == "cpu":
        return bp_matched_plain(proj, geo, angles, z0, z_planes)
    return bp_matched_cuda(proj, geo, angles, z0, z_planes)
