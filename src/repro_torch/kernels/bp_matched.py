"""Exact transpose A^T of the Joseph slab projector: kernel and plain version.

Port of ``repro/kernels/bp_matched.py``.  The contract is
``f(proj, geo, angles, z0=0, z_planes=None) -> slab`` with the slab
``(z_planes, Ny, Nx)`` such that for any slab ``x`` and projections ``y``::

    <fp_ray(x, geo, angles, z0=z0), y> == <x, bp_matched(y, geo, angles,
                                            z0=z0, z_planes=x.shape[0])>

to fp32 summation tolerance.

* :func:`bp_matched_cuda` launches the hand-written CUDA kernel
  (``csrc/bp_matched.cu``, replacing the Pallas ``_bp_matched_kernel``): a
  deterministic gather, one thread per output voxel, reading its taps off
  per-plane tables in shared memory that a block fills once per angle
  with fp_ray's tap arithmetic (the shared ``joseph_common.cuh``); a pass
  before it scales the projections by each ray's seg into a scratch of
  ``seg_chunk`` angles, and the two run chunk by chunk (the same bits for
  any chunk).  The scratch lies outside the execution plan, as the
  reference's kernel has none: a caller with a :class:`MemoryModel` sizes
  the chunk by :func:`seg_chunk_for` to fit the headroom the model leaves
  beside its usable bytes;
* :func:`bp_matched_plain` is the vjp of the plain forward projector,
  taken plane by plane (the forward is a sum of independent per-plane
  terms, so the per-plane vjps are the rows of the whole vjp, and the
  memory stays that of one plane);
* :func:`bp_matched` picks between them by the tensor's device alone.

The kernel is compiled in several tile configurations (slab planes of a
block, angles staged at a time: ``build.configs("bp_matched")``);
``config`` picks one by its index, 0 the default.  Every configuration
gives the same bits; ``seg_chunk`` is the budget's, not a tile.

``bp_matched_cuda.launches`` / ``bp_matched_plain.calls`` count launches
and plain calls.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.geometry import ConeGeometry
from ..core.splitting import MemoryModel
from .fp_ray import (_check_cuda, _plane_sample, _rays, angle_constants,
                     launch, plane_centers)

#: most angles of the kernel's scratch (the projections times seg): at
#: most SEG_CHUNK * Nv * Nu * 4 bytes beside the projections, 8 MiB at a
#: 512^2 detector, a quarter of the streamed backprojection's 32-angle chunk
SEG_CHUNK = 8


def seg_chunk_for(geo: ConeGeometry, memory: MemoryModel) -> int:
    """Angles of scratch that fit in the headroom ``memory`` leaves beside
    its usable bytes (``device_bytes - usable``, which no plan spends), at
    most :data:`SEG_CHUNK`; 0 when not one angle fits, which the kernel
    refuses."""
    nv, nu = geo.n_detector
    headroom = memory.device_bytes - memory.usable
    return min(SEG_CHUNK, headroom // (nv * nu * 4))


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
                    z0: int = 0, z_planes: Optional[int] = None,
                    seg_chunk: Optional[int] = None,
                    config: int = 0) -> torch.Tensor:
    """Launch the CUDA exact adjoint, in tile configuration ``config``, on
    a CUDA ``proj``; see :func:`bp_matched_plain` for the contract.
    ``seg_chunk`` angles of scratch at a time (None: :data:`SEG_CHUNK`)."""
    _check_cuda(proj, "projections")
    chunk = SEG_CHUNK if seg_chunk is None else int(seg_chunk)
    if chunk < 1:
        raise ValueError(
            f"bp_matched needs a scratch of at least one angle "
            f"({proj.shape[1] * proj.shape[2] * 4} bytes) beside the "
            f"budget: raise the memory model's headroom")
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
    proj = proj.contiguous()
    xc = plane_centers(geo, proj.device)
    gs = proj.new_empty((min(consts.shape[0], chunk),) + proj.shape[1:])
    launch("bp_matched", (proj.data_ptr(), consts.data_ptr(), xc.data_ptr(),
                          out_t.data_ptr(), gs.data_ptr(), gs.shape[0],
                          int(config)),
           consts, geo, planes, z0)
    bp_matched_cuda.launches += 1
    return out_t.permute(1, 2, 0).contiguous()


bp_matched_cuda.launches = 0


def bp_matched(proj: torch.Tensor, geo: ConeGeometry, angles, z0: int = 0,
               z_planes: Optional[int] = None,
               seg_chunk: Optional[int] = None,
               config: int = 0) -> torch.Tensor:
    """Exact adjoint on ``proj``'s device: the CUDA kernel for a CUDA
    tensor (with ``seg_chunk`` angles of scratch, in tile configuration
    ``config``), the plain version (no scratch, no tiles) for a CPU tensor,
    and an error otherwise."""
    if proj.device.type == "cpu":
        return bp_matched_plain(proj, geo, angles, z0, z_planes)
    return bp_matched_cuda(proj, geo, angles, z0, z_planes, seg_chunk,
                           config)
