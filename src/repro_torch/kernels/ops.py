"""Cached public wrappers of the kernels.

Port of ``repro/kernels/ops.py``.  The reference caches one jitted
function per static key (geometry, block sizes, weight, interpret) and
takes the angles as a traced argument, so that repeated calls reuse one
executable.  PyTorch traces nothing; what the port builds once per static
key -- (geometry, tile configuration, weight, device), (eps, device) or
(masks, cap, device) -- is a launcher: the kernel wrapper bound to that
key, with the per-geometry constants (``fp_ray``'s plane centres) put on
the device when the launcher is built.  A call with new angle values hits
the cache and builds nothing; :func:`cache_info` exposes the counters.

Each wrapper runs the kernel on a CUDA tensor and its plain version on a
CPU tensor (the reference's ``interpret``); ``flash_attention``'s launcher
passes gradients through (on the card the kernel's autograd Function, on
the CPU autograd of the plain version).  They take the port's own
knobs, not the reference's block sizes, which have no counterpart here:

* ``fp_ray_project``: ``slab_planes`` -> ``config``, an index into
  ``fp_ray``'s compiled tile configurations (:func:`.autotune.configs`
  ``("fp")``: rows a thread owns, warps a block);
* ``bp_voxel_backproject``: ``z_block`` / ``angle_chunk`` -> ``config``
  (``bp_voxel``'s: planes a thread sums, columns in y of a block);
* ``tv_gradient_fused``: ``z_block`` -> none (``tv_grad`` has one tile);
* ``flash_attention``: ``block_q`` / ``block_kv`` -> none (the kernel's
  tiles are fixed by the head dim and the dtype).

Every configuration gives the same bits, and the plain versions have no
tiles.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import torch

from . import bp_voxel as _bp
from . import flash_attention as _fa
from . import fp_ray as _fp
from . import tv_grad as _tv
from ..core.geometry import ConeGeometry


@lru_cache(maxsize=None)
def _fp_launcher(geo: ConeGeometry, config: int, device: torch.device):
    _fp.plane_centers(geo, device)

    def f(vol, angles):
        return _fp.fp_ray(vol, geo, angles, 0, config)
    return f


@lru_cache(maxsize=None)
def _bp_launcher(geo: ConeGeometry, config: int, weight: str,
                 device: torch.device):
    _bp._weight_code(weight)

    def f(proj, angles):
        return _bp.bp_voxel(proj, geo, angles, weight, 0, None, config)
    return f


@lru_cache(maxsize=None)
def _tv_launcher(eps: float, device: torch.device):
    def f(vol):
        return _tv.tv_grad(vol, eps)
    return f


@lru_cache(maxsize=None)
def _flash_launcher(causal: bool, window: Optional[int],
                    softcap: Optional[float], device: torch.device):
    def f(q, k, v):
        return _fa.flash_attention(q, k, v, causal, window, softcap)
    return f


def cache_info():
    """lru statistics of the launcher caches (regression-tested: repeated
    calls must hit, never rebuild)."""
    return {"fp": _fp_launcher.cache_info(),
            "bp": _bp_launcher.cache_info(),
            "tv": _tv_launcher.cache_info(),
            "flash": _flash_launcher.cache_info()}


def clear_cache() -> None:
    _fp_launcher.cache_clear()
    _bp_launcher.cache_clear()
    _tv_launcher.cache_clear()
    _flash_launcher.cache_clear()


def _on(angles, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(angles, dtype=torch.float32).to(device)


def fp_ray_project(vol: torch.Tensor, geo: ConeGeometry, angles,
                   config: int = 0) -> torch.Tensor:
    """Joseph forward projection (x-dominant angles) via ``fp_ray``."""
    return _fp_launcher(geo, int(config), vol.device)(
        vol, _on(angles, vol.device))


def bp_voxel_backproject(proj: torch.Tensor, geo: ConeGeometry, angles,
                         weight: str = "fdk",
                         config: int = 0) -> torch.Tensor:
    """Voxel-driven backprojection via ``bp_voxel``."""
    return _bp_launcher(geo, int(config), weight, proj.device)(
        proj, _on(angles, proj.device))


def tv_gradient_fused(vol: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Fused TV-gradient stencil via ``tv_grad``."""
    return _tv_launcher(float(eps), vol.device)(vol)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """FlashAttention-2 style fused attention (GQA-aware) via
    ``flash_attention``."""
    return _flash_launcher(bool(causal), window, softcap, q.device)(q, k, v)
