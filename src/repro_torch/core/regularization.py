"""TV regularisation on one device (paper SS2.3).

Port of the single-device half of ``repro/core/regularization.py``
(lines 52-137).  Two minimisers, as in TIGRE:

* :func:`minimize_tv` -- steepest-descent minimisation of smoothed
  isotropic TV (used by ASD-POCS), one TV gradient per step.  The gradient
  is :func:`repro_torch.kernels.tv_grad.tv_grad`: on a CUDA tensor the
  hand-written kernel (``csrc/tv_grad.cu``), on a CPU tensor its plain
  version.  The reference differentiates ``tv_value`` with ``jax.grad``;
  the kernel computes the same gradient in closed form, and its parity is
  held against that ``jax.grad`` (rtol 1e-5, atol 1e-5).
* :func:`rof_denoise` -- Chambolle's dual projection for the ROF model
  (FISTA-TV's proximal step), in plain PyTorch ops as the reference has it
  in plain ``jnp``: no kernel.

Both run on the device of the tensor they are given.  The masked TV
objective and the halo-split ``dist_minimize_tv`` / ``dist_rof_denoise``
(paper Fig 6) need ``torch.distributed`` and arrive with the distributed
slice (ROADMAP Queue A 10).
"""

from __future__ import annotations

import torch

from ..kernels.tv_grad import _forward_diff, tv_grad
from .device import norm


# --------------------------------------------------------------------------
# TV value / gradient (forward differences, z-radius-1 stencil)
# --------------------------------------------------------------------------

def _tv_field(vol: torch.Tensor, eps: float) -> torch.Tensor:
    """|grad f| per voxel with edge-replicate (Neumann) forward
    differences."""
    dz, dy, dx = (_forward_diff(vol, d) for d in range(3))
    return torch.sqrt(dz * dz + dy * dy + dx * dx + eps * eps)


def tv_value(vol: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return torch.sum(_tv_field(vol, eps))


def tv_gradient(vol: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Gradient of :func:`tv_value`: the ``tv_grad`` kernel on a CUDA
    tensor, its plain version on a CPU tensor."""
    return tv_grad(vol, eps)


def minimize_tv(vol: torch.Tensor, hyper: float, n_iters: int = 20,
                eps: float = 1e-6) -> torch.Tensor:
    """TIGRE's ``minimizeTV``: steepest descent with norm-relative steps,
    ``v <- v - hyper * g / (||g|| + 1e-12)``.  The steps update a copy of
    ``vol`` in place (the same bits as the reference's expression), so the
    loop holds three volumes: ``vol``, the iterate and the gradient.  The
    norm stays a 0-d tensor on the device, so the loop never waits for
    it."""
    v = vol.clone()
    for _ in range(n_iters):
        g = tv_gradient(v, eps)
        gn = norm(g) + 1e-12
        v.sub_(g.mul_(hyper).div_(gn))
    return v


# --------------------------------------------------------------------------
# ROF model via Chambolle's dual projection
# --------------------------------------------------------------------------

def _grad3(v: torch.Tensor):
    return tuple(_forward_diff(v, d) for d in range(3))


def _div_axis(p: torch.Tensor, dim: int) -> torch.Tensor:
    """One axis of :func:`_div3`: p_0, p_i - p_{i-1} inside, -p_{n-2} at
    the last index; p itself for an axis of size 1."""
    n = p.shape[dim]
    if n <= 1:
        return p
    return torch.cat([p.narrow(dim, 0, 1),
                      p.narrow(dim, 1, n - 2) - p.narrow(dim, 0, n - 2),
                      -p.narrow(dim, n - 2, 1)], dim)


def _div3(pz: torch.Tensor, py: torch.Tensor, px: torch.Tensor):
    """Adjoint of ``_grad3`` (Chambolle's boundary convention)."""
    return _div_axis(pz, 0) + _div_axis(py, 1) + _div_axis(px, 2)


def _rof_step(p, f, tau: float):
    pz, py, px = p
    gz, gy, gx = _grad3(_div3(pz, py, px) - f)
    denom = 1.0 + tau * torch.sqrt(gz * gz + gy * gy + gx * gx)
    return ((pz + tau * gz) / denom, (py + tau * gy) / denom,
            (px + tau * gx) / denom)


def rof_denoise(vol: torch.Tensor, lam: float = 10.0, n_iters: int = 30,
                tau: float = 0.124) -> torch.Tensor:
    """Chambolle (2004) dual projection for min ||u - vol||^2/2 +
    TV(u)/lam."""
    f = vol * lam
    p = tuple(torch.zeros_like(vol) for _ in range(3))
    for _ in range(n_iters):
        p = _rof_step(p, f, tau)
    return vol - _div3(*p) / lam


def halo_overhead(planes_local: int, halo: int) -> float:
    """Fraction of redundant stencil work per shard for halo depth
    ``halo``."""
    return 2.0 * halo / max(planes_local, 1)
