"""Plain-PyTorch oracles for every kernel (allclose targets in tests).

Port of ``repro/kernels/ref.py``.  Each oracle is independent of the
hand-written kernel it checks, on any device:

* :func:`fp_ray_ref` -- the plain Joseph projector
  (:func:`repro_torch.core.projector.forward_project_joseph`, x-dominant);
* :func:`bp_voxel_ref` -- the plain voxel-driven backprojector
  (:func:`repro_torch.core.projector.backproject_voxel`);
* :func:`tv_grad_ref` -- autograd of the TV objective
  (:func:`repro_torch.core.regularization.tv_value`), as the reference's
  ``tv_gradient`` is ``jax.grad`` of it (the port's ``tv_gradient`` is
  the ``tv_grad`` kernel on a CUDA tensor, so it is no oracle there);
* :func:`flash_attention_ref` -- dense softmax attention with the same
  masks and cap, GQA by repeating the KV heads.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..core.geometry import ConeGeometry
from ..core.projector import backproject_voxel, forward_project_joseph


def _angles(angles, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(angles, dtype=torch.float32).to(device)


def fp_ray_ref(vol: torch.Tensor, geo: ConeGeometry, angles) -> torch.Tensor:
    """Oracle for fp_ray: the plain Joseph projector (x-dominant)."""
    return forward_project_joseph(vol, geo, _angles(angles, vol.device),
                                  xdom=True)


def bp_voxel_ref(proj: torch.Tensor, geo: ConeGeometry, angles,
                 weight: str = "fdk") -> torch.Tensor:
    """Oracle for bp_voxel: the plain voxel-driven backprojector."""
    return backproject_voxel(proj, geo, _angles(angles, proj.device),
                             weight=weight)


def tv_grad_ref(vol: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Oracle for tv_grad: autograd of the TV objective."""
    from ..core.regularization import tv_value
    return torch.func.grad(lambda v: tv_value(v, eps))(vol)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None) -> torch.Tensor:
    """Oracle for flash_attention: dense softmax attention with the same
    masking / capping semantics (GQA via head repetition)."""
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    group = hq // hkv
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(d)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    s = torch.where(mask[None, None], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v).to(q.dtype)
