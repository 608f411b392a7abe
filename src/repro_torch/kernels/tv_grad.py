"""Gradient of the smoothed isotropic TV objective: kernel and plain version.

Port of ``repro/kernels/tv_grad.py``.  Three callables share one contract,
``f(vol, eps=1e-6) -> g``: ``vol`` is a float32 (Nz, Ny, Nx) volume and
``g``, of the same shape, the closed-form gradient of
``sum sqrt(dz^2 + dy^2 + dx^2 + eps^2)`` with edge-replicate forward
differences (0 at the last index of each axis):

    g_i = -(dz_i + dy_i + dx_i) / m_i
          + dz_{i-z} / m_{i-z} + dy_{i-y} / m_{i-y} + dx_{i-x} / m_{i-x}

with a backward term 0 at index 0 of its axis.  Any shape is taken: the
Pallas wrapper's ``Nz % z_block == 0`` is a TPU block-shape restriction.

* :func:`tv_grad_cuda` launches the hand-written CUDA kernel
  (``csrc/tv_grad.cu``, replacing the Pallas ``_tv_grad_kernel``) on a
  CUDA tensor, and raises for anything else;
* :func:`tv_grad_plain` is the same function in plain PyTorch, following
  ``_tv_grad_kernel`` expression by expression over the whole volume: the
  oracle of the kernel, and what runs on the CPU;
* :func:`tv_grad` picks between them by the tensor's device alone.

``tv_grad_cuda.launches`` counts kernel launches and
``tv_grad_plain.calls`` calls of the plain version (see
:func:`repro_torch.kernels.reset_counters`).
"""

from __future__ import annotations

import torch

from . import build
from .fp_ray import _check_cuda


def _check(vol: torch.Tensor) -> None:
    if vol.dim() != 3 or vol.dtype != torch.float32:
        raise ValueError("tv_grad takes a float32 (Nz, Ny, Nx) volume, got "
                         f"{vol.dtype} of shape {tuple(vol.shape)}")


def _shift_in(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` moved one index up along ``dim``, with 0 entering at index 0
    (the backward term ``t_{i-e}``)."""
    zero = torch.zeros_like(t.narrow(dim, 0, 1))
    return torch.cat([zero, t.narrow(dim, 0, t.shape[dim] - 1)], dim)


def _forward_diff(f: torch.Tensor, dim: int) -> torch.Tensor:
    """``f_{i+e} - f_i``, 0 at the last index of ``dim``."""
    n = f.shape[dim]
    d = f.narrow(dim, 1, n - 1) - f.narrow(dim, 0, n - 1)
    return torch.cat([d, torch.zeros_like(f.narrow(dim, 0, 1))], dim)


# --------------------------------------------------------------------------
# plain version (the oracle)
# --------------------------------------------------------------------------

def tv_grad_plain(vol: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Plain-PyTorch TV gradient (the kernel's oracle), following
    ``_tv_grad_kernel`` (tv_grad.py:26-56) over the whole volume."""
    tv_grad_plain.calls += 1
    _check(vol)
    dz, dy, dx = (_forward_diff(vol, d) for d in range(3))
    m = torch.sqrt(dz * dz + dy * dy + dx * dx + eps * eps)
    inv_m = 1.0 / m
    g = -(dz + dy + dx) * inv_m
    g = g + _shift_in(dz * inv_m, 0)
    g = g + _shift_in(dy * inv_m, 1)
    g = g + _shift_in(dx * inv_m, 2)
    return g


tv_grad_plain.calls = 0


# --------------------------------------------------------------------------
# the CUDA kernel's wrapper
# --------------------------------------------------------------------------

def tv_grad_cuda(vol: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Launch the CUDA TV-gradient kernel on a CUDA ``vol``; see
    :func:`tv_grad_plain` for the contract."""
    _check_cuda(vol, "volume")
    _check(vol)
    vol = vol.contiguous()
    out = torch.empty_like(vol)
    if vol.numel() == 0:
        return out
    nz, ny, nx = vol.shape
    dev = vol.device
    build.launch(
        "tv_grad", dev, vol.data_ptr(), out.data_ptr(), nz, ny, nx,
        float(eps) * float(eps),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream)
    tv_grad_cuda.launches += 1
    return out


tv_grad_cuda.launches = 0


def tv_grad(vol: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """TV gradient on ``vol``'s device: the CUDA kernel for a CUDA tensor,
    the plain version for a CPU tensor, and an error otherwise."""
    if vol.device.type == "cpu":
        return tv_grad_plain(vol, eps)
    return tv_grad_cuda(vol, eps)
