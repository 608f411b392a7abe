"""Hand-written CUDA kernels of the port, each beside its plain version.

* :mod:`.fp_ray` — the Joseph forward projector A (``csrc/fp_ray.cu``);
* :mod:`.bp_matched` — its exact adjoint A^T (``csrc/bp_matched.cu``);
* :mod:`.bp_voxel` — the voxel-driven backprojector of FDK and the SART
  family (``csrc/bp_voxel.cu``);
* :mod:`.tv_grad` — the gradient of the smoothed TV objective, ASD-POCS's
  regulariser (``csrc/tv_grad.cu``);
* :mod:`.flash_attention` — FlashAttention-2 with GQA, causal and
  sliding-window masks and the logit soft-cap, the LM's attention: the
  forward (``csrc/flash_attention.cu``: a tensor-core kernel for bfloat16,
  a SIMT kernel for float32) and, for training, its backward
  (``csrc/flash_attention_bwd.cu``, in a ``torch.autograd.Function``);
* :mod:`.build` — ``nvcc`` at first use, ``ctypes`` loading;
* :mod:`.autotune` — the measured tile autotuner of ``fp_ray``,
  ``bp_matched`` and ``bp_voxel`` (each compiled in a few tile
  configurations that give the same bits);
* :mod:`.ops` — cached public wrappers of the kernels;
* :mod:`.ref` — plain-PyTorch oracles of the kernels.

Importing this package builds and loads nothing.
"""

from __future__ import annotations

from typing import Dict

from . import autotune, ops, ref
from .bp_matched import bp_matched_cuda, bp_matched_plain
from .bp_voxel import bp_voxel_cuda, bp_voxel_plain
from .flash_attention import (flash_attention_bwd_plain,
                              flash_attention_cuda, flash_attention_plain,
                              flash_attention_plain_lse)
from .fp_ray import fp_ray_cuda, fp_ray_plain
from .tv_grad import tv_grad_cuda, tv_grad_plain

_LAUNCHES = {"fp_ray": fp_ray_cuda, "bp_matched": bp_matched_cuda,
             "bp_voxel": bp_voxel_cuda, "tv_grad": tv_grad_cuda,
             "flash_attention": flash_attention_cuda}
_PLAIN = {"fp_ray": fp_ray_plain, "bp_matched": bp_matched_plain,
          "bp_voxel": bp_voxel_plain, "tv_grad": tv_grad_plain,
          "flash_attention": flash_attention_plain}


def reset_counters() -> None:
    """Set every kernel's launch count and plain-call count to 0."""
    for fn in _LAUNCHES.values():
        fn.launches = 0
    for fn in _PLAIN.values():
        fn.calls = 0
    flash_attention_cuda.wgmma_launches = 0
    flash_attention_cuda.bwd_launches = 0
    flash_attention_cuda.bwd_wgmma_launches = 0


def counters() -> Dict[str, Dict[str, int]]:
    """``{kernel: {"launches": n, "plain_calls": m}}`` since the last
    :func:`reset_counters` (``flash_attention_cuda.wgmma_launches`` says how
    many of flash_attention's forward launches took its tensor-core kernel,
    ``flash_attention_cuda.bwd_launches`` how many backward launches it
    made and ``flash_attention_cuda.bwd_wgmma_launches`` how many of those
    took its tensor-core backward; ``plain_calls`` counts the plain
    backward and row statistics too)."""
    return {name: {"launches": _LAUNCHES[name].launches,
                   "plain_calls": _PLAIN[name].calls}
            for name in _LAUNCHES}
