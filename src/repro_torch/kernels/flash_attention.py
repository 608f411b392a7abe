"""FlashAttention-2 forward with grouped-query attention: kernel and plain
version.

Port of ``repro/kernels/flash_attention.py``.  Three callables share one
contract, ``f(q, k, v, causal=True, window=None, softcap=None) -> out``:
``q`` is (B, Hq, S, D) and ``k``, ``v`` are (B, Hkv, S, D), all float32 or
all bfloat16, with Hq a multiple of Hkv (query head h reads KV head
h // (Hq // Hkv)); ``out`` is (B, Hq, S, D) in q's type.  What is computed
is ``_flash_kernel``'s function: ``q * (1/sqrt(D))`` rounded in q's type,
float32 scores, the soft-cap ``cap * tanh(s / cap)`` before the mask, the
causal and window masks on absolute positions (masked entries -1e30), a
float32 softmax and the output in q's type.  Any S is taken: the Pallas
wrapper's ``S % block == 0`` is a TPU block-shape restriction.  Queries and
keys have one length (self-attention, as every caller in the reference).

* :func:`flash_attention_cuda` launches a hand-written CUDA kernel
  (``csrc/flash_attention.cu``, replacing the Pallas ``_flash_kernel``) on
  CUDA tensors, and raises for anything else.  The kernel is chosen by the
  type alone: bfloat16 runs the tensor-core kernel (wgmma on bf16
  operands with fp32 accumulation, TMA loads of K and V into a ring of
  stages, P·V on a bf16 hi/lo pair of P), float32 the SIMT kernel on the
  fp32 units.  A launch that fails raises; nothing falls back.  It has
  no backward: with gradients on, a q, k or v that requires a gradient is
  refused (ROADMAP A3.3);
* :func:`flash_attention_plain` is the same function in plain PyTorch, a
  dense softmax as ``kernels/ref.py::flash_attention_ref`` (the reference's
  oracle), in query chunks whose score block stays near
  :data:`SCORE_BYTES`: the oracle of the kernel, and what runs on the CPU;
* :func:`flash_attention` picks between them by the tensors' device alone.

``flash_attention_cuda.launches`` counts kernel launches of either kernel,
``flash_attention_cuda.wgmma_launches`` those of the bfloat16 tensor-core
kernel among them, and ``flash_attention_plain.calls`` calls of the plain
version (see :func:`repro_torch.kernels.counters`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import build
from .fp_ray import _check_cuda

NEG_INF = -1e30
#: head dims the kernel is compiled for
HEAD_DIMS = (32, 64, 80, 112, 128, 256)
#: bytes of float32 scores the plain version holds per query chunk
SCORE_BYTES = 1 << 30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: Optional[int], softcap: Optional[float]) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("flash_attention takes q (B, Hq, S, D) and k, v "
                         f"(B, Hkv, S, D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, s, d = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, s, d):
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} in batch, length or head dim")
    if hq % k.shape[1]:
        raise ValueError(f"Hq={hq} not a multiple of Hkv={k.shape[1]}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention takes float32 or bfloat16 q, k, v "
                         f"of one type; got {q.dtype}, {k.dtype}, {v.dtype}")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be positive, got {softcap}")


def _scaled_q(q: torch.Tensor) -> torch.Tensor:
    """``q * (1/sqrt(D))`` rounded in q's type: the reference multiplies by
    a Python float, which JAX rounds to q's type first."""
    scale = torch.tensor(1.0 / math.sqrt(q.shape[-1]), dtype=q.dtype)
    return q * scale


# --------------------------------------------------------------------------
# plain version (the oracle)
# --------------------------------------------------------------------------

def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, window: Optional[int] = None,
                          softcap: Optional[float] = None) -> torch.Tensor:
    """Plain-PyTorch attention (the kernel's oracle): a dense float32
    softmax per chunk of query rows, over the keys the chunk's masks can
    reach (a masked key's weight is exactly 0, since every row keeps its
    diagonal).  GQA without repeating K/V: the query heads of one KV head
    are stacked into the rows of one matrix product."""
    flash_attention_plain.calls += 1
    _check(q, k, v, window, softcap)
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    qs = _scaled_q(q).float().view(b, hkv, g, s, d)
    kf, vf = k.float(), v.float()
    out = torch.empty((b, hkv, g, s, d), dtype=torch.float32,
                      device=q.device)
    chunk = max(1, min(s, SCORE_BYTES // (4 * b * hq * s)))
    for q0 in range(0, s, chunk):
        q1 = min(s, q0 + chunk)
        k_lo = max(0, q0 - window + 1) if window is not None else 0
        k_hi = q1 if causal else s
        rows = q1 - q0
        sc = torch.matmul(qs[:, :, :, q0:q1].reshape(b, hkv, g * rows, d),
                          kf[:, :, k_lo:k_hi].transpose(-1, -2))
        sc = sc.view(b, hkv, g, rows, k_hi - k_lo)
        if softcap is not None:
            sc = softcap * torch.tanh(sc / softcap)
        q_pos = torch.arange(q0, q1, device=q.device)[:, None]
        k_pos = torch.arange(k_lo, k_hi, device=q.device)[None, :]
        keep = torch.ones((rows, k_hi - k_lo), dtype=torch.bool,
                          device=q.device)
        if causal:
            keep &= k_pos <= q_pos
        if window is not None:
            keep &= k_pos > q_pos - window
        p = torch.softmax(sc.masked_fill(~keep, NEG_INF), dim=-1)
        out[:, :, :, q0:q1] = torch.matmul(
            p.view(b, hkv, g * rows, k_hi - k_lo),
            vf[:, :, k_lo:k_hi]).view(b, hkv, g, rows, d)
        del sc, p
    return out.view(b, hq, s, d).to(q.dtype)


flash_attention_plain.calls = 0


# --------------------------------------------------------------------------
# the CUDA kernel's wrapper
# --------------------------------------------------------------------------

def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, window: Optional[int] = None,
                         softcap: Optional[float] = None) -> torch.Tensor:
    """Launch the CUDA attention kernel of q's type (the tensor-core one
    for bfloat16, the SIMT one for float32) on CUDA ``q``, ``k``, ``v``;
    see :func:`flash_attention_plain` for the contract.

    The kernel has no backward: with gradients on and any of q, k, v
    requiring one, it raises instead of returning a tensor that autograd
    cannot differentiate (nothing runs in its place)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention_cuda has no backward kernel yet (ROADMAP A3.3, "
            "the flash_attention backward): it cannot return a gradient for "
            "q, k or v; run attention layers under torch.no_grad() or "
            "inference_mode on the card, or train on the CPU, where the "
            "plain version is differentiable")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_cuda(t, name)
    _check(q, k, v, window, softcap)
    b, hq, s, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {HEAD_DIMS}, got {d}")
    if q.device != k.device or q.device != v.device:
        raise ValueError("q, k and v must lie on one device")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the tensor-core kernel reads q, k, v by TMA: they "
                         "must start 16-byte aligned")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    dev = q.device
    build.launch(
        "flash_attention", dev, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), b, hq,
        k.shape[1], s, d, _DTYPES[q.dtype], 1.0 / math.sqrt(d), int(causal),
        window or 0, float(softcap or 0.0),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream)
    flash_attention_cuda.launches += 1
    flash_attention_cuda.wgmma_launches += int(q.dtype == torch.bfloat16)
    return out


flash_attention_cuda.launches = 0
flash_attention_cuda.wgmma_launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """Attention on the tensors' device: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors, and an error otherwise."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, window, softcap)
    return flash_attention_cuda(q, k, v, causal, window, softcap)
