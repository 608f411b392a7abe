"""FlashAttention-2 with grouped-query attention, forward and backward:
kernels and plain versions.

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
  fp32 units.  With gradients on and a q, k or v that requires one, it
  goes through :class:`_FlashAttentionFn`: the forward also writes each
  row's log-sum-exp, and the backward launches the kernels of
  ``csrc/flash_attention_bwd.cu`` for dq, dk and dv: for bfloat16 on the
  tensor cores (wgmma, TMA, P and dS as bf16 hi/lo pairs), for float32 the
  SIMT kernels on the fp32 units.  Otherwise the forward alone runs, as
  in prefill.  A launch that fails raises; nothing falls back, forward or
  backward;
* :func:`flash_attention_plain` is the same function in plain PyTorch, a
  dense softmax as ``kernels/ref.py::flash_attention_ref`` (the reference's
  oracle), in query chunks whose score block stays near
  :data:`SCORE_BYTES`: the oracle of the kernel, and what runs on the CPU
  (autograd differentiates it there);
* :func:`flash_attention_plain_lse` (the forward with its row statistics)
  and :func:`flash_attention_bwd_plain` (the backward's recompute from
  them) are the oracles of the training kernels; no path runs them;
* :func:`flash_attention` picks between the kernel and the plain version by
  the tensors' device alone.

``flash_attention_cuda.launches`` counts forward launches of either
kernel, ``flash_attention_cuda.wgmma_launches`` those of the bfloat16
tensor-core kernel among them, ``flash_attention_cuda.bwd_launches``
backward launches (one per backward: the preprocess, dK/dV and dQ
kernels), ``flash_attention_cuda.bwd_wgmma_launches`` those of the
bfloat16 tensor-core backward among them, and
``flash_attention_plain.calls`` calls of any of the plain versions (see
:func:`repro_torch.kernels.counters`).
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


def _check_bwd(q, o, lse, d_out) -> None:
    """The backward's own inputs: the forward's float32 out ``o`` and row
    statistics ``lse``, and ``d_out`` in q's type, of q's shape."""
    b, hq, s, _ = q.shape
    if d_out.dtype != q.dtype or o.dtype != torch.float32 or \
            lse.dtype != torch.float32:
        raise ValueError(f"d_out {d_out.dtype} must be q's type {q.dtype}, "
                         f"o {o.dtype} and lse {lse.dtype} float32")
    if o.shape != q.shape or d_out.shape != q.shape or \
            tuple(lse.shape) != (b, hq, s):
        raise ValueError(f"o {tuple(o.shape)}, d_out {tuple(d_out.shape)} "
                         f"and lse {tuple(lse.shape)} do not match q "
                         f"{tuple(q.shape)}")


def _scaled_q(q: torch.Tensor) -> torch.Tensor:
    """``q * (1/sqrt(D))`` rounded in q's type: the reference multiplies by
    a Python float, which JAX rounds to q's type first."""
    scale = torch.tensor(1.0 / math.sqrt(q.shape[-1]), dtype=q.dtype)
    return q * scale


# --------------------------------------------------------------------------
# plain version (the oracle)
# --------------------------------------------------------------------------

def _chunks(q: torch.Tensor, causal: bool, window: Optional[int]):
    """(q0, q1, k_lo, k_hi, keep) of each chunk of query rows: the keys
    [k_lo, k_hi) its masks can reach and the (rows, keys) mask of kept
    pairs, chunks sized so that a score block stays near SCORE_BYTES."""
    b, hq, s, _ = q.shape
    chunk = max(1, min(s, SCORE_BYTES // (4 * b * hq * s)))
    for q0 in range(0, s, chunk):
        q1 = min(s, q0 + chunk)
        k_lo = max(0, q0 - window + 1) if window is not None else 0
        k_hi = q1 if causal else s
        q_pos = torch.arange(q0, q1, device=q.device)[:, None]
        k_pos = torch.arange(k_lo, k_hi, device=q.device)[None, :]
        keep = torch.ones((q1 - q0, k_hi - k_lo), dtype=torch.bool,
                          device=q.device)
        if causal:
            keep &= k_pos <= q_pos
        if window is not None:
            keep &= k_pos > q_pos - window
        yield q0, q1, k_lo, k_hi, keep


def _plain(q, k, v, causal, window, softcap, with_lse: bool):
    """(out, lse and the float32 out when ``with_lse``, else None, None)."""
    _check(q, k, v, window, softcap)
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    qs = _scaled_q(q).float().view(b, hkv, g, s, d)
    kf, vf = k.float(), v.float()
    out = torch.empty((b, hkv, g, s, d), dtype=torch.float32,
                      device=q.device)
    lse = (torch.empty((b, hkv, g, s), dtype=torch.float32, device=q.device)
           if with_lse else None)
    for q0, q1, k_lo, k_hi, keep in _chunks(q, causal, window):
        rows = q1 - q0
        sc = torch.matmul(qs[:, :, :, q0:q1].reshape(b, hkv, g * rows, d),
                          kf[:, :, k_lo:k_hi].transpose(-1, -2))
        sc = sc.view(b, hkv, g, rows, k_hi - k_lo)
        if softcap is not None:
            sc = softcap * torch.tanh(sc / softcap)
        sc = sc.masked_fill(~keep, NEG_INF)
        if with_lse:
            lse[:, :, :, q0:q1] = torch.logsumexp(sc, dim=-1)
        p = torch.softmax(sc, dim=-1)
        out[:, :, :, q0:q1] = torch.matmul(
            p.view(b, hkv, g * rows, k_hi - k_lo),
            vf[:, :, k_lo:k_hi]).view(b, hkv, g, rows, d)
        del sc, p
    out = out.view(b, hq, s, d)
    if not with_lse:
        return out.to(q.dtype), None, None
    return out.to(q.dtype), lse.view(b, hq, s), out


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, window: Optional[int] = None,
                          softcap: Optional[float] = None) -> torch.Tensor:
    """Plain-PyTorch attention (the kernel's oracle): a dense float32
    softmax per chunk of query rows, over the keys the chunk's masks can
    reach (a masked key's weight is exactly 0, since every row keeps its
    diagonal).  GQA without repeating K/V: the query heads of one KV head
    are stacked into the rows of one matrix product.  Differentiable: on
    the CPU, autograd of it is the attention's gradient."""
    flash_attention_plain.calls += 1
    return _plain(q, k, v, causal, window, softcap, False)[0]


flash_attention_plain.calls = 0


def flash_attention_plain_lse(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = True,
                              window: Optional[int] = None,
                              softcap: Optional[float] = None):
    """``(out, lse, out_f32)``: :func:`flash_attention_plain`'s output,
    each row's log-sum-exp of its capped, masked scores (natural log,
    float32, (B, Hq, S)), and the output in float32 before its rounding to
    q's type (the backward's Di reads it): what the training forward kernel
    writes.  The oracle of that kernel; counted in
    ``flash_attention_plain.calls``."""
    flash_attention_plain.calls += 1
    return _plain(q, k, v, causal, window, softcap, True)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, d_out: torch.Tensor,
                              causal: bool = True,
                              window: Optional[int] = None,
                              softcap: Optional[float] = None):
    """``(dq, dk, dv)`` of the attention, by the backward kernels'
    recompute (``csrc/flash_attention_bwd.cu``) in plain PyTorch: from the
    forward's float32 output ``o`` (``out_f32`` of
    :func:`flash_attention_plain_lse`) and ``lse``, per chunk of query rows,
    P = exp(s - lse) with masked scores -1e30, dS = P (d_out·vᵀ - Di) with
    Di = rowsum(d_out ∘ o), times 1 - tanh²(s/cap) under a cap;
    dv = Σ Pᵀ d_out, dk = Σ dSᵀ q', dq = q's type(dS k) · (1/√D) in q's
    type, each rounded once to q's type.  The oracle of the backward
    kernels; counted in ``flash_attention_plain.calls``."""
    flash_attention_plain.calls += 1
    _check(q, k, v, window, softcap)
    _check_bwd(q, o, lse, d_out)
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    qs = _scaled_q(q).float().view(b, hkv, g, s, d)
    kf, vf = k.float(), v.float()
    do = d_out.float().view(b, hkv, g, s, d)
    di = (do * o.float().view(b, hkv, g, s, d)).sum(-1)
    m = lse.float().view(b, hkv, g, s)
    dqp = torch.empty((b, hkv, g, s, d), dtype=torch.float32,
                      device=q.device)
    dk = torch.zeros((b, hkv, s, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for q0, q1, k_lo, k_hi, keep in _chunks(q, causal, window):
        rows, n = q1 - q0, k_hi - k_lo
        qc = qs[:, :, :, q0:q1].reshape(b, hkv, g * rows, d)
        dc = do[:, :, :, q0:q1].reshape(b, hkv, g * rows, d)
        sc = torch.matmul(qc, kf[:, :, k_lo:k_hi].transpose(-1, -2))
        sc = sc.view(b, hkv, g, rows, n)
        if softcap is not None:
            t = torch.tanh(sc / softcap)
            sc = softcap * t
        p = torch.exp(sc.masked_fill(~keep, NEG_INF)
                      - m[:, :, :, q0:q1, None])
        dp = torch.matmul(dc, vf[:, :, k_lo:k_hi].transpose(-1, -2))
        ds = p * (dp.view(b, hkv, g, rows, n) - di[:, :, :, q0:q1, None])
        if softcap is not None:
            ds = ds * (1.0 - t * t)
        p, ds = p.view(b, hkv, g * rows, n), ds.view(b, hkv, g * rows, n)
        dv[:, :, k_lo:k_hi] += torch.matmul(p.transpose(-1, -2), dc)
        dk[:, :, k_lo:k_hi] += torch.matmul(ds.transpose(-1, -2), qc)
        dqp[:, :, :, q0:q1] = torch.matmul(
            ds, kf[:, :, k_lo:k_hi]).view(b, hkv, g, rows, d)
        del sc, p, dp, ds
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=q.dtype)
    dq = dqp.view(b, hq, s, d).to(q.dtype) * scale
    return dq, dk.to(k.dtype), dv.to(v.dtype)


# --------------------------------------------------------------------------
# the CUDA kernels' wrappers
# --------------------------------------------------------------------------

def _check_cuda_args(q, k, v, window, softcap) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_cuda(t, name)
    _check(q, k, v, window, softcap)
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {HEAD_DIMS}, got "
                         f"{q.shape[-1]}")
    if q.device != k.device or q.device != v.device:
        raise ValueError("q, k and v must lie on one device")


def _stream_args(dev: torch.device):
    return (dev.index if dev.index is not None
            else torch.cuda.current_device(),
            torch.cuda.current_stream(dev).cuda_stream)


def _launch_fwd(q, k, v, causal, window, softcap, with_lse: bool):
    """(out, lse, out_f32) of the forward kernel on contiguous CUDA q, k,
    v; ``with_lse`` has it also write each row's log-sum-exp and, for
    bfloat16, its output before the rounding (the same bits of out either
    way; out_f32 is out itself in float32); else lse and out_f32 are
    None."""
    b, hq, s, d = q.shape
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the tensor-core kernel reads q, k, v by TMA: they "
                         "must start 16-byte aligned")
    out = torch.empty_like(q)
    lse = out_f32 = None
    if with_lse:
        lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
        out_f32 = (out if q.dtype == torch.float32 else
                   torch.empty_like(q, dtype=torch.float32))
    if out.numel() == 0:
        return out, lse, out_f32
    bf16_f32 = with_lse and q.dtype == torch.bfloat16
    build.launch(
        "flash_attention", q.device, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), out.data_ptr(), lse.data_ptr() if with_lse else 0,
        out_f32.data_ptr() if bf16_f32 else 0, b, hq, k.shape[1], s, d,
        _DTYPES[q.dtype], 1.0 / math.sqrt(d),
        int(causal), window or 0, float(softcap or 0.0),
        *_stream_args(q.device))
    flash_attention_cuda.launches += 1
    flash_attention_cuda.wgmma_launches += int(q.dtype == torch.bfloat16)
    return out, lse, out_f32


def _launch_fwd_lse(q, k, v, causal, window, softcap):
    return _launch_fwd(q, k, v, causal, window, softcap, True)


def _launch_bwd(q, k, v, o, lse, d_out, causal, window, softcap):
    """(dq, dk, dv) of the backward kernels (``csrc/flash_attention_bwd.cu``:
    Di, then dK/dV, then dQ, one launch of the entry) from the forward's
    float32 output ``o`` and ``lse``.  bfloat16 takes the tensor-core
    kernels (wgmma; q', d_out, K, V, lse and Di by TMA), float32 the SIMT
    ones: the type alone chooses."""
    b, hq, s, d = q.shape
    for name, t in (("o", o), ("lse", lse), ("d_out", d_out)):
        _check_cuda(t, name)
    _check_bwd(q, o, lse, d_out)
    o, lse, d_out = o.contiguous(), lse.contiguous(), d_out.contiguous()
    bf16 = q.dtype == torch.bfloat16
    if bf16 and any(t.data_ptr() % 16 for t in (q, k, v, d_out, lse)):
        raise ValueError("the tensor-core backward reads q, k, v, d_out and "
                         "lse by TMA or 16-byte loads: they must start "
                         "16-byte aligned")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if dq.numel() == 0:
        return dq, dk, dv
    di = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    build.launch(
        "flash_attention_bwd", q.device, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), o.data_ptr(), lse.data_ptr(), d_out.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), di.data_ptr(), b, hq,
        k.shape[1], s, d, _DTYPES[q.dtype], 1.0 / math.sqrt(d), int(causal),
        window or 0, float(softcap or 0.0), *_stream_args(q.device))
    flash_attention_cuda.bwd_launches += 1
    flash_attention_cuda.bwd_wgmma_launches += int(bf16)
    return dq, dk, dv


class _FlashAttentionFn(torch.autograd.Function):
    """Attention with its gradient from kernels: ``forward`` runs ``fwd(q,
    k, v, causal, window, softcap) -> (out, lse, out_f32)``, returns out and
    saves q, k, v, out_f32 and lse; ``backward`` runs ``bwd(q, k, v,
    out_f32, lse, d_out, causal, window, softcap) -> (dq, dk, dv)``.
    :func:`flash_attention_cuda` binds the CUDA launchers; the CPU tests
    bind the plain versions to check the wiring.  Remat
    (``torch.utils.checkpoint``) recomputes the forward through it."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, fwd, bwd):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse, out_f32 = fwd(q, k, v, causal, window, softcap)
        ctx.save_for_backward(q, k, v, out_f32, lse)
        ctx.args, ctx.bwd = (causal, window, softcap), bwd
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out_f32, lse = ctx.saved_tensors
        grads = ctx.bwd(q, k, v, out_f32, lse, d_out.contiguous(),
                        *ctx.args)
        grads = tuple(g if need else None
                      for g, need in zip(grads, ctx.needs_input_grad))
        return grads + (None,) * 5


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, window: Optional[int] = None,
                         softcap: Optional[float] = None) -> torch.Tensor:
    """Launch the CUDA attention kernel of q's type (the tensor-core one
    for bfloat16, the SIMT one for float32) on CUDA ``q``, ``k``, ``v``;
    see :func:`flash_attention_plain` for the contract.

    With gradients on and any of q, k, v requiring one, the call goes
    through :class:`_FlashAttentionFn` (the forward with its row
    statistics; the backward kernels when autograd asks for the
    gradient).  Otherwise the forward launches alone, without them."""
    _check_cuda_args(q, k, v, window, softcap)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttentionFn.apply(q, k, v, causal, window, softcap,
                                       _launch_fwd_lse, _launch_bwd)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return _launch_fwd(q, k, v, causal, window, softcap, False)[0]


flash_attention_cuda.launches = 0
flash_attention_cuda.wgmma_launches = 0
flash_attention_cuda.bwd_launches = 0
flash_attention_cuda.bwd_wgmma_launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """Attention on the tensors' device: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors, and an error otherwise."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, window, softcap)
    return flash_attention_cuda(q, k, v, causal, window, softcap)
