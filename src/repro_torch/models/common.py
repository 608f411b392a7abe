"""Shared building blocks of the LM: norms, rotary embedding, init, the
chunked cross-entropy.

Port of ``repro/models/common.py`` for one device: there are no sharding
rules (``ShardingRules`` is a mesh concept).  Random init
draws from an explicit ``torch.Generator`` with the reference's
distributions; the bits differ from ``jax.random``'s, so parity tests carry
weights across with :func:`repro_torch.models.lm.load_reference_params`.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch


# --------------------------------------------------------------------------
# initialisation
# --------------------------------------------------------------------------

def dense_init(gen: Optional[torch.Generator], shape: Sequence[int],
               in_axis: int = 0, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """Truncated-normal fan-in init: N(0, 1) cut to [-2, 2], times
    1/sqrt(shape[in_axis]); drawn in float32, then cast."""
    t = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * (1.0 / math.sqrt(shape[in_axis]))).to(dtype)


def embed_init(gen: Optional[torch.Generator], shape: Sequence[int],
               dtype=torch.float32, device=None) -> torch.Tensor:
    """N(0, 0.02^2), drawn in float32, then cast."""
    t = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    t.normal_(0.0, 1.0, generator=gen)
    return (t * 0.02).to(dtype)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in float32, scaled by ``1 + scale`` (a zero-init scale is
    the identity), returned in x's type."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


# --------------------------------------------------------------------------
# rotary position embedding
# --------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float = 10000.0) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, D even); positions: (S,).  The half-split layout (first
    half rotated against the second).  As in the reference, the
    frequencies are cast to x's type before the angle is taken, so in
    bfloat16 they are bfloat16-rounded; the angle, cos and sin are float32,
    and cos and sin are cast to x's type."""
    d = x.shape[-1]
    freqs = torch.as_tensor(rope_frequencies(d, theta), dtype=x.dtype,
                            device=x.device)
    ang = positions[..., :, None].float() * freqs[None, :]
    cos = torch.cos(ang).to(x.dtype)
    sin = torch.sin(ang).to(x.dtype)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# --------------------------------------------------------------------------
# loss
# --------------------------------------------------------------------------

def softmax_xent_chunked(x: torch.Tensor, emb: torch.Tensor,
                         labels: torch.Tensor, chunk: int = 512,
                         softcap: float = 0.0) -> torch.Tensor:
    """Mean cross-entropy of ``labels`` (B, S) under the logits ``x @
    emb^T``, with the unembedding fused per sequence chunk of ``chunk``
    (the whole sequence when S % chunk != 0), so the full (B, S, V) logits
    never exist at once.  Logits are float32 from float32-cast inputs,
    soft-capped by ``softcap`` (gemma2's final cap) when it is nonzero;
    the row max is held constant for the gradient (the reference's
    ``stop_gradient``).  Returns the float32 sum over the chunks divided
    by B * S."""
    b, s, _ = x.shape
    if s % chunk:
        chunk = s
    embf = emb.float()
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, chunk):
        logits = x[:, c0:c0 + chunk].float() @ embf.t()
        if softcap:
            logits = softcap * torch.tanh(logits / softcap)
        m = logits.amax(dim=-1, keepdim=True).detach()
        lse = torch.log(torch.exp(logits - m).sum(dim=-1)) + m[..., 0]
        gold = logits.gather(
            -1, labels[:, c0:c0 + chunk, None].long())[..., 0]
        total = total + (lse - gold).sum()
    return total / (b * s)
