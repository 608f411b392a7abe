"""Grouped-query attention (sliding window, soft-cap, QK-norm): init, the
full-sequence pass of prefill and the one-token decode on a ring cache.

Port of the GQA half of ``repro/models/attention.py`` for one device.  MLA
and cross-attention are not ported yet (ROADMAP A3).

The reference picks its full-sequence attention with
``AttnConfig.use_flash``: the Pallas kernel when set, else ``_sdpa``, a
chunked jnp attention kept so that GSPMD owns the sharding on the TPU.  The
port keeps the field for config parity but dispatches by device, as its
other kernels do: :func:`gqa_fwd` calls
:func:`repro_torch.kernels.ops.flash_attention` (the cached wrapper of
:func:`repro_torch.kernels.flash_attention.flash_attention`), which launches
the CUDA kernel on a CUDA tensor and runs the kernel's plain version (a
chunked dense softmax, the port's ``_sdpa``) on a CPU tensor.  Both
reference paths compute that function within the reference's tolerances
(``tests/test_kernels.py:74-111``), and the CPU tests hold the port against
both.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch

from ..kernels.flash_attention import NEG_INF
from ..kernels.ops import flash_attention
from .common import apply_rope, dense_init, rms_norm

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    causal: bool = True
    window: Optional[int] = None          # sliding window (gemma2 local)
    softcap: Optional[float] = None       # logit soft-capping (gemma2)
    qk_norm: bool = False
    rope_theta: float = 10000.0
    use_flash: bool = False               # read by no code; see module doc


def init_gqa(gen: Optional[torch.Generator], cfg: AttnConfig,
             dtype=torch.bfloat16, device=None) -> Params:
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    p = {
        "wq": dense_init(gen, (d, h * hd), 0, dtype, device),
        "wk": dense_init(gen, (d, kvh * hd), 0, dtype, device),
        "wv": dense_init(gen, (d, kvh * hd), 0, dtype, device),
        "wo": dense_init(gen, (h * hd, d), 0, dtype, device),
    }
    if cfg.qk_norm:
        p["q_scale"] = torch.zeros((hd,), dtype=dtype, device=device)
        p["k_scale"] = torch.zeros((hd,), dtype=dtype, device=device)
    return p


def _project(p, x: torch.Tensor, cfg: AttnConfig, positions: torch.Tensor):
    """q (B, H, S, D), k and v (B, Hkv, S, D): projected, QK-normed and
    rotated as in the reference."""
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    q = (x @ p["wq"]).view(b, s, h, hd)
    k = (x @ p["wk"]).view(b, s, kvh, hd)
    v = (x @ p["wv"]).view(b, s, kvh, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_scale"])
        k = rms_norm(k, p["k_scale"])
    q = apply_rope(q.transpose(1, 2), positions, cfg.rope_theta)
    k = apply_rope(k.transpose(1, 2), positions, cfg.rope_theta)
    return q, k, v.transpose(1, 2)


def gqa_fwd(p, x: torch.Tensor, cfg: AttnConfig,
            positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence attention.  x: (B, S, d_model) -> (B, S, d_model).
    (The reference can also return the K/V as a cache; the port's prefill
    returns none, as the reference's serving path.)"""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q, k, v = _project(p, x, cfg, positions)
    o = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                        causal=cfg.causal, window=cfg.window,
                        softcap=cfg.softcap)
    o = o.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.head_dim)
    return o @ p["wo"]


def gqa_decode(p, x: torch.Tensor, cache: Dict[str, torch.Tensor],
               cfg: AttnConfig, pos: int):
    """One-token decode.  x: (B, 1, d_model); cache ``k``/``v``:
    (B, Hkv, S_cache, D) and ``pos``: (S_cache,) int32, the absolute
    position held in each slot (-1 = empty).

    The cache is a ring buffer: the new K/V go to slot ``pos % S_cache``.
    For full-context layers S_cache = S_max and the ring index is the
    identity; for sliding-window layers S_cache = window.  Validity comes
    from the per-slot positions, so both layouts share one code path.  The
    cache is updated in place (the reference returns a new one; in place
    saves a copy of every layer's cache per step) and returned.

    As in the reference, the scores and the value product take operands in
    the cache's type and return float32 (the reference's
    ``preferred_element_type``): the products of two bf16 values are exact
    in float32, so the operands are widened and multiplied in float32."""
    b = x.shape[0]
    h, kvh, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    pos = int(pos)
    posv = torch.full((1,), pos, device=x.device)
    q, k_new, v_new = _project(p, x, cfg, posv)      # q (B, H, 1, D)
    k, v, slot_pos = cache["k"], cache["v"], cache["pos"]
    slot = pos % k.shape[2]
    k[:, :, slot] = k_new[:, :, 0].to(k.dtype)
    v[:, :, slot] = v_new[:, :, 0].to(v.dtype)
    slot_pos[slot] = pos
    group = h // kvh
    qg = q.reshape(b, kvh, group, hd).to(k.dtype).float()
    scores = torch.matmul(qg, k.float().transpose(-1, -2)) / math.sqrt(hd)
    if cfg.softcap is not None:
        scores = cfg.softcap * torch.tanh(scores / cfg.softcap)
    valid = (slot_pos >= 0) & (slot_pos <= pos)
    if cfg.window is not None:
        valid &= slot_pos > pos - cfg.window
    scores = scores.masked_fill(~valid, NEG_INF)
    pattn = torch.softmax(scores, dim=-1)
    o = torch.matmul(pattn.to(v.dtype).float(), v.float())  # (B, Hkv, G, D)
    o = o.reshape(b, 1, h * hd).to(x.dtype)
    return o @ p["wo"], cache
