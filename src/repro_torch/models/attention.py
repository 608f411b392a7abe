"""Attention variants on one device: grouped-query attention (sliding
window, soft-cap, QK-norm), MLA (minicpm3's latent KV) and gated
cross-attention (llama-3.2-vision's image layers).  Each has an init, a
full-sequence pass (prefill) and a one-token decode (cross-attention has no
cache: it re-projects the image context every step, as the reference).
Each full-sequence pass also runs on the model shards of a mesh, head
parallel (:func:`gqa_fwd_mesh`, :func:`mla_fwd_mesh`,
:func:`cross_fwd_mesh`: heads split by the reference's ``heads_x_dim``
and ``kv_x_dim`` columns, one all-reduce of the ``wo`` partials); each
module keeps the reference's logical axes of its leaves (``GQA_AXES``,
``MLA_AXES``, ``CROSS_AXES``).

Port of ``repro/models/attention.py``.  The reference picks its GQA
full-sequence attention with ``AttnConfig.use_flash``: the Pallas kernel
when set, else ``_sdpa``, a chunked jnp attention kept so that GSPMD owns
the sharding on the TPU.  The port keeps the field for config parity but
dispatches by device, as its other kernels do: :func:`gqa_fwd` calls
:func:`repro_torch.kernels.ops.flash_attention` (the cached wrapper of
:func:`repro_torch.kernels.flash_attention.flash_attention`), which launches
the CUDA kernel on a CUDA tensor and runs the kernel's plain version (a
chunked dense softmax, the port's ``_sdpa``) on a CPU tensor.  Training
differentiates either: on the card through the kernel's autograd Function,
whose backward is the hand-written backward kernels (as the reference's
gradient is XLA's derivative of ``_sdpa``), on the CPU by autograd of the
plain version.  Both
reference paths compute that function within the reference's tolerances
(``tests/test_kernels.py:74-111``), and the CPU tests hold the port against
both.

MLA and cross-attention run in plain ops on every device, because the
reference computes them in plain jnp ops and never reaches a Pallas kernel:
:func:`mla_fwd` is the reference's expanded causal attention over query
chunks, :func:`mla_decode` its weight-absorbed form on the latent cache,
and :func:`cross_fwd` calls :func:`_sdpa`, the counterpart of the
reference's ``_sdpa`` (non-causal, Sq != Skv).  On a mesh MLA is head
parallel whatever the reference's ``FLAGS["mla_seq_parallel"]`` says: that
flag only constrains the query rows' layout, the function is the same,
and the weights already lie split by heads, so one all-reduce and no
weight regather computes it.  The reference's ``MLAConfig.seq_parallel``
(its ``ArchConfig.seq_parallel``, which replicates the block weights) is
read by :class:`~repro_torch.models.sharded_lm.ShardedLM`, which then runs
each model shard's block of query rows (``mla_fwd(..., rows=)``); the
port's ``MLAConfig`` leaves the field out.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

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


#: the reference's logical axes of the GQA leaves (``GQA_AXES``)
GQA_AXES = {
    "wq": ("embed", "heads_x_dim"),
    "wk": ("embed", "kv_x_dim"),
    "wv": ("embed", "kv_x_dim"),
    "wo": ("heads_x_dim", "embed"),
    "q_scale": (None,),
    "k_scale": (None,),
}


def _project(p, x: torch.Tensor, cfg: AttnConfig, positions: torch.Tensor):
    """q (B, H, S, D), k and v (B, Hkv, S, D): projected, QK-normed and
    rotated as in the reference."""
    return _heads(p, x @ p["wq"], x @ p["wk"], x @ p["wv"], cfg, positions)


def _heads(p, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           cfg: AttnConfig, positions: torch.Tensor):
    """Projected q (B, S, nq * D) and k, v (B, S, nk * D), whole heads,
    QK-normed and rotated: q (B, nq, S, D), k and v (B, nk, S, D)."""
    b, s, _ = q.shape
    hd = cfg.head_dim
    q = q.view(b, s, -1, hd)
    k = k.view(b, s, -1, hd)
    v = v.view(b, s, -1, hd)
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


@dataclasses.dataclass(frozen=True)
class GQAShardPlan:
    """What one model shard computes of a GQA layer on a mesh.  Ranges
    are of the flat projection columns (``wq``'s H * D, ``wk``'s
    Hkv * D) or of heads."""
    q_own: Tuple[int, int]          # its columns of wq, and rows of wo
    kv_own: Tuple[int, int]         # its columns of wk and wv
    heads: Tuple[int, int]          # the query heads it attends
    kv_heads: Tuple[int, int]       # the KV heads they read
    #: the local KV head of each local query head where the kernel's
    #: grouping (query head i reads KV head i // (nq // nk)) differs
    kv_index: Optional[Tuple[int, ...]]


def gqa_mesh_plan(cfg: AttnConfig, n_model: int, q_split: bool,
                  kv_split: bool) -> List[GQAShardPlan]:
    """Each model shard's part of a GQA layer: ``wq``'s columns and
    ``wo``'s rows in equal blocks when ``q_split`` (the reference's
    ``heads_x_dim`` on the model axis), ``wk``'s and ``wv``'s columns when
    ``kv_split`` (``kv_x_dim``), the whole matrix otherwise.  A shard
    attends every head its block of ``wo``'s rows touches, so that a
    block that ends inside a head (a flat axis that divides where the
    head count does not) computes that head whole, as its neighbour does;
    it reads the KV heads of those query heads, whoever holds their
    columns."""
    hd, h, kvh = cfg.head_dim, cfg.n_heads, cfg.n_kv
    group = h // kvh

    def block(width, split, m):
        if not split:
            return (0, width)
        return (m * width // n_model, (m + 1) * width // n_model)

    plans = []
    for m in range(n_model):
        q_own = block(h * hd, q_split, m)
        h_lo, h_hi = q_own[0] // hd, -(-q_own[1] // hd)
        k_lo, k_hi = h_lo // group, (h_hi - 1) // group + 1
        nq, nk = h_hi - h_lo, k_hi - k_lo
        idx = tuple((h_lo + i) // group - k_lo for i in range(nq))
        natural = nq % nk == 0 and \
            idx == tuple(i // (nq // nk) for i in range(nq))
        plans.append(GQAShardPlan(q_own, block(kvh * hd, kv_split, m),
                                  (h_lo, h_hi), (k_lo, k_hi),
                                  None if natural else idx))
    return plans


def gqa_fwd_mesh(ps, xs: List[torch.Tensor], cfg: AttnConfig,
                 plans: List[GQAShardPlan], comm, group: Sequence[int],
                 positions: List[torch.Tensor]) -> List[torch.Tensor]:
    """:func:`gqa_fwd` of one data replica over its model shards
    ``group``: member ``j`` holds the replicated input ``xs[j]`` (B, S,
    d_model), its slices ``ps[j]`` of the layer's weights as
    ``plans[j]`` says, and its device's ``positions[j]``.  Each member
    projects its columns, gets the whole heads it attends (pieces that
    other members projected come by :meth:`MeshComm.regather`), runs the
    ``flash_attention`` kernel on them, multiplies its part of the output
    by its rows of ``wo``, and the partial products are summed over the
    group (:meth:`MeshComm.all_reduce`) when ``wo``'s rows are split.
    Returns each member's (B, S, d_model) output."""
    hd = cfg.head_dim
    q_split = plans[0].q_own != (0, cfg.n_heads * hd)
    qs, ks, vs = _gather_heads(comm, group, plans, hd,
                               *([x @ p[w] for p, x in zip(ps, xs)]
                                 for w in ("wq", "wk", "wv")))
    outs = []
    for p, pl, q, k, v, pos in zip(ps, plans, qs, ks, vs, positions):
        b, s, _ = q.shape
        q, k, v = _heads(p, q.contiguous(), k.contiguous(), v.contiguous(),
                         cfg, pos)
        k, v = _kv_for_group(pl, k, v)
        o = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            causal=cfg.causal, window=cfg.window,
                            softcap=cfg.softcap)
        outs.append(_wo_partial(p, pl, o, hd))
    return comm.all_reduce(outs, group, "attn") if q_split else outs


def _gather_heads(comm, group, plans: List[GQAShardPlan], hd: int,
                  q_parts, k_parts, v_parts):
    """Each member's projected columns (its ``q_own`` of q, ``kv_own`` of
    k and v) regathered into the whole heads it attends (``heads``,
    ``kv_heads``; :meth:`MeshComm.regather`): (qs, ks, vs)."""
    def cols(heads):
        return (heads[0] * hd, heads[1] * hd)

    qs = comm.regather(q_parts, group, [pl.q_own for pl in plans],
                       [cols(pl.heads) for pl in plans], 2, "qkv")
    ks, vs = (comm.regather(parts, group, [pl.kv_own for pl in plans],
                            [cols(pl.kv_heads) for pl in plans], 2, "qkv")
              for parts in (k_parts, v_parts))
    return qs, ks, vs


def _kv_for_group(pl: GQAShardPlan, k: torch.Tensor, v: torch.Tensor):
    """k, v (B, nk, S, D) with a KV head per local query head where the
    plan's grouping is not the kernel's (``kv_index``)."""
    if pl.kv_index is None:
        return k, v
    idx = torch.tensor(pl.kv_index, device=k.device)
    return k.index_select(1, idx), v.index_select(1, idx)


def _wo_partial(p, pl: GQAShardPlan, o: torch.Tensor, hd: int):
    """The attention output o (B, nq, S, D) of the member's heads, its
    ``q_own`` columns times its rows of ``wo``: its partial (B, S,
    d_model)."""
    b, nq, s, _ = o.shape
    o = o.transpose(1, 2).reshape(b, s, nq * hd)
    lo = pl.q_own[0] - pl.heads[0] * hd
    return o[..., lo:lo + pl.q_own[1] - pl.q_own[0]] @ p["wo"]


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


# --------------------------------------------------------------------------
# MLA -- multi-head latent attention (MiniCPM3 / DeepSeek-V2 style)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_dim: int = 64
    qk_rope_dim: int = 32
    v_head_dim: int = 64
    rope_theta: float = 10000.0


#: query rows per chunk of :func:`mla_fwd` and :func:`_sdpa` (the
#: reference's)
_Q_CHUNK = 1024


def init_mla(gen: Optional[torch.Generator], cfg: MLAConfig,
             dtype=torch.bfloat16, device=None) -> Params:
    h = cfg.n_heads
    qd = cfg.qk_nope_dim + cfg.qk_rope_dim
    p = {"wq_a": dense_init(gen, (cfg.d_model, cfg.q_lora_rank), 0, dtype,
                            device)}
    p["q_a_scale"] = torch.zeros((cfg.q_lora_rank,), dtype=dtype,
                                 device=device)
    p["wq_b"] = dense_init(gen, (cfg.q_lora_rank, h * qd), 0, dtype, device)
    p["wkv_a"] = dense_init(gen, (cfg.d_model,
                                  cfg.kv_lora_rank + cfg.qk_rope_dim), 0,
                            dtype, device)
    p["kv_a_scale"] = torch.zeros((cfg.kv_lora_rank,), dtype=dtype,
                                  device=device)
    p["wkv_b"] = dense_init(gen, (cfg.kv_lora_rank,
                                  h * (cfg.qk_nope_dim + cfg.v_head_dim)), 0,
                            dtype, device)
    p["wo"] = dense_init(gen, (h * cfg.v_head_dim, cfg.d_model), 0, dtype,
                         device)
    return p


#: the reference's logical axes of the MLA leaves (``MLA_AXES``)
MLA_AXES = {
    "wq_a": ("embed", None),
    "q_a_scale": (None,),
    "wq_b": (None, "heads_x_dim"),
    "wkv_a": ("embed", None),
    "kv_a_scale": (None,),
    "wkv_b": (None, "heads_x_dim"),
    "wo": ("heads_x_dim", "embed"),
}


def _mla_latents(p, xq: torch.Tensor, xk: torch.Tensor, cfg: MLAConfig):
    """The normed query latent of the rows ``xq`` (B, Sq, d_model), and the
    normed kv latent (B, Sk, rank) and unrotated shared k_rope (B, Sk,
    rope) of the rows ``xk``: the projections by the replicated ``wq_a``
    and ``wkv_a``."""
    q_lat = rms_norm(xq @ p["wq_a"], p["q_a_scale"])
    kv_lat, k_rope = (xk @ p["wkv_a"]).split(
        [cfg.kv_lora_rank, cfg.qk_rope_dim], dim=-1)
    return q_lat, rms_norm(kv_lat, p["kv_a_scale"]), k_rope


def _mla_split_q(q: torch.Tensor, cfg: MLAConfig, positions: torch.Tensor):
    """q (B, S, n * (nope + rope)), whole heads: q_nope (B, S, n, nope) and
    q_rope (B, S, n, rope) rotated."""
    b, s, _ = q.shape
    nope, rope = cfg.qk_nope_dim, cfg.qk_rope_dim
    q_nope, q_rope = q.view(b, s, -1, nope + rope).split([nope, rope], dim=-1)
    q_rope = apply_rope(q_rope.transpose(1, 2), positions,
                        cfg.rope_theta).transpose(1, 2)
    return q_nope, q_rope


def _mla_project(p, x: torch.Tensor, cfg: MLAConfig,
                 positions: torch.Tensor):
    """q_nope (B, S, H, nope), q_rope (B, S, H, rope) rotated, the normed
    kv latent (B, S, rank) and k_rope (B, S, rope) rotated, shared by every
    head."""
    q_lat, kv_lat, k_rope = _mla_latents(p, x, x, cfg)
    q_nope, q_rope = _mla_split_q(q_lat @ p["wq_b"], cfg, positions)
    k_rope = apply_rope(k_rope[:, None], positions, cfg.rope_theta)[:, 0]
    return q_nope, q_rope, kv_lat, k_rope


def _mla_attend(q_nope, q_rope, kv: torch.Tensor, k_rope: torch.Tensor,
                cfg: MLAConfig, q0: int, dtype) -> torch.Tensor:
    """The expanded causal attention of the query rows q0 .. q0 + Sq of n
    heads (q_nope (B, Sq, n, nope), q_rope rotated) over the keys of rows
    0 .. Sk (kv (B, Sk, n * (nope + v)), those heads' columns of the
    latent times ``wkv_b``; k_rope (B, Sk, rope) rotated, shared), Sk >=
    q0 + Sq: float32 over query chunks of 1024 rows, each chunk
    multiplying only the key columns up to its last row, q widened to
    float32 before the scale.  Returns (B, Sq, n * v) in ``dtype``."""
    b, sq, n, nope = q_nope.shape
    sk, rope, vd = kv.shape[1], cfg.qk_rope_dim, cfg.v_head_dim
    k_nope, v = kv.view(b, sk, n, nope + vd).split([nope, vd], dim=-1)
    qf = torch.cat([q_nope, q_rope], dim=-1).transpose(1, 2)  # (B,n,Sq,Dq)
    kf = torch.cat([k_nope, k_rope[:, :, None].expand(b, sk, n, rope)],
                   dim=-1).transpose(1, 2).float()
    vf = v.transpose(1, 2).float()
    scale = 1.0 / math.sqrt(nope + rope)
    qc = _Q_CHUNK if sq > _Q_CHUNK and sq % _Q_CHUNK == 0 else sq
    rows = torch.arange(q0 + sq, device=q_nope.device)
    outs = []
    for a in range(0, sq, qc):
        lo, hi = q0 + a, q0 + a + qc
        sc = torch.matmul(qf[:, :, a:a + qc].float() * scale,
                          kf[:, :, :hi].transpose(-1, -2))  # column skip
        sc.masked_fill_(rows[None, :hi] > rows[lo:hi, None], NEG_INF)
        outs.append(torch.matmul(torch.softmax(sc, dim=-1), vf[:, :, :hi]))
        del sc
    o = outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)
    return o.transpose(1, 2).reshape(b, sq, n * vd).to(dtype)


def mla_fwd(p, x: torch.Tensor, cfg: MLAConfig,
            positions: Optional[torch.Tensor] = None,
            rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """MLA full-sequence pass, the reference's expanded form: the latent
    expanded to per-head K (nope part, plus the shared rope part) and V,
    then causal attention in float32 over query chunks of 1024 rows, each
    chunk multiplying only the key columns up to its last row.  As in the
    reference, q is widened to float32 before it is scaled by
    1/sqrt(nope + rope).  x: (B, S, d_model) -> (B, S, d_model).  (The
    reference can also return the latent as a cache; the port's prefill
    returns none, as the reference's serving path.)  With ``rows`` (r0,
    r1), only the output rows r0 .. r1, attending the keys of rows 0 ..
    r1: a model shard's block of a sequence-parallel layer."""
    b, s, _ = x.shape
    r0, r1 = rows or (0, s)
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q_lat, kv_lat, k_rope = _mla_latents(p, x[:, r0:r1], x[:, :r1], cfg)
    q_nope, q_rope = _mla_split_q(q_lat @ p["wq_b"], cfg, positions[r0:r1])
    k_rope = apply_rope(k_rope[:, None], positions[:r1],
                        cfg.rope_theta)[:, 0]
    o = _mla_attend(q_nope, q_rope, kv_lat @ p["wkv_b"], k_rope, cfg, r0,
                    x.dtype)
    return o @ p["wo"]


@dataclasses.dataclass(frozen=True)
class MLAShardPlan:
    """What one model shard computes of an MLA layer on a mesh: ranges of
    the flat columns of ``wq_b`` (H * (nope + rope)) and ``wkv_b``
    (H * (nope + v)), of ``wo``'s rows (H * v), and of heads."""
    q_own: Tuple[int, int]          # its columns of wq_b
    kv_own: Tuple[int, int]         # its columns of wkv_b
    o_own: Tuple[int, int]          # its rows of wo
    heads: Tuple[int, int]          # the heads it attends


def mla_mesh_plan(cfg: MLAConfig, n_model: int, q_split: bool,
                  kv_split: bool, o_split: bool) -> List[MLAShardPlan]:
    """Each model shard's part of an MLA layer: equal blocks of ``wq_b``'s
    and ``wkv_b``'s columns and of ``wo``'s rows where the reference's
    ``heads_x_dim`` splits them on the model axis (``q_split``,
    ``kv_split``, ``o_split``), the whole matrix otherwise.  The three
    have different widths a head (nope + rope, nope + v and v), so a
    block may end inside a head in one and not in another: a shard
    attends every head its block of ``wo``'s rows touches, whole, and
    reads the columns of those heads whoever projected them, as
    :func:`gqa_mesh_plan` does."""
    h, vd = cfg.n_heads, cfg.v_head_dim
    qd, kvd = cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.qk_nope_dim + vd

    def block(width, split, m):
        if not split:
            return (0, width)
        return (m * width // n_model, (m + 1) * width // n_model)

    plans = []
    for m in range(n_model):
        o_own = block(h * vd, o_split, m)
        plans.append(MLAShardPlan(block(h * qd, q_split, m),
                                  block(h * kvd, kv_split, m), o_own,
                                  (o_own[0] // vd, -(-o_own[1] // vd))))
    return plans


def mla_fwd_mesh(ps, xs: List[torch.Tensor], cfg: MLAConfig,
                 plans: List[MLAShardPlan], comm, group: Sequence[int],
                 positions: List[torch.Tensor]) -> List[torch.Tensor]:
    """:func:`mla_fwd` of one data replica over its model shards
    ``group``, head parallel: member ``j`` holds the replicated input
    ``xs[j]`` (B, S, d_model), the replicated ``wq_a``, ``wkv_a`` and
    norm scales, and its slices ``ps[j]`` of ``wq_b``, ``wkv_b`` and
    ``wo`` as ``plans[j]`` says.  Each member projects both latents, then
    its columns of ``wq_b`` and ``wkv_b``; gets the whole heads it attends
    (pieces other members projected come by :meth:`MeshComm.regather`);
    attends them as :func:`mla_fwd` does; multiplies its part of the
    output by its rows of ``wo``; and the partial products are summed
    over the group (:meth:`MeshComm.all_reduce`, in float32, rounded
    once) when ``wo``'s rows are split.  Returns each member's (B, S,
    d_model) output."""
    vd = cfg.v_head_dim
    qd, kvd = cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.qk_nope_dim + vd
    o_split = plans[0].o_own != (0, cfg.n_heads * vd)
    lats = [_mla_latents(p, x, x, cfg) for p, x in zip(ps, xs)]
    qs = comm.regather([q_lat @ p["wq_b"] for p, (q_lat, _, _) in
                        zip(ps, lats)], group, [pl.q_own for pl in plans],
                       [(pl.heads[0] * qd, pl.heads[1] * qd)
                        for pl in plans], 2, "qkv")
    kvs = comm.regather([kv_lat @ p["wkv_b"] for p, (_, kv_lat, _) in
                         zip(ps, lats)], group, [pl.kv_own for pl in plans],
                        [(pl.heads[0] * kvd, pl.heads[1] * kvd)
                         for pl in plans], 2, "qkv")
    outs = []
    for p, pl, x, q, kv, (_, _, k_rope), pos in zip(ps, plans, xs, qs, kvs,
                                                    lats, positions):
        q_nope, q_rope = _mla_split_q(q, cfg, pos)
        k_rope = apply_rope(k_rope[:, None], pos, cfg.rope_theta)[:, 0]
        o = _mla_attend(q_nope, q_rope, kv, k_rope, cfg, 0, x.dtype)
        lo = pl.o_own[0] - pl.heads[0] * vd
        outs.append(o[..., lo:lo + pl.o_own[1] - pl.o_own[0]] @ p["wo"])
    return comm.all_reduce(outs, group, "attn") if o_split else outs


def mla_decode(p, x: torch.Tensor, cache: Dict[str, torch.Tensor],
               cfg: MLAConfig, pos: int):
    """One-token decode on the latent cache, in the reference's
    weight-absorbed form (DeepSeek-V2 App. C): ``wkv_b``'s key half is
    folded into the query and its value half applied after attention, so
    the step's cost is linear in the cache length with rank-sized inner
    dimensions.  x: (B, 1, d_model); cache ``kv_lat`` (B, S_max, rank),
    ``k_rope`` (B, S_max, rope) and ``pos`` (S_max,) int32, the position
    held in each slot (-1 = empty); the new entries go to slot ``pos`` (no
    ring: MLA layers are full-context).  The cache is updated in place and
    returned.

    Each of the reference's ``preferred_element_type=float32`` products
    widens its operands, in the types the reference gives them, to float32
    (exact: a product of two bf16 values is exact in float32), and the
    reference's roundings stay where they are: q_abs to the cache's type
    before the score product, the attention weights to the cache's type,
    and the latent output to ``wkv_b``'s type."""
    b = x.shape[0]
    h, nope = cfg.n_heads, cfg.qk_nope_dim
    pos = int(pos)
    posv = torch.full((1,), pos, device=x.device)
    q_nope, q_rope, lat_new, rope_new = _mla_project(p, x, cfg, posv)
    kv_lat, k_rope, slot_pos = cache["kv_lat"], cache["k_rope"], cache["pos"]
    kv_lat[:, pos] = lat_new[:, 0].to(kv_lat.dtype)
    k_rope[:, pos] = rope_new[:, 0].to(k_rope.dtype)
    slot_pos[pos] = pos
    wkv = p["wkv_b"].view(cfg.kv_lora_rank, h, nope + cfg.v_head_dim)
    wk, wv = wkv.split([nope, cfg.v_head_dim], dim=-1)
    # (B, H, rank): q_nope (B, 1, H, nope) against wk (rank, H, nope)
    q_abs = torch.einsum("bhd,rhd->bhr", q_nope[:, 0].float(), wk.float())
    lat = kv_lat.float()
    s_nope = torch.matmul(q_abs.to(kv_lat.dtype).float(),
                          lat.transpose(1, 2))             # (B, H, S_max)
    s_rope = torch.matmul(q_rope[:, 0].to(k_rope.dtype).float(),
                          k_rope.float().transpose(1, 2))
    scores = (s_nope + s_rope) * (1.0 / math.sqrt(nope + cfg.qk_rope_dim))
    valid = (slot_pos >= 0) & (slot_pos <= pos)
    scores = scores.masked_fill(~valid, NEG_INF)
    attn = torch.softmax(scores, dim=-1)
    o_lat = torch.matmul(attn.to(kv_lat.dtype).float(), lat)  # (B, H, rank)
    o = torch.einsum("bhr,rhd->bhd", o_lat.to(wv.dtype).float(), wv.float())
    o = o.reshape(b, 1, h * cfg.v_head_dim).to(x.dtype)
    return o @ p["wo"], cache


# --------------------------------------------------------------------------
# cross-attention (llama-3.2-vision image layers; stub patch embeddings)
# --------------------------------------------------------------------------

def init_cross(gen: Optional[torch.Generator], cfg: AttnConfig,
               dtype=torch.bfloat16, device=None) -> Params:
    """GQA weights, per-head QK-norm scales and a 0-d tanh gate, zero as
    the reference's (so an untrained layer adds nothing)."""
    p = init_gqa(gen, cfg, dtype, device)
    p["q_scale"] = torch.zeros((cfg.head_dim,), dtype=dtype, device=device)
    p["k_scale"] = torch.zeros((cfg.head_dim,), dtype=dtype, device=device)
    p["gate"] = torch.zeros((), dtype=dtype, device=device)
    return p


#: the logical axes of the cross-attention leaves: GQA's and the 0-d gate
CROSS_AXES = dict(GQA_AXES, gate=())


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Non-causal attention of q (B, Hq, Sq, D) over k, v (B, Hkv, Skv, D),
    any Sq and Skv, Hq a multiple of Hkv; float32 softmax over query chunks
    of 1024 rows, the result in q's type.

    The counterpart of the reference's ``_sdpa`` (``repro/models/
    attention.py``) with no mask and no cap, the only form the reference's
    cross-attention calls.  It mirrors that plain path; it is not a
    fallback for the flash kernel (whose plain version, its oracle, takes
    Sq == Skv only)."""
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    kf = k.float()[:, :, None].transpose(-1, -2)     # (B, Hkv, 1, D, Skv)
    vf = v.float()[:, :, None]
    scale = 1.0 / math.sqrt(d)
    qc = _Q_CHUNK if sq > _Q_CHUNK and sq % _Q_CHUNK == 0 else sq
    outs = []
    for q0 in range(0, sq, qc):
        qb = q[:, :, q0:q0 + qc].float() * scale
        qb = qb.reshape(b, hkv, hq // hkv, -1, d)
        pr = torch.softmax(torch.matmul(qb, kf), dim=-1)
        outs.append(torch.matmul(pr, vf).reshape(b, hq, -1, d))
    o = outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)
    return o.to(q.dtype)


def cross_fwd(p, x: torch.Tensor, ctx: torch.Tensor,
              cfg: AttnConfig) -> torch.Tensor:
    """Text rows x (B, S, d_model) attend, without a mask, over the image
    context ctx (B, n_ctx, d_model): per-head RMS-normed q and k, no RoPE;
    the output ``tanh(gate) * (o @ wo)``.  The decode step calls it on the
    one new row."""
    b, s, _ = x.shape
    sk = ctx.shape[1]
    h, kvh, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    q = rms_norm((x @ p["wq"]).view(b, s, h, hd), p["q_scale"])
    k = rms_norm((ctx @ p["wk"]).view(b, sk, kvh, hd), p["k_scale"])
    v = (ctx @ p["wv"]).view(b, sk, kvh, hd)
    o = _sdpa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    o = o.transpose(1, 2).reshape(b, s, h * hd)
    return torch.tanh(p["gate"]) * (o @ p["wo"])


def cross_fwd_mesh(ps, xs: List[torch.Tensor], ctxs: List[torch.Tensor],
                   cfg: AttnConfig, plans: List[GQAShardPlan], comm,
                   group: Sequence[int]) -> List[torch.Tensor]:
    """:func:`cross_fwd` of one data replica over its model shards
    ``group``: member ``j`` holds the replicated text rows ``xs[j]`` (B, S,
    d_model) and image context ``ctxs[j]`` (B, n_ctx, d_model), the
    replicated norm scales and gate, and its slices ``ps[j]`` of ``wq``,
    ``wk``, ``wv`` and ``wo`` as ``plans[j]`` (:func:`gqa_mesh_plan`)
    says.  Each member projects q from the text rows and k, v from the
    context by its columns; gets the whole heads it attends (pieces other
    members projected come by :meth:`MeshComm.regather`), since the
    per-head RMS norms of q and k need the whole head; attends them by
    :func:`_sdpa`; multiplies its part of the output by its rows of
    ``wo``; sums the partial products over the group
    (:meth:`MeshComm.all_reduce`) when ``wo``'s rows are split; and only
    then multiplies by ``tanh(gate)``, as the reference multiplies the
    whole product.  Returns each member's (B, S, d_model) output."""
    hd = cfg.head_dim
    q_split = plans[0].q_own != (0, cfg.n_heads * hd)
    qs, ks, vs = _gather_heads(
        comm, group, plans, hd, [x @ p["wq"] for p, x in zip(ps, xs)],
        *([c @ p[w] for p, c in zip(ps, ctxs)] for w in ("wk", "wv")))
    outs = []
    for p, pl, q, k, v in zip(ps, plans, qs, ks, vs):
        b, s, _ = q.shape
        sk = k.shape[1]
        q = rms_norm(q.view(b, s, -1, hd), p["q_scale"]).transpose(1, 2)
        k = rms_norm(k.view(b, sk, -1, hd), p["k_scale"]).transpose(1, 2)
        k, v = _kv_for_group(pl, k, v.view(b, sk, -1, hd).transpose(1, 2))
        outs.append(_wo_partial(p, pl, _sdpa(q, k, v), hd))
    if q_split:
        outs = comm.all_reduce(outs, group, "attn")
    return [torch.tanh(p["gate"]) * o for p, o in zip(ps, outs)]
