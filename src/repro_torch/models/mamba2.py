"""Mamba2 (SSD) block: zamba2-7b's backbone, on one device or head
parallel on the model shards of a mesh (:func:`mamba2_fwd_mesh`).

Port of ``repro/models/mamba2.py``.  The full-sequence pass is the
*chunked* state-space-dual algorithm (Mamba2 paper SS6): the sequence is
cut into chunks of length L; within a chunk the output is an
attention-like masked matrix product, across chunks a loop over the
``nc`` chunks carries the (H, P, N) state (the reference's ``lax.scan``).
Decode is the O(1) recurrent update ``S <- a S + dt B x^T; y = C S`` on a
float32 state.

The reference computes the block in plain jnp ops and reaches no Pallas
kernel, so the port computes it in plain torch ops on every device.  Every
rounding of the reference is kept: in a bf16 model the decays and their
cumulative sums are float32, ``exp(decay)`` is cast to the compute type,
``C.B`` and ``x dt`` are in the compute type, the chunk states and the
inter-chunk recurrence are float32.  One departure, in the gradient
alone: the intra-chunk decays are masked before their exp, where the
reference masks after it; the outputs are the same bits, and where
``exp(cum_t - cum_s)`` above the diagonal overflows (zamba2's widths in
any chunk of 256) the gradient stays finite, where the reference's is
NaN.  The reference's
``FLAGS["mamba_head_constraints"]`` only constrains ``xh`` and ``dt`` to
``heads_inner``, a layout of the same function, so nothing here reads
it: on a mesh the ``inner`` leaves already lie split by heads, each shard
runs the SSD on its heads, and the gated norm's sum of squares and the
``out_proj`` partials are the only things summed over the shards.

Layout: d_inner = expand * d_model, H = d_inner / P heads of P = head_dim,
B and C shared across heads (one group), state N = d_state.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from .common import dense_init, rms_norm

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class Mamba2Config:
    d_model: int
    d_state: int = 64               # N  (zamba2: ssm_state=64)
    head_dim: int = 64              # P
    expand: int = 2
    conv_width: int = 4
    chunk: int = 256                # SSD chunk length L
    dt_min: float = 1e-3
    dt_max: float = 0.1

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        if self.d_inner % self.head_dim:
            raise ValueError(f"d_inner {self.d_inner} is not a multiple of "
                             f"head_dim {self.head_dim}")
        return self.d_inner // self.head_dim

    @property
    def d_conv_ch(self) -> int:     # channels through the causal conv
        return self.d_inner + 2 * self.d_state


def init_mamba2(gen: Optional[torch.Generator], cfg: Mamba2Config,
                dtype=torch.bfloat16, device=None) -> Params:
    """The reference's leaves and distributions: separate z / x / B / C /
    dt projections (fan-in truncated normal), N(0, 0.1^2) conv taps with
    zero biases, ``dt_bias`` the softplus inverse of a log-uniform dt in
    [dt_min, dt_max], ``a_log = log(1..H)``, ``d_skip`` ones (those three
    float32 whatever ``dtype``), a zero norm scale."""
    di, n, h = cfg.d_inner, cfg.d_state, cfg.n_heads

    def normal(shape, std):
        t = torch.empty(shape, dtype=torch.float32, device=device)
        t.normal_(0.0, 1.0, generator=gen)
        return (t * std).to(dtype)

    u = torch.empty((h,), dtype=torch.float32, device=device)
    u.uniform_(0.0, 1.0, generator=gen)
    dt = torch.exp(u * (math.log(cfg.dt_max) - math.log(cfg.dt_min))
                   + math.log(cfg.dt_min))
    return {
        "w_z": dense_init(gen, (cfg.d_model, di), 0, dtype, device),
        "w_x": dense_init(gen, (cfg.d_model, di), 0, dtype, device),
        "w_B": dense_init(gen, (cfg.d_model, n), 0, dtype, device),
        "w_C": dense_init(gen, (cfg.d_model, n), 0, dtype, device),
        "w_dt": dense_init(gen, (cfg.d_model, h), 0, dtype, device),
        "conv_x": normal((cfg.conv_width, di), 0.1),
        "conv_xb": torch.zeros((di,), dtype=dtype, device=device),
        "conv_B": normal((cfg.conv_width, n), 0.1),
        "conv_Bb": torch.zeros((n,), dtype=dtype, device=device),
        "conv_C": normal((cfg.conv_width, n), 0.1),
        "conv_Cb": torch.zeros((n,), dtype=dtype, device=device),
        "dt_bias": torch.log(torch.expm1(dt)),                # softplus^-1
        "a_log": torch.log(torch.arange(1, h + 1, dtype=torch.float32,
                                        device=device)),
        "d_skip": torch.ones((h,), dtype=torch.float32, device=device),
        "norm_scale": torch.zeros((di,), dtype=dtype, device=device),
        "out_proj": dense_init(gen, (di, cfg.d_model), 0, dtype, device),
    }


def _silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` with ``sigmoid(x) = 1 / (1 + exp(-x))``, every
    step rounded in x's type: ``jax.nn.silu`` as XLA expands it on the
    CPU (``exp``, ``add``, ``divide``, ``multiply``, each rounded)."""
    return x * (1 / (1 + torch.exp(-x)))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as ``logaddexp(x, 0)`` (``jax.nn.softplus``)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


#: the reference's logical axes of the Mamba2 leaves (``MAMBA2_AXES``)
MAMBA2_AXES = {
    "w_z": ("embed", "inner"),
    "w_x": ("embed", "inner"),
    "w_B": ("embed", None),
    "w_C": ("embed", None),
    "w_dt": ("embed", None),
    "conv_x": (None, "inner"),
    "conv_xb": ("inner",),
    "conv_B": (None, None),
    "conv_Bb": (None,),
    "conv_C": (None, None),
    "conv_Cb": (None,),
    "dt_bias": (None,),
    "a_log": (None,),
    "d_skip": (None,),
    "norm_scale": ("inner",),
    "out_proj": ("inner", "embed"),
}


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d and SiLU.  xbc: (B, S, C); w: (W, C); state:
    the last W-1 inputs before xbc, (B, W-1, C), or None (zeros).  Returns
    (out, new_state), the new state the last W-1 rows of [state, xbc].  The
    taps are summed in order 0..W-1 in x's type, as the reference's
    Python ``sum``."""
    bsz, s, c = xbc.shape
    width = w.shape[0]
    if state is None:
        state = torch.zeros((bsz, width - 1, c), dtype=xbc.dtype,
                            device=xbc.device)
    padded = torch.cat([state, xbc], dim=1)                  # (B, S+W-1, C)
    out = padded[:, 0:s] * w[0]
    for i in range(1, width):
        out = out + padded[:, i:i + s] * w[i]
    new_state = padded[:, -(width - 1):] if width > 1 else state
    return _silu(out + b), new_state


#: RMS norm in float32 scaled by ``1 + scale`` (eps 1e-6), returned in
#: x's type: the reference's ``_rms``, which is ``common.rms_norm``
_rms = rms_norm


def _ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, cfg: Mamba2Config,
                 init_state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD.  xh: (Bz, S, H, P) in the compute type; dt: (Bz, S, H)
    float32; a: (H,) float32 (negative); B, C: (Bz, S, N) float32.
    Returns (y (Bz, S, H, P) in the compute type, the final state
    (Bz, H, P, N) float32).

    The intra-chunk decay tensor is laid out (Bz, nc, H, L, L), the
    reference's (Bz, nc, L, L, H) with the heads ahead of the rows, so that
    its product with x dt is one batched matrix product; the elements and
    their roundings are the reference's."""
    bsz, s, h, p = xh.shape
    n = B.shape[-1]
    L = min(cfg.chunk, s)
    assert s % L == 0, f"seq {s} not divisible by chunk {L}"
    nc = s // L
    cdtype = xh.dtype

    # per-step log decay: log a_t = dt_t * a  (a < 0)
    loga = dt * a
    xc = xh.reshape(bsz, nc, L, h, p)
    dtc = dt.reshape(bsz, nc, L, h)
    Bc = B.reshape(bsz, nc, L, n)
    Cc = C.reshape(bsz, nc, L, n)
    cum = torch.cumsum(loga.reshape(bsz, nc, L, h), dim=2)    # (Bz,nc,L,H)
    total = cum[:, :, -1]                                     # (Bz,nc,H)

    # intra-chunk: M[t,s] = (C_t . B_s) exp(cum_t - cum_s) 1[s<=t]
    cb = torch.matmul(Cc.to(cdtype), Bc.to(cdtype).transpose(-1, -2))
    cum_h = cum.permute(0, 1, 3, 2)                           # (Bz,nc,H,L)
    # the exponents above the diagonal are set to -inf before the exp, so
    # those entries are 0, as the reference's mask after the exp makes
    # them, and so is their gradient: exp(cum_t - cum_s) for s > t
    # overflows at zamba2's widths (|dt a| up to ~11 a step), and the
    # reference's masked inf times a zero cotangent makes every gradient
    # NaN.  A copy even in float32: autograd keeps exp's output, which the
    # in-place product below would otherwise overwrite
    tri = torch.ones((L, L), dtype=torch.bool, device=xh.device).tril()
    m = (cum_h[..., :, None] - cum_h[..., None, :]).masked_fill_(
        ~tri, float("-inf")).exp_().to(cdtype, copy=True)
    m.mul_(cb[:, :, None])                                    # (Bz,nc,H,L,L)
    xdt = xc * dtc[..., None].to(cdtype)                      # (Bz,nc,L,H,P)
    y = torch.matmul(m, xdt.permute(0, 1, 3, 2, 4)).permute(0, 1, 3, 2, 4)
    del m

    # chunk states: S_c = sum_s exp(total - cum_s) dt_s B_s x_s^T
    wdt = torch.exp(total[:, :, None, :] - cum) * dtc         # (Bz,nc,L,H)
    u = wdt[..., None] * xc.float()                           # (Bz,nc,L,H,P)
    sc = torch.matmul(u.reshape(bsz, nc, L, h * p).transpose(-1, -2),
                      Bc).reshape(bsz, nc, h, p, n)
    del u

    # inter-chunk recurrence over the nc chunks: the state before each
    state = (torch.zeros((bsz, h, p, n), dtype=torch.float32,
                         device=xh.device) if init_state is None
             else init_state.float())
    prev = torch.empty((bsz, nc, h, p, n), dtype=torch.float32,
                       device=xh.device)
    decay = torch.exp(total)                                  # (Bz,nc,H)
    for c in range(nc):
        prev[:, c] = state
        state = state * decay[:, c, :, None, None] + sc[:, c]

    # inter-chunk output: y_t += C_t . (exp(cum_t) S_prev), the three
    # factors in the compute type and contracted in the reference's
    # einsum's order (opt_einsum's cheaper path): the outer product
    # C_t exp(cum_t) first when N < P, else C_t . S_prev first, each
    # product rounded to the compute type
    ecum = torch.exp(cum).to(cdtype).permute(0, 1, 3, 2)      # (Bz,nc,H,L)
    prev_t = prev.to(cdtype).transpose(-1, -2)               # (Bz,nc,H,N,P)
    Cq = Cc.to(cdtype)[:, :, None]                            # (Bz,nc,1,L,N)
    if n < p:
        y_inter = torch.matmul(Cq * ecum[..., None], prev_t)
    else:
        y_inter = torch.matmul(Cq, prev_t) * ecum[..., None]
    y_inter = y_inter.permute(0, 1, 3, 2, 4)                  # (Bz,nc,L,H,P)
    y = (y + y_inter).reshape(bsz, s, h, p)
    return y, state


def _gated(p: Params, x: torch.Tensor, cfg: Mamba2Config,
           heads: Optional[Tuple[int, int]] = None):
    """The block up to its norm, over the SSD heads ``heads`` (a range of
    the H heads; all of them when None): ``y * silu(z)`` in x's type (B, S,
    the heads' channels), and the decode cache ``{"conv": {"x", "B", "C"},
    "ssm"}`` (the last W-1 conv inputs, the final float32 state).  ``p``
    holds the heads' channels of ``w_z``, ``w_x``, ``conv_x`` and
    ``conv_xb``, and the whole ``w_B``, ``w_C``, ``w_dt``, ``conv_B*``,
    ``conv_C*``, ``dt_bias``, ``a_log`` and ``d_skip``: B, C and dt are
    computed whole, then the heads' slices of dt, a and D are taken."""
    bsz, s, _ = x.shape
    h0, h1 = (0, cfg.n_heads) if heads is None else heads
    z = x @ p["w_z"]
    xin, conv_x = _causal_conv(x @ p["w_x"], p["conv_x"], p["conv_xb"])
    B, conv_B = _causal_conv(x @ p["w_B"], p["conv_B"], p["conv_Bb"])
    C, conv_C = _causal_conv(x @ p["w_C"], p["conv_C"], p["conv_Cb"])
    dt = _softplus((x @ p["w_dt"]).float() + p["dt_bias"])[..., h0:h1]
    a = -torch.exp(p["a_log"][h0:h1])
    xh = xin.reshape(bsz, s, h1 - h0, cfg.head_dim)
    y, state = _ssd_chunked(xh, dt, a, B.float(), C.float(), cfg)
    # y (compute type) + xh D (float32: a bf16 x times a float32 D), then
    # rounded to x's type, as the reference's type promotion does
    y = (y + xh * p["d_skip"][h0:h1, None]).reshape(bsz, s, -1)
    return y.to(x.dtype) * _silu(z), {
        "conv": {"x": conv_x, "B": conv_B, "C": conv_C}, "ssm": state}


def mamba2_fwd(p: Params, x: torch.Tensor, cfg: Mamba2Config,
               make_cache: bool = False):
    """Full-sequence Mamba2 block.  x: (B, S, D) -> (out (B, S, D), cache):
    with ``make_cache`` the decode cache ``{"conv": {"x", "B", "C"}, "ssm"}``
    (the last W-1 conv inputs, the final float32 state), else None."""
    g, cache = _gated(p, x, cfg)
    y = _rms(g, p["norm_scale"])
    return y @ p["out_proj"], (cache if make_cache else None)


# --------------------------------------------------------------------------
# on a mesh
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MambaShardPlan:
    """What one model shard computes of a Mamba2 layer on a mesh: its
    channels of d_inner (columns of ``w_z``, ``w_x`` and ``conv_x``,
    entries of ``conv_xb`` and ``norm_scale``, rows of ``out_proj``) and
    the SSD heads they make."""
    inner: Tuple[int, int]
    heads: Tuple[int, int]


def mamba_mesh_plan(cfg: Mamba2Config, n_model: int,
                    split: bool) -> List[MambaShardPlan]:
    """Each model shard's part of a Mamba2 layer: equal blocks of the
    d_inner channels where the reference's ``inner`` is on the model axis
    (``split``), every channel otherwise.  A block must hold whole SSD
    heads: one that ends inside a head raises (ROADMAP A3.4.3)."""
    di, pd = cfg.d_inner, cfg.head_dim
    if not split:
        return [MambaShardPlan((0, di), (0, cfg.n_heads))] * n_model
    w = di // n_model
    if w % pd:
        raise ValueError(
            f"a Mamba2 d_inner of {di} on {n_model} model shards splits "
            f"into blocks of {w} channels, which end inside a {pd}-wide SSD "
            "head: a split inside an SSD head does not run on a mesh "
            "(ROADMAP A3.4.3)")
    return [MambaShardPlan((m * w, (m + 1) * w), (m * w // pd,
                                                   (m + 1) * w // pd))
            for m in range(n_model)]


def mamba2_fwd_mesh(ps, xs: List[torch.Tensor], cfg: Mamba2Config,
                    plans: List[MambaShardPlan], comm,
                    group: Sequence[int]) -> List[torch.Tensor]:
    """:func:`mamba2_fwd` of one data replica over its model shards
    ``group``, head parallel: member ``j`` holds the replicated input
    ``xs[j]`` (B, S, d_model), the replicated ``w_B``, ``w_C``, ``w_dt``,
    ``conv_B*``, ``conv_C*``, ``dt_bias``, ``a_log`` and ``d_skip``, and
    its slices ``ps[j]`` of the ``inner`` leaves as ``plans[j]`` says.
    Each member runs the chunked SSD on its heads (heads do not interact
    there: B and C are one group shared by all).  The gated norm is over
    the whole d_inner: each member's float32 sum of squares is summed over
    the group (:meth:`MeshComm.all_reduce`) and divided by d_inner, the
    mean of squares that ``rms_norm`` then takes.  Each member multiplies
    by its rows of ``out_proj`` and the partials are summed over the group
    in float32, rounded once.  Where ``inner`` is replicated every member
    computes the whole block (:func:`mamba2_fwd`'s bits) and nothing is
    summed.  Returns each member's (B, S, d_model) output."""
    gs = [_gated(p, x, cfg, pl.heads)[0] for p, pl, x in zip(ps, plans, xs)]
    if plans[0].inner == (0, cfg.d_inner):
        return [_rms(g, p["norm_scale"]) @ p["out_proj"]
                for p, g in zip(ps, gs)]
    sums = comm.all_reduce([g.float().square().sum(-1, keepdim=True)
                            for g in gs], group, "norm")
    outs = [_rms(g, p["norm_scale"], mean_sq=sq / cfg.d_inner)
            @ p["out_proj"] for p, g, sq in zip(ps, gs, sums)]
    return comm.all_reduce(outs, group, "mamba")


def mamba2_decode(p: Params, x: torch.Tensor, cache, cfg: Mamba2Config):
    """One-token decode.  x: (B, 1, D); cache ``{"conv": {"x", "B", "C"},
    "ssm" (B, H, P, N) float32}``, updated in place (the reference returns a
    new one) and returned with the output (B, 1, D)."""
    bsz = x.shape[0]
    h, pd = cfg.n_heads, cfg.head_dim
    conv = cache["conv"]
    z = x @ p["w_z"]
    xin, conv_x = _causal_conv(x @ p["w_x"], p["conv_x"], p["conv_xb"],
                               state=conv["x"])
    B, conv_B = _causal_conv(x @ p["w_B"], p["conv_B"], p["conv_Bb"],
                             state=conv["B"])
    C, conv_C = _causal_conv(x @ p["w_C"], p["conv_C"], p["conv_Cb"],
                             state=conv["C"])
    for name, new in (("x", conv_x), ("B", conv_B), ("C", conv_C)):
        conv[name].copy_(new)
    B, C = B[:, 0].float(), C[:, 0].float()                   # (B, N)
    dt = _softplus((x @ p["w_dt"]).float() + p["dt_bias"])[:, 0]   # (B, H)
    a = -torch.exp(p["a_log"])
    xh = xin.reshape(bsz, h, pd).float()

    ssm = cache["ssm"]
    upd = (dt[:, :, None] * xh)[..., None] * B[:, None, None, :]
    ssm.mul_(torch.exp(dt * a)[:, :, None, None]).add_(upd)
    y = torch.matmul(ssm, C[:, None, :, None])[..., 0]        # (B, H, P)
    y = (y + xh * p["d_skip"][:, None]).reshape(bsz, 1, cfg.d_inner)
    y = _rms(y.to(x.dtype) * _silu(z), p["norm_scale"])
    return y @ p["out_proj"], cache
