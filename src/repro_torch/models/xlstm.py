"""xLSTM blocks (xlstm-350m): mLSTM (matrix memory, parallelisable) and
sLSTM (scalar memory, sequential recurrence), on one device.

Port of ``repro/models/xlstm.py``.  The reference computes both blocks in
plain jnp ops and reaches no Pallas kernel, so the port computes them in
plain torch ops on every device.

* mLSTM prefill is the *stabilised parallel form* (xLSTM paper App. A):
  with log-forget gates f and log-input gates i the attention-like weight
  is ``D[t, s] = exp((F_t - F_s) + i_s - m_t)``, ``F_t = sum_{r<=t} log
  f_r``, with a per-row stabiliser ``m_t = max(max_s logD[t, s], 0)``;
  output ``(D * qk) @ V / max(|sum_s D * qk|, exp(-m_t))``.  Under
  ``FLAGS["mlstm_chunked"]`` and S > 1024, S % 1024 == 0, it runs over
  query chunks of 1024 rows instead (no (B, H, S, S) tensor).  Decode keeps
  the (H, P, P) matrix state recurrently, in float32.
* sLSTM is a true recurrence: a loop over time with a block-diagonal (per
  head) recurrent matrix, on a float32 (c, n, m, y) state.

The reference's roundings are kept: in a bf16 model ``k`` is divided by
sqrt(P) in bf16, the scores are rounded to bf16 before they are widened,
the parallel form's D is rounded to the compute type (the chunked form's
stays float32), the weights are cast to the compute type for the product
with V, SiLU is XLA's CPU expansion (:func:`.mamba2._silu`) and the tanh
GeLU is rounded step by step; ``F`` is summed in the order of XLA's CPU
cumulative sum.

As in the reference, ``mlstm_fwd(make_cache=True)`` hands decode a *zero*
matrix state (C = 0, n = 0, m = -1e30) with the conv state: a decode after
a prefill starts each mLSTM layer afresh (its comment speaks of a
recompute that no code of the reference does).  ``slstm_fwd`` hands its
final state on.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from .common import dense_init
from .mamba2 import _causal_conv, _silu
from .perf import FLAGS

Params = Dict[str, Any]

#: the decode state's m before the first step (the reference's)
M_INIT = -1e30


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    d_model: int
    n_heads: int = 4
    proj_factor: float = 2.0        # mLSTM up-projection factor
    conv_width: int = 4

    @property
    def d_inner(self) -> int:
        return int(self.proj_factor * self.d_model)

    @property
    def head_dim(self) -> int:
        if self.d_inner % self.n_heads:
            raise ValueError(f"d_inner {self.d_inner} is not a multiple of "
                             f"n_heads {self.n_heads}")
        return self.d_inner // self.n_heads


#: the reference's logical axes of the mLSTM leaves (``MLSTM_AXES``): the
#: square wq / wk / wv row-parallel over the inner dimension
MLSTM_AXES = {
    "w_up": ("embed", "inner"), "conv_w": (None, "inner"),
    "conv_b": ("inner",), "wq": ("inner", None), "wk": ("inner", None),
    "wv": ("inner", None), "w_if": ("inner", None), "b_if": (None,),
    "norm_scale": ("inner",), "w_down": ("inner", "embed"),
}
#: the reference's logical axes of the sLSTM leaves (``SLSTM_AXES``)
SLSTM_AXES = {
    "w_in": ("embed", "inner"), "r_heads": (None, None, None, None),
    "bias": (None,), "norm_scale": (None,),
    "w_ffn_up": ("embed", "mlp"), "w_ffn_down": ("mlp", "embed"),
}


def _normal(gen, shape, std, dtype, device) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=device)
    t.normal_(0.0, 1.0, generator=gen)
    return (t * std).to(dtype)


def _bias(parts, device) -> torch.Tensor:
    """float32 concatenation of (length, value) runs."""
    return torch.cat([torch.full((n,), v, dtype=torch.float32, device=device)
                      for n, v in parts])


# --------------------------------------------------------------------------
# mLSTM
# --------------------------------------------------------------------------

def init_mlstm(gen: Optional[torch.Generator], cfg: XLSTMConfig,
               dtype=torch.bfloat16, device=None) -> Params:
    """The reference's leaves and distributions: fan-in truncated-normal
    projections, N(0, 0.1^2) conv taps with zero biases, the gate
    projection ``w_if`` and its bias ``b_if`` (0 for the input gates, 3 for
    the forget gates) float32 whatever ``dtype``, a zero norm scale."""
    d, di, h = cfg.d_model, cfg.d_inner, cfg.n_heads
    return {
        "w_up": dense_init(gen, (d, 2 * di), 0, dtype, device),  # [x, z]
        "conv_w": _normal(gen, (cfg.conv_width, di), 0.1, dtype, device),
        "conv_b": torch.zeros((di,), dtype=dtype, device=device),
        "wq": dense_init(gen, (di, di), 0, dtype, device),
        "wk": dense_init(gen, (di, di), 0, dtype, device),
        "wv": dense_init(gen, (di, di), 0, dtype, device),
        "w_if": dense_init(gen, (di, 2 * h), 0, torch.float32, device),
        "b_if": _bias(((h, 0.0), (h, 3.0)), device),
        "norm_scale": torch.zeros((di,), dtype=dtype, device=device),
        "w_down": dense_init(gen, (di, d), 0, dtype, device),
    }


def _multihead_rms(x: torch.Tensor, scale: torch.Tensor, nh: int,
                   eps: float = 1e-6) -> torch.Tensor:
    """Per-head RMS norm of (B, S, di) viewed as (B, S, H, P), in float32,
    scaled by ``1 + scale``, returned in x's type."""
    b, s, di = x.shape
    xh = x.reshape(b, s, nh, di // nh).float()
    var = xh.square().mean(dim=-1, keepdim=True)
    xh = (xh * torch.rsqrt(var + eps)).reshape(b, s, di)
    return (xh * (1 + scale.float())).to(x.dtype)


def _div_scalar(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` with ``c`` first rounded to x's type, as JAX takes a
    Python scalar into a bf16 division."""
    return x / torch.tensor(c, dtype=x.dtype, device=x.device)


#: the block length of XLA's CPU cumulative sum
SCAN_BLOCK = 16


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    """Cumulative sum over the last axis in the order of ``jnp.cumsum`` on
    XLA's CPU (its reduce-window rewrite): blocks of ``SCAN_BLOCK`` summed
    in sequence, the block totals scanned the same way, each block's carry
    added last.  At S 2048 a sequential or double-accumulated sum puts F a
    few float32 ulps off the reference's, enough to flip bf16 roundings of
    the outputs."""
    n = x.shape[-1]
    if n <= SCAN_BLOCK:
        cols = [x[..., 0]]
        for i in range(1, n):
            cols.append(cols[-1] + x[..., i])
        return torch.stack(cols, dim=-1)
    nb = -(-n // SCAN_BLOCK)
    xb = F.pad(x, (0, nb * SCAN_BLOCK - n)).unflatten(-1, (nb, SCAN_BLOCK))
    inner = _cumsum(xb)
    carry = F.pad(_cumsum(inner[..., -1])[..., :-1], (1, 0))
    return (inner + carry[..., None]).flatten(-2)[..., :n]


def _mlstm_rows(q, k, v, F_, logi, rows: slice, round_d: bool):
    """The stabilised parallel form for the query rows ``rows`` against
    keys ``0 .. rows.stop``: (B, H, R, P) in q's type.  ``round_d`` rounds
    D to the compute type (the parallel form) or keeps it float32 (the
    chunked form)."""
    q0, q1 = rows.start, rows.stop
    logD = F_[..., q0:q1, None] - F_[..., None, :q1] + logi[..., None, :q1]
    tri = (torch.arange(q1, device=q.device)[None, :]
           <= torch.arange(q0, q1, device=q.device)[:, None])
    logD = logD.masked_fill(~tri, float("-inf"))
    mrow = torch.maximum(logD.amax(dim=-1, keepdim=True),
                         torch.zeros((), dtype=logD.dtype, device=q.device))
    D = torch.exp(logD - mrow)                                # (B,H,R,q1)
    del logD
    if round_d:
        D = D.to(q.dtype).float()
    sc = torch.matmul(q[:, :, q0:q1], k[:, :, :q1].transpose(-1, -2))
    wts = sc.float() * D                                      # (B,H,R,q1)
    del sc, D
    num = torch.matmul(wts.to(q.dtype), v[:, :, :q1])
    den = torch.maximum(wts.sum(dim=-1, keepdim=True).abs(), torch.exp(-mrow))
    return (num.float() / den).to(q.dtype)


#: the chunked form's query chunk (the reference's)
MLSTM_QCHUNK = 1024


def mlstm_fwd(p: Params, x: torch.Tensor, cfg: XLSTMConfig,
              make_cache: bool = False):
    """Parallel (stabilised) mLSTM.  x: (B, S, D) -> (out (B, S, D), cache):
    with ``make_cache`` the decode cache ``{"conv", "C", "n", "m"}`` (the
    last W-1 conv inputs and, as the reference, a zero float32 state),
    else None."""
    bsz, s, _ = x.shape
    h, pd, di = cfg.n_heads, cfg.head_dim, cfg.d_inner
    xi, z = (x @ p["w_up"]).split(di, dim=-1)
    xc, conv_state = _causal_conv(xi, p["conv_w"], p["conv_b"])

    def heads(t):
        return t.reshape(bsz, s, h, pd).transpose(1, 2)       # (B,H,S,P)

    q = heads(xc @ p["wq"])
    k = _div_scalar(heads(xc @ p["wk"]), math.sqrt(pd))
    v = heads(xi @ p["wv"])
    gates = xc.float() @ p["w_if"] + p["b_if"]                # (B,S,2H)
    ig, fg = gates.split(h, dim=-1)
    logf = F.logsigmoid(fg).transpose(1, 2)                   # (B,H,S)
    logi = ig.transpose(1, 2)
    F_ = _cumsum(logf)

    if FLAGS.get("mlstm_chunked") and s > MLSTM_QCHUNK and \
            s % MLSTM_QCHUNK == 0:
        # query chunks with static causal column skipping: every key of a
        # chunk's rows lies in [0, q1); D stays float32
        yh = torch.cat([
            _mlstm_rows(q, k, v, F_, logi, slice(q0, q0 + MLSTM_QCHUNK),
                        round_d=False)
            for q0 in range(0, s, MLSTM_QCHUNK)], dim=2)
    else:
        yh = _mlstm_rows(q, k, v, F_, logi, slice(0, s), round_d=True)

    y = yh.transpose(1, 2).reshape(bsz, s, di).to(x.dtype)
    y = _multihead_rms(y, p["norm_scale"], h)
    out = (y * _silu(z)) @ p["w_down"]
    cache = None
    if make_cache:
        dev = x.device
        cache = {"conv": conv_state,
                 "C": torch.zeros((bsz, h, pd, pd), device=dev),
                 "n": torch.zeros((bsz, h, pd), device=dev),
                 "m": torch.full((bsz, h), M_INIT, device=dev)}
    return out, cache


def mlstm_decode(p: Params, x: torch.Tensor, cache, cfg: XLSTMConfig):
    """O(1) recurrent mLSTM step (xLSTM eq. 19-27).  x: (B, 1, D); cache
    ``{"conv", "C" (B, H, P, P), "n" (B, H, P), "m" (B, H)}`` (the state
    float32), updated in place (the reference returns a new one) and
    returned with the output (B, 1, D)."""
    bsz = x.shape[0]
    h, pd, di = cfg.n_heads, cfg.head_dim, cfg.d_inner
    xi, z = (x @ p["w_up"]).split(di, dim=-1)
    xc, conv_state = _causal_conv(xi, p["conv_w"], p["conv_b"],
                                  state=cache["conv"])
    cache["conv"].copy_(conv_state)
    q = (xc @ p["wq"]).reshape(bsz, h, pd).float()
    k = _div_scalar((xc @ p["wk"]).reshape(bsz, h, pd),
                    math.sqrt(pd)).float()
    v = (xi @ p["wv"]).reshape(bsz, h, pd).float()
    gates = xc[:, 0].float() @ p["w_if"] + p["b_if"]
    ig, fg = gates.split(h, dim=-1)                           # (B,H)
    logf = F.logsigmoid(fg)

    C, n, m = cache["C"], cache["n"], cache["m"]
    lfm = logf + m
    m_new = torch.maximum(lfm, ig)
    fw = torch.exp(lfm - m_new)[..., None]
    iw = torch.exp(ig - m_new)[..., None]
    C.mul_(fw[..., None]).add_(iw[..., None] * v[..., :, None]
                               * k[..., None, :])
    n.mul_(fw).add_(iw * k)
    m.copy_(m_new)
    num = torch.matmul(C, q[..., None])[..., 0]               # (B,H,P)
    den = torch.maximum((n * q).sum(dim=-1).abs(), torch.exp(-m))[..., None]
    yh = (num / den).reshape(bsz, 1, di).to(x.dtype)
    y = _multihead_rms(yh, p["norm_scale"], h)
    return (y * _silu(z)) @ p["w_down"], cache


# --------------------------------------------------------------------------
# sLSTM
# --------------------------------------------------------------------------

def _ffn_dim(d: int) -> int:
    """The gated FFN's width: proj factor 4/3."""
    return int(4 * d / 3)


def init_slstm(gen: Optional[torch.Generator], cfg: XLSTMConfig,
               dtype=torch.bfloat16, device=None) -> Params:
    """The reference's leaves and distributions: the 4-gate input
    projection (i, f, z, o), per-head recurrent matrices ``r_heads``
    N(0, 1/hd) and the gate bias (3 for the forget gate, 0 elsewhere),
    both float32 whatever ``dtype``; a zero norm scale; the gated FFN."""
    d, h = cfg.d_model, cfg.n_heads
    hd = d // h
    return {
        "w_in": dense_init(gen, (d, 4 * d), 0, dtype, device),
        "r_heads": _normal(gen, (4, h, hd, hd), 1 / math.sqrt(hd),
                           torch.float32, device),
        "bias": _bias(((d, 0.0), (d, 3.0), (2 * d, 0.0)), device),
        "norm_scale": torch.zeros((d,), dtype=dtype, device=device),
        "w_ffn_up": dense_init(gen, (d, 2 * _ffn_dim(d)), 0, dtype, device),
        "w_ffn_down": dense_init(gen, (_ffn_dim(d), d), 0, dtype, device),
    }


def _slstm_scan(gates_seq: torch.Tensor, r_heads: torch.Tensor,
                bias: torch.Tensor, h: int, hd: int, state):
    """Sequential sLSTM recurrence.  gates_seq: (S, B, 4D) input
    projections (i, f, z, o); state: dict of (B, D) float32 ``c, n, m, y``.
    Returns (ys (S, B, D) float32, the final state).

    The loop runs head-major: the state is (H, B, hd), the gate inputs with
    their bias (H, B, 4 hd), so each step's recurrent term is one batched
    product added to them; the values are the reference's step's.  No
    step reads anything back to the host."""
    s, bsz, d4 = gates_seq.shape
    d = h * hd
    # g_t + bias for every step at once, laid out (S, H, B, 4 hd)
    gb = (gates_seq.float().reshape(s, bsz, 4, h, hd)
          + bias.view(4, h, hd)).permute(0, 3, 1, 2, 4).reshape(
              s, h, bsz, 4 * hd)
    # rec[h, b, (g, p)] = sum_q R[g, h, p, q] y[h, b, q]
    rt = r_heads.permute(1, 3, 0, 2).reshape(h, hd, 4 * hd)

    def head_major(t):
        return t.reshape(bsz, h, hd).transpose(0, 1)

    c, n, m, y = (head_major(state[key]) for key in ("c", "n", "m", "y"))
    # max(n, 1) as jnp.maximum: at the first step n is exactly 1, and
    # there the gradient splits half and half between n and the 1
    one = torch.ones((), device=gates_seq.device)
    ys = []
    for t in range(s):
        zin = torch.baddbmm(gb[t], y, rt).view(h, bsz, 4, hd)
        ig, fg, zg, og = zin.unbind(dim=2)
        lfm = F.logsigmoid(fg) + m
        m = torch.maximum(lfm, ig)
        i_st = torch.exp(ig - m)
        f_st = torch.exp(lfm - m)
        c = f_st * c + i_st * torch.tanh(zg)
        n = f_st * n + i_st
        y = torch.sigmoid(og) * c / torch.maximum(n, one)
        ys.append(y)

    def batch_major(t):
        return t.transpose(0, 1).reshape(bsz, d)

    ys = torch.stack(ys).transpose(1, 2).reshape(s, bsz, d)
    return ys, {key: batch_major(v) for key, v in
                (("c", c), ("n", n), ("m", m), ("y", y))}


def _slstm_zero_state(bsz: int, d: int, device=None):
    return {"c": torch.zeros((bsz, d), device=device),
            "n": torch.zeros((bsz, d), device=device),
            "m": torch.full((bsz, d), M_INIT, device=device),
            "y": torch.zeros((bsz, d), device=device)}


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (its default, the tanh form) as the reference runs
    it: ``x * 0.5 * (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3)))`` with the
    constants and every step rounded to x's type.  ``F.gelu(approximate=
    "tanh")`` rounds once and leaves 45 % of bf16 outputs an ulp off."""
    def c(v):
        return torch.tensor(v, dtype=x.dtype, device=x.device)
    inner = x + c(0.044715) * (x * x * x)
    return x * (c(0.5) * (c(1.0) + torch.tanh(c(math.sqrt(2 / math.pi))
                                               * inner)))


def _slstm_out(p: Params, ys: torch.Tensor, dtype, h: int) -> torch.Tensor:
    """The recurrence's output (S, B, D) float32 through the multi-head
    norm and the gated FFN (tanh GeLU)."""
    y = _multihead_rms(ys.transpose(0, 1).to(dtype), p["norm_scale"], h)
    u, g = (y @ p["w_ffn_up"]).chunk(2, dim=-1)
    return (_gelu_tanh(u) * g) @ p["w_ffn_down"]


def slstm_fwd(p: Params, x: torch.Tensor, cfg: XLSTMConfig,
              make_cache: bool = False):
    """Full-sequence sLSTM from a zero state.  x: (B, S, D) -> (out, the
    final float32 state ``{"c", "n", "m", "y"}`` with ``make_cache``, else
    None)."""
    bsz, s, d = x.shape
    h = cfg.n_heads
    gates = (x @ p["w_in"]).transpose(0, 1)                   # (S, B, 4D)
    ys, state = _slstm_scan(gates, p["r_heads"], p["bias"], h, d // h,
                            _slstm_zero_state(bsz, d, x.device))
    return _slstm_out(p, ys, x.dtype, h), (state if make_cache else None)


def slstm_decode(p: Params, x: torch.Tensor, cache, cfg: XLSTMConfig):
    """One sLSTM step.  x: (B, 1, D); cache: the float32 ``{"c", "n",
    "m", "y"}`` (B, D), updated in place and returned with the output."""
    d = x.shape[-1]
    h = cfg.n_heads
    gates = (x @ p["w_in"]).transpose(0, 1)                   # (1, B, 4D)
    ys, state = _slstm_scan(gates, p["r_heads"], p["bias"], h, d // h,
                            cache)
    for key, val in state.items():
        cache[key].copy_(val)
    return _slstm_out(p, ys, x.dtype, h), cache
