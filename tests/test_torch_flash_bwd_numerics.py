"""The numerics of the tensor-core ``flash_attention`` backward (bfloat16),
emulated in plain PyTorch on the CPU and held against autograd of
``flash_attention_plain``.

The kernels (``csrc/flash_attention_bwd.cu``, ``flash_bwd_dkdv_tc`` and
``flash_bwd_dq_tc``) recompute S = q'·kᵀ and dP = d_out·vᵀ per tile of 64
keys on the tensor cores (bf16 operands, float32 sums), form
P = exp(c - lse) and dS = P (dP - Di)(1 - tanh²) in float32, and feed P to
dV += Pᵀ·d_out and dS to dK += dSᵀ·q' and dq' += dS·k: bf16 products again,
where autograd keeps P and dS in float32.  One rounding of P or dS to bf16
(up to 2^-8 of each weight) puts gradient entries outside the bfloat16
band (rtol 1e-2, atol 1e-3 of the leaf's largest entry), so each goes in as
a pair, x = hi + lo with hi = bf16(x), lo = bf16(x - hi), and both halves'
products are added (2^-16 of each weight).  The emulation below does the
same, tile by tile, with the kernels' exp (``exp2`` of
``(c - lse) log2(e)``) and soft-cap (``cap (1 - 2 / (2^(2 x log2(e) / cap)
+ 1))``, as the forward's), Di from the forward's float32 out, dk and dv
summed in float32 over the GQA group and rounded once, and
dq = bf16(bf16(dq') · bf16(1/√D)).

The tests show that the pairs keep every entry in the band at S 1000
(no tile divides it), D 64, 128 and 256, GQA 2 and 4 and the four mask and
cap settings of ``chip_smoke.py``, and that one rounding of P or of dS does
not.  No card, no JAX; one intra-op thread (the suite's workers share the
cores).
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (_scaled_q,
                                                 flash_attention_plain,
                                                 flash_attention_plain_lse)

RTOL, ATOL = 1e-2, 1e-3   # chip_smoke.py's FLASH_GRAD_TOL, bfloat16
LOG2E = 1.4426950408889634
TILE = 64
MASKS = [(True, None, None), (False, None, None), (True, 64, 50.0),
         (False, 64, None)]
MASK_IDS = ["causal", "full", "causal-window-cap", "window"]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite runs its files in parallel worker
    processes, and these small float32 products gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(x: torch.Tensor, split: bool):
    """(hi, lo) of float32 x as bf16 values; lo is 0 without ``split``."""
    hi = x.bfloat16().float()
    return hi, ((x - hi).bfloat16().float() if split
                else torch.zeros_like(x))


def emulate_bwd(q, k, v, d_out, causal=True, window=None, softcap=None,
                split_p=True, split_ds=True):
    """(dq, dk, dv) by the tensor-core backward's arithmetic: per tile of
    64 keys, float32 S and dP from bf16 operands, the kernels' cap and exp,
    P and dS as hi/lo pairs (one rounding when ``split_p`` or
    ``split_ds`` is off), float32 sums, one rounding of each leaf."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    _, lse, o32 = flash_attention_plain_lse(q, k, v, causal, window,
                                            softcap)
    qs = _scaled_q(q).float()
    kf = k.float().repeat_interleave(g, 1)
    vf = v.float().repeat_interleave(g, 1)
    do = d_out.float()
    di = (do * o32).sum(-1, keepdim=True)
    m = lse[..., None]
    dqp = torch.zeros((b, hq, s, d))
    dk = torch.zeros((b, hq, s, d))
    dv = torch.zeros((b, hq, s, d))
    rows = torch.arange(s)[:, None]
    for k0 in range(0, s, TILE):
        k1 = min(s, k0 + TILE)
        kt, vt = kf[:, :, k0:k1], vf[:, :, k0:k1]
        sc = qs @ kt.transpose(-1, -2)
        dp = do @ vt.transpose(-1, -2)
        dcap = 1.0
        if softcap is not None:
            t = 1.0 - 2.0 / (torch.exp2(sc * (2.0 * LOG2E / softcap)) + 1.0)
            sc, dcap = softcap * t, 1.0 - t * t
        cols = torch.arange(k0, k1)[None, :]
        keep = torch.ones((s, k1 - k0), dtype=torch.bool)
        if causal:
            keep &= cols <= rows
        if window is not None:
            keep &= cols > rows - window
        p = torch.where(keep, torch.exp2((sc - m) * LOG2E),
                        torch.zeros(()))
        ds = p * (dp - di) * dcap
        p_hi, p_lo = _pair(p, split_p)
        d_hi, d_lo = _pair(ds, split_ds)
        dv[:, :, k0:k1] = (p_hi.transpose(-1, -2) @ do
                           + p_lo.transpose(-1, -2) @ do)
        dk[:, :, k0:k1] = (d_hi.transpose(-1, -2) @ qs
                           + d_lo.transpose(-1, -2) @ qs)
        dqp += d_hi @ kt + d_lo @ kt
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.bfloat16)
    dq = dqp.bfloat16() * scale
    group = lambda x: x.view(b, hkv, g, s, d).sum(2).bfloat16()
    return dq, group(dk), group(dv)


def plain_grads(q, k, v, d_out, *masks):
    """dq, dk, dv of autograd of the plain version (the oracle)."""
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = flash_attention_plain(*leaves, *masks)
    return torch.autograd.grad(out, leaves, d_out)


def outside(got, want) -> int:
    """Entries of ``got`` outside the bfloat16 band around ``want``."""
    want = want.float()
    err = (got.float() - want).abs()
    atol = ATOL * float(want.abs().max())
    return int((err > atol + RTOL * want.abs()).sum())


def _inputs(seed, hq, hkv, d, s=1000, q_scale=4.0):
    """bf16 q, k, v, d_out from a numpy seed; q of std 4 (chip_smoke.py's
    FLASH_Q_SCALE: scores of std 4, so the cap of 50 matters)."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy((rng.standard_normal(shape) * c).astype(
        np.float32)).bfloat16()
        for shape, c in (((1, hq, s, d), q_scale), ((1, hkv, s, d), 1.0),
                         ((1, hkv, s, d), 1.0), ((1, hq, s, d), 1.0)))


@pytest.mark.parametrize("causal,window,softcap", MASKS, ids=MASK_IDS)
@pytest.mark.parametrize("gqa", [2, 4])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_hi_lo_pairs_stay_in_the_band(d, gqa, causal, window, softcap):
    """S 1000, one KV head and ``gqa`` query heads: every entry of the
    emulated dq, dk and dv lies in the bfloat16 band around autograd of the
    plain version."""
    q, k, v, d_out = _inputs(d + gqa, gqa, 1, d)
    masks = (causal, window, softcap)
    want = plain_grads(q, k, v, d_out, *masks)
    got = emulate_bwd(q, k, v, d_out, *masks)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16 and a.shape == w.shape
        assert outside(a, w) == 0, name


@pytest.mark.parametrize("what", ["P", "dS"])
def test_one_rounding_leaves_the_band(what):
    """P rounded once moves dv, dS rounded once moves dq and dk out of the
    band in some of the mask and cap settings at D 128, GQA 2 (the reason
    for the pairs), while the pairs keep all of them in."""
    one = {"P": dict(split_p=False), "dS": dict(split_ds=False)}[what]
    leaves = {"P": (2,), "dS": (0, 1)}[what]
    n_single = n_pair = 0
    q, k, v, d_out = _inputs(9, 4, 2, 128)
    for masks in MASKS:
        want = plain_grads(q, k, v, d_out, *masks)
        single = emulate_bwd(q, k, v, d_out, *masks, **one)
        pair = emulate_bwd(q, k, v, d_out, *masks)
        n_single += sum(outside(single[i], want[i]) for i in leaves)
        n_pair += sum(outside(pair[i], want[i]) for i in leaves)
    assert n_pair == 0
    assert n_single > 0
