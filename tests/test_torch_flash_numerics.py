"""The numerics of the tensor-core ``flash_attention`` (bfloat16), emulated
in plain PyTorch on the CPU and held against ``flash_attention_plain``.

The kernel (``csrc/flash_attention.cu``, ``flash_tc_kernel``) walks the
keys in tiles of 64 with an online softmax in float32, as the plain
version's function does, but feeds P·V to bf16 tensor-core products: P
must be bf16 there, where the plain version keeps it float32.  Rounding P
once (up to 2^-8 of each weight) leaves outputs of diffuse attention outside the
bfloat16 band (rtol 1e-2, atol 1e-4: one output ulp); the kernel therefore
splits P into a bf16 pair, P = hi + lo, hi = bf16(P), lo = bf16(P - hi),
and adds both products (2^-16 of each weight).  The emulation below does
the same, tile by tile, with the kernel's soft-cap formula
``cap * (1 - 2 / (2^(2 x log2(e) / cap) + 1))`` and ``exp2`` of
``(x - m) log2(e)``; l sums the float32 P.

The tests show that the pair stays in the band at S 1000, D 256 and on a
reduced gemma2 layer's q, k, v, that one rounding of P does not, and that
the band still excludes the plain version with the window, the causal
mask or the cap dropped.  No card, no JAX.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import reduced
from repro_torch.kernels.flash_attention import (NEG_INF, _scaled_q,
                                                 flash_attention_plain)
from repro_torch.models.attention import _project
from repro_torch.models.lm import LM, _apply_norm, block_fwd

BAND = dict(rtol=1e-2, atol=1e-4)
LOG2E = 1.4426950408889634
TILE = 64
MASKS = [(True, None, None), (False, None, None), (True, 64, 50.0),
         (False, 4096, 50.0)]


def soft_cap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """The kernel's soft-cap, in float32."""
    k = torch.tensor(2.0 * LOG2E / cap, dtype=torch.float32)
    return cap * (1.0 - 2.0 / (torch.exp2(x * k) + 1.0))


def emulate(q, k, v, causal=True, window=None, softcap=None, split=True):
    """The tensor-core kernel's arithmetic: q' rounded in bf16, float32
    scores per tile of 64 keys, soft-cap, masks, online softmax; P·V on
    bf16 P (the hi/lo pair when ``split``, else hi alone); out in bf16."""
    b, hq, s, d = q.shape
    g = hq // k.shape[1]
    qs = _scaled_q(q).float()
    kf = k.float().repeat_interleave(g, 1)
    vf = v.float().repeat_interleave(g, 1)
    m = torch.full((b, hq, s, 1), NEG_INF)
    l = torch.zeros((b, hq, s, 1))
    acc = torch.zeros((b, hq, s, d))
    rows = torch.arange(s)[:, None]
    for k0 in range(0, s, TILE):
        k1 = min(s, k0 + TILE)
        sc = qs @ kf[:, :, k0:k1].transpose(-1, -2)
        if softcap is not None:
            sc = soft_cap(sc, softcap)
        cols = torch.arange(k0, k1)[None, :]
        keep = torch.ones((s, k1 - k0), dtype=torch.bool)
        if causal:
            keep &= cols <= rows
        if window is not None:
            keep &= cols > rows - window
        sc = sc.masked_fill(~keep, NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        corr = torch.exp2((m - m_new) * LOG2E)
        p = torch.exp2((sc - m_new) * LOG2E)
        hi = p.bfloat16().float()
        acc = acc * corr + hi @ vf[:, :, k0:k1]
        if split:
            acc = acc + (p - hi).bfloat16().float() @ vf[:, :, k0:k1]
        l = l * corr + p.sum(-1, keepdim=True)
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


def outside(got, want) -> int:
    err = (got.float() - want.float()).abs()
    return int((err > BAND["atol"] + BAND["rtol"] * want.float().abs()).sum())


def _qkv(seed, b, hq, hkv, s, d, q_scale=4.0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy((rng.standard_normal(shape) * c).astype(
        np.float32)).bfloat16()
        for shape, c in (((b, hq, s, d), q_scale), ((b, hkv, s, d), 1.0),
                         ((b, hkv, s, d), 1.0)))


@pytest.mark.parametrize("causal,window,softcap", MASKS)
def test_hi_lo_pair_stays_in_the_band(causal, window, softcap):
    """S 1000 (no tile divides it), D 256, Hq/Hkv 8, bf16: the pair's
    output lies within the band around the plain version everywhere."""
    q, k, v = _qkv(0, 1, 16, 2, 1000, 256)
    want = flash_attention_plain(q, k, v, causal, window, softcap)
    got = emulate(q, k, v, causal, window, softcap)
    assert outside(got, want) == 0


@pytest.mark.parametrize("q_scale", [1.0, 4.0])
def test_one_rounding_of_p_leaves_the_band(q_scale):
    """P rounded to bf16 once puts outputs outside the band (some per
    cent at S 1000, D 256): the reason the kernel adds the lo half."""
    q, k, v = _qkv(1, 1, 16, 2, 1000, 256, q_scale)
    want = flash_attention_plain(q, k, v, True, None, 50.0)
    assert outside(emulate(q, k, v, True, None, 50.0, split=False),
                   want) > want.numel() // 1000
    assert outside(emulate(q, k, v, True, None, 50.0), want) == 0


def _layer_qkv(model, tokens, layer):
    """The q, k, v that layer ``layer``'s attention sees in prefill."""
    cfg = model.cfg
    kinds = cfg.layer_kinds
    with torch.no_grad():
        x = model._embed(tokens)
        pos = torch.arange(x.shape[1])
        for i in range(layer):
            x = block_fwd(kinds[i], model.layers[i], x, cfg, positions=pos)[0]
        p = model.layers[layer]
        h = _apply_norm(p["ln1"], x, cfg)
        return _project(p["attn"], h, cfg.attn_cfg(kinds[layer]), pos)


@pytest.mark.parametrize("layer", [0, 1])
def test_reduced_gemma2_layer_in_the_band(layer):
    """A reduced gemma2 in bf16 (head dim 32, window 16, soft-cap 50),
    prompts of 300 tokens: layer 0 (local) and layer 1 (global)."""
    cfg = dataclasses.replace(reduced("gemma2-9b"), dtype=torch.bfloat16)
    model = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 300)).astype(np.int32))
    q, k, v = _layer_qkv(model, tokens, layer)
    acfg = cfg.attn_cfg(cfg.layer_kinds[layer])
    args = (acfg.causal, acfg.window, acfg.softcap)
    assert q.dtype == torch.bfloat16 and acfg.softcap == 50.0
    want = flash_attention_plain(q, k, v, *args)
    assert outside(emulate(q, k, v, *args), want) == 0


@pytest.mark.parametrize("what", ["window", "causal", "softcap"])
def test_band_still_excludes_a_dropped_mask_or_cap(what):
    """The plain version with the window, the causal mask or the cap
    dropped lies outside the band around the right answer, while the
    pair's output lies inside: the band still tells them apart."""
    q, k, v = _qkv(3, 1, 16, 2, 1000, 256)
    right = (True, 64, 50.0)
    wrong = {"window": (True, None, 50.0), "causal": (False, 64, 50.0),
             "softcap": (True, 64, None)}[what]
    want = flash_attention_plain(q, k, v, *right)
    assert outside(emulate(q, k, v, *right), want) == 0
    assert outside(flash_attention_plain(q, k, v, *wrong), want) > 0


def test_soft_cap_formula_is_within_two_ulps_of_the_cap():
    """The kernel's cap·tanh(x/cap), from exp2 and a reciprocal, against
    tanh in float64, over the scores a cap of 50 sees: within two float32
    ulps of 50 (2.4e-5), the rounding of 2 / (e + 1) near 2."""
    x = torch.linspace(-400.0, 400.0, 200001, dtype=torch.float32)
    want = 50.0 * torch.tanh(x.double() / 50.0)
    assert float((soft_cap(x, 50.0).double() - want).abs().max()) <= \
        50.0 * 2.0 ** -21


def test_hi_lo_pair_keeps_p_to_2_to_the_minus_16():
    """bf16 keeps 8 significant bits: one rounding is off by up to 2^-8 of
    the value, the pair by up to 2^-16."""
    p = torch.from_numpy(np.random.default_rng(4).random(1 << 20).astype(
        np.float32)) + 1e-30
    hi = p.bfloat16().float()
    lo = (p - hi).bfloat16().float()
    assert float(((hi - p).abs() / p).max()) <= 2.0 ** -8
    assert float(((hi + lo - p).abs() / p).max()) <= 2.0 ** -16
    assert math.isclose(float((hi + lo).sum()), float(p.double().sum()),
                        rel_tol=1e-6)
