"""The port's attention against the JAX package, on the CPU.

* the kernel's plain version vs the Pallas kernel (interpret mode) and the
  reference's oracle ``ref.flash_attention_ref``, at the shapes, masks,
  caps and dtypes of ``tests/test_kernels.py:74-111`` (rtol 2e-4, atol 2e-4
  in float32; 5e-2 in bfloat16), plus lengths no TPU block divides;
* ``gqa_fwd`` vs the JAX ``gqa_fwd`` with ``use_flash`` False and True;
* ``gqa_decode`` on a ring cache vs the JAX one;
* ``rms_norm``, ``layer_norm`` and ``apply_rope`` in float32 and bfloat16.

Inputs come from numpy seeds and go to both packages as numpy arrays.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention as flash_pallas
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro_torch import kernels
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _qkv(seed, b, hq, hkv, s, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, s, d)).astype(np.float32),
            rng.standard_normal((b, hkv, s, d)).astype(np.float32),
            rng.standard_normal((b, hkv, s, d)).astype(np.float32))


def _to_torch(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _np(t):
    return t.float().numpy()


# --------------------------------------------------------------------------
# the kernel's plain version
# --------------------------------------------------------------------------

@pytest.mark.parametrize("b,hq,hkv,s,d", [
    (1, 4, 4, 128, 32), (2, 8, 2, 256, 64), (1, 8, 1, 128, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_pallas_and_oracle(b, hq, hkv, s, d, causal):
    q, k, v = _qkv(0, b, hq, hkv, s, d)
    got = _np(tfa.flash_attention_plain(_to_torch(q), _to_torch(k),
                                        _to_torch(v), causal=causal))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    pallas = flash_pallas(jq, jk, jv, causal=causal, block_q=64, block_kv=64,
                          interpret=True)
    oracle = ref.flash_attention_ref(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, np.asarray(oracle), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("window,softcap", [(64, None), (None, 30.0),
                                            (64, 30.0)])
def test_plain_window_softcap_matches_pallas_and_oracle(window, softcap):
    q, k, v = _qkv(1, 2, 4, 2, 256, 32)
    got = _np(tfa.flash_attention_plain(_to_torch(q), _to_torch(k),
                                        _to_torch(v), causal=True,
                                        window=window, softcap=softcap))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    pallas = flash_pallas(jq, jk, jv, causal=True, window=window,
                          softcap=softcap, block_q=64, block_kv=64,
                          interpret=True)
    oracle = ref.flash_attention_ref(jq, jk, jv, causal=True, window=window,
                                     softcap=softcap)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, np.asarray(oracle), rtol=2e-4, atol=2e-4)


def test_plain_bf16_matches_pallas_and_oracle():
    q, k, v = _qkv(2, 1, 4, 4, 128, 64)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    tq, tk, tv = (_to_torch(np.asarray(a, np.float32), torch.bfloat16)
                  for a in (jq, jk, jv))
    got = tfa.flash_attention_plain(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    pallas = flash_pallas(jq, jk, jv, causal=True, block_q=64, block_kv=64,
                          interpret=True)
    oracle = ref.flash_attention_ref(jq, jk, jv, causal=True)
    for want in (pallas, oracle):
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("s,causal,window,softcap", [
    (100, True, 16, 50.0), (77, False, 10, None), (129, False, None, 30.0)])
def test_plain_any_length_and_query_chunks_match_oracle(monkeypatch, s,
                                                       causal, window,
                                                       softcap):
    """Lengths no TPU block divides (against the oracle only: the Pallas
    wrapper refuses them), whole and in query chunks of 7 rows."""
    q, k, v = _qkv(3, 2, 4, 2, s, 32)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = np.asarray(ref.flash_attention_ref(jq, jk, jv, causal=causal,
                                              window=window,
                                              softcap=softcap))
    args = (_to_torch(q), _to_torch(k), _to_torch(v), causal, window,
            softcap)
    whole = _np(tfa.flash_attention_plain(*args))
    monkeypatch.setattr(tfa, "SCORE_BYTES", 4 * 2 * 4 * s * 7)
    chunked = _np(tfa.flash_attention_plain(*args))
    np.testing.assert_allclose(whole, want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(chunked, want, rtol=2e-4, atol=2e-4)


def test_wrapper_dispatches_by_device_and_checks_inputs():
    q, k, v = (_to_torch(a) for a in _qkv(4, 1, 4, 2, 16, 32))
    kernels.reset_counters()
    out = tfa.flash_attention(q, k, v, window=4, softcap=50.0)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert kernels.counters()["flash_attention"] == {"launches": 0,
                                                     "plain_calls": 1}
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfa.flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match="multiple"):
        tfa.flash_attention(q[:, :3], k, v)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tfa.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="window"):
        tfa.flash_attention(q, k, v, window=0)
    assert tfa.flash_attention_cuda.launches == 0


# --------------------------------------------------------------------------
# gqa_fwd / gqa_decode
# --------------------------------------------------------------------------

def _attn_cfgs(window=8, softcap=50.0, qk_norm=False):
    kw = dict(d_model=64, n_heads=4, n_kv=2, head_dim=16, window=window,
              softcap=softcap, qk_norm=qk_norm)
    return jattn.AttnConfig(**kw), tattn.AttnConfig(**kw)


def _attn_params(seed, jcfg, qk_norm):
    rng = np.random.default_rng(seed)
    d, h, kvh, hd = jcfg.d_model, jcfg.n_heads, jcfg.n_kv, jcfg.head_dim
    p = {"wq": rng.standard_normal((d, h * hd)) / 8,
         "wk": rng.standard_normal((d, kvh * hd)) / 8,
         "wv": rng.standard_normal((d, kvh * hd)) / 8,
         "wo": rng.standard_normal((h * hd, d)) / 8}
    if qk_norm:
        p["q_scale"] = rng.standard_normal(hd) / 4
        p["k_scale"] = rng.standard_normal(hd) / 4
    return {k: v.astype(np.float32) for k, v in p.items()}


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gqa_fwd_matches_jax(use_flash, dtype):
    """The port's one path against both reference paths: fp32 at rtol 1e-4
    / atol 1e-5; bf16 at 5e-2 / 5e-2 (the reference's bf16 kernel band;
    ``_sdpa`` scales q in float32, the kernel in q's type)."""
    jdt, tdt = DTYPES[dtype]
    jcfg, tcfg = _attn_cfgs(qk_norm=True)
    jcfg = dataclasses.replace(jcfg, use_flash=use_flash)
    p = _attn_params(5, jcfg, True)
    x = np.random.default_rng(6).standard_normal((2, 64, 64)).astype(
        np.float32)
    jp = {k: jnp.asarray(v, jdt) for k, v in p.items()}
    want, _ = jattn.gqa_fwd(jp, jnp.asarray(x, jdt), jcfg, jcommon.NO_SHARD)
    tp = {k: _to_torch(np.asarray(v, np.float32), tdt)
          for k, v in jp.items()}
    tx = _to_torch(np.asarray(jnp.asarray(x, jdt), np.float32), tdt)
    got = tattn.gqa_fwd(tp, tx, tcfg)
    tol = (1e-4, 1e-5) if dtype == "f32" else (5e-2, 5e-2)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=tol[0], atol=tol[1])


@pytest.mark.parametrize("ring", [6, 24])
def test_gqa_decode_ring_cache_matches_jax(ring):
    """Twenty decode steps on a ring of 6 slots (past the window of 8, so
    slots are overwritten) and on a full cache of 24, float32: outputs at
    rtol 1e-4 / atol 1e-5, cache contents and slot positions equal."""
    jcfg, tcfg = _attn_cfgs(window=8 if ring == 24 else 6)
    p = _attn_params(7, jcfg, False)
    xs = np.random.default_rng(8).standard_normal((20, 2, 1, 64)).astype(
        np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jc = {"k": jnp.zeros((2, 2, ring, 16)), "v": jnp.zeros((2, 2, ring, 16)),
          "pos": jnp.full((ring,), -1, jnp.int32)}
    tc = {"k": torch.zeros((2, 2, ring, 16)),
          "v": torch.zeros((2, 2, ring, 16)),
          "pos": torch.full((ring,), -1, dtype=torch.int32)}
    for t in range(20):
        want, jc = jattn.gqa_decode(jp, jnp.asarray(xs[t]), jc, jcfg,
                                    jcommon.NO_SHARD, jnp.asarray(t))
        got, tc = tattn.gqa_decode(tp, torch.from_numpy(xs[t]), tc, tcfg, t)
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4,
                                   atol=1e-5)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    np.testing.assert_allclose(_np(tc["k"]), np.asarray(jc["k"]), rtol=1e-5,
                               atol=1e-6)


def test_gqa_decode_bf16_cache_returns_float32_products():
    """bf16 cache: the port widens the operands and multiplies in float32,
    as the reference's ``preferred_element_type``; 12 steps against the
    JAX decode at 2e-2 / 2e-2 (one bf16 rounding of the output apart)."""
    jcfg, tcfg = _attn_cfgs(window=None)
    p = _attn_params(9, jcfg, False)
    xs = np.random.default_rng(10).standard_normal((12, 2, 1, 64))
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()}
    tp = {k: _to_torch(np.asarray(v, np.float32), torch.bfloat16)
          for k, v in jp.items()}
    jc = {"k": jnp.zeros((2, 2, 12, 16), jnp.bfloat16),
          "v": jnp.zeros((2, 2, 12, 16), jnp.bfloat16),
          "pos": jnp.full((12,), -1, jnp.int32)}
    tc = {"k": torch.zeros((2, 2, 12, 16), dtype=torch.bfloat16),
          "v": torch.zeros((2, 2, 12, 16), dtype=torch.bfloat16),
          "pos": torch.full((12,), -1, dtype=torch.int32)}
    for t in range(12):
        jx = jnp.asarray(xs[t], jnp.bfloat16)
        want, jc = jattn.gqa_decode(jp, jx, jc, jcfg, jcommon.NO_SHARD,
                                    jnp.asarray(t))
        got, tc = tattn.gqa_decode(
            tp, _to_torch(np.asarray(jx, np.float32), torch.bfloat16), tc,
            tcfg, t)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   rtol=2e-2, atol=2e-2)


# --------------------------------------------------------------------------
# norms and rotary embedding
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rms_norm_matches_jax(dtype):
    """float32 at 1e-6; bf16 equal up to one bf16 ulp (8e-3 relative)."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(11)
    x = jnp.asarray(rng.standard_normal((3, 5, 64)) * 3, jdt)
    scale = jnp.asarray(rng.standard_normal(64) / 4, jdt)
    want = np.asarray(jcommon.rms_norm(x, scale), np.float32)
    got = tcommon.rms_norm(_to_torch(np.asarray(x, np.float32), tdt),
                           _to_torch(np.asarray(scale, np.float32), tdt))
    assert got.dtype == tdt
    tol = 1e-6 if dtype == "f32" else 8e-3
    np.testing.assert_allclose(_np(got), want, rtol=tol, atol=tol)


def test_layer_norm_matches_jax():
    rng = np.random.default_rng(12)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 2 + 1
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    want = np.asarray(jcommon.layer_norm(*map(jnp.asarray, (x, scale, bias))))
    got = tcommon.layer_norm(*map(torch.from_numpy, (x, scale, bias)))
    np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_apply_rope_matches_jax(dtype):
    """Half-split layout, frequencies cast to x's type before the angle;
    positions up to 8191 (bf16 frequencies change the angle there).
    float32 at 1e-4 (sin/cos of large angles); bf16 at one bf16 ulp of the
    values (2e-2 absolute on unit-scale inputs)."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(13)
    x = jnp.asarray(rng.standard_normal((2, 3, 9, 32)), jdt)
    pos = np.array([0, 1, 2, 31, 32, 1000, 4095, 4096, 8191])
    want = np.asarray(jcommon.apply_rope(x, jnp.asarray(pos)), np.float32)
    got = tcommon.apply_rope(_to_torch(np.asarray(x, np.float32), tdt),
                             torch.from_numpy(pos))
    assert got.dtype == tdt
    tol = 1e-4 if dtype == "f32" else 2e-2
    np.testing.assert_allclose(_np(got), want, rtol=tol, atol=tol)
    np.testing.assert_allclose(tcommon.rope_frequencies(32, 1e4),
                               jcommon.rope_frequencies(32, 1e4), rtol=0)
