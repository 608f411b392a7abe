"""MLA (minicpm3-4b) and gated cross-attention (llama-3.2-vision-11b)
against the JAX package, on the CPU.

The same numpy inputs and the reference's own parameters (drawn by
``jax.random``, carried across as numpy) go through ``repro.models`` and
``repro_torch.models``.  Bands: float32 rtol 1e-3, atol 1e-4 (the
reference's decode-vs-forward band, ``tests/test_models.py:86-87``).
bfloat16: one layer rounds where the reference does, so its output is the
reference's to within one bf16 unit in the last place (rtol 1e-2, atol
1e-3; on this CPU most outputs are the same bits), a band that a rounding
dropped or added in MLA decode leaves (one ulp at 40-50 % of the outputs);
the whole models, at ``tests/test_torch_lm_zoo.py``'s band.  The reference zero-initialises the
cross-attention gate, and ``tanh(0)`` multiplies the whole attention away,
so every comparison sets the gates to a nonzero value first.

Besides the layers, the caches, the gate, the ``ctx`` input and the step
builders, this file runs ``tests/test_torch_lm_zoo.py``'s whole-model
checks (forward, prefill and decode against the reference, the configs
field by field) on both reduced configs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import attention as jattn
from repro.models.common import NO_SHARD
from repro.models.lm import make_model
from repro_torch import configs as tconfigs
from repro_torch.launch.steps import build_prefill_step, build_serve_step
from repro_torch.models import attention as tattn
from repro_torch.models.lm import (LM, _tensor, block_cache_shapes,
                                   load_reference_params)
from test_torch_lm_zoo import (GATE, MLA_XATTN, check_config,
                               check_decode, check_forward)

B, S = 2, 24
F32_TOL = dict(rtol=1e-3, atol=1e-4)
#: one bf16 ulp (2^-8 to 2^-7 of the value) and a little
BF16_TOL = dict(rtol=1e-2, atol=1e-3)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
MLA = "minicpm3-4b"
VLM = "llama-3.2-vision-11b"


def _np(t):
    return t.float().numpy()


def _torch_params(p):
    return {k: _tensor(np.asarray(v)) for k, v in p.items()}


def _x(shape, dtype, seed=0):
    """N(0, 1) numpy input and its two copies in ``dtype``."""
    jdt, tdt = DTYPES[dtype]
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _mla(dtype, seed=0):
    """(the two packages' MLAConfig, reference params, port params) of the
    reduced minicpm3's widths."""
    cfg = jconfigs.reduced(MLA)
    jcfg = cfg.mla_cfg()
    jp = jattn.init_mla(jax.random.PRNGKey(seed), jcfg, DTYPES[dtype][0])
    return jcfg, tconfigs.reduced(MLA).mla_cfg(), jp, _torch_params(jp)


def _cross(dtype, gate=GATE, seed=0):
    """(reference AttnConfig, port AttnConfig, reference params, port
    params) of the reduced llama-vision's cross-attention, gate set."""
    jcfg = jconfigs.reduced(VLM).attn_cfg("attn")
    jp = jattn.init_cross(jax.random.PRNGKey(seed), jcfg, DTYPES[dtype][0])
    jp["gate"] = jnp.asarray(gate, jp["gate"].dtype)
    return (jcfg, tconfigs.reduced(VLM).attn_cfg("xattn"), jp,
            _torch_params(jp))


# --------------------------------------------------------------------------
# MLA
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mla_fwd_matches_jax(dtype):
    jcfg, tcfg, jp, tp = _mla(dtype)
    jx, tx = _x((B, S, jcfg.d_model), dtype)
    want, _ = jattn.mla_fwd(jp, jx, jcfg, NO_SHARD)
    got = tattn.mla_fwd(tp, tx, tcfg)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (B, S, jcfg.d_model)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **(F32_TOL if dtype == "f32" else BF16_TOL))


def test_mla_fwd_query_chunks_match_jax():
    """S 2048: two query chunks of 1024 rows, the second reaching every
    key column, the first only its own."""
    jcfg, tcfg, jp, tp = _mla("f32", seed=1)
    jx, tx = _x((1, 2048, jcfg.d_model), "f32", seed=1)
    want, _ = jattn.mla_fwd(jp, jx, jcfg, NO_SHARD)
    np.testing.assert_allclose(_np(tattn.mla_fwd(tp, tx, tcfg)),
                               np.asarray(want), **F32_TOL)


def _mla_caches(jcfg, dtype, s_max):
    jdt, tdt = DTYPES[dtype]
    shapes = {"kv_lat": (B, s_max, jcfg.kv_lora_rank),
              "k_rope": (B, s_max, jcfg.qk_rope_dim)}
    jc = {k: jnp.zeros(v, jdt) for k, v in shapes.items()}
    jc["pos"] = jnp.full((s_max,), -1, jnp.int32)
    tc = {k: torch.zeros(v, dtype=tdt) for k, v in shapes.items()}
    tc["pos"] = torch.full((s_max,), -1, dtype=torch.int32)
    return jc, tc


def _widening_einsum(einsum):
    """``jnp.einsum`` with bf16 operands widened to float32 when float32
    is asked for: the same exact products and float32 sums (XLA's CPU dot
    refuses one of MLA decode's bf16 x bf16 -> f32 contractions)."""
    def f(spec, *ops, preferred_element_type=None, **kw):
        if preferred_element_type == jnp.float32:
            ops = [o.astype(jnp.float32) for o in ops]
        return einsum(spec, *ops, preferred_element_type=
                      preferred_element_type, **kw)
    return f


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mla_decode_matches_jax(dtype, monkeypatch):
    """12 steps on a 16-slot latent cache: each step's output and the
    cache after it (latent, rotated key part, slot positions), the cache
    updated in place.  In bfloat16 the port rounds where the reference
    does (q_abs and the weights to the cache's type, the latent output to
    wkv_b's), so the outputs agree to about one bf16 ulp."""
    monkeypatch.setattr(jnp, "einsum", _widening_einsum(jnp.einsum))
    jcfg, tcfg, jp, tp = _mla(dtype, seed=2)
    jx, tx = _x((B, 12, jcfg.d_model), dtype, seed=2)
    jc, tc = _mla_caches(jcfg, dtype, 16)
    ids = {k: id(v) for k, v in tc.items()}
    dec = jax.jit(lambda p, x, c, pos: jattn.mla_decode(p, x, c, jcfg,
                                                        NO_SHARD, pos))
    tol = F32_TOL if dtype == "f32" else BF16_TOL
    for t in range(12):
        want, jc = dec(jp, jx[:, t:t + 1], jc, jnp.asarray(t, jnp.int32))
        got, tc = tattn.mla_decode(tp, tx[:, t:t + 1], tc, tcfg, t)
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   **tol)
    assert {k: id(v) for k, v in tc.items()} == ids
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    assert tc["pos"].tolist() == list(range(12)) + [-1] * 4
    for k in ("kv_lat", "k_rope"):
        np.testing.assert_allclose(_np(tc[k]), np.asarray(jc[k], np.float32),
                                   **tol)


def test_mla_decode_absorbed_equals_expanded_fwd():
    """The port against itself, float32: the weight-absorbed decode step
    at each position gives the expanded full-sequence pass's row."""
    _, tcfg, _, tp = _mla("f32", seed=3)
    _, tx = _x((B, S, tcfg.d_model), "f32", seed=3)
    want = tattn.mla_fwd(tp, tx, tcfg)
    _, tc = _mla_caches(tcfg, "f32", S)
    for t in range(S):
        got, tc = tattn.mla_decode(tp, tx[:, t:t + 1], tc, tcfg, t)
        np.testing.assert_allclose(_np(got[:, 0]), _np(want[:, t]),
                                   **F32_TOL)


# --------------------------------------------------------------------------
# cross-attention
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cross_fwd_matches_jax(dtype):
    """S 24 text rows over the 16 patch rows of the reduced config, GQA 2,
    no mask, no RoPE, gate 0.5."""
    jcfg, tcfg, jp, tp = _cross(dtype)
    n_ctx = jconfigs.reduced(VLM).n_ctx_tokens
    jx, tx = _x((B, S, jcfg.d_model), dtype, seed=4)
    jc, tc = _x((B, n_ctx, jcfg.d_model), dtype, seed=5)
    want = jattn.cross_fwd(jp, jx, jc, jcfg, NO_SHARD)
    got = tattn.cross_fwd(tp, tx, tc, tcfg)
    assert got.dtype == DTYPES[dtype][1]
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **(F32_TOL if dtype == "f32" else BF16_TOL))


def test_cross_fwd_query_chunks_match_jax():
    """2048 text rows (two query chunks) over 40 patch rows."""
    jcfg, tcfg, jp, tp = _cross("f32", gate=-0.7, seed=6)
    jx, tx = _x((1, 2048, jcfg.d_model), "f32", seed=6)
    jc, tc = _x((1, 40, jcfg.d_model), "f32", seed=7)
    want = jattn.cross_fwd(jp, jx, jc, jcfg, NO_SHARD)
    np.testing.assert_allclose(_np(tattn.cross_fwd(tp, tx, tc, tcfg)),
                               np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 2)])
def test_sdpa_matches_reference_sdpa(hq, hkv):
    """The port's plain non-causal attention against the reference's
    ``_sdpa`` with the causal mask off: Sq 24 != Skv 40, groups 1, 2 and
    4."""
    cfg = jattn.AttnConfig(d_model=64, n_heads=hq, n_kv=hkv, head_dim=16,
                           causal=False)
    jq, tq = _x((B, hq, S, 16), "f32", seed=8)
    jk, tk = _x((B, hkv, 40, 16), "f32", seed=9)
    jv, tv = _x((B, hkv, 40, 16), "f32", seed=10)
    np.testing.assert_allclose(_np(tattn._sdpa(tq * 3, tk, tv)),
                               np.asarray(jattn._sdpa(jq * 3, jk, jv, cfg)),
                               **F32_TOL)


def test_zero_gate_removes_cross_attention_exactly():
    """Gate 0: the layer adds exact zeros, so the model's output does not
    depend on the context at all; gate 0.5: it does."""
    cfg = dataclasses.replace(tconfigs.reduced(VLM), dtype=torch.float32)
    model = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    tok = torch.from_numpy(np.random.default_rng(11).integers(
        0, cfg.vocab, (B, S)).astype(np.int32))
    c1, c2 = (torch.randn((B, cfg.n_ctx_tokens, cfg.d_model),
                          generator=torch.Generator().manual_seed(s))
              for s in (12, 13))
    xattn = model.layers[cfg.layer_kinds.index("xattn")]
    assert float(xattn["attn"]["gate"]) == 0.0      # the reference's init
    h = torch.randn((B, S, cfg.d_model))
    assert torch.equal(tattn.cross_fwd(xattn["attn"], h, c1,
                                       cfg.attn_cfg("xattn")),
                       torch.zeros_like(h))
    assert torch.equal(model(tok, c1), model(tok, c2))
    model.set_xattn_gates(GATE)
    a, b = model(tok, c1), model(tok, c2)
    assert float((a - b).abs().max()) > 1e-2


# --------------------------------------------------------------------------
# the model: caches, ctx, loading, step builders
# --------------------------------------------------------------------------

def test_caches_equal_reference():
    """minicpm3: one latent cache per layer ({kv_lat, k_rope, pos}, no
    head axis), zeros and positions -1 as the reference's; llama-vision:
    GQA caches, None at each cross-attention layer."""
    for name in (MLA, VLM):
        jm = make_model(jconfigs.reduced(name))
        tm = LM(tconfigs.reduced(name), device="cpu")
        jc = jm.init_cache(B, S)["stack"]
        tc = tm.init_cache(B, S)
        cfg = tm.cfg
        for i, kind in enumerate(cfg.layer_kinds):
            r, j = divmod(i, len(cfg.pattern))
            want = jc.get(f"b{j}")
            if want is None:
                assert kind == "xattn" and tc[i] is None
                assert block_cache_shapes(kind, cfg, B, S) is None
                continue
            assert set(tc[i]) == set(want)
            for k, t in tc[i].items():
                np.testing.assert_array_equal(t.float().numpy(),
                                              np.asarray(want[k][r],
                                                         np.float32))
                assert t.dtype == {jnp.dtype(jnp.int32): torch.int32,
                                   jnp.dtype(jnp.bfloat16):
                                       torch.bfloat16}[want[k].dtype]
    mla = tconfigs.get_config(MLA)
    assert block_cache_shapes("mla", mla, 2, 8192) == {
        "kv_lat": ((2, 8192, 256), torch.bfloat16),
        "k_rope": ((2, 8192, 32), torch.bfloat16),
        "pos": ((8192,), torch.int32)}


def test_load_reference_params_takes_gates_and_mla_leaves():
    """Each repeat's 0-d gate (stacked to (R,) in the reference) lands on
    its layer as a 0-d parameter of the model's type; MLA's leaves load by
    name."""
    cfg = dataclasses.replace(jconfigs.reduced(VLM), n_layers=10)
    tree = jax.tree.map(np.asarray, make_model(cfg).init(
        jax.random.PRNGKey(3)))
    gates = tree["stack"]["b4"]["attn"]["gate"]
    assert gates.shape == (2,)
    tree["stack"]["b4"]["attn"]["gate"] = np.asarray([0.25, -0.5],
                                                     gates.dtype)
    tcfg = dataclasses.replace(tconfigs.reduced(VLM), n_layers=10)
    tm = load_reference_params(tree, tcfg, device="cpu")
    for layer, want in ((4, 0.25), (9, -0.5)):
        g = tm.layers[layer]["attn"]["gate"]
        assert g.shape == () and g.dtype == torch.bfloat16
        assert float(g) == want
    np.testing.assert_array_equal(
        _np(tm.layers[7]["attn"]["wq"]),
        np.asarray(tree["stack"]["b2"]["attn"]["wq"][1], np.float32))
    jtree = jax.tree.map(np.asarray, make_model(jconfigs.reduced(MLA)).init(
        jax.random.PRNGKey(4)))
    tm = load_reference_params(jtree, tconfigs.reduced(MLA), device="cpu")
    names = {k.split(".", 3)[3] for k in tm.state_dict()
             if k.startswith("layers.1.attn.")}
    assert names == {"wq_a", "q_a_scale", "wq_b", "wkv_a", "kv_a_scale",
                     "wkv_b", "wo"}
    np.testing.assert_array_equal(
        _np(tm.layers[1]["attn"]["wkv_b"]),
        np.asarray(jtree["stack"]["b0"]["attn"]["wkv_b"][1], np.float32))


def test_vlm_needs_its_context():
    """Without ctx a VLM raises (it does not skip its cross-attention
    layers); a ctx of another batch or width raises; a model without
    cross-attention ignores ctx, as the reference."""
    cfg = dataclasses.replace(tconfigs.reduced(VLM), dtype=torch.float32)
    model = LM(cfg, device="cpu")
    tok = torch.zeros((B, 4), dtype=torch.int32)
    for call in (lambda: model(tok), lambda: model.prefill(tok),
                 lambda: model.decode_step(tok[:, :1], 0,
                                           model.init_cache(B, 4)),
                 lambda: build_prefill_step(cfg, batch=B, seq=4,
                                            model=model).fn(tok)):
        with pytest.raises(ValueError, match="pass ctx"):
            call()
    for shape in ((B + 1, 16, cfg.d_model), (B, 16, cfg.d_model + 1),
                  (16, cfg.d_model)):
        with pytest.raises(ValueError, match="ctx of shape"):
            model(tok, torch.zeros(shape))
    other = LM(dataclasses.replace(tconfigs.reduced(MLA),
                                   dtype=torch.float32), device="cpu")
    assert torch.equal(other(tok), other(tok, torch.zeros((1, 2, 3))))


@pytest.mark.parametrize("name", [MLA, VLM])
def test_step_builders_take_ctx(name):
    """build_prefill_step / build_serve_step on the CPU, float32: the
    specs name ctx for the VLM only; S decode steps end at prefill's
    logits; the same seed gives the same bits."""
    cfg = dataclasses.replace(tconfigs.reduced(name), dtype=torch.float32)
    pre = build_prefill_step(cfg, batch=B, seq=S, device="cpu", seed=5)
    serve = build_serve_step(cfg, batch=B, seq=S, model=pre.model)
    tok = torch.from_numpy(np.random.default_rng(14).integers(
        0, cfg.vocab, (B, S)).astype(np.int32))
    ctx = None
    if name == VLM:
        assert pre.in_specs["ctx"] == serve.in_specs["ctx"] == \
            ((B, cfg.n_ctx_tokens, cfg.d_model), torch.float32)
        ctx = torch.randn(pre.in_specs["ctx"][0],
                          generator=torch.Generator().manual_seed(15))
    else:
        assert "ctx" not in pre.in_specs and "ctx" not in serve.in_specs
    pre.model.set_xattn_gates(GATE)
    logits = pre.fn(tok, ctx)
    caches = pre.model.init_cache(B, S)
    assert [c is None for c in caches] == \
        [k == "xattn" for k in cfg.layer_kinds]
    for t in range(S):
        got, caches = serve.fn(tok[:, t:t + 1], t, caches, ctx)
    np.testing.assert_allclose(_np(got), _np(logits), **F32_TOL)
    again = build_prefill_step(cfg, batch=B, seq=S, device="cpu", seed=5)
    again.model.set_xattn_gates(GATE)
    assert torch.equal(again.fn(tok, ctx), logits)


# --------------------------------------------------------------------------
# the whole reduced models against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", MLA_XATTN)
def test_forward_logits_prefill_and_aux_match_jax(name, dtype):
    check_forward(name, dtype)


@pytest.mark.parametrize("name", MLA_XATTN)
def test_decode_sequence_matches_jax(name):
    check_decode(name)


@pytest.mark.parametrize("name", MLA_XATTN)
def test_configs_equal_reference_field_by_field(name):
    check_config(name)
