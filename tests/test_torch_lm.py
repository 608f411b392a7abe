"""The port's LM serving path against the JAX package, on the CPU.

Reduced gemma2 (4 layers, local/global pattern, window 16, soft-caps 50
and 30), with the reference's parameters carried across by
``load_reference_params``: ``forward``, ``prefill`` and a decode sequence
against the JAX ``LM`` in float32 (rtol 1e-3, atol 1e-4: the reference's
decode-vs-forward band, ``tests/test_models.py:86-87``) and bfloat16 (see
``BF16_TOL``); the port's own decode-equals-forward and ring-equals-full
cache checks; configs, cells, input specs and the step builders.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models.lm import make_model
from repro_torch import configs as tconfigs
from repro_torch.launch.steps import build_prefill_step, build_serve_step
from repro_torch.models.attention import MLAConfig
from repro_torch.models.lm import (ATTN_KINDS, LM, NOT_PORTED_KINDS,
                                   PORTED_KINDS, load_reference_params)

B, S = 2, 24            # 24 > the reduced window of 16: the ring wraps
F32_TOL = dict(rtol=1e-3, atol=1e-4)
#: bf16 band: both packages round every activation to bf16, but in other
#: places (torch's gelu rounds once, the reference's jnp gelu once per
#: operation; other matmul kernels), so hidden states part by a few bf16
#: ulps: measured on the CPU, max |diff| 0.049 on hidden states up to 3.8
#: (3 ulps there), 0.014 on prefill logits, 0.018 on decode logits
BF16_TOL = dict(rtol=5e-2, atol=1e-1)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _pair(dtype, **kw):
    """(JAX model, its params, the port's model holding them, port cfg)."""
    jdt, tdt = DTYPES[dtype]
    jcfg = dataclasses.replace(jconfigs.reduced("gemma2-9b"), dtype=jdt, **kw)
    tcfg = dataclasses.replace(tconfigs.reduced("gemma2-9b"), dtype=tdt, **kw)
    jm = make_model(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    tm = load_reference_params(jax.tree.map(np.asarray, params), tcfg,
                               device="cpu")
    return jm, params, tm, tcfg


def _tokens(seed=0, s=S, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (B, s)).astype(
        np.int32)


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_forward_and_logits_match_jax(dtype):
    jm, params, tm, _ = _pair(dtype)
    tok = _tokens()
    jh, _, _ = jm.forward(params, jnp.asarray(tok), remat=False)
    th = tm(torch.from_numpy(tok))
    tol = F32_TOL if dtype == "f32" else BF16_TOL
    np.testing.assert_allclose(_np(th), np.asarray(jh, np.float32), **tol)
    np.testing.assert_allclose(_np(tm.logits(th)),
                               np.asarray(jm.logits(params, jh)), **tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_prefill_matches_jax(dtype):
    jm, params, tm, _ = _pair(dtype)
    tok = _tokens(1)
    want = np.asarray(jm.prefill(params, jnp.asarray(tok)))
    got = tm.prefill(torch.from_numpy(tok))
    assert got.shape == (B, 1, 512) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), want,
                               **(F32_TOL if dtype == "f32" else BF16_TOL))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_sequence_matches_jax(dtype):
    """24 steps from empty caches (the local layers' ring of 16 wraps)."""
    jm, params, tm, _ = _pair(dtype)
    tok = _tokens(2)
    jc = jm.init_cache(B, S)
    tc = tm.init_cache(B, S)
    dec = jax.jit(jm.decode_step)
    tol = F32_TOL if dtype == "f32" else BF16_TOL
    for t in range(S):
        want, jc = dec(params, jnp.asarray(tok[:, t:t + 1]),
                       jnp.asarray(t, jnp.int32), jc)
        got, tc = tm.decode_step(torch.from_numpy(tok[:, t:t + 1]), t, tc)
        np.testing.assert_allclose(_np(got), np.asarray(want), **tol)


def test_decode_equals_forward_fp32():
    """The port alone: decoding token by token gives, at every position,
    the logits of the full-sequence pass (``tests/test_models.py:74``)."""
    cfg = dataclasses.replace(tconfigs.reduced("gemma2-9b"),
                              dtype=torch.float32)
    model = LM(cfg, device="cpu",
               generator=torch.Generator().manual_seed(3))
    tok = torch.from_numpy(_tokens(3))
    hidden = model(tok)
    want = model.logits(hidden)
    caches = model.init_cache(B, S)
    for t in range(S):
        got, caches = model.decode_step(tok[:, t:t + 1], t, caches)
        np.testing.assert_allclose(_np(got[:, 0]), _np(want[:, t]),
                                   **F32_TOL)


def test_ring_cache_equals_full_cache_for_window_layer():
    """Window 8, 24 steps: the local layers' ring of 8 slots gives the
    logits of a full 24-slot cache (``tests/test_models.py:91``)."""
    cfg = dataclasses.replace(tconfigs.reduced("gemma2-9b"),
                              dtype=torch.float32, window=8)
    model = LM(cfg, device="cpu",
               generator=torch.Generator().manual_seed(4))
    tok = torch.from_numpy(_tokens(4))
    ring = model.init_cache(B, S)
    assert ring[0]["k"].shape[2] == 8 and ring[1]["k"].shape[2] == S
    full = model.init_cache(B, S)
    full[0] = {"k": torch.zeros_like(full[1]["k"]),
               "v": torch.zeros_like(full[1]["v"]),
               "pos": torch.full((S,), -1, dtype=torch.int32)}
    full[2] = {n: t.clone() for n, t in full[0].items()}
    want = model.logits(model(tok))
    for t in range(S):
        a, ring = model.decode_step(tok[:, t:t + 1], t, ring)
        b, full = model.decode_step(tok[:, t:t + 1], t, full)
        np.testing.assert_allclose(_np(a), _np(b), **F32_TOL)
        np.testing.assert_allclose(_np(a[:, 0]), _np(want[:, t]), **F32_TOL)


def test_load_reference_params_orders_layers_by_repeat():
    """``stack/b{i}[r]`` is layer r * len(pattern) + i: layer 1 holds the
    first global block, layer 2 the second local one."""
    _, params, tm, _ = _pair("f32")
    stack = jax.tree.map(np.asarray, params["stack"])
    for layer, (b, r) in enumerate([("b0", 0), ("b1", 0), ("b0", 1),
                                    ("b1", 1)]):
        np.testing.assert_array_equal(
            tm.layers[layer]["attn"]["wq"].numpy(), stack[b]["attn"]["wq"][r])
        assert ("post_ln1" in tm.layers[layer]) is True
    np.testing.assert_array_equal(tm.embed.numpy(),
                                  np.asarray(params["embed"]))


# --------------------------------------------------------------------------
# configs and cells
# --------------------------------------------------------------------------

def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("which", ["get_config", "reduced"])
def test_config_equals_reference_field_by_field(which):
    want = _fields(getattr(jconfigs, which)("gemma2-9b"))
    got = _fields(getattr(tconfigs, which)("gemma2-9b"))
    assert want.pop("dtype") == jnp.bfloat16
    assert got.pop("dtype") == torch.bfloat16
    assert got == want


def test_cells_and_skips_equal_reference():
    assert tconfigs.SHAPES == jconfigs.SHAPES
    assert tconfigs.DECODE_SHAPES == jconfigs.DECODE_SHAPES
    jcfg, tcfg = jconfigs.get_config("gemma2-9b"), tconfigs.get_config(
        "gemma2-9b")
    for enc in (False, True):
        for shape in jconfigs.SHAPES:
            assert tconfigs.cell_skip_reason(
                dataclasses.replace(tcfg, encoder_only=enc), shape) == \
                jconfigs.cell_skip_reason(
                    dataclasses.replace(jcfg, encoder_only=enc), shape)


def test_param_count_equals_reference():
    """9.24 B parameters at full width (17.2 GiB in bf16)."""
    for name in ("gemma2-9b",):
        for fn in ("get_config", "reduced"):
            assert getattr(tconfigs, fn)(name).param_count() == \
                getattr(jconfigs, fn)(name).param_count()
    assert tconfigs.get_config("gemma2-9b").param_count() == 9_241_705_984


def test_unported_architectures_and_blocks_raise():
    """Nothing is left unported: the registry holds the reference's
    architectures, in its order, each config buildable; a block kind the
    reference does not have is still refused."""
    assert tconfigs.NOT_PORTED == ()
    assert tconfigs.ARCH_NAMES == jconfigs.ARCH_NAMES
    for name in jconfigs.ARCH_NAMES:
        assert tconfigs.get_config(name).name == name
        assert tconfigs.reduced(name).name == jconfigs.reduced(name).name
    cfg = dataclasses.replace(tconfigs.reduced("gemma2-9b"),
                              pattern=("attn", "conv"))
    with pytest.raises(ValueError, match="unknown block kind"):
        LM(cfg, device="cpu")


def test_block_kinds_and_configs():
    assert NOT_PORTED_KINDS == ()
    assert set(PORTED_KINDS) == set(ATTN_KINDS) | {
        "mla", "xattn", "mamba", "mamba_shared", "mlstm", "slstm"}
    ref_kinds = {kind for name in jconfigs.ARCH_NAMES
                 for cfg in (jconfigs.get_config(name),)
                 for kind in cfg.prelude + cfg.pattern}
    assert ref_kinds <= set(PORTED_KINDS)
    assert tconfigs.get_config("minicpm3-4b").layer_kinds == ("mla",) * 62
    kinds = tconfigs.get_config("llama-3.2-vision-11b").layer_kinds
    assert len(kinds) == 40 and kinds.count("xattn") == 8
    assert [i for i, k in enumerate(kinds) if k == "xattn"] == \
        list(range(4, 40, 5))
    assert tconfigs.get_config("minicpm3-4b").mla_cfg() == MLAConfig(
        2560, 40, 768, 256, 64, 32, 64, 10000.0)


def test_input_specs_are_concrete():
    cfg = tconfigs.get_config("gemma2-9b")
    assert tconfigs.input_specs(cfg, "prefill_32k") == {
        "tokens": ((32, 32768), torch.int32)}
    assert tconfigs.input_specs(cfg, "prefill_32k", batch=2, seq=8192) == {
        "tokens": ((2, 8192), torch.int32)}
    dec = tconfigs.input_specs(cfg, "decode_32k", batch=2)
    assert dec["token"] == ((2, 1), torch.int32)
    assert len(dec["caches"]) == 42
    assert dec["caches"][0]["k"] == ((2, 8, 4096, 256), torch.bfloat16)
    assert dec["caches"][1]["k"] == ((2, 8, 32768, 256), torch.bfloat16)
    assert dec["caches"][1]["pos"] == ((32768,), torch.int32)
    train = tconfigs.input_specs(cfg, "train_4k")
    assert train["labels"] == ((256, 4096), torch.int32)
    assert tconfigs.input_specs(dataclasses.replace(cfg, encoder_only=True),
                                "prefill_32k", batch=2, seq=8) == {
        "tokens": ((2, 8, 3584), torch.bfloat16)}
    vlm = dataclasses.replace(cfg, family="vlm", n_ctx_tokens=16)
    assert tconfigs.input_specs(vlm, "prefill_32k", batch=2, seq=8) == {
        "tokens": ((2, 8), torch.int32),
        "ctx": ((2, 16, 3584), torch.bfloat16)}


# --------------------------------------------------------------------------
# step builders and init
# --------------------------------------------------------------------------

def test_step_builders_on_the_cpu():
    cfg = dataclasses.replace(tconfigs.reduced("gemma2-9b"),
                              dtype=torch.float32)
    pre = build_prefill_step(cfg, batch=B, seq=S, device="cpu", seed=5)
    assert pre.in_specs == {"tokens": ((B, S), torch.int32)}
    tok = torch.from_numpy(_tokens(5))
    logits = pre.fn(tok)
    assert logits.shape == (B, 1, cfg.vocab)
    serve = build_serve_step(cfg, batch=B, seq=S, model=pre.model)
    assert serve.model is pre.model
    caches = pre.model.init_cache(B, S)
    for t in range(S):
        got, caches = serve.fn(tok[:, t:t + 1], t, caches)
    np.testing.assert_allclose(_np(got), _np(logits), **F32_TOL)
    again = build_prefill_step(cfg, batch=B, seq=S, device="cpu", seed=5)
    assert torch.equal(again.fn(tok), logits)


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfigs.reduced("gemma2-9b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_prefill_step(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_serve_step(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LM(cfg)


def test_init_follows_the_reference_distributions():
    cfg = dataclasses.replace(tconfigs.reduced("gemma2-9b"), d_model=256,
                              d_ff=512, vocab=4096, dtype=torch.float32)
    model = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(6))
    assert abs(float(model.embed.std()) - 0.02) < 1e-3
    w = model.layers[0]["ffn"]["w_gate"]
    bound = 2.0 / np.sqrt(cfg.d_model)
    assert float(w.abs().max()) <= bound + 1e-7
    # N(0, 1) cut to [-2, 2] has std 0.8796
    assert abs(float(w.std()) * np.sqrt(cfg.d_model) - 0.8796) < 0.02
    assert float(model.layers[1]["post_ln2"]["scale"].abs().max()) == 0.0
    assert all(not p.requires_grad for p in model.parameters())
    same = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(6))
    assert torch.equal(same.layers[3]["attn"]["wo"],
                       model.layers[3]["attn"]["wo"])
