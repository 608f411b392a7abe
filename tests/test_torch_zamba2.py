"""The reduced zamba2-7b (Mamba2 layers and a shared attention block)
against the JAX package, on the CPU.

Each reduced model (10 layers: one prelude ``mamba`` layer, then three
repeats of ``mamba, mamba, mamba_shared``) holds the reference's
parameters, carried across by ``load_reference_params``; the same seeded
numpy tokens go through both.  Bands: float32 rtol 1e-3, atol 1e-4 (the
reference's decode-vs-forward band, ``tests/test_models.py:86-87``);
bfloat16 ``tests/test_torch_lm_zoo.py``'s whole-model band (rtol 5e-2,
atol 1e-1: both packages round every activation to bf16, at other places
in the attention and the FFN).  The reduced SSD chunk is 16, so every
sequence here is a multiple of 16 or shorter than 16.

Besides the whole model, the file checks that the shared block is one
parameter set, the caches and input specs (every shape, ``long_500k``
included: zamba2 is sub-quadratic), the config, the parameter count, the
step builders and the flash-launch count of a prefill.
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
from repro_torch.models.lm import (LM, block_cache_shapes, block_cache_zeros,
                                   flash_layers, load_reference_params)
from test_torch_lm_zoo import check_config

NAME = "zamba2-7b"
B, S = 2, 32
F32_TOL = dict(rtol=1e-3, atol=1e-4)
BF16_TOL = dict(rtol=5e-2, atol=1e-1)
TOL = {"f32": F32_TOL, "bf16": BF16_TOL}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TORCH_OF = {jnp.dtype(jnp.int32): torch.int32,
            jnp.dtype(jnp.float32): torch.float32,
            jnp.dtype(jnp.bfloat16): torch.bfloat16}


def _np(t):
    return t.float().numpy()


def _pair(dtype, seed=0):
    """(JAX model, its params, the port's model holding them)."""
    jdt, tdt = DTYPES[dtype]
    jcfg = dataclasses.replace(jconfigs.reduced(NAME), dtype=jdt)
    tcfg = dataclasses.replace(tconfigs.reduced(NAME), dtype=tdt)
    jm = make_model(jcfg)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    tm = load_reference_params(tree, tcfg, device="cpu")
    return jm, jax.tree.map(jnp.asarray, tree), tm


def _tokens(vocab, seed=0, s=S):
    return np.random.default_rng(seed).integers(0, vocab, (B, s)).astype(
        np.int32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_forward_logits_prefill_match_jax(dtype):
    """forward's hidden states (S 32: two chunks), the logits and the
    prefill's last-position logits against the reference's; aux is 0."""
    jm, params, tm = _pair(dtype)
    tok = _tokens(tm.cfg.vocab)
    jh, _, jaux = jax.jit(lambda p, t: jm.forward(p, t, remat=False))(
        params, jnp.asarray(tok))
    th, taux = tm(torch.from_numpy(tok), return_aux=True)
    assert th.dtype == DTYPES[dtype][1]
    np.testing.assert_allclose(_np(th), np.asarray(jh, np.float32),
                               **TOL[dtype])
    np.testing.assert_allclose(_np(tm.logits(th)),
                               np.asarray(jm.logits(params, jh)),
                               **TOL[dtype])
    got = tm.prefill(torch.from_numpy(tok))
    assert got.shape == (B, 1, tm.cfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(
        jm.prefill(params, jnp.asarray(tok))), **TOL[dtype])
    assert float(taux) == float(jaux) == 0.0


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_sequence_matches_jax(dtype):
    """24 decode steps from empty caches (32 slots): every step's logits,
    then every layer's conv states, float32 SSM state and shared K/V cache
    against the reference's."""
    jm, params, tm = _pair(dtype, seed=1)
    tok = _tokens(tm.cfg.vocab, seed=2)
    jc, tc = jm.init_cache(B, S), tm.init_cache(B, S)
    dec = jax.jit(jm.decode_step)
    for t in range(24):
        want, jc = dec(params, jnp.asarray(tok[:, t:t + 1]),
                       jnp.asarray(t, jnp.int32), jc)
        got, tc = tm.decode_step(torch.from_numpy(tok[:, t:t + 1]), t, tc)
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL[dtype])
    for i, (kind, layer) in enumerate(zip(tm.cfg.layer_kinds,
                                          _ref_caches(tm.cfg, jc))):
        got, want = _leaves(tc[i]), _leaves(layer)
        assert set(got) == set(want), i
        for name, t in got.items():
            if name.endswith("pos"):
                np.testing.assert_array_equal(t.numpy(), want[name])
            else:
                np.testing.assert_allclose(_np(t), want[name].astype(
                    np.float32), **TOL[dtype], err_msg=f"{i} {name}")


def test_decode_equals_chunked_prefill():
    """The port against itself in float32: decoding 32 tokens one by one
    gives, at positions 7, 15 and 31, the logits of the chunked prefill of
    that prefix (one chunk of 8, one of 16, two of 16)."""
    cfg = dataclasses.replace(tconfigs.reduced(NAME), dtype=torch.float32)
    model = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    tok = torch.from_numpy(_tokens(cfg.vocab, seed=4))
    want = {p: model.prefill(tok[:, :p + 1]) for p in (7, 15, 31)}
    caches = model.init_cache(B, S)
    for t in range(S):
        got, caches = model.decode_step(tok[:, t:t + 1], t, caches)
        if t in want:
            np.testing.assert_allclose(_np(got), _np(want[t]), **F32_TOL)


def test_shared_block_is_one_parameter_set():
    """The model holds the shared attention block once (``shared_attn``):
    no layer has attention parameters of its own; loading the reference's
    top-level ``shared_attn`` fills it; changing it changes the output of
    every call site (each ``mamba_shared`` layer's contribution), and
    zeroing its output projection and FFN makes the model a pure Mamba2
    stack."""
    jm, params, tm = _pair("f32", seed=5)
    state = tm.state_dict()
    shared = {k for k in state if k.startswith("shared_attn.")}
    assert shared == {f"shared_attn.{k}" for k in (
        "ln1.scale", "attn.wq", "attn.wk", "attn.wv", "attn.wo",
        "ln2.scale", "ffn.w_gate", "ffn.w_up", "ffn.w_down")}
    assert not any(".attn." in k or ".ffn." in k for k in state
                   if k.startswith("layers."))
    np.testing.assert_array_equal(
        state["shared_attn.attn.wq"].numpy(),
        np.asarray(params["shared_attn"]["attn"]["wq"]))
    assert sum(p.numel() for p in tm.shared_attn.parameters()) == \
        sum(np.asarray(a).size for a in jax.tree.leaves(params["shared_attn"]))
    tok = torch.from_numpy(_tokens(tm.cfg.vocab, seed=6))
    before = tm(tok)
    with torch.no_grad():
        tm.shared_attn["attn"]["wo"].mul_(2.0)
    assert float((tm(tok) - before).abs().max()) > 1e-3
    # every mamba_shared layer reads the one set: with its output
    # projections zeroed, each call site adds exactly nothing
    sites = [i for i, k in enumerate(tm.cfg.layer_kinds)
             if k == "mamba_shared"]
    assert sites == [3, 6, 9] and flash_layers(tm.cfg) == 3
    with torch.no_grad():
        tm.shared_attn["attn"]["wo"].zero_()
        tm.shared_attn["ffn"]["w_down"].zero_()
    plain = dataclasses.replace(tm.cfg, pattern=("mamba",) * 3)
    ref = LM(plain, device="cpu")
    ref.load_state_dict({k: v for k, v in tm.state_dict().items()
                         if not k.startswith("shared_attn.")})
    assert ref.shared_attn is None
    assert torch.equal(tm(tok), ref(tok))


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_leaves(v, key + "."))
        else:
            out[key] = v if isinstance(v, (torch.Tensor, tuple)) \
                else np.asarray(v)
    return out


def _ref_caches(cfg, caches, at=lambda a, r: a[r]):
    """The reference's caches as one tree per layer in run order (the
    prelude's as they are, the stack's leaves taken at each repeat r by
    ``at``)."""
    out = [caches[f"p{i}"] for i in range(len(cfg.prelude))]
    for r in range(cfg.n_repeats):
        out += [jax.tree.map(lambda a: at(a, r), caches["stack"][f"b{i}"])
                for i in range(len(cfg.pattern))]
    return out


def test_caches_equal_reference_and_block_cache_zeros():
    """init_cache: a mamba layer's {conv {x, B, C}, ssm}, a mamba_shared
    layer's {mamba, shared {k, v, pos}}, zeros and positions -1, the SSM
    state float32, shapes and types those of block_cache_shapes and of the
    reference's caches."""
    cfg = tconfigs.reduced(NAME)
    tc = LM(cfg, device="cpu").init_cache(B, S)
    jc = _ref_caches(cfg, make_model(jconfigs.reduced(NAME)).init_cache(B, S))
    for i, kind in enumerate(cfg.layer_kinds):
        got, want = _leaves(tc[i]), _leaves(jc[i])
        shapes = _leaves(block_cache_shapes(kind, cfg, B, S))
        assert set(got) == set(want) == set(shapes)
        assert set(_leaves(block_cache_zeros(kind, cfg, B, S))) == set(got)
        for name, t in got.items():
            assert (tuple(t.shape), t.dtype) == shapes[name]
            assert t.dtype == TORCH_OF[want[name].dtype], (i, name)
            np.testing.assert_array_equal(_np(t), want[name].astype(
                np.float32))
    full = tconfigs.get_config(NAME)
    assert block_cache_shapes("mamba_shared", full, 2, 8192) == {
        "mamba": {"conv": {"x": ((2, 3, 7168), torch.bfloat16),
                           "B": ((2, 3, 64), torch.bfloat16),
                           "C": ((2, 3, 64), torch.bfloat16)},
                  "ssm": ((2, 112, 64, 64), torch.float32)},
        "shared": {"k": ((2, 32, 8192, 112), torch.bfloat16),
                   "v": ((2, 32, 8192, 112), torch.bfloat16),
                   "pos": ((8192,), torch.int32)}}


def test_config_equals_reference_field_by_field():
    check_config(NAME)
    cfg = tconfigs.get_config(NAME)
    assert cfg.layer_kinds == ("mamba",) * 3 + (
        ("mamba",) * 5 + ("mamba_shared",)) * 13
    assert (cfg.hd, flash_layers(cfg)) == (112, 13)


def test_param_count_equals_reference():
    """6.64 B parameters at full width (12.4 GiB in bf16): 81 Mamba2
    blocks of 78.0 M (with their pre-norm), one shared block of 205.5 M,
    the tied embedding."""
    for fn in ("get_config", "reduced"):
        assert getattr(tconfigs, fn)(NAME).param_count() == \
            getattr(jconfigs, fn)(NAME).param_count()
    full = tconfigs.get_config(NAME)
    assert full.param_count() == 6_636_442_832
    meta = LM(full, device="meta")
    assert sum(p.numel() for p in meta.shared_attn.parameters()) == \
        205_528_064
    assert sum(p.numel() for p in meta.layers[0].parameters()) == 77_978_064


def _ref_specs(cfg, shape):
    """The reference's input specs as the port's: {name: (shape, dtype)},
    the caches as one nested tree per layer in run order."""
    specs = jconfigs.input_specs(cfg, shape)
    out = {}
    for key, val in specs.items():
        if key == "caches":
            per_layer = _ref_caches(cfg, val, at=lambda a, r:
                                    jax.ShapeDtypeStruct(a.shape[1:],
                                                         a.dtype))
            out[key] = [jax.tree.map(
                lambda a: (tuple(a.shape), TORCH_OF[a.dtype]), layer)
                for layer in per_layer]
        else:
            out[key] = (tuple(val.shape), TORCH_OF[val.dtype])
    return out


def test_cells_and_input_specs_equal_reference():
    """Every shape, long_500k included (sub-quadratic: it runs): the same
    skip reason (none) and the same input shapes and types, the decode
    caches nested per layer; 13 shared K/V caches of 524288 slots at
    long_500k."""
    jcfg, tcfg = jconfigs.get_config(NAME), tconfigs.get_config(NAME)
    for shape in jconfigs.SHAPES:
        assert tconfigs.cell_skip_reason(tcfg, shape) is None
        assert jconfigs.cell_skip_reason(jcfg, shape) is None
        assert tconfigs.input_specs(tcfg, shape) == _ref_specs(jcfg, shape), \
            shape
    long = tconfigs.input_specs(tcfg, "long_500k")
    shared = [c["shared"]["k"] for c in long["caches"] if "shared" in c]
    assert shared == [((1, 32, 524288, 112), torch.bfloat16)] * 13
    assert long["token"] == ((1, 1), torch.int32)


def test_step_builders_run_zamba2():
    """build_prefill_step / build_serve_step on the CPU, float32: the
    specs, 32 decode steps on 32 slots ending at prefill's logits, and the
    same seed giving the same bits."""
    cfg = dataclasses.replace(tconfigs.reduced(NAME), dtype=torch.float32)
    pre = build_prefill_step(cfg, batch=B, seq=S, device="cpu", seed=7)
    serve = build_serve_step(cfg, batch=B, seq=S, model=pre.model)
    assert pre.in_specs == {"tokens": ((B, S), torch.int32)}
    assert serve.in_specs["caches"][3]["shared"]["pos"] == ((S,),
                                                            torch.int32)
    tok = torch.from_numpy(_tokens(cfg.vocab, seed=8))
    logits = pre.fn(tok)
    caches = pre.model.init_cache(B, S)
    for t in range(S):
        got, caches = serve.fn(tok[:, t:t + 1], t, caches)
    np.testing.assert_allclose(_np(got), _np(logits), **F32_TOL)
    again = build_prefill_step(cfg, batch=B, seq=S, device="cpu", seed=7)
    assert torch.equal(again.fn(tok), logits)
