"""The reduced xlstm-350m (mLSTM and sLSTM blocks) against the JAX package,
on the CPU.

The reduced model (4 layers: ``mlstm, mlstm, mlstm, slstm``, 64 wide, 2
heads) holds the reference's parameters, carried across by
``load_reference_params``; the same seeded numpy tokens go through both.
Bands: float32 rtol 2e-4, atol 2e-5 for the logits against the reference;
bfloat16 rtol 1e-2, atol 1e-3 against the reference run op by op (its own
``unroll=True``: every jnp op rounds to bf16, which the port mirrors);
decode vs prefill rtol 1e-3, atol 1e-4 (``tests/test_models.py:86-87``).

The reference's jitted forward (``lax.scan``) is not its op-by-op run in
bf16: XLA's CPU compiler keeps some bf16 values in float32 where the next
op widens them (a bf16 dot's output before ``.astype(float32)``, a
residual sum read by the next norm), and which ones depends on the fusion
and the shapes.  Against it the bf16 logits are held to the zoo's
whole-model band (rtol 5e-2, atol 1e-1, ``tests/test_torch_lm_zoo.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import perf as jperf
from repro.models.lm import make_model
from repro_torch import configs as tconfigs
from repro_torch.launch.steps import (build_prefill_step, build_serve_step,
                                      build_train_step)
from repro_torch.models import perf as tperf
from repro_torch.models.lm import (LM, block_cache_zeros, flash_layers,
                                   load_reference_params)
from repro_torch.optim import adamw_init
from test_torch_lm_zoo import _ref_specs, check_config

NAME = "xlstm-350m"
B, S = 2, 24
F32_TOL = dict(rtol=2e-4, atol=2e-5)
BF16_TOL = dict(rtol=1e-2, atol=1e-3)
ZOO_BF16_TOL = dict(rtol=5e-2, atol=1e-1)
LM_TOL = dict(rtol=1e-3, atol=1e-4)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np(t):
    return t.detach().float().numpy()


def _pair(dtype, seed=0):
    """(JAX model, its params, the port's model holding them)."""
    jdt, tdt = DTYPES[dtype]
    jcfg = dataclasses.replace(jconfigs.reduced(NAME), dtype=jdt)
    tcfg = dataclasses.replace(tconfigs.reduced(NAME), dtype=tdt)
    jm = make_model(jcfg)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    tm = load_reference_params(tree, tcfg, device="cpu")
    return jm, jax.tree.map(jnp.asarray, tree), tm


def _tokens(seed=0, s=S, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (B, s)).astype(
        np.int32)


def test_config_equals_reference_field_by_field():
    check_config(NAME)
    cfg = tconfigs.get_config(NAME)
    assert cfg.layer_kinds == ("mlstm", "mlstm", "mlstm", "slstm") * 6
    assert dataclasses.asdict(cfg.xlstm_cfg()) == dataclasses.asdict(
        jconfigs.get_config(NAME).xlstm_cfg())


def test_param_count_equals_reference():
    """448,439,440 parameters at full width (0.84 GiB in bf16)."""
    for fn in ("get_config", "reduced"):
        assert getattr(tconfigs, fn)(NAME).param_count() == \
            getattr(jconfigs, fn)(NAME).param_count()
    assert tconfigs.get_config(NAME).param_count() == 448_439_440


def test_no_layer_launches_flash_attention():
    assert flash_layers(tconfigs.get_config(NAME)) == 0
    assert flash_layers(tconfigs.reduced(NAME)) == 0


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_prefill_logits_match_jax(dtype):
    """forward's logits at every position and prefill's last-position
    logits, S 24, against the reference's op-by-op forward."""
    jm, params, tm = _pair(dtype)
    tok = _tokens()
    jh, _, _ = jm.forward(params, jnp.asarray(tok), remat=False, unroll=True)
    tol = F32_TOL if dtype == "f32" else BF16_TOL
    with torch.inference_mode():
        th = tm(torch.from_numpy(tok))
        got_pre = tm.prefill(torch.from_numpy(tok))
    np.testing.assert_allclose(_np(tm.logits(th)),
                               np.asarray(jm.logits(params, jh)), **tol)
    # the reference's prefill: the logits of forward's last position
    np.testing.assert_allclose(_np(got_pre), np.asarray(jm.logits(
        params, jh[:, -1:])), **tol)


def test_bf16_prefill_matches_the_compiled_reference():
    """bf16 logits against the reference's jitted scan at the zoo's
    whole-model band (see the module doc)."""
    jm, params, tm = _pair("bf16")
    tok = _tokens(seed=1)
    want = jax.jit(lambda p, t: jm.prefill(p, t))(params, jnp.asarray(tok))
    with torch.inference_mode():
        got = tm.prefill(torch.from_numpy(tok))
    np.testing.assert_allclose(_np(got), np.asarray(want), **ZOO_BF16_TOL)


def test_chunked_mlstm_prefill_matches_jax_float32():
    """FLAGS["mlstm_chunked"] in both packages, S 2048 (two query chunks of
    1024 in each mLSTM layer): the last-position logits, float32."""
    jm, params, tm = _pair("f32", seed=2)
    tok = _tokens(seed=2, s=2048)
    jperf.FLAGS["mlstm_chunked"] = tperf.FLAGS["mlstm_chunked"] = True
    try:
        want = jm.prefill(params, jnp.asarray(tok), unroll=True)
        with torch.inference_mode():
            got = tm.prefill(torch.from_numpy(tok))
    finally:
        jperf.FLAGS["mlstm_chunked"] = tperf.FLAGS["mlstm_chunked"] = False
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32_TOL)


def test_decode_from_empty_cache_equals_prefill():
    """The reference's decode-equals-forward check in the port, float32:
    12 steps from empty caches give forward's logits at every position
    (the mLSTM recurrence against its parallel form)."""
    _, _, tm = _pair("f32", seed=3)
    tok = torch.from_numpy(_tokens(seed=3, s=12))
    with torch.inference_mode():
        want = tm.logits(tm(tok))
        caches = tm.init_cache(B, 12)
        for t in range(12):
            got, caches = tm.decode_step(tok[:, t:t + 1], t, caches)
            np.testing.assert_allclose(_np(got[:, 0]), _np(want[:, t]),
                                       **LM_TOL)


def test_decode_sequence_matches_jax_float32():
    """12 decode steps from empty caches against the reference's jitted
    decode_step, float32."""
    jm, params, tm = _pair("f32", seed=4)
    tok = _tokens(seed=4, s=12)
    jc, tc = jm.init_cache(B, 12), tm.init_cache(B, 12)
    dec = jax.jit(jm.decode_step)
    with torch.inference_mode():
        for t in range(12):
            want, jc = dec(params, jnp.asarray(tok[:, t:t + 1]),
                           jnp.asarray(t, jnp.int32), jc)
            got, tc = tm.decode_step(torch.from_numpy(tok[:, t:t + 1]), t,
                                     tc)
            np.testing.assert_allclose(_np(got), np.asarray(want), **LM_TOL)


def test_caches_and_input_specs_equal_reference():
    """Every shape's specs, long_500k included (xLSTM is sub-quadratic: an
    O(1) state), and the empty caches: float32 states, m = -1e30."""
    jcfg, tcfg = jconfigs.get_config(NAME), tconfigs.get_config(NAME)
    for shape in jconfigs.SHAPES:
        assert tconfigs.cell_skip_reason(tcfg, shape) is None
        assert tconfigs.input_specs(tcfg, shape) == _ref_specs(jcfg, shape), \
            shape
    long = tconfigs.input_specs(tcfg, "long_500k")["caches"]
    assert long[0]["C"] == ((1, 4, 512, 512), torch.float32)
    assert long[3] == {k: ((1, 1024), torch.float32) for k in "cnmy"}
    rcfg = tconfigs.reduced(NAME)
    jz = make_model(jconfigs.reduced(NAME)).init_cache(B, 8)["stack"]
    for i, kind in enumerate(rcfg.pattern):
        got = block_cache_zeros(kind, rcfg, B, 8, device="cpu")
        assert set(got) == set(jz[f"b{i}"])
        for k, v in got.items():
            np.testing.assert_array_equal(_np(v), np.asarray(
                jz[f"b{i}"][k][0], np.float32), err_msg=k)


def test_float32_leaves_kept_through_loading():
    """A bf16 reduced model loaded from the reference's tree: the mLSTM's
    w_if, b_if and the sLSTM's r_heads, bias stay float32 with the
    reference's values; every other leaf is bf16."""
    jm = make_model(jconfigs.reduced(NAME))
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(5)))
    tm = load_reference_params(tree, tconfigs.reduced(NAME), device="cpu")
    f32 = {"w_if", "b_if", "r_heads", "bias"}
    for key, t in tm.state_dict().items():
        assert t.dtype == (torch.float32 if key.split(".")[-1] in f32
                           else torch.bfloat16), key
    np.testing.assert_array_equal(
        tm.state_dict()["layers.3.slstm.r_heads"].numpy(),
        tree["stack"]["b3"]["slstm"]["r_heads"][0])
    np.testing.assert_array_equal(
        tm.state_dict()["layers.1.mlstm.w_if"].numpy(),
        tree["stack"]["b1"]["mlstm"]["w_if"][0])


def test_step_builders_run_xlstm():
    """build_prefill_step, build_serve_step and build_train_step on the
    CPU, float32: decode from empty caches ends at prefill's logits, the
    same seed gives the same bits, and a train step moves the weights and
    returns a finite loss and gradient norm."""
    cfg = dataclasses.replace(tconfigs.reduced(NAME), dtype=torch.float32)
    pre = build_prefill_step(cfg, batch=B, seq=S, device="cpu", seed=7)
    serve = build_serve_step(cfg, batch=B, seq=S, model=pre.model)
    assert pre.in_specs == {"tokens": ((B, S), torch.int32)}
    assert serve.in_specs["caches"][0]["C"] == ((B, 2, 64, 64),
                                                torch.float32)
    tok = torch.from_numpy(_tokens(seed=8))
    logits = pre.fn(tok)
    caches = pre.model.init_cache(B, S)
    for t in range(S):
        got, caches = serve.fn(tok[:, t:t + 1], t, caches)
    np.testing.assert_allclose(_np(got), _np(logits), **LM_TOL)
    again = build_prefill_step(cfg, batch=B, seq=S, device="cpu", seed=7)
    assert torch.equal(again.fn(tok), logits)
    train = build_train_step(cfg, batch=B, seq=S, model=again.model)
    assert train.in_specs == {"tokens": ((B, S), torch.int32),
                              "labels": ((B, S), torch.int32)}
    before = again.model.embed.detach().clone()
    opt = adamw_init(dict(again.model.named_parameters()))
    opt, metrics = train.fn(opt, {"tokens": tok, "labels": tok.roll(-1, 1)})
    assert int(opt["step"]) == 1
    assert np.isfinite(float(metrics["loss"]))
    assert float(metrics["grad_norm"]) > 0
    assert not torch.equal(again.model.embed.detach(), before)
    assert isinstance(again.model, LM)
