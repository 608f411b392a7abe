"""The port's xLSTM blocks (``repro_torch.models.xlstm``) against the JAX
package's (``repro.models.xlstm``), on the CPU.

The same seeded numpy inputs and the reference's own parameters (drawn by
``jax.random``, carried across as numpy) go through both packages; the
reference's functions run op by op, as its own tests call them.  Bands:

* float32: rtol 2e-4, atol 2e-5 (both compute in float32; sums run in
  another order);
* bfloat16: rtol 1e-2, atol 1e-3 (one bf16 ulp and a little).  The port
  rounds where the reference's ops round (the bf16 divisor sqrt(P), the
  scores and D, the weights for the product with V, XLA's CPU SiLU, the
  tanh GeLU step by step, F summed in XLA's cumsum order), so at these
  lengths its bf16 layers are the reference's bits almost everywhere;
* the float32 states of a bf16 layer: rtol 2e-4, atol 2e-5.

The layers run at the reduced xlstm-350m's widths (64 wide, 2 heads: an
mLSTM head dim of 64, d_inner 128), where torch's CPU bf16 GEMMs round
every element as XLA's float32-accumulated dots do.  At 96 wide and 4
heads one element in 1e4 of a projection rounds the other way, and one
output of 7680 at S 40 (0.0067, where the output projection cancels) fell
1.6e-6 outside the bf16 band.  sqrt(64) is a bf16 number, so the rounding
of the divisor is checked on its own at head dim 48.  The chunked mLSTM
form needs S > 1024 (S 2048 here).  At that length the gate
projection's float32 sums (XLA's order against oneDNN's) put F a few ulps
off the reference's, and exp(F_t - F_s) turns that into flipped bf16
roundings of D, so the chunked form is held to the float32 band there, and
in bf16 to being as close to its float32 output as the reference's bf16
layer is to its own.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models import perf as jperf
from repro.models import xlstm as jx
from repro.models.common import NO_SHARD
from repro_torch.models import perf as tperf
from repro_torch.models import xlstm as tx
from repro_torch.models.mamba2 import _causal_conv
from repro_torch.models.lm import _tensor

B = 2
F32_TOL = dict(rtol=2e-4, atol=2e-5)
BF16_TOL = dict(rtol=1e-2, atol=1e-3)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": F32_TOL, "bf16": BF16_TOL}
#: (d_model, n_heads) of the layers, the reduced xlstm-350m's
WIDTH = (64, 2)
D = WIDTH[0]
#: float32 leaves of the blocks in any model
F32_LEAVES = {"mlstm": ("w_if", "b_if"), "slstm": ("r_heads", "bias")}


def _np(t):
    return t.detach().float().numpy()


def _ref(a):
    return np.asarray(a, np.float32)


def _x(shape, dtype, seed=0, scale=1.0):
    """N(0, scale^2) numpy input and its two copies in ``dtype``."""
    jdt, tdt = DTYPES[dtype]
    a = (np.random.default_rng(seed).standard_normal(shape)
         * scale).astype(np.float32)
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _cfgs(width=WIDTH):
    return jx.XLSTMConfig(*width), tx.XLSTMConfig(*width)


def _params(kind, dtype, seed=0, width=WIDTH):
    jcfg, tcfg = _cfgs(width)
    init = jx.init_mlstm if kind == "mlstm" else jx.init_slstm
    jp = init(jax.random.PRNGKey(seed), jcfg, DTYPES[dtype][0])
    return jcfg, tcfg, jp, {k: _tensor(np.asarray(v)) for k, v in jp.items()}


@pytest.fixture
def chunked():
    """FLAGS["mlstm_chunked"] on in both packages for the test."""
    jperf.FLAGS["mlstm_chunked"] = tperf.FLAGS["mlstm_chunked"] = True
    yield
    jperf.FLAGS["mlstm_chunked"] = tperf.FLAGS["mlstm_chunked"] = False


def test_config_and_init_leaves_equal_reference():
    """XLSTMConfig field for field with its properties (xlstm-350m: d_inner
    2048 in 4 heads of 512); the port's init has the reference's leaves,
    shapes and types (float32 w_if, b_if, r_heads, bias in a bf16 block)
    and the reference's constant leaves."""
    jcfg, tcfg = _cfgs((1024, 4))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert (tcfg.d_inner, tcfg.head_dim) == (jcfg.d_inner, jcfg.head_dim) \
        == (2048, 512)
    jcfg, tcfg = _cfgs()
    gen = torch.Generator().manual_seed(0)
    for kind in ("mlstm", "slstm"):
        jinit = jx.init_mlstm if kind == "mlstm" else jx.init_slstm
        tinit = tx.init_mlstm if kind == "mlstm" else tx.init_slstm
        jp = jinit(jax.random.PRNGKey(0), jcfg, jnp.bfloat16)
        tp = tinit(gen, tcfg, torch.bfloat16)
        assert set(tp) == set(jp), kind
        for k, v in jp.items():
            assert tuple(tp[k].shape) == v.shape, k
            assert tp[k].dtype == (torch.float32 if k in F32_LEAVES[kind]
                                   else torch.bfloat16), k
        for k in ("b_if", "bias", "conv_b", "norm_scale"):
            if k in jp:
                np.testing.assert_array_equal(_np(tp[k]), _ref(jp[k]))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_causal_conv_and_multihead_rms_match_jax(dtype):
    """The 4-tap conv with SiLU from zeros and from a carried state, and
    the per-head RMS norm (2 heads of 64)."""
    jw, tw = _x((4, 128), dtype, seed=1, scale=0.3)
    jb, tb = _x((128,), dtype, seed=2, scale=0.1)
    jxx, txx = _x((B, 12, 128), dtype, seed=3)
    js, ts = _x((B, 3, 128), dtype, seed=4)
    for state in ((None, None), (js, ts)):
        want, wstate = jx._causal_conv(jxx, jw, jb, state[0])
        got, gstate = _causal_conv(txx, tw, tb, state[1])
        np.testing.assert_allclose(_np(got), _ref(want), **TOL[dtype])
        np.testing.assert_array_equal(_np(gstate), _ref(wstate))
    jsc, tsc = _x((128,), dtype, seed=5, scale=0.2)
    got = tx._multihead_rms(txx * 3, tsc, 2)
    assert got.dtype == DTYPES[dtype][1]
    np.testing.assert_allclose(_np(got), _ref(jx._multihead_rms(
        jxx * 3, jsc, 2)), **TOL[dtype])


@pytest.mark.parametrize("n", [1, 16, 17, 300, 2048])
def test_cumsum_is_xla_cpu_order(n):
    """_cumsum gives jnp.cumsum's float32 bits on the CPU: one block, a
    block and one, and two and three levels of block totals."""
    a = (-np.abs(np.random.default_rng(n).standard_normal((B, 3, n)))
         * 0.05).astype(np.float32)
    np.testing.assert_array_equal(tx._cumsum(torch.from_numpy(a)).numpy(),
                                  np.asarray(jnp.cumsum(jnp.asarray(a), -1)))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mlstm_parallel_form_and_cache_match_jax(dtype):
    """The stabilised parallel form at S 40 and its decode cache: the conv
    state (the last 3 inputs of the x branch) and, as the reference, a zero
    float32 state with m = -1e30."""
    jcfg, tcfg, jp, tp = _params("mlstm", dtype, seed=1)
    jxx, txx = _x((B, 40, D), dtype, seed=6)
    want, wc = jx.mlstm_fwd(jp, jxx, jcfg, NO_SHARD, make_cache=True)
    got, gc = tx.mlstm_fwd(tp, txx, tcfg, make_cache=True)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (B, 40, D)
    np.testing.assert_allclose(_np(got), _ref(want), **TOL[dtype])
    np.testing.assert_array_equal(_np(gc["conv"]), _ref(wc["conv"]))
    for k in ("C", "n", "m"):
        assert gc[k].dtype == torch.float32
        np.testing.assert_array_equal(gc[k].numpy(), np.asarray(wc[k]))
    assert bool((gc["m"] == -1e30).all()) and not gc["C"].any()
    assert tx.mlstm_fwd(tp, txx, tcfg)[1] is None


def test_mlstm_chunked_form_matches_jax_float32(chunked):
    """FLAGS["mlstm_chunked"] at S 2048 (two query chunks of 1024), the
    reduced config's widths, float32."""
    jcfg, tcfg, jp, tp = _params("mlstm", "f32", seed=2)
    jxx, txx = _x((B, 2048, 64), "f32", seed=7)
    want = jx.mlstm_fwd(jp, jxx, jcfg, NO_SHARD)[0]
    got = tx.mlstm_fwd(tp, txx, tcfg)[0]
    np.testing.assert_allclose(_np(got), _ref(want), **F32_TOL)


def test_mlstm_chunked_form_bf16_as_close_as_the_reference(chunked):
    """The chunked form at S 2048 in bf16 (D kept float32, the weights
    rounded for the product with V): against the float32 layer on the same
    weights, the port's bf16 output is no further off than the
    reference's bf16 output (mean |err| within 5 %, max |err| within 25 %)."""
    jcfg, tcfg, jp, tp = _params("mlstm", "bf16", seed=2)
    jxx, txx = _x((B, 2048, 64), "bf16", seed=7)
    exact = _ref(jx.mlstm_fwd(jax.tree.map(lambda a: a.astype(jnp.float32),
                                           jp),
                              jxx.astype(jnp.float32), jcfg, NO_SHARD)[0])
    ref_err = np.abs(_ref(jx.mlstm_fwd(jp, jxx, jcfg, NO_SHARD)[0]) - exact)
    port_err = np.abs(_np(tx.mlstm_fwd(tp, txx, tcfg)[0]) - exact)
    assert port_err.mean() <= 1.05 * ref_err.mean()
    assert port_err.max() <= 1.25 * ref_err.max()


def _torch_state(cache):
    """A reference cache as the port's: torch tensors, bf16 kept."""
    return {k: _tensor(np.asarray(v)) for k, v in cache.items()}


def check_decode_sequence(kind, dtype, seed, prefix, steps):
    """``steps`` recurrent steps after a ``prefix``-token forward's cache
    (the mLSTM's: its conv state and a zero matrix state; the sLSTM's: its
    final state).  Each step's output is held to the band from the
    reference's own state at that step, so the check sees the step's
    roundings and not a float32 drift of the state carried into them; the
    port's own chain of states, updated in place, is held to the float32
    state band after the last step."""
    jcfg, tcfg, jp, tp = _params(kind, dtype, seed=seed)
    jfwd, tfwd = ((jx.mlstm_fwd, tx.mlstm_fwd) if kind == "mlstm"
                  else (jx.slstm_fwd, tx.slstm_fwd))
    jdec, tdec = ((jx.mlstm_decode, tx.mlstm_decode) if kind == "mlstm"
                  else (jx.slstm_decode, tx.slstm_decode))
    jxx, txx = _x((B, prefix + steps, D), dtype, seed=seed + 10)
    _, jc = jfwd(jp, jxx[:, :prefix], jcfg, NO_SHARD, make_cache=True)
    _, tc = tfwd(tp, txx[:, :prefix], tcfg, make_cache=True)
    tc = {k: v.clone() for k, v in tc.items()}
    ids = {k: id(v) for k, v in tc.items()}
    for t in range(prefix, prefix + steps):
        x_j, x_t = jxx[:, t:t + 1], txx[:, t:t + 1]
        got = tdec(tp, x_t, _torch_state(jc), tcfg)[0]
        want, jc = jdec(jp, x_j, jc, jcfg, NO_SHARD)
        assert got.shape == (B, 1, D) and got.dtype == DTYPES[dtype][1]
        np.testing.assert_allclose(_np(got), _ref(want), **TOL[dtype])
        tc = tdec(tp, x_t, tc, tcfg)[1]
    assert {k: id(v) for k, v in tc.items()} == ids
    for k, v in tc.items():
        tol = TOL[dtype] if k == "conv" else F32_TOL
        np.testing.assert_allclose(_np(v), _ref(jc[k]), **tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mlstm_decode_sequence_matches_jax(dtype):
    """Four steps after a 4-token prefill: the outputs, the conv state and
    the float32 C, n, m."""
    check_decode_sequence("mlstm", dtype, seed=3, prefix=4, steps=4)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_slstm_forward_and_final_state_match_jax(dtype):
    """The sLSTM recurrence over S 24 from the zero state, the norm and the
    gated FFN; the final float32 (c, n, m, y)."""
    jcfg, tcfg, jp, tp = _params("slstm", dtype, seed=4)
    jxx, txx = _x((B, 24, D), dtype, seed=9)
    want, ws = jx.slstm_fwd(jp, jxx, jcfg, NO_SHARD, make_cache=True)
    got, gs = tx.slstm_fwd(tp, txx, tcfg, make_cache=True)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (B, 24, D)
    np.testing.assert_allclose(_np(got), _ref(want), **TOL[dtype])
    for k in "cnmy":
        assert gs[k].dtype == torch.float32 and gs[k].shape == (B, D)
        np.testing.assert_allclose(gs[k].numpy(), np.asarray(ws[k]),
                                   **F32_TOL)
    assert tx.slstm_fwd(tp, txx, tcfg)[1] is None


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_slstm_decode_sequence_matches_jax(dtype):
    """Four steps on the state a 16-token forward hands on: the outputs
    and the float32 (c, n, m, y)."""
    check_decode_sequence("slstm", dtype, seed=5, prefix=16, steps=4)


def test_bf16_divisor_is_rounded_first():
    """k / sqrt(P) in bf16 at head dim 48: JAX takes the Python scalar
    sqrt(48) in as bf16 (6.9375) before dividing; _div_scalar gives its
    bits, a division by the unrounded float does not."""
    jxx, txx = _x((4096,), "bf16", seed=16, scale=3.0)
    want = _ref(jxx / math.sqrt(48))
    np.testing.assert_array_equal(_np(tx._div_scalar(txx, math.sqrt(48))),
                                  want)
    assert (_np(txx / math.sqrt(48)) != want).mean() > 0.01


def test_gelu_rounds_each_step_as_the_reference():
    """jax.nn.gelu's default (tanh) form in bf16 rounds every step: the
    port's _gelu_tanh gives its bits; F.gelu(approximate="tanh"), which
    rounds once, does not."""
    jxx, txx = _x((4096,), "bf16", seed=11, scale=2.0)
    want = _ref(jax.nn.gelu(jxx))
    np.testing.assert_array_equal(_np(tx._gelu_tanh(txx)), want)
    assert (_np(F.gelu(txx, approximate="tanh")) != want).mean() > 0.2


def test_prefill_hands_decode_a_zero_matrix_state():
    """The reference's handoff, copied: after mlstm_fwd(make_cache=True),
    decode runs from C = 0, n = 0, m = -1e30 (the prefix reaches it only
    through the conv state), so its first step equals a step from a fresh
    cache holding that conv state; the sLSTM hands its final state on,
    and its first step after prefill does not equal a step from zeros."""
    jcfg, tcfg, jp, tp = _params("mlstm", "f32", seed=6)
    _, txx = _x((B, 9, D), "f32", seed=12)
    _, cache = tx.mlstm_fwd(tp, txx[:, :8], tcfg, make_cache=True)
    fresh = {"conv": cache["conv"].clone(),
             "C": torch.zeros_like(cache["C"]),
             "n": torch.zeros_like(cache["n"]),
             "m": torch.full_like(cache["m"], -1e30)}
    a = tx.mlstm_decode(tp, txx[:, 8:], cache, tcfg)[0]
    b = tx.mlstm_decode(tp, txx[:, 8:], fresh, tcfg)[0]
    assert torch.equal(a, b)
    jcfg, tcfg, jp, sp = _params("slstm", "f32", seed=6)
    _, state = tx.slstm_fwd(sp, txx[:, :8], tcfg, make_cache=True)
    zero = tx._slstm_zero_state(B, D)
    assert not torch.equal(tx.slstm_decode(sp, txx[:, 8:], state, tcfg)[0],
                           tx.slstm_decode(sp, txx[:, 8:], zero, tcfg)[0])


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_recurrent_decode_equals_full_sequence_form(kind):
    """The port against itself in float32: 16 decode steps from an empty
    cache give, row by row, the full-sequence form's outputs (the mLSTM's
    recurrence against its parallel form; the sLSTM's loop run one step at
    a time)."""
    jcfg, tcfg, jp, tp = _params(kind, "f32", seed=7)
    _, txx = _x((B, 16, D), "f32", seed=13)
    fwd = tx.mlstm_fwd if kind == "mlstm" else tx.slstm_fwd
    dec = tx.mlstm_decode if kind == "mlstm" else tx.slstm_decode
    want = fwd(tp, txx, tcfg)[0]
    if kind == "mlstm":
        h, pd = tcfg.n_heads, tcfg.head_dim
        cache = {"conv": torch.zeros((B, 3, tcfg.d_inner)),
                 "C": torch.zeros((B, h, pd, pd)),
                 "n": torch.zeros((B, h, pd)),
                 "m": torch.full((B, h), -1e30)}
    else:
        cache = tx._slstm_zero_state(B, D)
    rows = [dec(tp, txx[:, t:t + 1], cache, tcfg)[0] for t in range(16)]
    np.testing.assert_allclose(_np(torch.cat(rows, 1)), _np(want),
                               rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_gradients_match_jax(kind):
    """float32 gradients of sum(out * w) for a seeded w, with respect to
    the input and every parameter, against jax.grad of the reference's
    layer (S 20; the sLSTM's max(n, 1) ties at its first step, where both
    split the gradient half and half)."""
    jcfg, tcfg, jp, tp = _params(kind, "f32", seed=8)
    jxx, txx = _x((B, 20, D), "f32", seed=14)
    w = np.random.default_rng(15).standard_normal((B, 20, D)).astype(
        np.float32)
    jfwd = jx.mlstm_fwd if kind == "mlstm" else jx.slstm_fwd
    tfwd = tx.mlstm_fwd if kind == "mlstm" else tx.slstm_fwd
    jg = jax.jit(jax.grad(
        lambda p, x: jnp.sum(jfwd(p, x, jcfg, NO_SHARD)[0] * w),
        argnums=(0, 1)))(jp, jxx)
    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    txx.requires_grad_(True)
    (tfwd(tp, txx, tcfg)[0] * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(_np(txx.grad), _ref(jg[1]), rtol=1e-3,
                               atol=1e-5)
    for k, v in tp.items():
        scale = float(np.abs(_ref(jg[0][k])).max()) or 1.0
        np.testing.assert_allclose(_np(v.grad), _ref(jg[0][k]), rtol=1e-3,
                                   atol=1e-5 * scale, err_msg=k)
