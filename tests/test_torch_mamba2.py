"""The port's Mamba2 block (``repro_torch.models.mamba2``) against the JAX
package's (``repro.models.mamba2``), on the CPU, and the plain attention at
zamba2's head dim 112 against the reference's Pallas kernel.

The same seeded numpy inputs and the reference's own parameters (drawn by
``jax.random``, carried across as numpy) go through both packages, the
reference's functions run op by op as its own tests call them.  Bands:

* float32: rtol 2e-4, atol 2e-5 (both compute in float32; the sums run in
  another order);
* bfloat16: rtol 1e-2, atol 1e-3, the layer band of
  ``tests/test_torch_mla_xattn.py`` (one bf16 ulp and a little).  The port
  rounds where the reference does, so on this CPU almost every output is
  the reference's bits;
* the float32 states of a bf16 layer: rtol 2e-4, atol 2e-5 (float32
  arithmetic on the same bf16 operands);
* attention at D 112: rtol 2e-4, atol 2e-4 in float32 and 5e-2 in
  bfloat16, the bands of the reference's kernel tests
  (``tests/test_kernels.py:74-111``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention as flash_pallas
from repro.models import mamba2 as jm2
from repro.models.common import NO_SHARD
from repro.models.lm import make_model
from repro_torch import configs as tconfigs
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.models import mamba2 as tm2
from repro_torch.models.lm import _tensor, load_reference_params

B = 2
F32_TOL = dict(rtol=2e-4, atol=2e-5)
BF16_TOL = dict(rtol=1e-2, atol=1e-3)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": F32_TOL, "bf16": BF16_TOL}
NAME = "zamba2-7b"
#: float32 leaves of a Mamba2 block in any model
F32_LEAVES = ("dt_bias", "a_log", "d_skip")


def _np(t):
    return t.float().numpy()


def _ref(a):
    return np.asarray(a, np.float32)


def _x(shape, dtype, seed=0, scale=1.0):
    """N(0, scale^2) numpy input and its two copies in ``dtype``."""
    jdt, tdt = DTYPES[dtype]
    a = (np.random.default_rng(seed).standard_normal(shape)
         * scale).astype(np.float32)
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _cfgs(**over):
    """(reference, port) Mamba2Config of the reduced zamba2, ``over``
    replaced in both."""
    jcfg = dataclasses.replace(jconfigs.reduced(NAME).mamba_cfg(), **over)
    tcfg = dataclasses.replace(tconfigs.reduced(NAME).mamba_cfg(), **over)
    return jcfg, tcfg


def _params(jcfg, dtype, seed=0):
    jp = jm2.init_mamba2(jax.random.PRNGKey(seed), jcfg, DTYPES[dtype][0])
    return jp, {k: _tensor(np.asarray(v)) for k, v in jp.items()}


def test_config_and_init_leaves_equal_reference():
    """The reduced and full configs' Mamba2Config field for field, with its
    three properties; the port's init has the reference's leaves, shapes
    and types (float32 dt_bias, a_log, d_skip in a bf16 block)."""
    for fn in ("get_config", "reduced"):
        jcfg = getattr(jconfigs, fn)(NAME).mamba_cfg()
        tcfg = getattr(tconfigs, fn)(NAME).mamba_cfg()
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
        for prop in ("d_inner", "n_heads", "d_conv_ch"):
            assert getattr(jcfg, prop) == getattr(tcfg, prop)
    full = tconfigs.get_config(NAME).mamba_cfg()
    assert (full.d_inner, full.n_heads, full.head_dim, full.d_state,
            full.chunk) == (7168, 112, 64, 64, 256)
    jcfg, tcfg = _cfgs()
    jp = jm2.init_mamba2(jax.random.PRNGKey(0), jcfg, jnp.bfloat16)
    tp = tm2.init_mamba2(torch.Generator().manual_seed(0), tcfg,
                         torch.bfloat16)
    assert set(tp) == set(jp)
    for k, v in jp.items():
        assert tuple(tp[k].shape) == v.shape, k
        assert tp[k].dtype == (torch.float32 if k in F32_LEAVES
                               else torch.bfloat16), k
    np.testing.assert_allclose(tp["a_log"].numpy(), np.asarray(jp["a_log"]),
                               **F32_TOL)
    # dt = softplus(dt_bias) lies in [dt_min, dt_max]
    dt = torch.nn.functional.softplus(tp["dt_bias"])
    assert bool(((dt >= tcfg.dt_min * 0.999) & (dt <= tcfg.dt_max * 1.001))
                .all())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state, dtype):
    """(B, S 12, C 40) through width-4 taps, from zeros or from a carried
    state; the output and the new state."""
    jw, tw = _x((4, 40), dtype, seed=1, scale=0.3)
    jb, tb = _x((40,), dtype, seed=2, scale=0.1)
    jx, tx = _x((B, 12, 40), dtype, seed=3)
    js, ts = _x((B, 3, 40), dtype, seed=4) if with_state else (None, None)
    want, wstate = jm2._causal_conv(jx, jw, jb, js)
    got, gstate = tm2._causal_conv(tx, tw, tb, ts)
    assert got.dtype == DTYPES[dtype][1] and gstate.shape == (B, 3, 40)
    np.testing.assert_allclose(_np(got), _ref(want), **TOL[dtype])
    np.testing.assert_array_equal(_np(gstate), _ref(wstate))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rms_matches_jax(dtype):
    jx, tx = _x((B, 10, 256), dtype, seed=5, scale=3.0)
    js, ts = _x((256,), dtype, seed=6, scale=0.2)
    got = tm2._rms(tx, ts)
    assert got.dtype == DTYPES[dtype][1]
    np.testing.assert_allclose(_np(got), _ref(jm2._rms(jx, js)),
                               **TOL[dtype])


def _ssd_inputs(jcfg, dtype, s, seed=7, state=False):
    """xh in ``dtype``, float32 dt (softplus range), a = -(1..H), float32
    B and C (and an initial state), for both packages."""
    h, p, n = jcfg.n_heads, jcfg.head_dim, jcfg.d_state
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((B, s, h, p)).astype(np.float32)
    dt = rng.uniform(1e-3, 0.1, (B, s, h)).astype(np.float32)
    a = -np.arange(1, h + 1, dtype=np.float32)
    bc = rng.standard_normal((2, B, s, n)).astype(np.float32)
    st = rng.standard_normal((B, h, p, n)).astype(np.float32) \
        if state else None
    jdt, tdt = DTYPES[dtype]
    j = (jnp.asarray(xh, jdt), jnp.asarray(dt), jnp.asarray(a),
         jnp.asarray(bc[0]), jnp.asarray(bc[1]))
    t = (torch.from_numpy(xh).to(tdt), torch.from_numpy(dt),
         torch.from_numpy(a), torch.from_numpy(bc[0]),
         torch.from_numpy(bc[1]))
    return j, t, st


@pytest.mark.parametrize("dtype,s,over", [
    ("f32", 16, {}), ("f32", 64, {}), ("bf16", 16, {}), ("bf16", 64, {}),
    ("bf16", 64, {"d_state": 32})],
    ids=["f32-one-chunk", "f32-four-chunks", "bf16-one-chunk",
         "bf16-four-chunks", "bf16-four-chunks-N-eq-P"])
def test_ssd_chunked_matches_jax(dtype, s, over):
    """The chunked SSD at chunk 16: one chunk (S 16) and four (S 64, the
    inter-chunk recurrence), from an initial state in float32.  N 16 < P
    32 contracts the inter-chunk output through the outer product C
    exp(cum) first, N = P = 32 through C . S_prev first, each as the
    reference's einsum does."""
    jcfg, tcfg = _cfgs(**over)
    j, t, st = _ssd_inputs(jcfg, dtype, s, state=dtype == "f32")
    init_j = None if st is None else jnp.asarray(st)
    init_t = None if st is None else torch.from_numpy(st)
    want, wfinal = jm2._ssd_chunked(*j, jcfg, init_state=init_j)
    got, gfinal = tm2._ssd_chunked(*t, tcfg, init_state=init_t)
    assert got.dtype == DTYPES[dtype][1] and gfinal.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _ref(want), **TOL[dtype])
    np.testing.assert_allclose(gfinal.numpy(), np.asarray(wfinal),
                               **F32_TOL)


def test_ssd_chunk_must_divide_the_sequence():
    _, tcfg = _cfgs()
    _, t, _ = _ssd_inputs(_cfgs()[0], "f32", 24)
    with pytest.raises(AssertionError, match="not divisible by chunk"):
        tm2._ssd_chunked(*t, tcfg)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mamba2_fwd_with_cache_matches_jax(dtype):
    """The whole block at S 48 (three chunks) and its decode cache: the
    conv states (the last three inputs of x, B, C) and the float32 final
    state."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, dtype, seed=1)
    jx, tx = _x((B, 48, jcfg.d_model), dtype, seed=8)
    want, wc = jm2.mamba2_fwd(jp, jx, jcfg, NO_SHARD, make_cache=True)
    got, gc = tm2.mamba2_fwd(tp, tx, tcfg, make_cache=True)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (B, 48, 128)
    np.testing.assert_allclose(_np(got), _ref(want), **TOL[dtype])
    for k in ("x", "B", "C"):
        np.testing.assert_allclose(_np(gc["conv"][k]), _ref(wc["conv"][k]),
                                   **TOL[dtype])
    assert gc["ssm"].dtype == torch.float32
    np.testing.assert_allclose(gc["ssm"].numpy(), np.asarray(wc["ssm"]),
                               **F32_TOL)
    assert tm2.mamba2_fwd(tp, tx, tcfg)[1] is None


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mamba2_decode_sequence_matches_jax(dtype):
    """Eight steps from the cache of a 16-token prefix: each step's output
    and, after the last, the conv states and the float32 state; the port
    updates the cache's tensors in place."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, dtype, seed=2)
    jx, tx = _x((B, 24, jcfg.d_model), dtype, seed=9)
    _, jc = jm2.mamba2_fwd(jp, jx[:, :16], jcfg, NO_SHARD, make_cache=True)
    _, tc = tm2.mamba2_fwd(tp, tx[:, :16], tcfg, make_cache=True)
    tc = {"conv": {k: v.clone() for k, v in tc["conv"].items()},
          "ssm": tc["ssm"].clone()}
    ids = {k: id(v) for k, v in tc["conv"].items()} | {"ssm": id(tc["ssm"])}
    for t in range(16, 24):
        want, jc = jm2.mamba2_decode(jp, jx[:, t:t + 1], jc, jcfg, NO_SHARD)
        got, tc = tm2.mamba2_decode(tp, tx[:, t:t + 1], tc, tcfg)
        assert got.shape == (B, 1, 128) and got.dtype == DTYPES[dtype][1]
        np.testing.assert_allclose(_np(got), _ref(want), **TOL[dtype])
    assert {k: id(v) for k, v in tc["conv"].items()} | \
        {"ssm": id(tc["ssm"])} == ids
    for k in ("x", "B", "C"):
        np.testing.assert_allclose(_np(tc["conv"][k]), _ref(jc["conv"][k]),
                                   **TOL[dtype])
    np.testing.assert_allclose(tc["ssm"].numpy(), np.asarray(jc["ssm"]),
                               **F32_TOL)


@pytest.mark.parametrize("s", [16, 64])
def test_chunked_forward_equals_stepwise_decode(s):
    """The port against itself in float32: the chunked pass over S tokens
    (one chunk, four chunks) gives, row by row, what S recurrent decode
    steps from an empty cache give, and the same final state."""
    _, tcfg = _cfgs()
    _, tp = _params(_cfgs()[0], "f32", seed=3)
    _, tx = _x((B, s, tcfg.d_model), "f32", seed=10)
    want, wc = tm2.mamba2_fwd(tp, tx, tcfg, make_cache=True)
    w1 = tcfg.conv_width - 1
    cache = {"conv": {"x": torch.zeros((B, w1, tcfg.d_inner)),
                      "B": torch.zeros((B, w1, tcfg.d_state)),
                      "C": torch.zeros((B, w1, tcfg.d_state))},
             "ssm": torch.zeros((B, tcfg.n_heads, tcfg.head_dim,
                                 tcfg.d_state))}
    rows = []
    for t in range(s):
        y, cache = tm2.mamba2_decode(tp, tx[:, t:t + 1], cache, tcfg)
        rows.append(y)
    np.testing.assert_allclose(_np(torch.cat(rows, 1)), _np(want),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(cache["ssm"].numpy(), wc["ssm"].numpy(),
                               rtol=1e-3, atol=1e-5)
    for k in ("x", "B", "C"):
        np.testing.assert_allclose(_np(cache["conv"][k]),
                                   _np(wc["conv"][k]), **F32_TOL)


def _ssd_stepwise(xh, dt, a, B, C):
    """The SSD as its recurrence, one step at a time: S <- exp(dt a) S +
    dt x B^T, y = S C."""
    bsz, s, h, p = xh.shape
    state = xh.new_zeros((bsz, h, p, B.shape[-1]))
    ys = []
    for t in range(s):
        upd = (dt[:, t, :, None] * xh[:, t])[..., None] * B[:, t, None, None]
        state = state * torch.exp(dt[:, t] * a)[:, :, None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", state, C[:, t]))
    return torch.stack(ys, 1)


def test_ssd_gradient_where_the_decays_overflow():
    """Decays as strong as zamba2's (dt a up to -80 a step, so exp(cum_t -
    cum_s) above the diagonal overflows float32 within a chunk of 16):
    ``_ssd_chunked``'s output and its gradients (x, dt, a, B, C) are
    finite and equal the float64 step-by-step recurrence's, rtol 1e-3
    and atol 1e-5 of each gradient's max.  Masking after the exp, as the
    reference does, makes every gradient NaN here."""
    rng = np.random.default_rng(21)
    bsz, s, h, p, n = 2, 32, 4, 8, 8
    cfg = tm2.Mamba2Config(d_model=16, d_state=n, head_dim=p, chunk=16)
    leaves = [rng.standard_normal((bsz, s, h, p)),
              rng.uniform(0.05, 0.2, (bsz, s, h)),
              -np.array([50.0, 100.0, 200.0, 400.0]),
              rng.standard_normal((bsz, s, n)),
              rng.standard_normal((bsz, s, n))]
    w = torch.from_numpy(rng.standard_normal((bsz, s, h, p)))
    grads = {}
    for dtype in (torch.float32, torch.float64):
        ts = [torch.tensor(v, dtype=dtype, requires_grad=True)
              for v in leaves]
        y = (tm2._ssd_chunked(*ts, cfg)[0] if dtype == torch.float32
             else _ssd_stepwise(*ts))
        (y * w.to(dtype)).sum().backward()
        grads[dtype] = [y.detach().double()] + [t.grad.double() for t in ts]
    for i, (got, want) in enumerate(zip(*grads.values())):
        assert bool(torch.isfinite(got).all()), i
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-3,
                                   atol=1e-5 * float(want.abs().max()),
                                   err_msg=str(i))


def test_float32_leaves_after_loading():
    """A bf16 reduced zamba2 loaded from the reference's tree: every Mamba2
    block's dt_bias, a_log and d_skip stay float32 and hold the
    reference's values (prelude layer 0 and the stack's repeats); every
    other leaf is bf16."""
    jm = make_model(jconfigs.reduced(NAME))
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(5)))
    tm = load_reference_params(tree, tconfigs.reduced(NAME), device="cpu")
    state = tm.state_dict()
    for key, t in state.items():
        want = torch.float32 if key.split(".")[-1] in F32_LEAVES \
            else torch.bfloat16
        assert t.dtype == want, key
    n_f32 = sum(k.split(".")[-1] in F32_LEAVES for k in state)
    assert n_f32 == 3 * tm.cfg.n_layers
    for leaf in F32_LEAVES:
        np.testing.assert_array_equal(
            state[f"layers.0.mamba.{leaf}"].numpy(),
            tree["prelude"]["p0"]["mamba"][leaf])
        # layer 1 + 3 r + i is stack position i of repeat r
        np.testing.assert_array_equal(
            state[f"layers.8.mamba.{leaf}"].numpy(),
            tree["stack"]["b1"]["mamba"][leaf][2])


@pytest.mark.parametrize("dtype,causal,hkv", [
    ("f32", True, 4), ("f32", False, 1), ("bf16", True, 4)])
def test_plain_attention_d112_matches_pallas(dtype, causal, hkv):
    """flash_attention_plain at head dim 112 (zamba2's 3584 / 32) against
    the reference's Pallas kernel in interpret mode and its oracle, S 128
    in blocks of 64, Hq 4 over Hkv 4 or 1."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal((1, h, 128, 112)).astype(np.float32)
               for h in (4, hkv, hkv))
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    got = _np(flash_attention_plain(*(torch.from_numpy(a).to(tdt)
                                      for a in (q, k, v)), causal=causal))
    tol = dict(rtol=2e-4, atol=2e-4) if dtype == "f32" else \
        dict(rtol=5e-2, atol=5e-2)
    pallas = flash_pallas(jq, jk, jv, causal=causal, block_q=64,
                          block_kv=64, interpret=True)
    np.testing.assert_allclose(got, _ref(pallas), **tol)
    np.testing.assert_allclose(
        got, _ref(ref.flash_attention_ref(jq, jk, jv, causal=causal)), **tol)
