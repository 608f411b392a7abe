"""The gradient of the port's attention against the JAX package, on the CPU.

The card computes the attention's gradient with the backward kernels of
``csrc/flash_attention_bwd.cu`` inside ``_FlashAttentionFn``; the CPU has
their plain twins, ``flash_attention_plain_lse`` (the forward with its row
statistics) and ``flash_attention_bwd_plain`` (the backward's recompute),
and autograd of ``flash_attention_plain``.  Here:

* ``flash_attention_bwd_plain`` against autograd of ``flash_attention_plain``;
* autograd of ``flash_attention_plain`` against ``jax.vjp`` of the
  reference's oracle ``repro.kernels.ref.flash_attention_ref``, and the
  port's ``gqa_fwd`` against ``jax.vjp`` of the reference's ``gqa_fwd``
  with ``use_flash=False`` (its ``_sdpa``, the path the reference trains
  by);
* ``flash_attention_plain_lse``'s lse against ``jax.nn.logsumexp`` of the
  scores of the reference's ``_flash_kernel``;
* the Function's wiring, with the plain forward and backward bound in as
  its launchers (a binding of these tests only), against autograd of the
  plain version, and through ``LM.loss`` with remat (the slice as a whole)
  against ``jax.value_and_grad`` of the reference's loss.

Inputs come from numpy seeds.  Bands, each with its reason:

* float32 attention gradients: rtol 2e-4, atol 2e-4, the forward's band
  (``tests/test_kernels.py:84``): float32 sums in other orders;
* bfloat16: rtol 1e-2 and an atol of 1e-3 of the leaf's largest entry:
  both sides compute in float32 from the same bf16 inputs and round each
  leaf once (about one bf16 ulp, 2^-8); the atol covers entries that
  cancel to near 0, and scales with the leaf as gradients do.  Di is taken
  from the float32 out, as autograd's softmax backward forms it; from the
  bf16 out dq and dk moved by up to 0.5 % of their largest entry;
* a layer's or a model's gradients (through the projections): rtol 1e-3,
  atol 1e-5 of each leaf's largest entry, ``tests/test_torch_train.py``'s
  band for a float32 backward pass; a bf16 model's, the Function against
  autograd on one model: rtol 1e-2, atol 1e-2 of the leaf's largest entry,
  since the attention gradients' one-ulp differences flow on through the
  bf16 projections' backward and the embedding's gather-add, each entry a
  sum of differently rounded terms (up to 0.7 % of the leaf's max, on the
  embedding, at these widths);
* lse: rtol 1e-5, atol 1e-5 (float32 scores, one log-sum-exp).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models.lm import make_model
from repro_torch import configs as tconfigs
from repro_torch import kernels
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import attention as tattn
from repro_torch.models.lm import LM, load_reference_params

F32_TOL = (2e-4, 2e-4)
BF16_TOL = (1e-2, 1e-3)   # atol as a fraction of the leaf's max |g|
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}

#: (b, hq, hkv, s, d, causal, window, softcap): GQA 1, 2 and 4, causal and
#: not, a window, the cap, lengths no tile divides
CASES = {
    "causal-gqa1": (2, 4, 4, 40, 32, True, None, None),
    "noncausal-gqa2": (1, 4, 2, 37, 64, False, None, None),
    "window-gqa4": (1, 8, 2, 50, 32, True, 8, None),
    "cap-window-gqa2": (2, 4, 2, 33, 16, False, 12, 50.0),
}


def _inputs(case, seed, dtype=torch.float32):
    """q (scaled by 4, so that the cap of 50 bends the scores), k, v and
    d_out of ``case``, from a numpy seed, in ``dtype``."""
    b, hq, hkv, s, d = CASES[case][:5]
    rng = np.random.default_rng(seed)
    arrs = (rng.standard_normal((b, hq, s, d)) * 4,
            rng.standard_normal((b, hkv, s, d)),
            rng.standard_normal((b, hkv, s, d)),
            rng.standard_normal((b, hq, s, d)))
    return tuple(torch.from_numpy(a.astype(np.float32)).to(dtype)
                 for a in arrs)


def _masks(case):
    return CASES[case][5:]


def _plain_grads(q, k, v, d_out, causal, window, softcap):
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = tfa.flash_attention_plain(*leaves, causal, window, softcap)
    return torch.autograd.grad(out, leaves, d_out)


def _close(got, want, dtype, err_msg=""):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    if dtype == torch.bfloat16:
        rtol, atol = BF16_TOL[0], BF16_TOL[1] * float(np.abs(want).max())
    else:
        rtol, atol = F32_TOL
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=err_msg)


def _grad_close(got, want, err_msg=""):
    want = np.asarray(want, np.float32)
    atol = 1e-5 * (float(np.abs(want).max()) or 1.0)
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=1e-3,
                               atol=atol, err_msg=err_msg)


# --------------------------------------------------------------------------
# the plain backward (the kernels' oracle) against autograd
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
def test_bwd_plain_matches_autograd(case, dtype):
    """flash_attention_bwd_plain from the forward's lse and float32 out
    against autograd of flash_attention_plain: dq, dk, dv."""
    tdt = DTYPES[dtype][1]
    q, k, v, d_out = _inputs(case, 1, tdt)
    masks = _masks(case)
    out, lse, out_f32 = tfa.flash_attention_plain_lse(q, k, v, *masks)
    assert torch.equal(out, tfa.flash_attention_plain(q, k, v, *masks))
    assert out_f32.dtype == torch.float32 and lse.dtype == torch.float32
    got = tfa.flash_attention_bwd_plain(q, k, v, out_f32, lse, d_out, *masks)
    want = _plain_grads(q, k, v, d_out, *masks)
    for name, a, b, t in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        assert a.dtype == tdt and a.shape == t.shape
        _close(a, b.float().numpy(), tdt, err_msg=name)


# --------------------------------------------------------------------------
# autograd of the plain version against the reference's derivatives
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["causal-gqa1", "window-gqa4",
                                  "cap-window-gqa2"])
def test_autograd_matches_reference_oracle_vjp(case):
    """Autograd of flash_attention_plain against jax.vjp of
    ref.flash_attention_ref, float32 (the oracle's bf16 path rounds its
    scores to bf16 in the einsum, a function of other roundings)."""
    q, k, v, d_out = _inputs(case, 2)
    masks = _masks(case)
    _, vjp = jax.vjp(lambda a, b, c: jref.flash_attention_ref(a, b, c,
                                                              *masks),
                     *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    want = vjp(jnp.asarray(d_out.numpy()))
    got = _plain_grads(q, k, v, d_out, *masks)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close(a, b, torch.float32, err_msg=name)


@pytest.mark.parametrize("window,softcap,n_kv", [(None, None, 4), (8, 50.0, 2)],
                         ids=["causal-mha", "window-cap-gqa2"])
def test_gqa_layer_gradients_match_reference_sdpa(window, softcap, n_kv):
    """The port's gqa_fwd (attention by the plain version, differentiated
    by autograd) against jax.vjp of the reference's gqa_fwd with
    use_flash=False (its _sdpa, differentiated by XLA): the gradients of x
    and of every projection, float32."""
    kw = dict(d_model=64, n_heads=4, n_kv=n_kv, head_dim=16, window=window,
              softcap=softcap, qk_norm=True)
    jcfg, tcfg = jattn.AttnConfig(**kw), tattn.AttnConfig(**kw)
    rng = np.random.default_rng(3)
    hd = 16
    p = {"wq": rng.standard_normal((64, 4 * hd)) / 8,
         "wk": rng.standard_normal((64, n_kv * hd)) / 8,
         "wv": rng.standard_normal((64, n_kv * hd)) / 8,
         "wo": rng.standard_normal((4 * hd, 64)) / 8,
         "q_scale": rng.standard_normal(hd) / 4,
         "k_scale": rng.standard_normal(hd) / 4}
    p = {name: a.astype(np.float32) for name, a in p.items()}
    x = rng.standard_normal((2, 48, 64)).astype(np.float32)
    g = rng.standard_normal((2, 48, 64)).astype(np.float32)
    _, vjp = jax.vjp(
        lambda jp, jx: jattn.gqa_fwd(jp, jx, jcfg, jcommon.NO_SHARD)[0],
        {name: jnp.asarray(a) for name, a in p.items()}, jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(g))
    tp = {name: torch.from_numpy(a).requires_grad_(True)
          for name, a in p.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    tattn.gqa_fwd(tp, tx, tcfg).backward(torch.from_numpy(g))
    _grad_close(tx.grad, jgx, err_msg="x")
    for name, t in tp.items():
        _grad_close(t.grad, jgp[name], err_msg=name)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", ["noncausal-gqa2", "cap-window-gqa2"])
def test_lse_matches_reference_logsumexp(case, dtype):
    """flash_attention_plain_lse's lse against jax.nn.logsumexp of the
    scores of the reference's _flash_kernel (q * (1/sqrt(D)) rounded in
    q's type, float32 dot, the cap, -1e30 where masked)."""
    jdt, tdt = DTYPES[dtype]
    q, k, v, _ = _inputs(case, 4, tdt)
    causal, window, softcap = _masks(case)
    b, hq, s, d = q.shape
    g = hq // k.shape[1]
    jq, jk = (jnp.asarray(t.float().numpy(), jdt) for t in (q, k))
    qs = (jq * (1.0 / math.sqrt(d))).astype(jnp.float32)
    kf = jnp.repeat(jk.astype(jnp.float32), g, axis=1)
    sc = jnp.einsum("bhqd,bhkd->bhqk", qs, kf,
                    precision=jax.lax.Precision.HIGHEST)
    if softcap is not None:
        sc = softcap * jnp.tanh(sc / softcap)
    q_pos, k_pos = jnp.arange(s)[:, None], jnp.arange(s)[None, :]
    keep = jnp.ones((s, s), bool)
    if causal:
        keep &= k_pos <= q_pos
    if window is not None:
        keep &= k_pos > q_pos - window
    want = jax.nn.logsumexp(jnp.where(keep, sc, -1e30), axis=-1)
    _, lse, _ = tfa.flash_attention_plain_lse(q, k, v, causal, window,
                                              softcap)
    assert lse.shape == (b, hq, s)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# --------------------------------------------------------------------------
# the autograd Function's wiring
# --------------------------------------------------------------------------

def _counting(fn):
    def f(*args):
        f.calls += 1
        return fn(*args)
    f.calls = 0
    return f


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", ["causal-gqa1", "cap-window-gqa2"])
def test_function_wiring_matches_autograd(case, dtype):
    """_FlashAttentionFn with the plain forward and backward bound in as
    its launchers: the same out as the plain version, one forward and one
    backward launch, and dq, dk, dv of autograd of the plain version;
    an input that needs no gradient gets none."""
    tdt = DTYPES[dtype][1]
    q, k, v, d_out = _inputs(case, 5, tdt)
    masks = _masks(case)
    fwd = _counting(tfa.flash_attention_plain_lse)
    bwd = _counting(tfa.flash_attention_bwd_plain)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = tfa._FlashAttentionFn.apply(*leaves, *masks, fwd, bwd)
    assert torch.equal(out.detach(), tfa.flash_attention_plain(q, k, v,
                                                               *masks))
    got = torch.autograd.grad(out, leaves, d_out)
    assert (fwd.calls, bwd.calls) == (1, 1)
    want = _plain_grads(q, k, v, d_out, *masks)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close(a, b.float().numpy(), tdt, err_msg=name)
    kq = k.clone().requires_grad_(True)
    out = tfa._FlashAttentionFn.apply(q, kq, v, *masks, fwd, bwd)
    out.backward(d_out)
    assert kq.grad is not None and q.grad is None and v.grad is None


def _bind_plain_function(monkeypatch):
    """Route the LM's attention through _FlashAttentionFn with the plain
    launchers whenever a gradient is wanted (as flash_attention_cuda does
    with the kernels on the card); returns the counting launchers."""
    fwd = _counting(tfa.flash_attention_plain_lse)
    bwd = _counting(tfa.flash_attention_bwd_plain)
    plain = tfa.flash_attention

    def attention(q, k, v, causal=True, window=None, softcap=None):
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (q, k, v)):
            return tfa._FlashAttentionFn.apply(q, k, v, causal, window,
                                               softcap, fwd, bwd)
        return plain(q, k, v, causal, window, softcap)

    monkeypatch.setattr(tfa, "flash_attention", attention)
    return fwd, bwd


def test_slice_loss_and_gradients_through_function_match_jax(monkeypatch):
    """Reduced stablelm-1.6b in float32: LM.loss with remat, its attention
    through the Function (plain launchers), against jax.value_and_grad of
    the reference's loss; the forward runs twice a layer (the pass and the
    remat recompute) and the backward once."""
    jcfg = dataclasses.replace(jconfigs.reduced("stablelm-1.6b"),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(tconfigs.reduced("stablelm-1.6b"),
                               dtype=torch.float32)
    jm = make_model(jcfg)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    tm = load_reference_params(tree, tcfg, device="cpu")
    rng = np.random.default_rng(6)
    tok, lab = (rng.integers(0, tcfg.vocab, (2, 40)).astype(np.int32)
                for _ in range(2))
    want, jg = jax.jit(jax.value_and_grad(lambda p: jm.loss(
        p, jnp.asarray(tok), jnp.asarray(lab))))(
        jax.tree.map(jnp.asarray, tree))
    fwd, bwd = _bind_plain_function(monkeypatch)
    tm.requires_grad_(True)
    loss = tm.loss(torch.from_numpy(tok), torch.from_numpy(lab), remat=True)
    loss.backward()
    n = tcfg.n_layers
    assert (fwd.calls, bwd.calls) == (2 * n, n)
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    for key, p in tm.named_parameters():
        parts = key.split(".")
        if parts[0] == "layers":
            ref = jg["stack"]["b0"]
            for part in parts[2:]:
                ref = ref[part]
            ref = ref[int(parts[1])]
        else:
            ref = jg
            for part in parts:
                ref = ref[part]
        _grad_close(p.grad, ref, err_msg=key)


def test_slice_bf16_gradients_through_function_match_autograd(monkeypatch):
    """Reduced stablelm-1.6b in bfloat16: LM.loss with remat through the
    Function (plain launchers) against autograd of the plain version on
    the same model: the same loss bits (the forward is the same
    arithmetic), and every parameter's gradient within the bf16 model
    band."""
    tcfg = tconfigs.reduced("stablelm-1.6b")
    model = LM(tcfg, device="cpu", generator=torch.Generator().manual_seed(3))
    rng = np.random.default_rng(7)
    tok, lab = (torch.from_numpy(rng.integers(0, tcfg.vocab, (2, 40)).astype(
        np.int32)) for _ in range(2))
    model.requires_grad_(True)
    grads, losses = [], []
    for through_function in (False, True):
        with monkeypatch.context() as mp:
            if through_function:
                fwd, bwd = _bind_plain_function(mp)
            model.zero_grad(set_to_none=True)
            loss = model.loss(tok, lab, remat=True)
            loss.backward()
            losses.append(loss.detach())
            grads.append({key: p.grad.clone()
                          for key, p in model.named_parameters()})
    assert (fwd.calls, bwd.calls) == (2 * tcfg.n_layers, tcfg.n_layers)
    assert torch.equal(losses[0], losses[1])
    for key, want in grads[0].items():
        want = want.float().numpy()
        np.testing.assert_allclose(
            grads[1][key].float().numpy(), want, rtol=1e-2,
            atol=1e-2 * float(np.abs(want).max()), err_msg=key)


def test_cpu_tensors_take_the_plain_version_and_counters_reset():
    """On the CPU, flash_attention runs the plain version under autograd
    (no Function, no launch); the CUDA wrapper refuses CPU tensors with or
    without a gradient; reset_counters zeroes the backward count."""
    q, k, v, d_out = _inputs("causal-gqa1", 8)
    kernels.reset_counters()
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = tfa.flash_attention(*leaves)
    assert out.grad_fn is not None and \
        "FlashAttention" not in type(out.grad_fn).__name__
    out.backward(d_out)
    assert tfa.flash_attention_plain.calls == 1
    assert tfa.flash_attention_cuda.launches == 0
    assert tfa.flash_attention_cuda.bwd_launches == 0
    for need in (False, True):
        with pytest.raises(ValueError):
            tfa.flash_attention_cuda(q.clone().requires_grad_(need), k, v)
    tfa.flash_attention_cuda.bwd_launches = 3
    kernels.reset_counters()
    assert tfa.flash_attention_cuda.bwd_launches == 0
    assert kernels.counters()["flash_attention"] == {"launches": 0,
                                                     "plain_calls": 0}
