"""The port's MoE layer against the JAX package, on the CPU.

The same numpy inputs and the reference's ``init_moe`` parameters
(carried across as numpy arrays) go through ``repro.models.moe.moe_fwd``
and ``repro_torch.models.moe.moe_fwd``.  Bands: out at rtol 2e-4, atol
2e-5 in float32 (the reference's own, ``tests/test_moe.py:49-50``), aux at
rtol 1e-6 (both sum the same float32 terms; the reference scatter-adds the
density one assignment at a time, the port multiplies the counts: 1e-7
apart).  In bfloat16 both round the expert products and the combine to
bf16 at other places: out within 2 bf16 ulps of |out| <= 2 (rtol 2e-2,
atol 2e-2).

The choices must be the reference's: which expert each assignment goes
to (top-k ties to the lower index), its rank in the expert and whether
the capacity drops it.  They are compared directly, and the outputs show
them (a token that loses an expert loses its share of the output).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro.models.common import ShardingRules
from repro_torch.models import moe as tmoe
from repro_torch.models.ffn import ffn_fwd
from repro_torch.models.lm import _tensor
from repro_torch.models.perf import FLAGS

RULES = ShardingRules()
F32_TOL = dict(rtol=2e-4, atol=2e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
AUX_RTOL = 1e-6
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}

#: (name, MoEConfig fields, batch, seq, dtype, inputs): "random" normal
#: tokens, "same" one token repeated (all route alike), "ties" random
#: tokens with router columns forced equal (see _tie_router)
CASES = {
    "base": (dict(), 2, 16, "f32", "random"),
    "shared": (dict(n_shared=2), 2, 16, "f32", "random"),
    "ample": (dict(capacity_factor=100.0), 2, 64, "f32", "random"),
    "drop_identical": (dict(), 1, 128, "f32", "same"),
    "drop_random": (dict(capacity_factor=0.5), 2, 128, "f32", "random"),
    "ties_top2": (dict(), 2, 40, "f32", "ties"),
    "ties_top1_drop": (dict(top_k=1), 1, 128, "f32", "ties"),
    "gelu": (dict(activation="gelu"), 2, 16, "f32", "random"),
    "deepseek_shape": (dict(d_model=64, d_expert=32, n_experts=64, top_k=6,
                            n_shared=2), 2, 48, "f32", "random"),
    "bf16_drop": (dict(capacity_factor=0.5, n_shared=1), 2, 128, "bf16",
                  "random"),
}


def _cfgs(**kw):
    base = dict(d_model=32, d_expert=16, n_experts=8, top_k=2, n_shared=0)
    base.update(kw)
    return jmoe.MoEConfig(**base), tmoe.MoEConfig(**base)


def _tie_router(router: np.ndarray, top_k: int) -> np.ndarray:
    """Columns 2, 4 and 6 equal and ahead of the rest for every token: the
    top-k takes 2 (and 4), never 6, by the lower-index rule."""
    r = router.copy()
    lead = np.abs(r).sum(0).max() * 4.0
    col = r[:, 2] + lead / np.sqrt(r.shape[0])
    for j in (2, 4, 6):
        r[:, j] = col
    return r


def _case(name, seed=0):
    """(reference cfg, port cfg, numpy params, numpy x, dtype name)."""
    fields, b, s, dtype, inputs = CASES[name]
    jcfg, tcfg = _cfgs(**fields)
    jdt = DTYPES[dtype][0]
    p = jax.tree.map(np.asarray,
                     jmoe.init_moe(jax.random.PRNGKey(seed), jcfg, jdt))
    rng = np.random.default_rng(seed + 1)
    if inputs == "same":
        x = np.broadcast_to(rng.standard_normal((1, 1, jcfg.d_model)),
                            (b, s, jcfg.d_model))
    else:
        x = rng.standard_normal((b, s, jcfg.d_model))
    x = np.ascontiguousarray(x, dtype=np.float32)
    if inputs == "ties":
        # a positive mean puts the lead of the tied columns on every token
        x = np.abs(x)
        p = dict(p, router=_tie_router(p["router"], jcfg.top_k))
    return jcfg, tcfg, p, x, dtype


def _run_both(jcfg, tcfg, p, x, dtype, stats=None):
    jdt, tdt = DTYPES[dtype]
    # jit: one compile per case instead of one per eager operation
    jo, ja = jax.jit(lambda p, x: jmoe.moe_fwd(p, x, jcfg, RULES))(
        p, jnp.asarray(x).astype(jdt))
    to, ta = tmoe.moe_fwd(jax.tree.map(_tensor, p),
                          torch.from_numpy(x).to(tdt), tcfg, stats)
    return (np.asarray(jo, np.float32), float(ja), to, float(ta))


def _ref_choices(p, x, jcfg):
    """The reference's expert of every assignment and whether it is kept,
    from its own functions (token-major, as its dispatch)."""
    t = x.shape[0] * x.shape[1]

    @jax.jit
    def choose(x, router):
        probs = jax.nn.softmax(x.reshape(t, -1) @ router, axis=-1)
        flat = jax.lax.top_k(probs, jcfg.top_k)[1].reshape(-1)
        return flat, jmoe._rank_in_expert(flat, jcfg.n_experts)

    flat, rank = choose(jnp.asarray(x), jnp.asarray(p["router"]))
    cap = max(int(jcfg.capacity_factor * t * jcfg.top_k / jcfg.n_experts
                  + 1), min(t, 64))
    return np.asarray(flat), np.asarray(rank), np.asarray(rank) < cap


def _port_choices(p, x, tcfg):
    t = x.shape[0] * x.shape[1]
    xt = torch.from_numpy(x).reshape(t, -1)
    probs = torch.softmax(xt @ _tensor(p["router"]), dim=-1)
    _, idx = tmoe._top_k(probs, tcfg.top_k)
    flat = idx.reshape(-1)
    rank = tmoe._rank_in_expert(flat, tcfg.n_experts)
    return flat.numpy(), rank.numpy(), (rank < tmoe.capacity(tcfg, t)).numpy()


@pytest.mark.parametrize("name", list(CASES))
def test_moe_fwd_matches_reference(name):
    """out in the reference's band, aux at rtol 1e-6, and the same number
    of assignments dropped."""
    jcfg, tcfg, p, x, dtype = _case(name)
    stats = {}
    jo, ja, to, ta = _run_both(jcfg, tcfg, p, x, dtype, stats)
    assert to.shape == x.shape and to.dtype == DTYPES[dtype][1]
    np.testing.assert_allclose(to.float().numpy(), jo,
                               **(F32_TOL if dtype == "f32" else BF16_TOL))
    np.testing.assert_allclose(ta, ja, rtol=AUX_RTOL)
    if dtype == "f32":
        _, _, keep = _ref_choices(p, x, jcfg)
        assert int(stats["dropped"]) == int((~keep).sum())
        assert stats["assignments"] == keep.size


@pytest.mark.parametrize("name", ["drop_identical", "drop_random",
                                  "ties_top2", "ties_top1_drop",
                                  "deepseek_shape"])
def test_same_experts_ranks_and_drops_as_reference(name):
    jcfg, tcfg, p, x, _ = _case(name)
    want = _ref_choices(p, x, jcfg)
    got = _port_choices(p, x, tcfg)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    if name.startswith("drop") or name == "ties_top1_drop":
        assert not want[2].all()            # the case does drop
    if name.startswith("ties"):
        # the tied columns: 2 (then 4) chosen, 6 never
        experts = want[0].reshape(-1, jcfg.top_k)
        assert (experts[:, 0] == 2).all() and not (experts == 6).any()
        if jcfg.top_k == 2:
            assert (experts[:, 1] == 4).all()


@pytest.mark.parametrize("name", ["drop_random", "deepseek_shape"])
def test_onehot_dispatch_equals_sort_dispatch(name, monkeypatch):
    """FLAGS["moe_onehot_dispatch"]: the one-hot ranks are the sort
    ranks, in both packages, and the port's output is the same bits."""
    jcfg, tcfg, p, x, dtype = _case(name)
    flat_np = _ref_choices(p, x, jcfg)[0]
    flat = torch.tensor(flat_np, dtype=torch.long)
    want = tmoe._rank_in_expert(flat, tcfg.n_experts)
    out, aux = tmoe.moe_fwd(jax.tree.map(_tensor, p), torch.from_numpy(x),
                            tcfg)
    monkeypatch.setitem(FLAGS, "moe_onehot_dispatch", True)
    np.testing.assert_array_equal(
        tmoe._rank_in_expert(flat, tcfg.n_experts).numpy(), want.numpy())
    from repro.models import perf as jperf
    monkeypatch.setitem(jperf.FLAGS, "moe_onehot_dispatch", True)
    np.testing.assert_array_equal(
        np.asarray(jmoe._rank_in_expert(jnp.asarray(flat_np),
                                        jcfg.n_experts)), want.numpy())
    out1, aux1 = tmoe.moe_fwd(jax.tree.map(_tensor, p), torch.from_numpy(x),
                              tcfg)
    assert torch.equal(out1, out) and torch.equal(aux1, aux)


# --------------------------------------------------------------------------
# the invariants of tests/test_moe.py, on the port
# --------------------------------------------------------------------------

def _port(name, **fields):
    """Port cfg and params (seeded torch init) for an invariant."""
    _, tcfg = _cfgs(**fields)
    return tcfg, tmoe.init_moe(torch.Generator().manual_seed(0), tcfg,
                               torch.float32)


def _x(*shape, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


def _inv_finite_and_shaped():
    for seed in range(3):
        cfg, p = _port("base")
        x = _x(2, 16, 32, seed=seed)
        out, aux = tmoe.moe_fwd(p, x, cfg)
        assert out.shape == x.shape and bool(torch.isfinite(out).all())
        assert float(aux) >= 0


def _inv_no_drop_equals_dense_mixture():
    """Ample capacity: every token gets exactly its top-k gates, so the
    output is the per-token mixture computed by hand."""
    cfg, p = _port("ample", capacity_factor=100.0)
    x = _x(1, 8, 32)
    out, _ = tmoe.moe_fwd(p, x, cfg)
    xt = x.reshape(-1, 32)
    gv, ei = torch.topk(torch.softmax(xt @ p["router"], -1), cfg.top_k)
    gv = gv / gv.sum(-1, keepdim=True)
    want = torch.zeros_like(xt)
    for t in range(xt.shape[0]):
        for j in range(cfg.top_k):
            e = int(ei[t, j])
            h = torch.nn.functional.silu(xt[t] @ p["w_gate"][e]) \
                * (xt[t] @ p["w_up"][e])
            want[t] += gv[t, j] * (h @ p["w_down"][e])
    np.testing.assert_allclose(out.reshape(-1, 32).numpy(), want.numpy(),
                               **F32_TOL)


def _inv_shared_experts_always_on():
    """Routed experts silenced (w_down zero): the shared experts' output
    alone remains."""
    cfg, p = _port("shared", n_shared=2)
    p = dict(p, w_down=torch.zeros_like(p["w_down"]))
    x = _x(2, 4, 32)
    out, _ = tmoe.moe_fwd(p, x, cfg)
    want = ffn_fwd(p["shared"], x.reshape(1, -1, 32),
                   cfg.shared_cfg)[0].reshape(2, 4, 32)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-5)


def _inv_capacity_drops_overflow():
    """128 identical tokens route alike: the 64-slot floor drops half, so
    the output is smaller than with ample capacity, and exactly zero on
    the dropped tokens (the later ones)."""
    cfg, p = _port("base")
    x = _x(1, 1, 32).expand(1, 128, 32).contiguous()
    stats = {}
    small, _ = tmoe.moe_fwd(p, x, cfg, stats)
    big, _ = tmoe.moe_fwd(p, x, dataclasses.replace(cfg,
                                                    capacity_factor=100.0))
    assert float(small.norm()) < float(big.norm())
    assert int(stats["dropped"]) == 128
    assert bool((small[0, 64:] == 0).all())
    np.testing.assert_allclose(small[0, :64].numpy(), big[0, :64].numpy(),
                               **F32_TOL)


def _inv_aux_balanced_below_skewed():
    cfg, p = _port("base")
    x = _x(4, 64, 32, seed=2)
    _, aux_rand = tmoe.moe_fwd(p, x, cfg)
    _, aux_skew = tmoe.moe_fwd(p, x[:1, :1].expand(4, 64, 32).contiguous(),
                               cfg)
    assert float(aux_skew) > float(aux_rand)


INVARIANTS = {f.__name__[5:]: f for f in (
    _inv_finite_and_shaped, _inv_no_drop_equals_dense_mixture,
    _inv_shared_experts_always_on, _inv_capacity_drops_overflow,
    _inv_aux_balanced_below_skewed)}


@pytest.mark.parametrize("name", list(INVARIANTS))
def test_invariant(name):
    INVARIANTS[name]()


def test_init_follows_the_reference():
    """Router float32 (fan-in truncated normal), experts in the model's
    type with the reference's scales, shapes as the reference's; a repeat
    with the same seed gives the same weights."""
    _, tcfg = _cfgs(d_model=256, d_expert=128, n_experts=4, n_shared=1)
    p = tmoe.init_moe(torch.Generator().manual_seed(1), tcfg, torch.bfloat16)
    jp = jax.eval_shape(lambda k: jmoe.init_moe(k, _cfgs(
        d_model=256, d_expert=128, n_experts=4, n_shared=1)[0],
        jnp.bfloat16), jax.random.PRNGKey(0))
    assert {k: tuple(v.shape) for k, v in p.items() if k != "shared"} == \
        {k: tuple(v.shape) for k, v in jp.items() if k != "shared"}
    assert p["router"].dtype == torch.float32
    assert p["w_up"].dtype == p["shared"]["w_up"].dtype == torch.bfloat16
    for name, fan in (("router", 256), ("w_gate", 256), ("w_down", 128)):
        w = p[name].float()
        assert float(w.abs().max()) <= 2.0 / np.sqrt(fan) * (1 + 2 ** -8)
        # N(0, 1) cut to [-2, 2] has std 0.8796
        assert abs(float(w.std()) * np.sqrt(fan) - 0.8796) < 0.03
    again = tmoe.init_moe(torch.Generator().manual_seed(1), tcfg,
                          torch.bfloat16)
    assert torch.equal(again["w_down"], p["w_down"])
