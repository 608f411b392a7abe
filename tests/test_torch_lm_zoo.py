"""Seven configs against the JAX package, on the CPU: stablelm-1.6b and
codeqwen1.5-7b (dense GQA), hubert-xlarge (encoder, frame-embedding
inputs), deepseek-moe-16b and moonshot-v1-16b-a3b (a dense first layer,
then MoE layers), minicpm3-4b (MLA) and llama-3.2-vision-11b (GQA layers
and a gated cross-attention layer over a seeded image context).

The per-config checks (``check_forward``, ``check_decode``,
``check_config``) run here for the five dense and MoE configs and in
``tests/test_torch_mla_xattn.py`` for the MLA and VLM configs; the
parameter counts and the cells cover all seven here.  The reference
zero-initialises the cross-attention gate, so that at init ``tanh(0)``
multiplies the whole cross-attention away; ``_pair`` sets every gate of
the reference's tree to 0.5 before both packages load it.

Each reduced model holds the reference's parameters, carried across by
``load_reference_params``.  Bands: float32 rtol 1e-3, atol 1e-4 (the
reference's decode-vs-forward band, ``tests/test_models.py:86-87``);
bfloat16 ``tests/test_torch_lm.py``'s (both round every activation to
bf16, at other places).  At B 2 x S 24 an MoE layer sees 48 tokens, under
the capacity floor of 64 slots, so no assignment is dropped in either
package; ``tests/test_torch_moe.py`` covers the drops.

Routing is a discontinuous function of the hidden state: in bfloat16 the
few-ulp differences between the packages can flip a token's k-th expert
where the reference's k-th and (k+1)-th probabilities nearly tie (a 1 %
gap flipped in moonshot's last layer).  The bf16 MoE comparison therefore
leaves out the tokens whose top-k gap in some MoE layer of the reference
is under 5 % (``_near_ties``: 27 % of moonshot's 48 tokens), and requires
most tokens to be compared; float32 compares every token.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.models.lm import make_model
from repro_torch import configs as tconfigs
from repro_torch.launch.steps import build_prefill_step, build_serve_step
from repro_torch.models.lm import load_reference_params

DENSE_MOE = ("stablelm-1.6b", "codeqwen1.5-7b", "hubert-xlarge",
             "deepseek-moe-16b", "moonshot-v1-16b-a3b")
MLA_XATTN = ("minicpm3-4b", "llama-3.2-vision-11b")
NAMES = DENSE_MOE + MLA_XATTN
DECODERS = tuple(n for n in DENSE_MOE if n != "hubert-xlarge")
B, S = 2, 24
F32_TOL = dict(rtol=1e-3, atol=1e-4)
BF16_TOL = dict(rtol=5e-2, atol=1e-1)
#: the cross-attention gates' value in the parity tests (zero at init)
GATE = 0.5
#: relative top-k gap under which bf16 rounding may flip a routing choice
TIE_GAP = 0.05
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TORCH_OF = {jnp.dtype(jnp.int32): torch.int32,
            jnp.dtype(jnp.float32): torch.float32,
            jnp.dtype(jnp.bfloat16): torch.bfloat16}


def with_gates(tree, gate=GATE):
    """The reference's numpy tree with every cross-attention gate set to
    ``gate`` (in the gate's type)."""
    def walk(node):
        return {k: (walk(v) if isinstance(v, dict) else
                    np.full_like(v, gate) if k == "gate" else v)
                for k, v in node.items()}
    return walk(tree)


def _pair(name, dtype):
    """(JAX model, its params, the port's model holding them), the gates
    at ``GATE``."""
    jdt, tdt = DTYPES[dtype]
    jcfg = dataclasses.replace(jconfigs.reduced(name), dtype=jdt)
    tcfg = dataclasses.replace(tconfigs.reduced(name), dtype=tdt)
    jm = make_model(jcfg)
    tree = with_gates(jax.tree.map(np.asarray,
                                   jm.init(jax.random.PRNGKey(0))))
    tm = load_reference_params(tree, tcfg, device="cpu")
    return jm, jax.tree.map(jnp.asarray, tree), tm


def _inputs(cfg, seed=0, s=S):
    """Token ids, or frame embeddings for the audio model, as numpy."""
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        return rng.standard_normal((B, s, cfg.d_model)).astype(np.float32)
    return rng.integers(0, cfg.vocab, (B, s)).astype(np.int32)


def _ctx(jm, tm, seed=7):
    """The image context of a VLM, N(0, 1) in the model's type, for each
    package (None, None for another model)."""
    cfg = tm.cfg
    if cfg.family != "vlm":
        return None, None
    c = np.random.default_rng(seed).standard_normal(
        (B, cfg.n_ctx_tokens, cfg.d_model)).astype(np.float32)
    return jnp.asarray(c, jm.cfg.dtype), torch.from_numpy(c).to(cfg.dtype)


def _np(t):
    return t.float().numpy()


def _near_ties(jm, params, x) -> np.ndarray:
    """(B, S) mask of the tokens whose k-th and (k+1)-th router
    probabilities lie within ``TIE_GAP`` of each other in some MoE layer
    of the reference, on the reference's own layer inputs."""
    cfg, rules = jm.cfg, jm.rules
    h = jm._embed(params, jnp.asarray(x))
    pos = jnp.arange(x.shape[1])
    layers = [params["prelude"][f"p{i}"] for i in range(len(cfg.prelude))]
    layers += [jax.tree.map(lambda a: a[r], params["stack"]["b0"])
               for r in range(cfg.n_repeats)]
    near = np.zeros(x.shape[:2], bool)
    k = cfg.top_k
    for kind, p in zip(tuple(cfg.prelude) + cfg.pattern * cfg.n_repeats,
                       layers):
        if kind == "moe":
            a, _ = jattn.gqa_fwd(p["attn"], jlm._apply_norm(p["ln1"], h, cfg),
                                 cfg.attn_cfg("attn"), rules, positions=pos)
            h2 = jlm._apply_norm(p["ln2"], h + a, cfg).astype(jnp.float32)
            top = -np.sort(-np.asarray(jax.nn.softmax(
                h2 @ p["moe"]["router"], axis=-1)), axis=-1)
            near |= top[..., k - 1] - top[..., k] < TIE_GAP * top[..., k - 1]
        h = jlm.block_fwd(kind, p, h, cfg, rules, positions=pos)[0]
    return near


def check_forward(name, dtype):
    """forward's hidden states, logits, prefill and aux loss against the
    reference's, in ``dtype``."""
    jm, params, tm = _pair(name, dtype)
    x = _inputs(tm.cfg)
    jctx, tctx = _ctx(jm, tm)
    jh, _, jaux = jax.jit(lambda p, t, c: jm.forward(p, t, ctx=c,
                                                     remat=False))(
        params, jnp.asarray(x), jctx)
    stats = {}
    th, taux = tm(torch.from_numpy(x), tctx, return_aux=True,
                  moe_stats=stats)
    tol = F32_TOL if dtype == "f32" else BF16_TOL
    keep = np.ones((B, S), bool)
    if dtype == "bf16" and tm.cfg.family == "moe":
        keep = ~_near_ties(jm, params, x)
        assert keep.mean() > 0.5, keep.mean()      # 0.73 in moonshot
    np.testing.assert_allclose(_np(th)[keep], np.asarray(jh, np.float32)[keep],
                               **tol)
    np.testing.assert_allclose(_np(tm.logits(th))[keep],
                               np.asarray(jm.logits(params, jh))[keep], **tol)
    # the reference's prefill: the logits of forward's last position
    want = np.asarray(jm.logits(params, jh[:, -1:]))
    got = tm.prefill(torch.from_numpy(x), tctx)
    assert got.shape == (B, 1, tm.cfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got)[keep[:, -1]], want[keep[:, -1]],
                               **tol)
    assert taux.dtype == torch.float32 and taux.shape == ()
    np.testing.assert_allclose(float(taux), float(jaux), **tol)
    if tm.cfg.family == "moe":
        n_moe = tm.cfg.layer_kinds.count("moe")
        assert float(jaux) > 0
        assert stats["assignments"] == n_moe * B * S * tm.cfg.top_k
        assert int(stats["dropped"]) == 0
    else:
        assert float(taux) == float(jaux) == 0.0 and not stats


def check_decode(name):
    """24 decode steps from empty caches, float32 (a VLM with its image
    context at every step)."""
    jm, params, tm = _pair(name, "f32")
    tok = _inputs(tm.cfg, seed=2)
    jctx, tctx = _ctx(jm, tm)
    jc = jm.init_cache(B, S)
    tc = tm.init_cache(B, S)
    dec = jax.jit(jm.decode_step)
    for t in range(S):
        want, jc = dec(params, jnp.asarray(tok[:, t:t + 1]),
                       jnp.asarray(t, jnp.int32), jc, ctx=jctx)
        got, tc = tm.decode_step(torch.from_numpy(tok[:, t:t + 1]), t, tc,
                                 tctx)
        np.testing.assert_allclose(_np(got), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", DENSE_MOE)
def test_forward_logits_prefill_and_aux_match_jax(name, dtype):
    check_forward(name, dtype)


@pytest.mark.parametrize("name", DECODERS)
def test_decode_sequence_matches_jax(name):
    check_decode(name)


# --------------------------------------------------------------------------
# configs, cells, input specs
# --------------------------------------------------------------------------

def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def check_config(name):
    """get_config and reduced equal the reference's, field by field."""
    assert name in tconfigs.ARCH_NAMES and name not in tconfigs.NOT_PORTED
    for which in ("get_config", "reduced"):
        want = _fields(getattr(jconfigs, which)(name))
        got = _fields(getattr(tconfigs, which)(name))
        assert want.pop("dtype") == jnp.bfloat16
        assert got.pop("dtype") == torch.bfloat16
        assert got == want, which


@pytest.mark.parametrize("name", DENSE_MOE)
def test_configs_equal_reference_field_by_field(name):
    check_config(name)


def test_param_count_equals_reference():
    """Full widths: 1.44 B (stablelm) to 27.24 B (moonshot) parameters."""
    for name in NAMES:
        for fn in ("get_config", "reduced"):
            assert getattr(tconfigs, fn)(name).param_count() == \
                getattr(jconfigs, fn)(name).param_count(), (name, fn)
    assert tconfigs.get_config("moonshot-v1-16b-a3b").param_count() == \
        27_237_877_760


def _ref_specs(cfg, shape):
    """The reference's input specs as the port's: {name: (shape, dtype)},
    the caches as one dict per layer in run order (the reference stacks
    each pattern position over the repeats and leaves the cache-less
    cross-attention positions out; the port's list holds None there)."""
    specs = jconfigs.input_specs(cfg, shape)
    out = {}
    for key, val in specs.items():
        if key == "caches":
            layers = [val[f"p{i}"] for i in range(len(cfg.prelude))]
            for r in range(cfg.n_repeats):
                layers += [val["stack"].get(f"b{i}")
                           for i in range(len(cfg.pattern))]
            out[key] = [None if c is None else
                        {n: (tuple(a.shape[1:] if i >= len(cfg.prelude)
                                   else a.shape), TORCH_OF[a.dtype])
                         for n, a in c.items()}
                        for i, c in enumerate(layers)]
        else:
            out[key] = (tuple(val.shape), TORCH_OF[val.dtype])
    return out


def test_cells_and_input_specs_equal_reference():
    """Every (config, shape) cell: the same skip reason and the same input
    shapes and types; hubert's decode cells have no cache in either
    package (both raise)."""
    for name in NAMES:
        jcfg, tcfg = jconfigs.get_config(name), tconfigs.get_config(name)
        for shape in jconfigs.SHAPES:
            assert tconfigs.cell_skip_reason(tcfg, shape) == \
                jconfigs.cell_skip_reason(jcfg, shape), (name, shape)
            if tcfg.encoder_only and shape in jconfigs.DECODE_SHAPES:
                with pytest.raises(ValueError):
                    jconfigs.input_specs(jcfg, shape)
                with pytest.raises(ValueError):
                    tconfigs.input_specs(tcfg, shape)
                continue
            assert tconfigs.input_specs(tcfg, shape) == \
                _ref_specs(jcfg, shape), (name, shape)


def test_hubert_takes_frame_embeddings_and_has_no_decode():
    cfg = dataclasses.replace(tconfigs.reduced("hubert-xlarge"),
                              dtype=torch.float32)
    pre = build_prefill_step(cfg, batch=B, seq=S, device="cpu", seed=1)
    assert pre.in_specs == {"tokens": ((B, S, cfg.d_model), torch.float32)}
    frames = torch.from_numpy(_inputs(cfg, seed=3))
    logits = pre.fn(frames)
    assert logits.shape == (B, 1, cfg.vocab)
    assert torch.equal(logits, pre.model.logits(pre.model(frames)[:, -1:]))
    # float32 frames in a float32 model go in as they are
    assert torch.equal(pre.model._embed(frames), frames)
    with pytest.raises(ValueError, match="encoder-only arch has no decode"):
        build_serve_step(cfg, batch=B, seq=S, model=pre.model)
    with pytest.raises(ValueError, match="no decode cache"):
        pre.model.init_cache(B, S)
    with pytest.raises(ValueError, match="no decode step"):
        pre.model.decode_step(frames[:, :1], 0, [None] * cfg.n_layers)


def test_loaded_router_is_float32_in_a_bf16_model():
    """The reference keeps the router in float32; the loader keeps each
    leaf's type, the meta model's, and refuses a leaf of another type."""
    jm, params, tm = _pair("deepseek-moe-16b", "bf16")
    routers = {k: t for k, t in tm.state_dict().items()
               if k.endswith("moe.router")}
    assert len(routers) == tm.cfg.layer_kinds.count("moe") == 2
    assert all(t.dtype == torch.float32 for t in routers.values())
    np.testing.assert_array_equal(
        routers["layers.2.moe.router"].numpy(),
        np.asarray(params["stack"]["b0"]["moe"]["router"][1]))
    others = {t.dtype for k, t in tm.state_dict().items()
              if not k.endswith("moe.router")}
    assert others == {torch.bfloat16}
    f32 = jax.tree.map(np.asarray, make_model(dataclasses.replace(
        jconfigs.reduced("deepseek-moe-16b"), dtype=jnp.float32)).init(
        jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="another type"):
        load_reference_params(f32, tm.cfg, device="cpu")
