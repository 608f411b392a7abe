"""The port's sharded MLA and cross-attention against the JAX package's,
on the CPU.

The reference's ``build_train_step(cfg, mesh, zero1=True)`` runs on its
(4, 2) and (2, 4) host meshes (``tests/conftest.py``) and the port's
sharded step (``build_train_step(..., mesh=, zero1=True)``, a
``ShardedLM``) on meshes of eight ``cpu`` shards of the same shapes, from
the same weights (the reference's ``jit(init)`` carried across by
``load_reference_params``) and the same global batch of 8 x 16 tokens,
for reduced minicpm3-4b (MLA: ``wq_b``, ``wkv_b`` and ``wo`` split by
heads) and reduced llama-3.2-vision-11b (four GQA layers and a gated
cross-attention layer over a seeded image context of ``n_ctx_tokens``
rows; on (2, 4) its ``kv_x_dim`` of 64 splits inside a 32-wide head).
The cross-attention gates are set to 0.5 in both packages' parameters,
so that no comparison passes because ``tanh(0)`` removed the layer.
Float32 bands: the loss and the gradients' global norm rtol 1e-5, the
updated parameters rtol 1e-3 and atol 1e-5; bfloat16 at the zoo's
whole-model band.  The port's sharded step also holds to its own
single-device step (on a (1, 8) mesh, where reduced minicpm3's 96
``wq_b`` columns split inside a head, and on a pod mesh), gives the same
bits with ZeRO-1 on and off and on a repeat, and runs ``seq_parallel``
(block weights replicated, each model shard its block of query rows).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.launch.steps import build_train_step as j_build_train_step
from repro.models.lm import make_model
from repro.optim import adamw_init as j_adamw_init
from repro_torch import configs as tconfigs
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import make_host_mesh, make_pod_mesh
from repro_torch.launch.steps import build_prefill_step, build_train_step
from repro_torch.models import attention as tattn
from repro_torch.models.lm import LM, load_reference_params
from repro_torch.models.sharded_lm import ShardedLM

B, S = 8, 16
MLA, VLM = "minicpm3-4b", "llama-3.2-vision-11b"
MESHES = {"4x2": ("host_mesh", 2), "2x4": ("mesh82", 4)}
F32 = dict(rtol=1e-5)
PARAM_F32 = dict(rtol=1e-3, atol=1e-5)
BF16 = dict(rtol=5e-2, atol=1e-1)
#: the cross-attention gates' value (zero at init)
GATE = 0.5


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite runs its files in parallel worker
    processes, and a sharded step's many small products on eight shards
    thrash the cores with more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(name, dtype="f32", **kw):
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return (dataclasses.replace(jconfigs.reduced(name), dtype=jdt, **kw),
            dataclasses.replace(tconfigs.reduced(name), dtype=tdt, **kw))


def _np(t):
    return t.detach().float().cpu().numpy()


def _batch(cfg, seed=0):
    """Token ids, labels and, for a VLM, an N(0, 1) image context, as
    numpy (the context float32, None for a text model)."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    lab = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    ctx = None
    if cfg.family == "vlm":
        ctx = rng.standard_normal((B, cfg.n_ctx_tokens, cfg.d_model)
                                  ).astype(np.float32)
    return tok, lab, ctx


def _torch_batch(tok, lab, ctx, cfg):
    out = {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab)}
    if ctx is not None:
        out["ctx"] = torch.from_numpy(ctx).to(cfg.dtype)
    return out


def _port_mesh(model_axis):
    return make_host_mesh(model_axis, devices=["cpu"] * 8)


def with_gates(tree, gate=GATE):
    """The reference's numpy tree with every cross-attention gate set to
    ``gate`` (in the gate's type)."""
    def walk(node):
        return {k: (walk(v) if isinstance(v, dict) else
                    np.full_like(v, gate) if k == "gate" else v)
                for k, v in node.items()}
    return walk(tree)


def _ref_step(jcfg, jmesh, tok, lab, ctx, monkeypatch):
    """The reference's sharded step from ``jit(init)(PRNGKey(0))`` with the
    gates at GATE: (initial params as numpy, loss, grad norm, new params
    as numpy)."""
    monkeypatch.setitem(jconfigs.SHAPES, "train_sharded", (S, B))
    built = j_build_train_step(jcfg, jmesh, "train_sharded", zero1=True)
    with jmesh:
        from repro.distributed.sharding import make_lm_rules
        model = make_model(jcfg, make_lm_rules(jmesh))
        params = jax.jit(model.init, out_shardings=built.in_shardings[0])(
            jax.random.PRNGKey(0))
        init = with_gates(jax.tree.map(np.asarray, params))
        params = jax.device_put(init, built.in_shardings[0])
        opt = jax.jit(j_adamw_init,
                      out_shardings=built.in_shardings[1])(params)
        batch = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)}
        if ctx is not None:
            batch["ctx"] = jnp.asarray(ctx, jcfg.dtype)
        new_p, _, metrics = built.jitted(params, opt, batch)
        return (init, float(metrics["loss"]), float(metrics["grad_norm"]),
                jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)),
                             new_p))


def _ref_leaf(model, tree, name):
    path, r = model.reference_leaf(name)
    for key in path:
        tree = tree[key]
    return tree if r is None else tree[r]


def _port_step(tcfg, init, tmesh, batch):
    model = load_reference_params(init, tcfg, device="cpu")
    step = build_train_step(tcfg, batch=B, seq=S, mesh=tmesh, model=model)
    _, metrics = step.fn(step.init_opt(), _torch_batch(*batch, tcfg))
    return step.model, float(metrics["loss"]), float(metrics["grad_norm"])


def _against_reference(name, key, dtype, band, param_band, request,
                       monkeypatch, seed=0, **kw):
    fixture, model_axis = MESHES[key]
    jcfg, tcfg = _cfgs(name, dtype, **kw)
    batch = _batch(tcfg, seed)
    init, jl, jg, jnew = _ref_step(jcfg, request.getfixturevalue(fixture),
                                   *batch, monkeypatch)
    model, tl, tg = _port_step(tcfg, init, _port_mesh(model_axis), batch)
    np.testing.assert_allclose(tl, jl, **band)
    np.testing.assert_allclose(tg, jg, **band)
    meta = LM(tcfg, device="meta")
    for pname, t in model.gather().items():
        np.testing.assert_allclose(_np(t), _ref_leaf(meta, jnew, pname),
                                   err_msg=pname, **param_band)


@pytest.mark.parametrize("key", MESHES)
@pytest.mark.parametrize("name", (MLA, VLM))
def test_sharded_step_matches_reference_float32(name, key, request,
                                                monkeypatch):
    """One ZeRO-1 train step on the mesh, float32, gates open: the loss
    and the gradient norm rtol 1e-5, every updated parameter rtol 1e-3
    atol 1e-5, against the reference's ``build_train_step(cfg, mesh,
    zero1=True)``."""
    _against_reference(name, key, "f32", F32, PARAM_F32, request,
                       monkeypatch)


@pytest.mark.parametrize("name,key", [(MLA, "2x4"), (VLM, "4x2")])
def test_sharded_step_matches_reference_bf16(name, key, request,
                                             monkeypatch):
    """The same step in bfloat16 (bf16 partial sums added in float32 and
    rounded once): the loss, the gradient norm and the updated parameters
    at the zoo's whole-model band, rtol 5e-2 atol 1e-1."""
    _against_reference(name, key, "bf16", BF16, BF16, request, monkeypatch,
                       seed=1)


def test_seq_parallel_matches_reference(request, monkeypatch):
    """Reduced minicpm3 with ``seq_parallel`` (every block weight
    replicated; each of the 2 model shards computes its 8 query rows of
    each MLA block and their FFN) against the reference's sequence-
    parallel step on (4, 2), float32, at the bands above."""
    _against_reference(MLA, "4x2", "f32", F32, PARAM_F32, request,
                       monkeypatch, seed=2, seq_parallel=True)


def _against_single(tcfg, mesh, seed):
    """Two float32 steps of the port's sharded step on ``mesh`` against two
    of its single-device step from the same model (gates open): losses
    and gradient norms rtol 1e-5, parameters rtol 1e-3 atol 1e-5; the
    sharded prefill with the context against the single-device one.
    Returns the sharded model."""
    model = LM(tcfg, device="cpu",
               generator=torch.Generator().manual_seed(seed))
    model.set_xattn_gates(GATE)
    sharded = build_train_step(tcfg, batch=B, seq=S, model=model, mesh=mesh)
    single = build_train_step(tcfg, batch=B, seq=S, model=model)
    tok, _, ctx = _batch(tcfg, seed=seed)
    ctx = None if ctx is None else torch.from_numpy(ctx).to(tcfg.dtype)
    tok = torch.from_numpy(tok)
    logits = build_prefill_step(tcfg, model=sharded.model, mesh=mesh).fn(
        tok, ctx)
    want = build_prefill_step(tcfg, model=model).fn(tok, ctx)
    np.testing.assert_allclose(_np(logits), _np(want), rtol=1e-4, atol=1e-5)
    opts = [sharded.init_opt(), single.init_opt()]
    for step in range(2):
        batch = _torch_batch(*_batch(tcfg, seed=seed + 1 + step), tcfg)
        opts[0], ms = sharded.fn(opts[0], batch)
        opts[1], m1 = single.fn(opts[1], batch)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(ms[k]), float(m1[k]), **F32)
    full = sharded.model.gather()
    for pname, p in model.named_parameters():
        np.testing.assert_allclose(_np(full[pname]), _np(p), err_msg=pname,
                                   **PARAM_F32)
    return sharded.model


@pytest.mark.parametrize("name,model_axis", [(MLA, 8), (VLM, 4),
                                             (MLA, "pod"), (VLM, "pod")])
def test_sharded_step_matches_single_device(name, model_axis):
    """The sharded step and prefill against the port's single-device ones
    (``_against_single``): reduced minicpm3 on (1, 8), where ``wq_b``'s 12
    columns a shard end inside a 24-wide head (each head attended by the
    two shards whose ``wo`` rows it touches, the missing columns
    regathered); reduced llama-vision on (2, 4), its context split with
    the batch; both on a (pod 2, data 2, model 2) mesh."""
    _, tcfg = _cfgs(name)
    mesh = make_pod_mesh(2, 2, devices=["cpu"] * 8) if model_axis == "pod" \
        else _port_mesh(model_axis)
    model = _against_single(tcfg, mesh, seed=5)
    if model_axis == 8:
        assert model.comm.bytes.get("qkv", 0) > 0


@pytest.mark.parametrize("model_axis", [2, 4])
def test_seq_parallel_matches_single_device(model_axis):
    """``seq_parallel`` reduced minicpm3 on (4, 2) and (2, 4) against the
    port's single-device step: the rows are regathered (bytes of kind
    ``seq``) and no ``wo`` partial is all-reduced."""
    _, tcfg = _cfgs(MLA, seq_parallel=True)
    model = _against_single(tcfg, _port_mesh(model_axis), seed=6)
    assert model.comm.bytes["seq"] > 0 and "attn" not in model.comm.bytes


def test_seq_parallel_needs_rows_that_split():
    """A sequence that does not divide the model axis raises."""
    _, tcfg = _cfgs(MLA, seq_parallel=True)
    model = ShardedLM(LM(tcfg, device="cpu"), _port_mesh(4))
    with pytest.raises(ValueError, match="does not split"):
        model.forward(torch.zeros((8, 6), dtype=torch.int32))


@pytest.mark.parametrize("name,model_axis", [(MLA, 2), (VLM, 4)])
def test_zero1_on_and_off_and_a_repeat_give_the_same_bits(name, model_axis):
    """Float32, two steps, gates open: ZeRO-1 on, ZeRO-1 off, and ZeRO-1
    on again from the same weights give the same losses, norms,
    parameters and gathered moments, bit for bit."""
    _, tcfg = _cfgs(name)
    init = LM(tcfg, device="cpu", generator=torch.Generator().manual_seed(9))
    init.set_xattn_gates(GATE)
    state = {n: p.detach().clone() for n, p in init.named_parameters()}
    batch = _torch_batch(*_batch(tcfg, seed=4), tcfg)
    from repro_torch.optim import gather_opt_mesh
    runs = []
    for zero1 in (True, False, True):
        init.load_state_dict(state)
        step = build_train_step(tcfg, batch=B, seq=S, model=init,
                                mesh=_port_mesh(model_axis), zero1=zero1)
        opt = step.init_opt()
        metrics = []
        for _ in range(2):
            opt, m = step.fn(opt, batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        runs.append((metrics, step.model.gather(),
                     gather_opt_mesh(step.model, opt, zero1)))
    for other in runs[1:]:
        assert other[0] == runs[0][0]
        for n, t in runs[0][1].items():
            assert torch.equal(other[1][n], t), n
        for kk in ("m", "v"):
            for n, t in runs[0][2][kk].items():
                assert torch.equal(other[2][kk][n], t), (kk, n)


@pytest.mark.parametrize("n_model,heads", [(8, 4), (16, 40), (2, 40)])
def test_mla_plan_covers_every_head(n_model, heads):
    """``mla_mesh_plan`` on a model axis where blocks may end inside a head
    (reduced minicpm3's 4 heads on 8 shards; 40 heads on 16): the ``wo``
    row blocks partition H * v, each shard's heads cover its rows, and
    every head is attended by a shard; on 2 shards the 40 heads split on
    head boundaries (20 each, no regather)."""
    full = tconfigs.get_config(MLA)
    cfg = dataclasses.replace(full.mla_cfg(), n_heads=heads)
    if heads == 4:
        cfg = tconfigs.reduced(MLA).mla_cfg()
    plans = tattn.mla_mesh_plan(cfg, n_model, True, True, True)
    vd, qd = cfg.v_head_dim, cfg.qk_nope_dim + cfg.qk_rope_dim
    assert [p.o_own for p in plans] == [
        (m * heads * vd // n_model, (m + 1) * heads * vd // n_model)
        for m in range(n_model)]
    for p in plans:
        assert p.heads[0] * vd <= p.o_own[0] and p.o_own[1] <= p.heads[1] * vd
    assert set().union(*(range(*p.heads) for p in plans)) == set(range(heads))
    inside = any(p.q_own != (p.heads[0] * qd, p.heads[1] * qd)
                 for p in plans)
    assert inside == (heads % n_model != 0)


@pytest.mark.parametrize("model_axis,dtype", [(2, "f32"), (4, "bf16")])
def test_cross_attention_layer_on_a_group(model_axis, dtype):
    """One cross-attention layer of reduced llama-vision on one replica's
    model shards (``cross_fwd_mesh``) against ``cross_fwd`` on one device,
    gate at 0.5: float32 rtol 1e-5 atol 1e-6; bfloat16 (the ``wo``
    partials summed in float32, rounded once, then gated) at the zoo's
    band.  On 4 shards
    ``wk``'s 16 columns a shard split inside a 32-wide head."""
    _, tcfg = _cfgs(VLM, dtype)
    model = LM(tcfg, device="cpu", generator=torch.Generator().manual_seed(3))
    model.set_xattn_gates(GATE)
    layer = tcfg.layer_kinds.index("xattn")
    sharded = ShardedLM(model, _port_mesh(model_axis))
    comm, group = sharded.comm, sharded.comm.model_group(0)
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((2, S, tcfg.d_model)).astype(
        np.float32)).to(tcfg.dtype)
    ctx = torch.from_numpy(rng.standard_normal(
        (2, tcfg.n_ctx_tokens, tcfg.d_model)).astype(np.float32)).to(
        tcfg.dtype)
    outs = tattn.cross_fwd_mesh(
        [sharded.shards[k]["layers"][str(layer)]["attn"] for k in group],
        [x] * len(group), [ctx] * len(group), tcfg.attn_cfg("xattn"),
        sharded.attn_plans["xattn"], comm, group)
    want = tattn.cross_fwd(model.layers[layer]["attn"], x, ctx,
                           tcfg.attn_cfg("xattn"))
    band = dict(F32, atol=1e-6) if dtype == "f32" else BF16
    for o in outs:
        np.testing.assert_allclose(_np(o), _np(want), **band)
    assert float(want.abs().max()) > 0


def test_image_context_is_required_and_refused():
    """A VLM on a mesh without its context raises, as ``LM`` does; a text
    config given one raises; the kinds still off the mesh (xLSTM here)
    raise naming ROADMAP A3.4."""
    _, vcfg = _cfgs(VLM)
    vlm = ShardedLM(LM(vcfg, device="cpu"), _port_mesh(2))
    tok = torch.zeros((B, S), dtype=torch.int32)
    with pytest.raises(ValueError, match="cross-attention layers: pass ctx"):
        vlm.loss(tok, tok)
    _, mcfg = _cfgs(MLA)
    mla = ShardedLM(LM(mcfg, device="cpu"), _port_mesh(2))
    with pytest.raises(ValueError, match="no cross-attention"):
        mla.prefill(tok, torch.zeros((B, 4, mcfg.d_model)))
    with pytest.raises(ValueError, match="A3.4"):
        ShardedLM(LM(tconfigs.reduced("xlstm-350m"), device="meta"),
                  _port_mesh(2))


def test_cli_trains_the_vlm_on_a_mesh(tmp_path, capsys):
    """``python -m repro_torch.launch.train --model-axis 2 --devices
    cpu,cpu,cpu,cpu`` on reduced llama-3.2-vision-11b: steps on a (2, 2)
    mesh with a seeded image context each step, and checkpoints; run
    again one step longer, it resumes."""
    args = ["--arch", VLM, "--reduced", "--batch", "4", "--seq", "16",
            "--model-axis", "2", "--devices", "cpu,cpu,cpu,cpu",
            "--ckpt-dir", str(tmp_path)]
    ttrain.main(args + ["--steps", "20"])
    assert "[train] step    19 loss" in capsys.readouterr().out
    ttrain.main(args + ["--steps", "21"])
    out = capsys.readouterr().out
    assert "[train] resumed from step 19" in out
    assert "[train] step    20 loss" in out
