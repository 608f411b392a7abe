"""The port's sharded Mamba2 and zamba2's shared attention block against
the JAX package's, on the CPU.

The reference's ``build_train_step(cfg, mesh, zero1=True)`` runs on its
(4, 2) and (2, 4) host meshes (``tests/conftest.py``) and the port's
sharded step (``build_train_step(..., mesh=, zero1=True)``, a
``ShardedLM``) on meshes of eight ``cpu`` shards of the same shapes, from
the same weights (the reference's ``jit(init)`` carried across by
``load_reference_params``) and the same global batch of 8 x 16 tokens,
for reduced zamba2-7b: one prelude ``mamba`` layer and three repeats of
``mamba, mamba, mamba_shared`` (SSD chunk 16; 8 SSD heads of 32 over
d_inner 256, split by heads over the model axis; the shared block's 4
heads of 32 and its FFN split as a GQA block's, called at three sites).
Float32 bands: the loss and the gradients' global norm rtol 1e-5, every
updated parameter rtol 1e-3 and atol 1e-5, the replicated Mamba2 leaves
and ``shared_attn.*`` included; bfloat16 at the zoo's whole-model band.
The port's sharded step also holds to its own single-device step (on a
(1, 8) mesh, where the shared block's 128 ``wq`` columns split inside a
32-wide head; on a pod mesh; on a model axis of 3, where every leaf is
replicated), gives the same bits with ZeRO-1 on and off and on a repeat,
lays ZeRO-1's pieces out by the stacked repeats at the card's depth, and
sums the replicated leaves' partial gradients over their holders.
A gated norm that took each shard's own mean leaves the band; a split
inside an SSD head raises.
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
from repro_torch.distributed.collectives import MeshComm
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import make_host_mesh, make_pod_mesh
from repro_torch.launch.steps import build_prefill_step, build_train_step
from repro_torch.models import mamba2 as tm2
from repro_torch.models.lm import LM, load_reference_params
from repro_torch.models.sharded_lm import ShardedLM

NAME = "zamba2-7b"
B, S = 8, 16
MESHES = {"4x2": ("host_mesh", 2), "2x4": ("mesh82", 4)}
F32 = dict(rtol=1e-5)
PARAM_F32 = dict(rtol=1e-3, atol=1e-5)
BF16 = dict(rtol=5e-2, atol=1e-1)
#: the Mamba2 leaves every model shard holds whole
REPLICATED = ("w_B", "w_C", "w_dt", "conv_B", "conv_Bb", "conv_C",
              "conv_Cb", "dt_bias", "a_log", "d_skip")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite runs its files in parallel worker
    processes, and a sharded step's many small products on eight shards
    thrash the cores with more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(dtype="f32", **kw):
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return (dataclasses.replace(jconfigs.reduced(NAME), dtype=jdt, **kw),
            dataclasses.replace(tconfigs.reduced(NAME), dtype=tdt, **kw))


def _np(t):
    return t.detach().float().cpu().numpy()


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    lab = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    return tok, lab


def _torch_batch(tok, lab):
    return {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab)}


def _port_mesh(model_axis, n=8):
    return make_host_mesh(model_axis, devices=["cpu"] * n)


def _model(tcfg, seed):
    return LM(tcfg, device="cpu",
              generator=torch.Generator().manual_seed(seed))


def _ref_step(jcfg, jmesh, tok, lab, monkeypatch):
    """The reference's sharded step from ``jit(init)(PRNGKey(0))``:
    (initial params as numpy, loss, grad norm, new params as numpy)."""
    monkeypatch.setitem(jconfigs.SHAPES, "train_sharded", (S, B))
    built = j_build_train_step(jcfg, jmesh, "train_sharded", zero1=True)
    with jmesh:
        from repro.distributed.sharding import make_lm_rules
        model = make_model(jcfg, make_lm_rules(jmesh))
        params = jax.jit(model.init, out_shardings=built.in_shardings[0])(
            jax.random.PRNGKey(0))
        init = jax.tree.map(np.asarray, params)
        opt = jax.jit(j_adamw_init,
                      out_shardings=built.in_shardings[1])(params)
        batch = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)}
        new_p, _, metrics = built.jitted(params, opt, batch)
        return (init, float(metrics["loss"]), float(metrics["grad_norm"]),
                jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)),
                             new_p))


def _ref_leaf(model, tree, name):
    path, r = model.reference_leaf(name)
    for key in path:
        tree = tree[key]
    return tree if r is None else tree[r]


def _against_reference(key, dtype, band, param_band, request, monkeypatch,
                       seed=0):
    fixture, model_axis = MESHES[key]
    jcfg, tcfg = _cfgs(dtype)
    tok, lab = _batch(tcfg, seed)
    init, jl, jg, jnew = _ref_step(jcfg, request.getfixturevalue(fixture),
                                   tok, lab, monkeypatch)
    model = load_reference_params(init, tcfg, device="cpu")
    step = build_train_step(tcfg, batch=B, seq=S, mesh=_port_mesh(model_axis),
                            model=model, zero1=True)
    _, metrics = step.fn(step.init_opt(), _torch_batch(tok, lab))
    np.testing.assert_allclose(float(metrics["loss"]), jl, **band)
    np.testing.assert_allclose(float(metrics["grad_norm"]), jg, **band)
    meta = LM(tcfg, device="meta")
    names = set()
    for pname, t in step.model.gather().items():
        np.testing.assert_allclose(_np(t), _ref_leaf(meta, jnew, pname),
                                   err_msg=pname, **param_band)
        names.add(pname.split(".")[-1])
    assert set(REPLICATED) | {"norm_scale"} <= names
    assert any(n.startswith("shared_attn.") for n in step.model.layouts)


@pytest.mark.parametrize("key", MESHES)
def test_sharded_step_matches_reference_float32(key, request, monkeypatch):
    """One ZeRO-1 train step of reduced zamba2 on the mesh, float32: the
    loss and the gradient norm rtol 1e-5, every updated parameter
    (``w_B``, ``w_C``, ``w_dt``, ``dt_bias``, ``a_log``, ``d_skip``,
    ``norm_scale`` and ``shared_attn.*`` among them) rtol 1e-3 atol 1e-5,
    against the reference's ``build_train_step(cfg, mesh, zero1=True)``."""
    _against_reference(key, "f32", F32, PARAM_F32, request, monkeypatch)


def test_sharded_step_matches_reference_bf16(request, monkeypatch):
    """The same step in bfloat16 on (2, 4) (bf16 partial sums added in
    float32 and rounded once): the loss, the gradient norm and the
    updated parameters at the zoo's whole-model band, rtol 5e-2 atol
    1e-1."""
    _against_reference("2x4", "bf16", BF16, BF16, request, monkeypatch,
                       seed=1)


def _against_single(tcfg, mesh, seed):
    """Two float32 steps of the port's sharded step on ``mesh`` against two
    of its single-device step from the same model: losses and gradient
    norms rtol 1e-5, parameters rtol 1e-3 atol 1e-5.  Returns the sharded
    model."""
    model = _model(tcfg, seed)
    sharded = build_train_step(tcfg, batch=B, seq=S, model=model, mesh=mesh)
    single = build_train_step(tcfg, batch=B, seq=S, model=model)
    opts = [sharded.init_opt(), single.init_opt()]
    for step in range(2):
        batch = _torch_batch(*_batch(tcfg, seed=seed + 1 + step))
        opts[0], ms = sharded.fn(opts[0], batch)
        opts[1], m1 = single.fn(opts[1], batch)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(ms[k]), float(m1[k]), **F32)
    full = sharded.model.gather()
    for pname, p in model.named_parameters():
        np.testing.assert_allclose(_np(full[pname]), _np(p), err_msg=pname,
                                   **PARAM_F32)
    return sharded.model


@pytest.mark.parametrize("model_axis", [8, "pod", 3])
def test_sharded_step_matches_single_device(model_axis):
    """The sharded step against the port's single-device one
    (``_against_single``): on (1, 8) each shard runs one SSD head and the
    shared block's 16 ``wq`` columns a shard end inside a 32-wide head
    (regathered); on a (pod 2, data 2, model 2) mesh; on (2, 3), where no
    leaf divides the model axis: every shard computes every block whole
    and no Mamba2 partial is summed."""
    _, tcfg = _cfgs()
    if model_axis == "pod":
        mesh = make_pod_mesh(2, 2, devices=["cpu"] * 8)
    elif model_axis == 3:
        mesh = _port_mesh(3, n=6)
    else:
        mesh = _port_mesh(model_axis)
    model = _against_single(tcfg, mesh, seed=5)
    if model_axis == 8:
        assert model.comm.bytes["qkv"] > 0 and model.comm.bytes["norm"] > 0
        assert [p.heads for p in model.mamba_plans] == [(m, m + 1)
                                                        for m in range(8)]
    if model_axis == 3:
        assert not {"norm", "mamba", "attn", "ffn"} & set(model.comm.bytes)


def test_zero1_on_and_off_and_a_repeat_give_the_same_bits():
    """Float32 on (4, 2), two steps: ZeRO-1 on, ZeRO-1 off, and ZeRO-1 on
    again from the same weights give the same losses, norms, parameters
    and gathered moments, bit for bit."""
    _, tcfg = _cfgs()
    init = _model(tcfg, 9)
    state = {n: p.detach().clone() for n, p in init.named_parameters()}
    batch = _torch_batch(*_batch(tcfg, seed=4))
    from repro_torch.optim import gather_opt_mesh
    runs = []
    for zero1 in (True, False, True):
        init.load_state_dict(state)
        step = build_train_step(tcfg, batch=B, seq=S, model=init,
                                mesh=_port_mesh(2), zero1=zero1)
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


def test_replicated_leaves_sum_their_partial_gradients():
    """After one backward pass on (4, 2), float32: each model shard's
    gradient of ``dt_bias``, ``a_log`` and ``d_skip`` is zero outside its
    heads (a partial), and the sum over every shard that holds a
    replicated Mamba2 leaf or a ``shared_attn`` leaf is the single-device
    gradient (``shared_attn``'s summed over its three call sites) at the
    ``LM.loss`` gradient band, rtol 1e-3 and atol 1e-5 of the leaf's
    max."""
    _, tcfg = _cfgs()
    model = _model(tcfg, 7)
    sharded = ShardedLM(model, _port_mesh(2)).requires_grad_()
    model.requires_grad_()
    tok, lab = (torch.from_numpy(a) for a in _batch(tcfg, seed=3))
    sharded.loss(tok, lab).backward()
    model.loss(tok, lab).backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    layer = "layers.1.mamba"
    for leaf in ("dt_bias", "a_log", "d_skip"):
        for k, pl in enumerate(sharded.mamba_plans):
            g = sharded.shard_param(k, f"{layer}.{leaf}").grad
            h0, h1 = pl.heads
            assert float(g[h0:h1].abs().max()) > 0, (leaf, k)
            assert float(g[:h0].abs().sum() + g[h1:].abs().sum()) == 0
    checked = {"mamba": 0, "shared": 0}
    for name, lay in sharded.layouts.items():
        is_mamba = name.startswith("layers.") and \
            name.split(".")[-1] in REPLICATED
        if lay.model_dim is not None or not (
                is_mamba or name.startswith("shared_attn.")):
            continue
        total = sum(sharded.shard_param(k, name).grad
                    for k in range(len(sharded.comm)))
        want = grads[name]
        scale = float(want.abs().max())
        np.testing.assert_allclose(_np(total), _np(want), rtol=1e-3,
                                   atol=1e-5 * scale, err_msg=name)
        checked["mamba" if is_mamba else "shared"] += 1
    assert checked["mamba"] == len(REPLICATED) * len(tcfg.layer_kinds)
    assert checked["shared"] >= 2                 # ln1 and ln2 at least


def _group_layer(tcfg, model_axis, seed=3):
    """Layer 1's Mamba2 block of reduced zamba2 on replica 0's model shards
    of a (8 / M, M) mesh: (the sharded model, its group, the input)."""
    model = _model(tcfg, seed)
    rng = np.random.default_rng(8)
    with torch.no_grad():
        scale = model.layers[1]["mamba"]["norm_scale"]
        scale.copy_(torch.from_numpy(0.5 * rng.standard_normal(
            tuple(scale.shape)).astype(np.float32)))
    sharded = ShardedLM(model, _port_mesh(model_axis))
    x = torch.from_numpy(rng.standard_normal((2, S, tcfg.d_model)).astype(
        np.float32)).to(tcfg.dtype)
    want = tm2.mamba2_fwd(model.layers[1]["mamba"], x, tcfg.mamba_cfg())[0]
    return sharded, sharded.comm.model_group(0), x, want


def _layer_on_group(sharded, group, x, comm=None):
    return tm2.mamba2_fwd_mesh(
        [sharded.shards[k]["layers"]["1"]["mamba"] for k in group],
        [x] * len(group), sharded.cfg.mamba_cfg(), sharded.mamba_plans,
        comm or sharded.comm, group)


@pytest.mark.parametrize("model_axis,dtype", [(2, "f32"), (4, "bf16"),
                                              (8, "f32")])
def test_mamba_layer_on_a_group(model_axis, dtype):
    """One Mamba2 layer on one replica's model shards
    (``mamba2_fwd_mesh``) against ``mamba2_fwd`` on one device, with a
    seeded non-zero ``norm_scale``: float32 rtol 1e-5 atol 1e-6;
    bfloat16 (the gated norm's sums of squares and the ``out_proj``
    partials summed in float32, rounded once) at the zoo's band.  On 8
    shards each holds one 32-wide SSD head."""
    _, tcfg = _cfgs(dtype)
    sharded, group, x, want = _group_layer(tcfg, model_axis)
    band = dict(F32, atol=1e-6) if dtype == "f32" else BF16
    for o in _layer_on_group(sharded, group, x):
        np.testing.assert_allclose(_np(o), _np(want), **band)
    assert float(want.abs().max()) > 0


class _OwnNorm(MeshComm):
    """A mesh whose ``norm`` all-reduce gives each member its own sum times
    the group's size: the gated norm of each shard's own mean."""

    def all_reduce(self, parts, group, kind):
        if kind == "norm":
            return [p * len(group) for p in parts]
        return super().all_reduce(parts, group, kind)


def test_per_shard_norm_mean_leaves_the_band():
    """The gated norm is over the whole d_inner: a layer that normalised
    each shard's channels by their own mean differs from ``mamba2_fwd``
    beyond the float32 band the layer holds (and beyond the parameter
    band of a train step), on (4, 2)."""
    _, tcfg = _cfgs()
    sharded, group, x, want = _group_layer(tcfg, 2)
    own = _OwnNorm(sharded.mesh)
    wrong = _layer_on_group(sharded, group, x, own)[0]
    err = np.abs(_np(wrong) - _np(want))
    limit = 1e-6 + 1e-5 * np.abs(_np(want))
    assert (err > limit).mean() > 0.5
    assert (err > 1e-5 + 1e-3 * np.abs(_np(want))).any()
    right = _layer_on_group(sharded, group, x)[0]
    np.testing.assert_allclose(_np(right), _np(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("head_dim,model_axis", [(64, 8)])
def test_split_inside_an_ssd_head_raises(head_dim, model_axis):
    """d_inner 256 in SSD heads of 64 on 8 model shards (32 channels a
    shard): a block ends inside an SSD head, and building the sharded
    model or its step raises, naming the shape and ROADMAP A3.4.3 (one
    head of 256 on 2 shards is
    ``test_torch_sharded_train.py::test_block_kinds_off_the_mesh_raise``)."""
    _, tcfg = _cfgs(mamba_head_dim=head_dim)
    with pytest.raises(ValueError, match=f"inside a {head_dim}-wide SSD "
                       r"head.*A3\.4\.3"):
        ShardedLM(LM(tcfg, device="meta"), _port_mesh(model_axis))
    with pytest.raises(ValueError, match="A3.4.3"):
        build_train_step(tcfg, batch=B, seq=S, device="cpu",
                         mesh=_port_mesh(model_axis))


@pytest.mark.parametrize("n_model", [2, 4, 8, 16])
def test_full_zamba2_plan_splits_on_head_boundaries(n_model):
    """zamba2-7b's 112 SSD heads of 64 (d_inner 7168) split over 2, 4, 8
    and 16 model shards on head boundaries: the blocks partition d_inner
    and each holds whole heads."""
    cfg = tconfigs.get_config(NAME).mamba_cfg()
    plans = tm2.mamba_mesh_plan(cfg, n_model, True)
    assert [p.inner for p in plans] == [
        (m * 7168 // n_model, (m + 1) * 7168 // n_model)
        for m in range(n_model)]
    assert [p.heads for p in plans] == [
        (m * 112 // n_model, (m + 1) * 112 // n_model)
        for m in range(n_model)]


def test_zero1_pieces_follow_the_stacked_repeats():
    """zamba2-7b at the card's depth (15 layers: the 3-layer prelude and two
    repeats of the 6-layer pattern) on a (data 2, model 2) mesh: ZeRO-1
    gives each data replica the whole moments of one repeat of every
    pattern leaf (the reference's spec puts the data axis on the stacked
    leaf's repeat axis), and splits each prelude leaf's moments along a
    dimension of its own."""
    from repro_torch.distributed.sharding import leaf_layouts, make_lm_rules
    cfg = dataclasses.replace(tconfigs.get_config(NAME), n_layers=15)
    model = LM(cfg, device="meta")
    layouts = leaf_layouts(model, make_lm_rules(_port_mesh(2, n=4)))
    n_pre, n_pat = len(cfg.prelude), len(cfg.pattern)
    for name, lay in layouts.items():
        if not name.startswith("layers."):
            continue
        i = int(name.split(".")[1])
        if i < n_pre:
            assert lay.z1_owner is None, name
        else:
            assert lay.z1_dim is None, name
            assert lay.z1_owner == (i - n_pre) // n_pat, name
    assert layouts["layers.0.mamba.w_z"].z1_dim == 0
    assert layouts["layers.0.mamba.w_z"].model_dim == 1


@pytest.mark.parametrize("model_axis,dtype", [(2, "f32"), (4, "bf16")])
def test_mesh_prefill_matches_lm_prefill(model_axis, dtype):
    """``build_prefill_step(..., mesh=)`` of reduced zamba2 against
    ``LM.prefill`` from the same weights: last-position float32 logits
    rtol 1e-4 atol 1e-5 in float32, the zoo's band in bfloat16."""
    _, tcfg = _cfgs(dtype)
    model = _model(tcfg, 11)
    tok = torch.from_numpy(_batch(tcfg, seed=12)[0])
    got = build_prefill_step(tcfg, model=model,
                             mesh=_port_mesh(model_axis)).fn(tok)
    want = model.prefill(tok)
    band = dict(rtol=1e-4, atol=1e-5) if dtype == "f32" else BF16
    assert got.shape == want.shape == (B, 1, tcfg.vocab)
    np.testing.assert_allclose(_np(got), _np(want), **band)


@pytest.mark.parametrize("name,item", [("deepseek-moe-16b", "A3.4.1"),
                                       ("xlstm-350m", "A3.4.3")])
def test_kinds_still_off_the_mesh_raise(name, item):
    """MoE (``moe``, ``dense``) and xLSTM (``mlstm``, ``slstm``) do not run
    on a mesh yet: building the sharded model raises, naming the ROADMAP
    item left."""
    with pytest.raises(ValueError, match=item):
        ShardedLM(LM(tconfigs.reduced(name), device="meta"), _port_mesh(2))


def test_cli_trains_zamba2_on_a_mesh(capsys):
    """``python -m repro_torch.launch.train --model-axis 2 --devices
    cpu,cpu,cpu,cpu`` on reduced zamba2-7b: 4 steps on a (2, 2) mesh, each
    loss and gradient norm finite."""
    ttrain.main(["--arch", NAME, "--reduced", "--batch", "4", "--seq", "16",
                 "--model-axis", "2", "--devices", "cpu,cpu,cpu,cpu",
                 "--steps", "4"])
    lines = [ln.split() for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[train] step")]
    assert [int(ln[2]) for ln in lines] == [0, 3]
    for ln in lines:
        loss, gnorm = float(ln[4]), float(ln[6])
        assert np.isfinite(loss) and np.isfinite(gnorm) and gnorm > 0
