"""The port's sharding layer against the JAX package's, on the CPU.

``ShardingRules`` / ``make_lm_rules`` / ``param_shardings`` /
``batch_sharding`` / ``cache_shardings`` / ``opt_shardings`` /
``zero1_spec`` of ``repro_torch`` give the reference's ``PartitionSpec``
entries, leaf by leaf, for all ten reduced configs, on the reference's
(4, 2) host mesh (``tests/conftest.py``'s ``host_mesh``) and a (2, 4) one
(``mesh82``), against the port's meshes of eight ``cpu`` shards of the
same shapes.  The port holds one tensor per layer where the reference
stacks a pattern position over its repeats: its caches compare with the
reference's stacked specs without their leading (replicated) layers
entry, and its per-layer ZeRO-1 layouts with the stacked leaf's.  A split
of a seeded tree by its specs gathers back bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.distributed.sharding import batch_sharding as j_batch_sharding
from repro.distributed.sharding import make_lm_rules as j_make_lm_rules
from repro.distributed.sharding import param_shardings as j_param_shardings
from repro.launch.steps import abstract_params
from repro.launch.steps import cache_shardings as j_cache_shardings
from repro.launch.steps import opt_shardings as j_opt_shardings
from repro.models.lm import make_model
from repro.optim.adamw import zero1_spec as j_zero1_spec
from repro_torch import configs as tconfigs
from repro_torch.distributed.sharding import (batch_sharding, gather_tree,
                                              leaf_layouts, make_lm_rules,
                                              param_shardings, split_tree)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import cache_shardings, opt_shardings
from repro_torch.models.attention import gqa_mesh_plan
from repro_torch.models.common import P
from repro_torch.models.lm import LM, load_reference_params
from repro_torch.models.sharded_lm import ShardedLM
from repro_torch.optim import zero1_spec

MESHES = {"4x2": ("host_mesh", 2), "2x4": ("mesh82", 4)}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite runs its files in parallel worker
    processes, and small tensors split over eight shards gain nothing
    from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _meshes(request, key):
    """(the reference's mesh, the port's mesh of eight cpu shards)."""
    fixture, model_axis = MESHES[key]
    return (request.getfixturevalue(fixture),
            make_host_mesh(model_axis, devices=["cpu"] * 8))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("key", MESHES)
def test_rules_spec_and_fallback_equal_reference(key, request):
    """``spec`` of logical axes (divisible kept, non-divisible and a
    length-1 axis dropped to replication) and ``_axis_size``, entry for
    entry; ``shard`` checks per-shard parts and moves nothing."""
    jmesh, tmesh = _meshes(request, key)
    jr, tr = j_make_lm_rules(jmesh), make_lm_rules(tmesh)
    cases = [(("batch", "mlp"), (8, 16)), (("batch", "mlp"), (3, 7)),
             (("batch", None, "vocab"), (1, 1, 10)),
             (("batch", None, "vocab"), (8, 1, 512)),
             (("layers", "embed", "heads_x_dim"), (2, 128, 96)),
             (("batch", "heads", None, None), (4, 6, 32, 16)),
             (("expert", "embed", None), (12, 64, 8)), (("embed",), (7,))]
    for axes, shape in cases:
        assert tr.spec(axes, shape) == tuple(jr.spec(axes, shape)), axes
        assert tr.spec(axes) == tuple(jr.spec(axes)), axes
    for name in ("batch", "model", "vocab", "layers"):
        mapped = jr.rules.get(name)
        assert tr._axis_size(tr.rules.get(name)) == jr._axis_size(mapped)
    shape = (8, 4, 512)
    parts = [torch.zeros(8 // (8 // tmesh.shape["model"]), 4,
                         512 // tmesh.shape["model"])] * 8
    assert tr.shard(parts, ("batch", None, "vocab"), shape) is parts
    with pytest.raises(ValueError, match="holds"):
        tr.shard(parts, ("batch", None, None), shape)


@pytest.mark.parametrize("name", jconfigs.ARCH_NAMES)
def test_param_and_opt_shardings_equal_reference(name, request):
    """Every leaf of all ten reduced configs on both meshes: the stacked
    shape, ``param_shardings``' spec, ``opt_shardings``' moment spec with
    and without ZeRO-1 (``zero1_spec`` on the stacked shape) and the
    step's; each port leaf's per-layer ZeRO-1 layout is the stacked
    leaf's, the repeat axis included."""
    jcfg, tcfg = jconfigs.reduced(name), tconfigs.reduced(name)
    tm = LM(tcfg, device="meta")
    jshape = abstract_params(jcfg)
    tshape = tm.param_shapes()
    for key in MESHES:
        jmesh, tmesh = _meshes(request, key)
        jr, tr = j_make_lm_rules(jmesh), make_lm_rules(tmesh)
        jp = j_param_shardings(make_model(jcfg, jr), jr, jshape)
        tp = param_shardings(tm, tr)
        jo = j_opt_shardings(jp, jshape, jmesh, zero1=True)
        to = opt_shardings(tp, tshape, tmesh, zero1=True)
        jo0 = j_opt_shardings(jp, jshape, jmesh, zero1=False)
        to0 = opt_shardings(tp, tshape, tmesh, zero1=False)
        paths = [p for p, _ in _leaves(jshape)]
        assert paths == [p for p, _ in _leaves(tshape)]
        for path in paths:
            shape = tuple(_at(jshape, path).shape)
            assert _at(tshape, path) == shape, path
            assert _at(tp, path).spec == tuple(_at(jp, path).spec), path
            for kk in ("m", "v"):
                assert _at(to[kk], path).spec == \
                    tuple(_at(jo[kk], path).spec), path
                assert _at(to0[kk], path).spec == \
                    tuple(_at(jo0[kk], path).spec), path
            assert zero1_spec(_at(tp, path).spec, shape, ("data",),
                              tmesh) == tuple(j_zero1_spec(
                                  _at(jp, path).spec, shape, ("data",),
                                  jmesh))
        assert to["step"].spec == tuple(jo["step"].spec) == ()
        n_data = tmesh.shape["data"]
        for lname, lay in leaf_layouts(tm, tr).items():
            path, r = tm.reference_leaf(lname)
            shape = tuple(_at(jshape, path).shape)
            pad = (None,) * len(shape)
            z1 = (tuple(_at(jo["m"], path).spec) + pad)[:len(shape)]
            spec = (tuple(_at(jp, path).spec) + pad)[:len(shape)]
            changed = [i for i, (a, b) in enumerate(zip(spec, z1)) if a != b]
            if r is not None and changed == [0]:
                assert lay.z1_owner == r // (shape[0] // n_data)
                assert lay.z1_dim is None
            elif changed:
                assert lay.z1_dim == changed[0] - (r is not None)
            else:
                assert lay.z1_dim is None and lay.z1_owner is None


@pytest.mark.parametrize("key", MESHES)
def test_batch_and_cache_shardings_equal_reference(key, request):
    """``batch_sharding`` of the train and prefill inputs (and of a batch
    that does not divide the data axis) and ``cache_shardings`` of
    every decoder's caches (8 sequences of 32 slots), layer by layer."""
    jmesh, tmesh = _meshes(request, key)
    jr, tr = j_make_lm_rules(jmesh), make_lm_rules(tmesh)
    for name in jconfigs.ARCH_NAMES:
        jcfg, tcfg = jconfigs.reduced(name), tconfigs.reduced(name)
        for cell in ("train_4k", "prefill_32k"):
            jspec = jconfigs.input_specs(jcfg, cell)
            tspec = tconfigs.input_specs(tcfg, cell)
            jb, tb = j_batch_sharding(jr, jspec), batch_sharding(tr, tspec)
            assert set(jb) == set(tb)
            for k in jb:
                assert tb[k].spec == tuple(jb[k].spec), (name, cell, k)
        odd = {"tokens": jax.ShapeDtypeStruct((3, 16), jnp.int32),
               "pos": jax.ShapeDtypeStruct((), jnp.int32)}
        tb = batch_sharding(tr, {"tokens": ((3, 16), torch.int32),
                                 "pos": ((), torch.int32)})
        jb = j_batch_sharding(jr, odd)
        assert tb["tokens"].spec == tuple(jb["tokens"].spec) == \
            (None, None) and tb["pos"].spec == tuple(jb["pos"].spec) == P()
        if jcfg.encoder_only:
            continue
        jm = make_model(jcfg)
        jc = j_cache_shardings(jr, jax.eval_shape(
            lambda: jm.init_cache(8, 32)))
        tc = cache_shardings(tr, tconfigs.input_specs(
            tcfg, "decode_32k", batch=8, seq=32)["caches"])
        n_pre, n_pat = len(tcfg.prelude), len(tcfg.pattern)
        for layer, tl in enumerate(tc):
            if layer < n_pre:
                jl, off = jc[f"p{layer}"], 0
            else:
                jl = jc["stack"].get(f"b{(layer - n_pre) % n_pat}")
                off = 1
            if jl is None:
                assert tl is None
                continue
            jleaves, tleaves = list(_leaves(jl)), list(_leaves(tl))
            assert [p for p, _ in jleaves] == [p for p, _ in tleaves]
            for (path, js), (_, ts) in zip(jleaves, tleaves):
                want = tuple(js.spec)[off:] if len(js.spec) else ()
                assert ts.spec == want, (name, layer, path)


@pytest.mark.parametrize("key", MESHES)
def test_split_and_gather_are_bit_identical(key, request):
    """A seeded tree of the reference's structure (reduced gemma2-9b, bf16
    and float32 leaves) cut by ``param_shardings``' specs into eight
    shards and gathered back, and a model split onto the mesh
    (``ShardedLM``) gathered back: the same bits."""
    _, tmesh = _meshes(request, key)
    tr = make_lm_rules(tmesh)
    tcfg = tconfigs.reduced("gemma2-9b")
    tm = LM(tcfg, device="meta")
    shapes = tm.param_shapes()
    specs = jax.tree.map(lambda ns: ns.spec, param_shardings(tm, tr),
                         is_leaf=lambda x: hasattr(x, "spec"))
    gen = torch.Generator().manual_seed(7)
    dtypes = iter([torch.bfloat16, torch.float32] * 1000)
    tree = jax.tree.map(lambda s: torch.randn(s, generator=gen).to(
        next(dtypes)), shapes, is_leaf=lambda x: isinstance(x, tuple))
    parts = split_tree(tree, specs, tmesh)
    assert len(parts) == 8
    back = gather_tree(parts, specs, shapes, tmesh)
    for path, t in _leaves(tree):
        assert torch.equal(_at(back, path), t), path
        assert _at(back, path).dtype == t.dtype
    jcfg = jconfigs.reduced("gemma2-9b")
    ref = jax.tree.map(np.asarray, make_model(jcfg).init(
        jax.random.PRNGKey(3)))
    model = load_reference_params(ref, tcfg, device="cpu")
    sharded = ShardedLM(model, tmesh)
    full = sharded.gather()
    for n, p in model.named_parameters():
        assert torch.equal(full[n], p), n
    m = tmesh.shape["model"]
    assert sharded.shard_param(1, "embed").shape == (tcfg.vocab // m,
                                                     tcfg.d_model)


def test_full_stablelm_layout_on_a_2x2_mesh():
    """stablelm-1.6b at full width on (data 2, model 2): 24 stacked layers
    split over data, so ZeRO-1 gives each data replica the whole moments
    of 12 layers (the reference's stacked layout), not a slice of every
    layer; the 100352-row tied embedding splits over model by rows and its
    moments over data by columns."""
    tmesh = make_host_mesh(2, devices=["cpu"] * 4)
    tm = LM(tconfigs.get_config("stablelm-1.6b"), device="meta")
    lays = leaf_layouts(tm, make_lm_rules(tmesh))
    for layer in (0, 11, 12, 23):
        lay = lays[f"layers.{layer}.attn.wq"]
        assert lay.model_dim == 1 and lay.z1_dim is None
        assert lay.z1_owner == layer // 12
        assert [o for _, o in lay.pieces(2, True)] == [(layer // 12,)]
        assert [o for _, o in lay.pieces(2, False)] == [(0, 1)]
    emb = lays["embed"]
    assert (emb.model_dim, emb.z1_dim, emb.z1_owner) == (0, 1, None)
    assert lays["final_norm.scale"].z1_dim == 0


@pytest.mark.parametrize("model_axis", [2, 4], ids=["heads", "mid-head"])
def test_gqa_plan_for_a_flat_axis_that_splits_inside_a_head(model_axis):
    """Reduced gemma2-9b (4 heads, 2 KV heads of 32): on a model axis of 4
    ``kv_x_dim`` (64) splits inside a head, so each shard holds 16 of its
    KV head's 32 columns and gathers the rest; each attends one query
    head, its KV head taken whole.  On 2 the split is by whole heads."""
    cfg = tconfigs.reduced("gemma2-9b").attn_cfg("attn_local")
    plans = gqa_mesh_plan(cfg, model_axis, True, True)
    per = 4 // model_axis
    for m, pl in enumerate(plans):
        assert pl.heads == (m * per, (m + 1) * per)
        assert pl.kv_own == (m * 64 // model_axis, (m + 1) * 64 // model_axis)
        assert pl.kv_heads == ((m * per) // 2, (m * per) // 2 + 1)
        assert pl.kv_index is None
