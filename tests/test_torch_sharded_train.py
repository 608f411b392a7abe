"""The port's sharded train step against the JAX package's, on the CPU.

The reference's ``build_train_step(cfg, mesh, zero1=True)`` runs on its
(4, 2) and (2, 4) host meshes (``tests/conftest.py``) and the port's
sharded step (``build_train_step(..., mesh=, zero1=True)``, a
``ShardedLM``) on meshes of eight ``cpu`` shards of the same shapes, from
the same weights (the reference's ``jit(init)`` carried across by
``load_reference_params``) and the same global batch of 8 x 16 tokens,
for the four dense GQA configs: stablelm-1.6b, codeqwen1.5-7b, gemma2-9b
(on (2, 4) its ``kv_x_dim`` of 64 splits inside a 32-wide head) and
hubert-xlarge (frame embeddings; its 64-row vocab).  Float32 bands: the
loss and the gradients' global norm rtol 1e-5, the updated parameters
rtol 1e-3 and atol 1e-5 (``tests/test_torch_train.py``'s); bfloat16 at
the zoo's whole-model band (``tests/test_torch_lm_zoo.py``).  The port's
sharded step also holds to its own single-device step, gives the same bits
with ZeRO-1 on and off and on a repeat, resumes a preempted run bit for
bit on its own mesh and within the float32 band on another, and refuses
the block kinds that do not run on a mesh yet (MoE, xLSTM) and a Mamba2
split inside an SSD head (the MLA and cross-attention configs,
minicpm3-4b and llama-3.2-vision-11b, run on a mesh and are held in
``tests/test_torch_sharded_mla_xattn.py``; zamba2-7b's Mamba2 and shared
attention block in ``tests/test_torch_sharded_mamba.py``).
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
from repro_torch.checkpoint import PreemptionGuard
from repro_torch.distributed.collectives import MeshComm
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import make_host_mesh, make_pod_mesh
from repro_torch.launch.steps import build_prefill_step, build_train_step
from repro_torch.models.lm import LM, load_reference_params
from repro_torch.models.sharded_lm import ShardedLM

B, S = 8, 16
DENSE = ("stablelm-1.6b", "codeqwen1.5-7b", "gemma2-9b", "hubert-xlarge")
#: the configs whose kinds do not run on a mesh yet (zamba2-7b's run
#: there, but not split inside an SSD head)
OTHER = tuple(n for n in jconfigs.ARCH_NAMES
              if n not in DENSE + ("minicpm3-4b", "llama-3.2-vision-11b"))
MESHES = {"4x2": ("host_mesh", 2), "2x4": ("mesh82", 4)}
F32 = dict(rtol=1e-5)
PARAM_F32 = dict(rtol=1e-3, atol=1e-5)
BF16 = dict(rtol=5e-2, atol=1e-1)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite runs its files in parallel worker
    processes, and a sharded step's many small products on eight shards
    thrash the cores with more (a ZeRO-1 test took 272 s under six
    workers, 6 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(name, dtype="f32"):
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return (dataclasses.replace(jconfigs.reduced(name), dtype=jdt),
            dataclasses.replace(tconfigs.reduced(name), dtype=tdt))


def _np(t):
    return t.detach().float().cpu().numpy()


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    if cfg.family == "audio":
        tok = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    else:
        tok = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    return tok, lab


def _torch_batch(tok, lab, cfg):
    t = torch.from_numpy(tok)
    return {"tokens": t.to(cfg.dtype) if t.is_floating_point() else t,
            "labels": torch.from_numpy(lab)}


def _port_mesh(model_axis):
    return make_host_mesh(model_axis, devices=["cpu"] * 8)


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
        batch = {"tokens": jnp.asarray(tok, jcfg.dtype)
                 if tok.dtype == np.float32 else jnp.asarray(tok),
                 "labels": jnp.asarray(lab)}
        new_p, _, metrics = built.jitted(params, opt, batch)
        return (init, float(metrics["loss"]), float(metrics["grad_norm"]),
                jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)),
                             new_p))


def _ref_leaf(model, tree, name):
    path, r = model.reference_leaf(name)
    for key in path:
        tree = tree[key]
    return tree if r is None else tree[r]


def _port_step(tcfg, init, tmesh, tok, lab, zero1=True, steps=1):
    model = load_reference_params(init, tcfg, device="cpu")
    step = build_train_step(tcfg, batch=B, seq=S, mesh=tmesh, model=model,
                            zero1=zero1)
    opt = step.init_opt()
    out = []
    for _ in range(steps):
        opt, metrics = step.fn(opt, _torch_batch(tok, lab, tcfg))
        out.append((float(metrics["loss"]), float(metrics["grad_norm"])))
    return step.model, opt, out


@pytest.mark.parametrize("key", MESHES)
@pytest.mark.parametrize("name", DENSE)
def test_sharded_step_matches_reference_float32(name, key, request,
                                                monkeypatch):
    """One ZeRO-1 train step on the mesh, float32: the loss and the
    gradient norm rtol 1e-5, every updated parameter rtol 1e-3 atol 1e-5,
    against the reference's ``build_train_step(cfg, mesh, zero1=True)``."""
    fixture, model_axis = MESHES[key]
    jcfg, tcfg = _cfgs(name)
    tok, lab = _batch(tcfg)
    init, jl, jg, jnew = _ref_step(jcfg, request.getfixturevalue(fixture),
                                   tok, lab, monkeypatch)
    model, _, [(tl, tg)] = _port_step(tcfg, init, _port_mesh(model_axis),
                                      tok, lab)
    np.testing.assert_allclose(tl, jl, **F32)
    np.testing.assert_allclose(tg, jg, **F32)
    meta = LM(tcfg, device="meta")
    for pname, t in model.gather().items():
        np.testing.assert_allclose(_np(t), _ref_leaf(meta, jnew, pname),
                                   err_msg=pname, **PARAM_F32)


@pytest.mark.parametrize("name,key", [("stablelm-1.6b", "4x2"),
                                      ("gemma2-9b", "2x4")])
def test_sharded_step_matches_reference_bf16(name, key, request,
                                             monkeypatch):
    """The same step in bfloat16 (bf16 partial sums added in float32 and
    rounded once): the loss, the gradient norm and the updated parameters
    at the zoo's whole-model band, rtol 5e-2 atol 1e-1."""
    fixture, model_axis = MESHES[key]
    jcfg, tcfg = _cfgs(name, "bf16")
    tok, lab = _batch(tcfg, seed=1)
    init, jl, jg, jnew = _ref_step(jcfg, request.getfixturevalue(fixture),
                                   tok, lab, monkeypatch)
    model, _, [(tl, tg)] = _port_step(tcfg, init, _port_mesh(model_axis),
                                      tok, lab)
    np.testing.assert_allclose(tl, jl, **BF16)
    np.testing.assert_allclose(tg, jg, **BF16)
    meta = LM(tcfg, device="meta")
    for pname, t in model.gather().items():
        assert t.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(t), _ref_leaf(meta, jnew, pname),
                                   err_msg=pname, **BF16)


@pytest.mark.parametrize("name,model_axis", [("stablelm-1.6b", 2),
                                             ("gemma2-9b", 4),
                                             ("hubert-xlarge", 1),
                                             ("codeqwen1.5-7b", "pod")])
def test_sharded_step_matches_single_device(name, model_axis):
    """Two float32 steps of the port's sharded step against two of its
    single-device step (``build_train_step`` without a mesh) from the same
    model: losses and gradient norms rtol 1e-5, parameters rtol 1e-3
    atol 1e-5; a (8, 1) mesh is data parallel alone, and a (pod 2, data
    2, model 2) mesh splits the batch over pods and data, pod major.  The
    sharded prefill (the train step's forward) gives the single-device
    logits."""
    _, tcfg = _cfgs(name)
    model = LM(tcfg, device="cpu", generator=torch.Generator().manual_seed(5))
    mesh = make_pod_mesh(2, 2, devices=["cpu"] * 8) if model_axis == "pod" \
        else _port_mesh(model_axis)
    sharded = build_train_step(tcfg, batch=B, seq=S, model=model, mesh=mesh)
    single = build_train_step(tcfg, batch=B, seq=S, model=model)
    tok, lab = _batch(tcfg, seed=2)
    logits = build_prefill_step(tcfg, model=sharded.model, mesh=mesh).fn(
        _torch_batch(tok, lab, tcfg)["tokens"])
    want = build_prefill_step(tcfg, model=model).fn(
        _torch_batch(tok, lab, tcfg)["tokens"])
    np.testing.assert_allclose(_np(logits), _np(want), rtol=1e-4, atol=1e-5)
    opts = [sharded.init_opt(), single.init_opt()]
    for step in range(2):
        batch = _torch_batch(*_batch(tcfg, seed=3 + step), tcfg)
        opts[0], ms = sharded.fn(opts[0], batch)
        opts[1], m1 = single.fn(opts[1], batch)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(ms[k]), float(m1[k]), **F32)
    full = sharded.model.gather()
    for pname, p in model.named_parameters():
        np.testing.assert_allclose(_np(full[pname]), _np(p), err_msg=pname,
                                   **PARAM_F32)


@pytest.mark.parametrize("model_axis", [2, 4])
def test_zero1_on_and_off_and_a_repeat_give_the_same_bits(model_axis):
    """Reduced gemma2-9b (sandwich norms, soft-caps, a local window) in
    float32, two steps: ZeRO-1 on, ZeRO-1 off, and ZeRO-1 on again from
    the same weights give the same losses, norms, parameters and gathered
    moments, bit for bit."""
    _, tcfg = _cfgs("gemma2-9b")
    init = LM(tcfg, device="cpu", generator=torch.Generator().manual_seed(9))
    state = {n: p.detach().clone() for n, p in init.named_parameters()}
    tok, lab = _batch(tcfg, seed=4)
    from repro_torch.optim import gather_opt_mesh
    runs = []
    for zero1 in (True, False, True):
        init.load_state_dict(state)
        step = build_train_step(tcfg, batch=B, seq=S, model=init,
                                mesh=_port_mesh(model_axis), zero1=zero1)
        opt = step.init_opt()
        metrics = []
        for _ in range(2):
            opt, m = step.fn(opt, _torch_batch(tok, lab, tcfg))
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


class TriggerAt(PreemptionGuard):
    """Reports a preemption from its ``at + 1``-th poll on (one poll a
    step): the run stops after step ``at``."""

    def __init__(self, at):
        super().__init__(install_handler=False)
        self.at, self.count = at, 0

    @property
    def preempted(self):
        self.count += 1
        return self.count > self.at


def test_preempt_and_resume_on_its_mesh_and_on_another(tmp_path):
    """Reduced stablelm-1.6b in float32 through ``train(model_axis=2,
    devices=[cpu] * 4)``, 5 steps: a run preempted after its 3rd step and
    resumed from its checkpoint (full logical leaves) on the same (2, 2)
    mesh gives the uninterrupted run's losses bit for bit; resumed on a
    (1, 4) mesh, and on one device, within the float32 band."""
    _, tcfg = _cfgs("stablelm-1.6b")
    tcfg = dataclasses.replace(tcfg, name="stablelm-f32")

    def model():
        return LM(tcfg, device="cpu",
                  generator=torch.Generator().manual_seed(11))

    kw = dict(steps=5, batch=4, seq=16, verbose=False)
    mesh = dict(model_axis=2, devices=["cpu"] * 4)
    _, _, whole = ttrain.train(model=model(), **kw, **mesh)
    ckpt = str(tmp_path / "ckpt")
    _, _, first = ttrain.train(model=model(), ckpt_dir=ckpt, ckpt_every=2,
                               guard=TriggerAt(2), **kw, **mesh)
    assert len(first) == 3
    for where, other in (("same", mesh),
                         ("1x4", dict(model_axis=4, devices=["cpu"] * 4)),
                         ("one device", {})):
        d = tmp_path / where
        import shutil
        shutil.copytree(ckpt, d)
        _, opt, rest = ttrain.train(model=model(), ckpt_dir=str(d),
                                    ckpt_every=2, **kw, **other)
        assert len(rest) == 2 and int(opt["step"]) == 5
        if where == "same":
            assert first + rest == whole
        else:
            np.testing.assert_allclose(first + rest, whole, rtol=1e-5)


@pytest.mark.parametrize("name", OTHER)
def test_block_kinds_off_the_mesh_raise(name):
    """MoE and xLSTM configs do not run on a mesh yet (ROADMAP A3.4.1 and
    A3.4.3's xLSTM half), nor does reduced zamba2 with its d_inner of 256
    in one SSD head, which two model shards would split inside the head
    (A3.4.3): building their sharded model raises, naming the queue item,
    and nothing runs unsharded in its place."""
    tcfg = tconfigs.reduced(name)
    if name == "zamba2-7b":
        tcfg = dataclasses.replace(tcfg,
                                   mamba_head_dim=tcfg.mamba_cfg().d_inner)
    model = LM(tcfg, device="meta")
    with pytest.raises(ValueError, match="A3.4"):
        ShardedLM(model, _port_mesh(2))
    with pytest.raises(ValueError, match="A3.4"):
        build_train_step(tcfg, batch=B, seq=S, device="cpu",
                         mesh=_port_mesh(2))


def test_all_reduce_rounds_bf16_partials_once():
    """bf16 partial sums are added in float32 in shard order and rounded
    once: 1 + 2^-8 + 2^-8 is 1 + 2^-7 (a bf16 value), where adding in
    bf16 rounds 1 + 2^-8 (half an ulp) to 1 first.  The backward
    all-reduces the gradients the same way, and the bytes between shards
    are counted."""
    comm = MeshComm(_port_mesh(4))
    parts = [torch.tensor([1.0, 3.0], dtype=torch.bfloat16),
             torch.tensor([2 ** -8, 0.5], dtype=torch.bfloat16),
             torch.tensor([2 ** -8, 0.25], dtype=torch.bfloat16),
             torch.tensor([0.0, 0.25], dtype=torch.bfloat16)]
    leaves = [p.clone().requires_grad_(True) for p in parts]
    outs = comm.all_reduce(leaves, [0, 1, 2, 3], "attn")
    want = torch.tensor([1 + 2 ** -7, 4.0], dtype=torch.bfloat16)
    chained = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    assert all(torch.equal(o, want) for o in outs)
    assert not torch.equal(chained, want)
    sum(o.float().sum() * (i + 1) for i, o in enumerate(outs)).backward()
    assert all(torch.equal(t.grad, torch.full((2,), 10.0,
                                              dtype=torch.bfloat16))
               for t in leaves)
    # 3 parts in and 3 sums out, forward and backward, 4 bytes each
    assert comm.bytes == {"attn": 2 * 6 * 4}


def test_cli_trains_on_a_mesh(tmp_path, capsys):
    """``python -m repro_torch.launch.train --model-axis 2 --devices
    cpu,cpu,cpu,cpu`` on reduced codeqwen1.5-7b: steps on a (2, 2) mesh
    and checkpoints; run again one step longer, it resumes."""
    args = ["--arch", "codeqwen1.5-7b", "--reduced", "--batch", "4",
            "--seq", "16", "--model-axis", "2", "--devices",
            "cpu,cpu,cpu,cpu", "--ckpt-dir", str(tmp_path)]
    ttrain.main(args + ["--steps", "20"])
    assert "[train] step    19 loss" in capsys.readouterr().out
    ttrain.main(args + ["--steps", "21"])
    out = capsys.readouterr().out
    assert "[train] resumed from step 19" in out
    assert "[train] step    20 loss" in out
