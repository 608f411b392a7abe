"""The port's training path (``softmax_xent_chunked``, ``LM.loss`` with
remat, ``build_train_step``, ``launch/train.py``) against the JAX package,
on the CPU.

Reduced stablelm-1.6b (its attention through the plain, differentiable
flash version) and reduced xlstm-350m run in float32, the reference's
parameters carried across by ``load_reference_params``.  Bands: the loss
rtol 1e-5; gradients rtol 1e-3 and an absolute 1e-5 of each leaf's
largest value (float32 sums of a backward pass in another order);
``train()`` losses over 3 steps rtol 1e-4 (``tests/test_fault_tolerance.py``'s
resume band).  The reference's ``train`` finds a config by name in
``repro.configs._MODULES``; a float32 copy of a reduced config is
registered there for the test, as ``examples/train_lm.py`` registers its
own config.  The port's ``train`` takes the model itself.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.launch.train import train as jtrain
from repro.models.common import NO_SHARD
from repro.models.common import softmax_xent_chunked as j_xent
from repro.models.lm import make_model
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import PreemptionGuard
from repro_torch.launch import train as ttrain_mod
from repro_torch.launch.steps import build_train_step
from repro_torch.models.common import softmax_xent_chunked
from repro_torch.models.lm import load_reference_params
from repro_torch.optim import adamw_init

B, S = 2, 32
TRAINED = ("stablelm-1.6b", "xlstm-350m")


def _np(t):
    return t.detach().float().numpy()


def _grad_close(got, want, err_msg=""):
    want = np.asarray(want, np.float32)
    atol = 1e-5 * (float(np.abs(want).max()) or 1.0)
    np.testing.assert_allclose(_np(got), want, rtol=1e-3, atol=atol,
                               err_msg=err_msg)


def _f32(name):
    """(reference, port) float32 copies of the reduced config."""
    return (dataclasses.replace(jconfigs.reduced(name), dtype=jnp.float32),
            dataclasses.replace(tconfigs.reduced(name), dtype=torch.float32))


def _pair(name, seed=0):
    jcfg, tcfg = _f32(name)
    jm = make_model(jcfg)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    return jm, jax.tree.map(jnp.asarray, tree), load_reference_params(
        tree, tcfg, device="cpu")


def _batch(vocab, seed=0, s=S):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, (B, s)).astype(np.int32),
            rng.integers(0, vocab, (B, s)).astype(np.int32))


@pytest.mark.parametrize("s,softcap", [(1024, 0.0), (100, 0.0), (1024, 30.0)],
                         ids=["two-chunks", "whole-sequence", "softcap"])
def test_softmax_xent_chunked_matches_jax(s, softcap):
    """Value and gradients (hidden states and the embedding): S 1024 in two
    chunks of 512, S 100 (not a multiple of 512: one chunk) and gemma2's
    final soft-cap."""
    rng = np.random.default_rng(s)
    x = rng.standard_normal((B, s, 32)).astype(np.float32)
    emb = (rng.standard_normal((300, 32)) * 0.3).astype(np.float32)
    lab = rng.integers(0, 300, (B, s)).astype(np.int32)
    want, (gx, ge) = jax.value_and_grad(
        lambda a, e: j_xent(a, e, jnp.asarray(lab), NO_SHARD,
                            softcap=softcap), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(emb))
    tx, te = (torch.from_numpy(a).requires_grad_(True) for a in (x, emb))
    got = softmax_xent_chunked(tx, te, torch.from_numpy(lab),
                               softcap=softcap)
    got.backward()
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    _grad_close(tx.grad, gx)
    _grad_close(te.grad, ge)


@pytest.mark.parametrize("name", TRAINED)
def test_loss_and_gradients_match_jax(name):
    """LM.loss (remat on, as the reference's default) and the gradient of
    every parameter against jax.value_and_grad of the reference's loss."""
    jm, params, tm = _pair(name)
    tok, lab = _batch(tm.cfg.vocab)
    want, jg = jax.jit(jax.value_and_grad(lambda p: jm.loss(
        p, jnp.asarray(tok), jnp.asarray(lab))))(params)
    tm.requires_grad_(True)
    loss = tm.loss(torch.from_numpy(tok), torch.from_numpy(lab))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    n_pat = len(tm.cfg.pattern)
    for key, p in tm.named_parameters():
        parts = key.split(".")
        if parts[0] == "layers":
            layer = int(parts[1])
            tree = jg["stack"][f"b{layer % n_pat}"]
            for part in parts[2:]:
                tree = tree[part]
            ref = tree[layer // n_pat]
        else:
            ref = jg
            for part in parts:
                ref = ref[part]
        _grad_close(p.grad, ref, err_msg=key)


@pytest.mark.parametrize("name", TRAINED)
def test_remat_gives_the_same_loss_and_gradients(name):
    """Each pattern unit recomputed in the backward pass
    (torch.utils.checkpoint) gives the bits of keeping its activations."""
    _, _, tm = _pair(name, seed=1)
    tok, lab = (torch.from_numpy(a) for a in _batch(tm.cfg.vocab, seed=1))
    tm.requires_grad_(True)
    out = []
    for remat in (True, False):
        tm.zero_grad(set_to_none=True)
        loss = tm.loss(tok, lab, remat=remat)
        loss.backward()
        out.append((loss.detach(), [p.grad.clone() for p in tm.parameters()]))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


@pytest.fixture
def registered(monkeypatch):
    """Register float32 copies of the trained reduced configs under
    ``<name>-f32`` in the reference's registry for the test."""
    for name in TRAINED:
        cfg = dataclasses.replace(_f32(name)[0], name=f"{name}-f32")
        entry = type("Entry", (), {"CONFIG": cfg,
                                   "reduced": staticmethod(lambda c=cfg: c)})
        monkeypatch.setitem(jconfigs._MODULES, cfg.name, entry)


@pytest.mark.parametrize("name", TRAINED)
def test_train_losses_match_reference(name, registered):
    """train() over 3 steps (batch 2 of 32 tokens, lr 3e-4, warmup 10,
    cosine over 3) from the reference's initial parameters: the losses
    step by step, and the trained embedding."""
    arch = f"{name}-f32"
    jparams, _, jl = jtrain(arch, steps=3, batch=B, seq=S, verbose=False)
    # the reference's train() draws its parameters by jit(init)(seed 0)
    init = jax.jit(make_model(jconfigs.reduced(arch)).init)
    tm = load_reference_params(
        jax.tree.map(np.asarray, init(jax.random.PRNGKey(0))),
        dataclasses.replace(_f32(name)[1], name=arch), device="cpu")
    model, opt, tl = ttrain_mod.train(steps=3, batch=B, seq=S,
                                      verbose=False, model=tm)
    assert model is tm and int(opt["step"]) == 3
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    np.testing.assert_allclose(_np(tm.embed), np.asarray(jparams["embed"]),
                               rtol=1e-3, atol=1e-6)


class TriggerAt(PreemptionGuard):
    """A guard that reports a preemption from its ``at + 1``-th poll on
    (one poll a step: the run stops after step ``at``), as
    ``tests/test_fault_tolerance.py``'s."""

    def __init__(self, at):
        super().__init__(install_handler=False)
        self.at, self.count = at, 0

    @property
    def preempted(self):
        self.count += 1
        return self.count > self.at


def test_preempt_and_resume_is_exact(tmp_path):
    """Reduced xlstm-350m (bf16) for 6 steps, checkpoints every 3: a run
    preempted after its 5th step commits that step; a second run resumes
    from it and finishes; its losses are the uninterrupted run's, bit for
    bit (deterministic data, a committed checkpoint of the parameters and
    the float32 moments)."""
    kw = dict(steps=6, batch=B, seq=S, verbose=False, device="cpu")
    _, _, ref = ttrain_mod.train("xlstm-350m", **kw)
    ckpt = str(tmp_path / "ckpt")
    _, _, first = ttrain_mod.train("xlstm-350m", ckpt_dir=ckpt,
                                   ckpt_every=3, guard=TriggerAt(4), **kw)
    assert len(first) == 5
    _, opt, rest = ttrain_mod.train("xlstm-350m", ckpt_dir=ckpt,
                                    ckpt_every=3, **kw)
    assert len(rest) == 1 and int(opt["step"]) == 6
    np.testing.assert_allclose(first + rest, ref, rtol=1e-4)
    assert first + rest == ref


@pytest.mark.parametrize("name", jconfigs.ARCH_NAMES)
def test_every_reduced_config_takes_a_train_step_on_the_cpu(name):
    """build_train_step on each reduced config in float32 (a VLM with a
    seeded image context, its gates opened to 0.5; an audio model on frame
    embeddings): a finite loss, a positive gradient norm, every parameter
    given a gradient and moved."""
    cfg = _f32(name)[1]
    step = build_train_step(cfg, batch=B, seq=16, device="cpu", seed=3)
    model = step.model
    model.set_xattn_gates(0.5)
    rng = np.random.default_rng(4)
    batch = {"labels": torch.from_numpy(
        rng.integers(0, cfg.vocab, (B, 16)).astype(np.int32))}
    if cfg.family == "audio":
        batch["tokens"] = torch.from_numpy(
            rng.standard_normal((B, 16, cfg.d_model)).astype(np.float32))
    else:
        batch["tokens"] = torch.from_numpy(
            rng.integers(0, cfg.vocab, (B, 16)).astype(np.int32))
    if cfg.family == "vlm":
        batch["ctx"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.n_ctx_tokens, cfg.d_model)).astype(np.float32))
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    opt = adamw_init(dict(model.named_parameters()))
    opt, metrics = step.fn(opt, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert float(metrics["grad_norm"]) > 0
    moved = [k for k, p in model.named_parameters()
             if not torch.equal(p.detach(), before[k])]
    assert len(moved) == len(before), set(before) - set(moved)


def test_cli_trains_checkpoints_and_resumes(tmp_path, capsys):
    """python -m repro_torch.launch.train on the CPU: 20 steps with a
    checkpoint directory (a checkpoint every 20 steps, as the reference's
    CLI), then again to 21 steps, which resumes from step 19."""
    args = ["--arch", "xlstm-350m", "--reduced", "--batch", "2", "--seq",
            "16", "--device", "cpu", "--ckpt-dir", str(tmp_path)]
    ttrain_mod.main(args + ["--steps", "20"])
    assert "[train] step    19 loss" in capsys.readouterr().out
    ttrain_mod.main(args + ["--steps", "21"])
    out = capsys.readouterr().out
    assert "[train] resumed from step 19" in out
    assert "[train] step    20 loss" in out
