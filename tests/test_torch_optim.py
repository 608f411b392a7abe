"""The port's optimizer, schedules, gradient compression, token pipeline
and watchdog (``repro_torch.optim``, ``repro_torch.data.tokens``,
``repro_torch.distributed``) against the JAX package's, on the CPU.

Seeded numpy trees go through both packages.  AdamW and clipping run in
float32 in both (bias corrections and the scheduled rate are float32
tensors in the port, as the reference's jnp computes them): the new
parameters and moments agree to rtol 1e-6 and an absolute 1e-6 of each
leaf's largest value over three steps (the global norm's float32 sums run
in another order, which moves the clip scale by an ulp; where a moment
nearly cancels, that is its absolute error), a bf16 parameter to one bf16
ulp.  The schedules agree to rtol 1e-6; the int8 codes exactly
(round half to even in both), their scales and the fed-back errors to
rtol 1e-6.  The token pipeline and ``feature_batch`` are the same numpy
code: their batches are equal bit for bit.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jo
from repro.data.tokens import TokenPipeline as JPipe
from repro.data.tokens import TokenPipelineConfig as JPipeCfg
from repro.data.tokens import feature_batch as j_feature_batch
from repro.distributed import Heartbeat as JHeartbeat
from repro_torch import optim as to
from repro_torch.data import (TokenPipeline, TokenPipelineConfig,
                              feature_batch)
from repro_torch.distributed import Heartbeat, StepWatchdog

TOL = dict(rtol=1e-6, atol=1e-9)
SHAPES = {"a": (7, 5), "b": {"c": (13,), "d": (3, 4, 2)}}


def _tree(shapes, seed, scale=1.0):
    """{name: float32 numpy} of ``shapes`` (nested dicts kept)."""
    rng = np.random.default_rng(seed)

    def make(s):
        if isinstance(s, dict):
            return {k: make(v) for k, v in s.items()}
        return (rng.standard_normal(s) * scale).astype(np.float32)
    return make(shapes)


def _jax(tree, dtype=jnp.float32):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def _torch(tree, dtype=torch.float32):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)).to(dtype),
                        tree)


def _close(got, want, rtol=1e-6, scaled_atol=1e-6, **tol):
    """Leaf by leaf, to ``rtol`` and ``scaled_atol`` times the leaf's
    largest |value| (or the absolute ``atol`` given)."""
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        w = np.asarray(w, np.float32)
        atol = tol.get("atol", scaled_atol * float(np.abs(w).max()))
        np.testing.assert_allclose(g.float().numpy(), w, rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("scale", [0.01, 10.0], ids=["unclipped", "clipped"])
def test_global_norm_and_clipping_match_jax(scale):
    """The norm, and the leaves scaled by min(1, 1 / (norm + 1e-9))."""
    g = _tree(SHAPES, 1, scale)
    want, wn = jo.clip_by_global_norm(_jax(g), 1.0)
    got, gn = to.clip_by_global_norm(_torch(g), 1.0)
    np.testing.assert_allclose(float(gn), float(wn), rtol=1e-6)
    np.testing.assert_allclose(float(to.global_norm(_torch(g))), float(wn),
                               rtol=1e-6)
    _close(got, want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_adamw_update_matches_jax(dtype):
    """Three AdamW steps with clipping, weight decay and a scheduled rate:
    parameters (float32, or bf16 computed in float32 and cast back),
    moments and step.  The inputs are not modified."""
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    cfg = jo.AdamWConfig(lr=1e-2)
    tcfg = to.AdamWConfig(lr=1e-2)
    assert cfg == jo.AdamWConfig(**vars(tcfg))
    jp, tp = _jax(_tree(SHAPES, 2), jdt), _torch(_tree(SHAPES, 2), tdt)
    js, ts = jo.adamw_init(jp), to.adamw_init(tp)
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 0
    for step in range(3):
        g = _tree(SHAPES, 10 + step, 0.5)
        jlr = jo.cosine_schedule(js["step"], 2, 10, cfg.lr)
        tlr = to.cosine_schedule(ts["step"], 2, 10, tcfg.lr)
        snapshot = [t.clone() for t in jax.tree.leaves(tp)]
        jp, js, jm = jo.adamw_update(jp, _jax(g, jdt), js, cfg, lr=jlr)
        new_tp, ts, tm = to.adamw_update(tp, _torch(g, tdt), ts, tcfg,
                                         lr=tlr)
        assert all(torch.equal(a, b) for a, b in
                   zip(snapshot, jax.tree.leaves(tp)))
        tp = new_tp
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
    assert int(ts["step"]) == int(js["step"]) == 3
    assert all(t.dtype == tdt for t in jax.tree.leaves(tp))
    _close(tp, jp, **({} if dtype == "f32" else dict(rtol=8e-3, atol=0)))
    _close(ts["m"], js["m"])
    _close(ts["v"], js["v"])


def test_schedules_match_jax():
    """linear_warmup and cosine_schedule (warmup 10 and 200, the two the
    trainers use) at a sweep of int32 steps, from before the warmup's end
    to past the decay's."""
    for step in [0, 1, 5, 9, 10, 11, 57, 199, 200, 201, 1234, 9999, 10000,
                 12000]:
        js = jnp.asarray(step, jnp.int32)
        ts = torch.tensor(step, dtype=torch.int32)
        for warm, total in ((10, 50), (200, 10000)):
            np.testing.assert_allclose(
                float(to.cosine_schedule(ts, warm, total, 3e-4)),
                float(jo.cosine_schedule(js, warm, total, 3e-4)), rtol=1e-6)
            np.testing.assert_allclose(
                float(to.linear_warmup(ts, warm, 3e-4)),
                float(jo.linear_warmup(js, warm, 3e-4)), rtol=1e-6)
        assert to.cosine_schedule(step, 10, 50, 3e-4).dtype == torch.float32


def test_int8_compression_matches_jax():
    """Codes, scale and the round trip of a float32 tensor (zeros too)."""
    g = _tree({"g": (64, 33)}, 3, 2.0)["g"]
    for a in (g, np.zeros_like(g)):
        wq, ws = jo.compress_int8(jnp.asarray(a))
        tq, ts = to.compress_int8(torch.from_numpy(a))
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(wq))
        np.testing.assert_allclose(float(ts), float(ws), rtol=1e-6)
        np.testing.assert_allclose(to.decompress_int8(tq, ts).numpy(),
                                   np.asarray(jo.decompress_int8(wq, ws)),
                                   **TOL)


def test_error_feedback_matches_jax():
    """Three rounds of ef_compress_update carrying the error state: the
    codes, scales and errors of every leaf."""
    je, te = jo.make_error_feedback_state(_jax(_tree(SHAPES, 4))), \
        to.make_error_feedback_state(_torch(_tree(SHAPES, 4)))
    for r in range(3):
        g = _tree(SHAPES, 20 + r)
        jq, je = jo.ef_compress_update(_jax(g), je)
        tq, te = to.ef_compress_update(_torch(g), te)
        for (tqq, tss), (wqq, wss) in zip(
                jax.tree.leaves(tq, is_leaf=lambda x: isinstance(x, tuple)),
                jax.tree.leaves(jq, is_leaf=lambda x: isinstance(x, tuple))):
            np.testing.assert_array_equal(tqq.numpy(), np.asarray(wqq))
            np.testing.assert_allclose(float(tss), float(wss), rtol=1e-6)
        _close(te, je)


@pytest.mark.parametrize("seed,shards", [(0, 1), (17, 4)])
def test_token_pipeline_equals_reference_bit_for_bit(seed, shards):
    """Every shard's batches at several steps, tokens and labels."""
    for shard in range(shards):
        kw = dict(vocab=50304, seq_len=96, global_batch=8, seed=seed,
                  n_shards=shards, shard=shard)
        tp, jp = TokenPipeline(TokenPipelineConfig(**kw)), \
            JPipe(JPipeCfg(**kw))
        for step in (0, 1, 7, 1000):
            got, want = tp.batch(step), jp.batch(step)
            for g, w in zip(got, want):
                assert g.dtype == np.int32
                np.testing.assert_array_equal(g, w)
        it = iter(tp)
        np.testing.assert_array_equal(next(it)[0], tp.batch(0)[0])


def test_feature_batch_equals_reference_bit_for_bit():
    kw = dict(vocab=504, seq_len=16, global_batch=4, seed=3)
    for step in (0, 5):
        for g, w in zip(feature_batch(TokenPipelineConfig(**kw), step, 32),
                        j_feature_batch(JPipeCfg(**kw), step, 32)):
            np.testing.assert_array_equal(g, w)


def test_watchdog_flags_stragglers_with_a_clean_baseline():
    """The reference's two watchdog checks: a 5x step is flagged, a normal
    one after it is not; stragglers stay out of the median."""
    dog = StepWatchdog(window=20, threshold=3.0, min_steps=5)
    for _ in range(10):
        assert not dog.observe(0.10)
    assert dog.observe(0.50)
    assert dog.stragglers == [10]
    assert not dog.observe(0.11)
    dog = StepWatchdog(window=20, threshold=3.0, min_steps=5)
    for _ in range(8):
        dog.observe(0.1)
    for _ in range(3):
        dog.observe(2.0)
    assert dog.observe(2.0)


def test_heartbeat_dead_hosts_and_the_reference_files(tmp_path):
    """Beats, timeouts and a host that never beat; the files are the
    reference's format (each package reads the other's)."""
    hb0 = Heartbeat(str(tmp_path), host_id=0, timeout=0.2)
    jb1 = JHeartbeat(str(tmp_path), host_id=1, timeout=0.2)
    hb0.beat(0)
    jb1.beat(0)
    assert hb0.dead_hosts(2) == [] and jb1.dead_hosts(2) == []
    assert hb0.dead_hosts(2, now=time.time() + 1.0) == [0, 1]
    assert 2 in hb0.dead_hosts(3)
