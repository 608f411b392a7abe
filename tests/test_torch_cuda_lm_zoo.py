"""The dense, MoE, MLA and VLM configs on the card: ``flash_attention`` at
head dim 80 (hubert-xlarge's 1280 / 16) and at llama-3.2-vision's GQA 4
(32 / 8 heads of 128) against its plain version, a reduced MoE model's
prefill repeated bit for bit, decode against prefill at each decoder's
full widths, and the reduced minicpm3-4b (MLA) and llama-3.2-vision-11b
(cross-attention, gates nonzero) on the card against the same weights on
the CPU.

Every test here needs a CUDA device and ``nvcc`` (the kernels build at
first use) and skips without a device.  The file imports nothing of JAX:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda_lm_zoo.py -q

Bands: the kernel against its plain version run on the card, rtol 2e-4,
atol 2e-4 in float32 (``tests/test_kernels.py:84``), rtol 1e-2, atol 1e-4
in bfloat16 (one bf16 ulp: both compute in float32 from the same inputs
and round once); decode vs prefill logits, and a float32 model on the card
vs on the CPU, rtol 1e-3, atol 1e-4 (``tests/test_models.py:86-87``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import get_config, reduced
from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 flash_attention_plain)
from repro_torch.launch.steps import build_prefill_step
from repro_torch.models.lm import LM, flash_layers

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(rtol=2e-4, atol=2e-4),
       torch.bfloat16: dict(rtol=1e-2, atol=1e-4)}
LM_TOL = dict(rtol=1e-3, atol=1e-4)
DECODERS = ("stablelm-1.6b", "codeqwen1.5-7b", "deepseek-moe-16b",
            "moonshot-v1-16b-a3b")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only there)")
    return torch.device("cuda")


def _qkv(b, hq, hkv, s, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy((rng.standard_normal(shape) * c).astype(
        np.float32)).to("cuda", dtype)
        for shape, c in (((b, hq, s, d), 4.0), ((b, hkv, s, d), 1.0),
                         ((b, hkv, s, d), 1.0)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window,softcap,hkv", [
    (False, None, None, 16), (True, None, None, 16), (True, 64, 50.0, 4)])
def test_flash_attention_d80_matches_plain(cuda, dtype, causal, window,
                                           softcap, hkv):
    """D 80 at hubert's heads (16 / 16) and with GQA, S 1000 (no tile
    divides it); bf16 on the tensor-core kernel; repeat launches give the
    same bits."""
    q, k, v = _qkv(2, 16, hkv, 1000, 80, dtype)
    kernels.reset_counters()
    got = flash_attention_cuda(q, k, v, causal, window, softcap)
    want = flash_attention_plain(q, k, v, causal, window, softcap)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    assert torch.equal(got, flash_attention_cuda(q, k, v, causal, window,
                                                 softcap))
    assert flash_attention_cuda.launches == 2
    assert flash_attention_cuda.wgmma_launches == \
        (2 if dtype == torch.bfloat16 else 0)


def test_reduced_moe_prefill_is_bit_identical_on_repeat(cuda):
    """Reduced deepseek (bf16) at B 2 x S 128: 256 tokens per MoE layer,
    past the capacity floor, so assignments are dropped; a repeat prefill
    gives the same bits (no float atomics in the combine)."""
    cfg = reduced("deepseek-moe-16b")
    step = build_prefill_step(cfg, batch=2, seq=128, seed=3)
    tok = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (2, 128)).astype(np.int32)).cuda()
    kernels.reset_counters()
    stats = {}
    with torch.inference_mode():
        hidden, aux = step.model(tok, return_aux=True, moe_stats=stats)
    first = step.fn(tok)
    assert torch.equal(first, step.fn(tok))
    assert bool(torch.isfinite(first).all()) and float(aux) > 0
    assert int(stats["dropped"]) > 0
    assert kernels.counters()["flash_attention"] == {
        "launches": 3 * cfg.n_layers, "plain_calls": 0}


@pytest.mark.parametrize("name", DECODERS)
def test_decode_equals_prefill_at_full_width(cuda, name):
    """2 layers of the config's full widths in float32 (the MoE configs:
    the dense prelude and one MoE layer), 32 tokens at batch 2: 64 tokens,
    within the capacity floor, so neither pass drops an assignment."""
    cfg = dataclasses.replace(get_config(name), n_layers=2,
                              dtype=torch.float32)
    model = LM(cfg, generator=torch.Generator(device="cuda").manual_seed(0))
    tok = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 32)).astype(np.int32)).cuda()
    with torch.inference_mode():
        want = {p: model.prefill(tok[:, :p + 1]) for p in (15, 31)}
        caches = model.init_cache(2, 32)
        for t in range(32):
            got, caches = model.decode_step(tok[:, t:t + 1], t, caches)
            if t in want:
                torch.testing.assert_close(got, want[t], **LM_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_gqa4_d128_matches_plain(cuda, dtype, causal):
    """llama-3.2-vision's self-attention heads: Hq 32 over Hkv 8 (a group
    of 4) at D 128, S 1000; bf16 on the tensor-core kernel, the repeat
    launch the same bits."""
    q, k, v = _qkv(2, 32, 8, 1000, 128, dtype, seed=5)
    kernels.reset_counters()
    got = flash_attention_cuda(q, k, v, causal, None, None)
    want = flash_attention_plain(q, k, v, causal, None, None)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    assert torch.equal(got, flash_attention_cuda(q, k, v, causal, None,
                                                 None))
    assert flash_attention_cuda.wgmma_launches == \
        (2 if dtype == torch.bfloat16 else 0)


@pytest.mark.parametrize("name", ["minicpm3-4b", "llama-3.2-vision-11b"])
def test_mla_and_xattn_on_the_card_match_the_cpu(cuda, name):
    """The reduced config in float32, the same weights on the card and on
    the CPU (gates 0.5): forward, prefill and 24 decode steps agree; the
    card's prefill launches flash_attention once per GQA layer (none for
    MLA and cross-attention layers) and never its plain version."""
    cfg = dataclasses.replace(reduced(name), dtype=torch.float32)
    cpu = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(2))
    cpu.set_xattn_gates(0.5)
    card = LM(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(3)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 24)).astype(
        np.int32))
    ctx = None
    if cfg.family == "vlm":
        ctx = torch.from_numpy(rng.standard_normal(
            (2, cfg.n_ctx_tokens, cfg.d_model)).astype(np.float32))
    on_card = lambda t: None if t is None else t.cuda()
    with torch.inference_mode():
        kernels.reset_counters()
        got = card.prefill(tok.cuda(), on_card(ctx))
        assert kernels.counters()["flash_attention"] == {
            "launches": flash_layers(cfg), "plain_calls": 0}
        torch.testing.assert_close(got.cpu(), cpu.prefill(tok, ctx),
                                   **LM_TOL)
        torch.testing.assert_close(card(tok.cuda(), on_card(ctx)).cpu(),
                                   cpu(tok, ctx), **LM_TOL)
        cc, gc = cpu.init_cache(2, 24), card.init_cache(2, 24)
        for t in range(24):
            want, cc = cpu.decode_step(tok[:, t:t + 1], t, cc, ctx)
            got, gc = card.decode_step(tok[:, t:t + 1].cuda(), t, gc,
                                       on_card(ctx))
            torch.testing.assert_close(got.cpu(), want, **LM_TOL)
