"""zamba2-7b on the card: ``flash_attention`` at head dim 112 (the shared
block's 3584 / 32) against its plain version, decode against the chunked
prefill at zamba2's full widths, and the reduced zamba2 on the card
against the same weights on the CPU.

Every test here needs a CUDA device and ``nvcc`` (the kernels build at
first use) and skips without a device.  The file imports nothing of JAX:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda_zamba2.py -q

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
from repro_torch.models.lm import LM, flash_layers

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(rtol=2e-4, atol=2e-4),
       torch.bfloat16: dict(rtol=1e-2, atol=1e-4)}
LM_TOL = dict(rtol=1e-3, atol=1e-4)
NAME = "zamba2-7b"


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
@pytest.mark.parametrize("causal,hkv", [(True, 32), (False, 32), (True, 8)])
def test_flash_attention_d112_matches_plain(cuda, dtype, causal, hkv):
    """D 112 at the shared block's heads (32 / 32) and with GQA 4 (32 / 8),
    causal and not, S 1000 (no tile divides it); bf16 on the tensor-core
    kernel, float32 on the SIMT one; repeat launches give the same bits."""
    q, k, v = _qkv(2, 32, hkv, 1000, 112, dtype, seed=hkv)
    kernels.reset_counters()
    got = flash_attention_cuda(q, k, v, causal, None, None)
    want = flash_attention_plain(q, k, v, causal, None, None)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    assert torch.equal(got, flash_attention_cuda(q, k, v, causal, None,
                                                 None))
    assert flash_attention_cuda.launches == 2
    assert flash_attention_cuda.wgmma_launches == \
        (2 if dtype == torch.bfloat16 else 0)


def test_decode_equals_prefill_at_full_width(cuda):
    """9 layers of zamba2's full widths in float32 (3 mamba, 5 mamba and
    one mamba_shared call of the shared block), SSD chunks of 8, 32 tokens
    at batch 2: decoding gives the chunked prefill's logits at positions
    7, 15 and 31 (one, two and four chunks), and each prefill launches the
    kernel once."""
    cfg = dataclasses.replace(get_config(NAME), n_layers=9, ssd_chunk=8,
                              dtype=torch.float32)
    model = LM(cfg, generator=torch.Generator(device="cuda").manual_seed(0))
    tok = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 32)).astype(np.int32)).cuda()
    with torch.inference_mode():
        kernels.reset_counters()
        want = {p: model.prefill(tok[:, :p + 1]) for p in (7, 15, 31)}
        assert kernels.counters()["flash_attention"] == {
            "launches": 3, "plain_calls": 0}
        caches = model.init_cache(2, 32)
        for t in range(32):
            got, caches = model.decode_step(tok[:, t:t + 1], t, caches)
            if t in want:
                torch.testing.assert_close(got, want[t], **LM_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reduced_zamba2_on_the_card_matches_the_cpu(cuda, dtype):
    """The reduced config, the same weights on the card and on the CPU:
    the prefill launches flash_attention once per mamba_shared layer and
    never its plain version (bf16: every launch on the tensor-core
    kernel); in float32, forward, prefill and 32 decode steps agree with
    the CPU; in bf16 a repeat prefill gives the same bits."""
    cfg = dataclasses.replace(reduced(NAME), dtype=dtype)
    cpu = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(2))
    card = LM(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    tok = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 32)).astype(np.int32))
    with torch.inference_mode():
        kernels.reset_counters()
        got = card.prefill(tok.cuda())
        assert flash_layers(cfg) == cfg.layer_kinds.count("mamba_shared") == 3
        assert kernels.counters()["flash_attention"] == {
            "launches": 3, "plain_calls": 0}
        assert flash_attention_cuda.wgmma_launches == \
            (3 if dtype == torch.bfloat16 else 0)
        if dtype == torch.bfloat16:
            assert torch.equal(got, card.prefill(tok.cuda()))
            assert bool(torch.isfinite(got).all())
            return
        torch.testing.assert_close(got.cpu(), cpu.prefill(tok), **LM_TOL)
        torch.testing.assert_close(card(tok.cuda()).cpu(), cpu(tok),
                                   **LM_TOL)
        cc, gc = cpu.init_cache(2, 32), card.init_cache(2, 32)
        for t in range(32):
            want, cc = cpu.decode_step(tok[:, t:t + 1], t, cc)
            got, gc = card.decode_step(tok[:, t:t + 1].cuda(), t, gc)
            torch.testing.assert_close(got.cpu(), want, **LM_TOL)
