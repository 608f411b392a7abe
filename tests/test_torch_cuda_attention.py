"""The port's LM path on the card: the attention kernel against its plain
version, and reduced gemma2 prefill through the kernel against the CPU
port.

Every test here needs a CUDA device and ``nvcc`` (the kernel builds at
first use) and skips without a device.  The file imports nothing of JAX,
so it runs where the port runs:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda_attention.py -q

Bands: kernel vs plain rtol 2e-4, atol 2e-4 in float32
(``tests/test_kernels.py:84``).  In bfloat16 both compute in float32 from
the same inputs and round once, so they differ by at most one unit in the
last place: rtol 1e-2, atol 1e-4 (the reference's 5e-2 would pass a
kernel that drops a mask).  q is drawn at 4 times the scale of k and v,
so that the scores have std 4 and the soft-cap of 50 changes the output.
Model logits as the reference's decode-vs-forward band, rtol 1e-3,
atol 1e-4 (``tests/test_models.py:86-87``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import reduced
from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 flash_attention_plain)
from repro_torch.launch.steps import build_prefill_step
from repro_torch.models.lm import LM

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(rtol=2e-4, atol=2e-4),
       torch.bfloat16: dict(rtol=1e-2, atol=1e-4)}
Q_SCALE = 4.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only there)")
    return torch.device("cuda")


def _qkv(b, hq, hkv, s, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy((rng.standard_normal(shape) * c).astype(
        np.float32)).to("cuda", dtype)
        for shape, c in (((b, hq, s, d), Q_SCALE), ((b, hkv, s, d), 1.0),
                         ((b, hkv, s, d), 1.0)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,s,d", [
    (1, 4, 4, 1000, 64), (2, 8, 4, 1000, 128), (1, 16, 2, 1000, 256),
    (2, 4, 2, 77, 32)])
@pytest.mark.parametrize("causal,window,softcap", [
    (False, None, 50.0), (True, 64, 50.0), (True, 4096, None)])
def test_kernel_matches_plain(cuda, dtype, b, hq, hkv, s, d, causal, window,
                              softcap):
    """Odd lengths, head dims 32 to 256, Hq/Hkv 1 to 8, masks and caps (a
    window of 4096 over 1000 keys is the causal mask alone); repeat
    launches bit-identical."""
    q, k, v = _qkv(b, hq, hkv, s, d, dtype)
    kernels.reset_counters()
    got = flash_attention_cuda(q, k, v, causal, window, softcap)
    want = flash_attention_plain(q, k, v, causal, window, softcap)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    assert torch.equal(got, flash_attention_cuda(q, k, v, causal, window,
                                                 softcap))
    assert kernels.counters()["flash_attention"] == {"launches": 2,
                                                     "plain_calls": 1}


def test_bf16_band_excludes_a_dropped_mask_or_cap(cuda):
    """The plain version with the window, the causal mask or the cap
    dropped lies outside the bfloat16 band around the right answer, so a
    kernel that dropped one would fail the test above."""
    q, k, v = _qkv(1, 16, 2, 1000, 256, torch.bfloat16)
    want = flash_attention_plain(q, k, v, True, 64, 50.0).float()
    band = TOL[torch.bfloat16]
    for wrong in ((True, None, 50.0), (False, 64, 50.0), (True, 64, None)):
        got = flash_attention_plain(q, k, v, *wrong).float()
        outside = (got - want).abs() > band["atol"] + band["rtol"] * \
            want.abs()
        assert bool(outside.any()), wrong


def test_reduced_gemma2_prefill_on_the_card_matches_the_cpu(cuda):
    """float32 reduced gemma2 (window 16, S 40): prefill and the full
    forward through the kernel (4 launches) vs the CPU port's plain path."""
    cfg = dataclasses.replace(reduced("gemma2-9b"), dtype=torch.float32)
    cpu = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    card = LM(cfg, device="cuda",
              generator=torch.Generator(device="cuda").manual_seed(0))
    card.load_state_dict({k: v.to("cuda") for k, v in
                          cpu.state_dict().items()})
    tok = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 40)).astype(np.int32))
    step = build_prefill_step(cfg, batch=2, seq=40, model=card)
    kernels.reset_counters()
    got = step.fn(tok.cuda())
    assert kernels.counters()["flash_attention"] == {"launches": 4,
                                                     "plain_calls": 0}
    want = cpu.prefill(tok)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(card.logits(card(tok.cuda())).cpu(),
                               cpu.logits(cpu(tok)), rtol=1e-3, atol=1e-4)
