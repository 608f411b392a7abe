"""xlstm-350m and training on the card: the xLSTM layers at xlstm-350m's
widths against the same code on the CPU, decode against prefill at one
pattern unit, two training steps on the card against the CPU, and CUDA
``flash_attention`` giving a gradient (its backward kernels).

Every test here needs a CUDA device and skips without one; the last
builds the attention kernels (``nvcc``).  The file imports nothing of
JAX:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda_xlstm.py -q

Bands (float32 throughout; TF32 matmuls stay off, torch's default): a
layer on the card against the CPU rtol 2e-4, atol 2e-5 (the CPU parity
band of ``tests/test_torch_xlstm.py``: the same ops, sums in another
order); decode vs prefill logits rtol 1e-3, atol 1e-4
(``tests/test_models.py:86-87``); training on the card against the CPU:
losses and gradient norms rtol 1e-4, parameters rtol 1e-3, atol 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 flash_attention_plain)
from repro_torch.launch.train import train
from repro_torch.models import perf
from repro_torch.models import xlstm as tx
from repro_torch.models.lm import LM

pytestmark = pytest.mark.cuda

F32_TOL = dict(rtol=2e-4, atol=2e-5)
LM_TOL = dict(rtol=1e-3, atol=1e-4)
NAME = "xlstm-350m"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only there)")
    if torch.backends.cuda.matmul.allow_tf32:
        pytest.skip("TF32 matmuls are on")
    return torch.device("cuda")


def _params(kind, seed):
    cfg = get_config(NAME).xlstm_cfg()
    init = tx.init_mlstm if kind == "mlstm" else tx.init_slstm
    return cfg, init(torch.Generator().manual_seed(seed), cfg, torch.float32)


def _on(tree, device):
    return {k: v.to(device) for k, v in tree.items()}


@pytest.mark.parametrize("form", ["parallel", "chunked"])
def test_mlstm_on_the_card_matches_the_cpu(cuda, form):
    """mLSTM at xlstm-350m's widths (4 heads of 512), float32, batch 1:
    the parallel form at S 1000 and the chunked form at S 2048 (two query
    chunks), then 4 recurrent steps on the cache it hands on."""
    cfg, p = _params("mlstm", 0)
    s = 1000 if form == "parallel" else 2048
    x = torch.randn((1, s + 4, 1024), generator=torch.Generator()
                    .manual_seed(1)) * 0.5
    perf.FLAGS["mlstm_chunked"] = form == "chunked"
    try:
        outs = {}
        for dev in ("cpu", cuda):
            pd, xd = _on(p, dev), x.to(dev)
            with torch.inference_mode():
                y, cache = tx.mlstm_fwd(pd, xd[:, :s], cfg, make_cache=True)
                steps = [tx.mlstm_decode(pd, xd[:, t:t + 1], cache, cfg)[0]
                         for t in range(s, s + 4)]
            outs[str(dev)] = (y.cpu(), torch.cat(steps, 1).cpu(),
                              {k: v.cpu() for k, v in cache.items()})
    finally:
        perf.FLAGS["mlstm_chunked"] = False
    (y0, d0, c0), (y1, d1, c1) = outs["cpu"], outs[str(cuda)]
    torch.testing.assert_close(y1, y0, **F32_TOL)
    torch.testing.assert_close(d1, d0, **F32_TOL)
    for k in c0:
        torch.testing.assert_close(c1[k], c0[k], **F32_TOL)


def test_slstm_on_the_card_matches_the_cpu(cuda):
    """sLSTM at xlstm-350m's widths (4 heads of 256), float32: the
    recurrence over S 256 and its final state, then 4 steps from it."""
    cfg, p = _params("slstm", 2)
    x = torch.randn((2, 260, 1024), generator=torch.Generator()
                    .manual_seed(3)) * 0.5
    outs = {}
    for dev in ("cpu", cuda):
        pd, xd = _on(p, dev), x.to(dev)
        with torch.inference_mode():
            y, state = tx.slstm_fwd(pd, xd[:, :256], cfg, make_cache=True)
            steps = [tx.slstm_decode(pd, xd[:, t:t + 1], state, cfg)[0]
                     for t in range(256, 260)]
        outs[str(dev)] = (y.cpu(), torch.cat(steps, 1).cpu(),
                          {k: v.cpu() for k, v in state.items()})
    (y0, d0, s0), (y1, d1, s1) = outs["cpu"], outs[str(cuda)]
    torch.testing.assert_close(y1, y0, **F32_TOL)
    torch.testing.assert_close(d1, d0, **F32_TOL)
    for k in s0:
        torch.testing.assert_close(s1[k], s0[k], **F32_TOL)


def test_decode_equals_prefill_at_one_unit(cuda):
    """4 layers of xlstm-350m's widths (3 mlstm + slstm), float32, 24
    tokens at batch 2: decode from empty caches gives prefill's logits at
    positions 7, 15 and 23; no kernel runs."""
    cfg = dataclasses.replace(get_config(NAME), n_layers=4,
                              dtype=torch.float32)
    model = LM(cfg, generator=torch.Generator(device="cuda").manual_seed(0))
    tok = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 24)).astype(np.int32)).cuda()
    kernels.reset_counters()
    with torch.inference_mode():
        want = {t: model.prefill(tok[:, :t + 1]) for t in (7, 15, 23)}
        caches = model.init_cache(2, 24)
        for t in range(24):
            got, caches = model.decode_step(tok[:, t:t + 1], t, caches)
            if t in want:
                torch.testing.assert_close(got, want[t], **LM_TOL)
    assert all(c == {"launches": 0, "plain_calls": 0}
               for c in kernels.counters().values())


def test_two_train_steps_on_the_card_match_the_cpu(cuda):
    """train() on one pattern unit of xlstm-350m's widths (4 layers,
    float32, vocab 50304), batch 2 of 64 tokens, 2 steps, from the same
    weights on the card and the CPU: the losses, the gradient norms and
    the trained parameters."""
    cfg = dataclasses.replace(get_config(NAME), name=NAME + "-unit",
                              n_layers=4, dtype=torch.float32)
    runs, models = {}, {}
    for dev in ("cpu", "cuda"):
        model = LM(cfg, device="cpu",
                   generator=torch.Generator().manual_seed(5)).to(dev)
        hist = []
        _, _, losses = train(steps=2, batch=2, seq=64, verbose=False,
                             model=model, history=hist)
        runs[dev] = (losses, [h["grad_norm"] for h in hist])
        models[dev] = model
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=1e-4)
    np.testing.assert_allclose(runs["cuda"][1], runs["cpu"][1], rtol=1e-4)
    for (name, a), b in zip(models["cpu"].named_parameters(),
                            models["cuda"].parameters()):
        torch.testing.assert_close(b.detach().cpu(), a.detach(), rtol=1e-3,
                                   atol=1e-5, msg=name)


def test_flash_attention_gives_a_gradient(cuda):
    """With gradients on, a q that requires one gets it from the backward
    kernels (one forward launch with its row statistics, one backward
    launch), and it agrees with autograd of the plain version; under
    no_grad, and with no input requiring a gradient, the forward launches
    alone."""
    q, k, v = (torch.randn((1, 4, 128, 64), device=cuda,
                           dtype=torch.bfloat16) for _ in range(3))
    kernels.reset_counters()
    qg = q.clone().requires_grad_(True)
    out = flash_attention_cuda(qg, k, v)
    out.float().sum().backward()
    assert flash_attention_cuda.launches == 1
    assert flash_attention_cuda.bwd_launches == 1
    assert qg.grad is not None and qg.grad.dtype == torch.bfloat16
    qp = q.clone().requires_grad_(True)
    flash_attention_plain(qp, k, v).float().sum().backward()
    err = (qg.grad.float() - qp.grad.float()).abs()
    atol = 1e-3 * float(qp.grad.float().abs().max())
    assert bool((err <= atol + 1e-2 * qp.grad.float().abs()).all())
    with torch.no_grad():
        out = flash_attention_cuda(q.clone().requires_grad_(True), k, v)
    assert out.shape == q.shape and out.grad_fn is None
    assert flash_attention_cuda(q, k, v).shape == q.shape
    assert flash_attention_cuda.launches == 3
    assert flash_attention_cuda.bwd_launches == 1
