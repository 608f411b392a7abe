"""The flash_attention backward kernels on the card: dq, dk, dv of
``flash_attention_cuda`` under autograd (its ``_FlashAttentionFn``: the
forward with its row statistics, then ``csrc/flash_attention_bwd.cu``:
the tensor-core kernels for bfloat16, counted in
``flash_attention_cuda.bwd_wgmma_launches``, the SIMT ones for float32)
against autograd of the plain version on the same card, repeat launches
bit for bit, a bfloat16 tensor that TMA cannot read refused, the forward's
out unchanged by asking for lse, and one stablelm-1.6b layer at full width
trained on the card against the CPU.

Every test here needs a CUDA device and skips without one; the kernels are
built by ``nvcc`` at first use.  The file imports nothing of JAX:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda_flash_backward.py -q

Bands: gradients in float32 rtol 2e-4, atol 2e-4 (the forward's band:
float32 sums in other orders); in bfloat16 rtol 1e-2 and an atol of 1e-3
of the leaf's largest entry (both sides compute in float32 from the same
bf16 inputs and round each leaf once); training on the card against the
CPU: losses and gradient norms rtol 1e-4, parameters rtol 1e-3, atol 1e-5
(``chip_smoke.py``'s train bands).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import (HEAD_DIMS, _launch_bwd,
                                                 _launch_fwd,
                                                 flash_attention_cuda,
                                                 flash_attention_plain,
                                                 flash_attention_plain_lse)
from repro_torch.launch.train import train
from repro_torch.models.lm import LM

pytestmark = pytest.mark.cuda

TOL = {torch.float32: (2e-4, 2e-4), torch.bfloat16: (1e-2, 1e-3)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only there)")
    if torch.backends.cuda.matmul.allow_tf32:
        pytest.skip("TF32 matmuls are on")
    return torch.device("cuda")


def _inputs(b, hq, hkv, s, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy((rng.standard_normal(shape) * c).astype(
        np.float32)).to("cuda", dtype)
        for shape, c in (((b, hq, s, d), 4.0), ((b, hkv, s, d), 1.0),
                         ((b, hkv, s, d), 1.0), ((b, hq, s, d), 1.0)))


def _grads(fn, q, k, v, d_out, *masks):
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = fn(*leaves, *masks)
    return out.detach(), torch.autograd.grad(out, leaves, d_out)


def _assert_band(got, want, dtype, what):
    rtol, atol = TOL[dtype]
    if dtype == torch.bfloat16:
        atol *= float(want.float().abs().max())
    err = (got.float() - want.float()).abs()
    bad = err > atol + rtol * want.float().abs()
    assert not bool(bad.any()), (f"{what}: {int(bad.sum())} outside, max "
                                 f"|err| {float(err.max()):.3g}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("b,hq,hkv,s,causal,window,softcap", [
    (2, 4, 4, 1000, True, None, None), (1, 4, 2, 77, False, 64, None),
    (2, 8, 2, 300, True, 64, 50.0)],
    ids=["causal-gqa1", "window-gqa2", "cap-window-gqa4"])
def test_backward_matches_plain_autograd(cuda, b, hq, hkv, s, causal, window,
                                         softcap, d, dtype):
    """dq, dk, dv of the kernels against autograd of the plain version, and
    a second backward on the same graph gives the same bits; bfloat16 runs
    the tensor-core backward, float32 the SIMT one."""
    q, k, v, d_out = _inputs(b, hq, hkv, s, d, dtype)
    masks = (causal, window, softcap)
    kernels.reset_counters()
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = flash_attention_cuda(*leaves, *masks)
    got = torch.autograd.grad(out, leaves, d_out, retain_graph=True)
    again = torch.autograd.grad(out, leaves, d_out)
    assert flash_attention_cuda.launches == 1
    assert flash_attention_cuda.bwd_launches == 2
    assert flash_attention_cuda.bwd_wgmma_launches == \
        2 * (dtype == torch.bfloat16)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _, want = _grads(flash_attention_plain, q, k, v, d_out, *masks)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype
        _assert_band(a, w, dtype, name)


@pytest.mark.parametrize("which", ["d_out", "lse"])
def test_backward_refuses_a_bf16_tensor_tma_cannot_read(cuda, which):
    """The tensor-core backward reads d_out and lse by TMA: one that does
    not start on 16 bytes is refused before any launch."""
    q, k, v, d_out = _inputs(1, 4, 2, 200, 64, torch.bfloat16)
    with torch.no_grad():
        _, lse, out_f32 = _launch_fwd(q, k, v, True, None, None, True)
    args = {"d_out": d_out, "lse": lse}
    t = args[which]
    shifted = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    shifted = shifted[1:].view(t.shape)
    shifted.copy_(t)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    args[which] = shifted
    kernels.reset_counters()
    with pytest.raises(ValueError, match="16-byte"):
        _launch_bwd(q, k, v, out_f32, args["lse"], args["d_out"], True, None,
                    None)
    assert flash_attention_cuda.bwd_launches == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_with_lse_keeps_out_and_matches_plain(cuda, dtype):
    """Asking the forward for lse and the float32 out leaves out's bits as
    they are; lse and the float32 out agree with the plain version's."""
    q, k, v, _ = _inputs(2, 8, 2, 1000, 128, dtype, seed=1)
    with torch.no_grad():
        plain = flash_attention_cuda(q, k, v, True, 64, 50.0)
        out, lse, out_f32 = _launch_fwd(q, k, v, True, 64, 50.0, True)
        _, lse_want, f32_want = flash_attention_plain_lse(q, k, v, True, 64,
                                                          50.0)
    assert torch.equal(out, plain)
    torch.testing.assert_close(lse, lse_want, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(out_f32, f32_want, rtol=2e-4, atol=2e-4)


def test_stablelm_layer_trains_on_the_card_as_on_the_cpu(cuda):
    """One stablelm-1.6b layer at full width in float32, batch 2 x 64: two
    AdamW steps on the card (attention by the float32 forward and the
    backward kernels) against the same two on the CPU."""
    cfg = dataclasses.replace(get_config("stablelm-1.6b"),
                              name="stablelm-1.6b-unit", n_layers=1,
                              dtype=torch.float32)
    runs, models = {}, {}
    for dev in ("cpu", "cuda"):
        model = LM(cfg, device="cpu",
                   generator=torch.Generator().manual_seed(5)).to(dev)
        hist = []
        kernels.reset_counters()
        _, _, losses = train(steps=2, batch=2, seq=64, verbose=False,
                             model=model, history=hist)
        runs[dev] = (losses, [h["grad_norm"] for h in hist])
        models[dev] = model
    assert flash_attention_cuda.launches == 4      # 2 steps, remat
    assert flash_attention_cuda.bwd_launches == 2
    assert kernels.counters()["flash_attention"]["plain_calls"] == 0
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=1e-4)
    np.testing.assert_allclose(runs["cuda"][1], runs["cpu"][1], rtol=1e-4)
    for (name, a), b in zip(models["cpu"].named_parameters(),
                            models["cuda"].parameters()):
        torch.testing.assert_close(b.detach().cpu(), a.detach(), rtol=1e-3,
                                   atol=1e-5, msg=name)
