"""The redesigned kernels on the card: the tensor-core ``flash_attention``
(bfloat16: wgmma, TMA, P·V on a bf16 hi/lo pair of P) and the
table-driven ``bp_matched``, each against its plain version.

Every test here needs a CUDA device and ``nvcc`` (the kernels build at
first use) and skips without a device.  The file imports nothing of JAX,
so it runs where the port runs:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda_redesign.py -q

Bands: ``flash_attention`` in bfloat16 rtol 1e-2, atol 1e-4 (both sides
compute in float32 from the same inputs and round once; the hi/lo pair
keeps P to 2^-17), float32 rtol = atol = 2e-4 (``tests/test_kernels.py:84``);
``bp_matched`` rtol 2e-4, atol 5e-3 (``tests/test_backend.py:23``) and
the adjoint identity against ``fp_ray`` to 1e-4
(``tests/test_adjoint.py:29``).  q is drawn at 4 times the scale of k and
v, so that the scores have std 4 and the soft-cap of 50 matters.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import reduced
from repro_torch.kernels import bp_matched as bp_matched_mod
from repro_torch.core.geometry import (ConeGeometry, circular_angles,
                                       dominant_axis_mask)
from repro_torch.kernels.bp_matched import bp_matched_cuda, bp_matched_plain
from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 flash_attention_plain)
from repro_torch.kernels.fp_ray import fp_ray_cuda
from repro_torch.launch.steps import build_prefill_step
from repro_torch.models.lm import LM

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(rtol=2e-4, atol=2e-4),
       torch.bfloat16: dict(rtol=1e-2, atol=1e-4)}
Q_SCALE = 4.0
RTOL, ATOL = 2e-4, 5e-3
ADJ_TOL = 1e-4


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


# --------------------------------------------------------------------------
# flash_attention: the tensor-core kernel
# --------------------------------------------------------------------------

@pytest.mark.parametrize("causal,window,softcap", [
    (True, None, 50.0), (False, 64, None), (True, 4096, 50.0)])
@pytest.mark.parametrize("s,d,hq,hkv", [
    (1000, 64, 4, 4), (129, 128, 8, 4), (1000, 256, 16, 2), (129, 32, 2, 1)])
def test_tensor_core_kernel_matches_plain(cuda, s, d, hq, hkv, causal,
                                          window, softcap):
    """Lengths no tile divides, head dims 32 to 256, Hq/Hkv 1, 2 and 8,
    masks and caps: within the bfloat16 band, repeat launches
    bit-identical, both launches on the tensor-core path."""
    q, k, v = _qkv(2, hq, hkv, s, d, torch.bfloat16)
    kernels.reset_counters()
    got = flash_attention_cuda(q, k, v, causal, window, softcap)
    want = flash_attention_plain(q, k, v, causal, window, softcap)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(),
                               **TOL[torch.bfloat16])
    assert torch.equal(got, flash_attention_cuda(q, k, v, causal, window,
                                                 softcap))
    assert kernels.counters()["flash_attention"] == {"launches": 2,
                                                     "plain_calls": 1}
    assert flash_attention_cuda.wgmma_launches == 2


def test_float32_takes_the_simt_kernel(cuda):
    q, k, v = _qkv(1, 4, 2, 300, 128, torch.float32, seed=1)
    kernels.reset_counters()
    got = flash_attention_cuda(q, k, v, True, 64, 50.0)
    torch.testing.assert_close(got, flash_attention_plain(q, k, v, True, 64,
                                                          50.0),
                               **TOL[torch.float32])
    assert kernels.counters()["flash_attention"] == {"launches": 1,
                                                     "plain_calls": 1}
    assert flash_attention_cuda.wgmma_launches == 0


def test_reduced_prefill_at_full_depth_runs_42_tensor_core_launches(cuda):
    """The reduced gemma2 (head dim 32) at gemma2-9b's 42 layers, bf16:
    one prefill launches the kernel once per layer, all on the tensor-core
    path, and gives finite logits close to the float32 CPU port."""
    cfg = dataclasses.replace(reduced("gemma2-9b"), n_layers=42,
                              dtype=torch.bfloat16)
    model = LM(cfg, device="cuda",
               generator=torch.Generator(device="cuda").manual_seed(0))
    tok = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 40)).astype(np.int32)).cuda()
    step = build_prefill_step(cfg, batch=2, seq=40, model=model)
    kernels.reset_counters()
    logits = step.fn(tok)
    assert kernels.counters()["flash_attention"] == {"launches": 42,
                                                     "plain_calls": 0}
    assert flash_attention_cuda.wgmma_launches == 42
    assert logits.shape == (2, 1, cfg.vocab)
    assert bool(torch.isfinite(logits.float()).all())


# --------------------------------------------------------------------------
# bp_matched: per-plane tables
# --------------------------------------------------------------------------

def _check_pair(geo, n_angles, z0, planes, seed):
    """bp_matched vs its plain version and the adjoint identity against
    fp_ray on a slab of ``planes`` planes at ``z0``, x-dominant angles of
    ``n_angles`` over the circle; repeat launches bit-identical."""
    ang = circular_angles(n_angles)
    a = torch.from_numpy(ang[dominant_axis_mask(ang)])
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(
        (planes,) + geo.n_voxel[1:]).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal(
        (len(a),) + geo.n_detector).astype(np.float32))
    kernels.reset_counters()
    bk = bp_matched_cuda(y.cuda(), geo, a.cuda(), z0, planes)
    torch.testing.assert_close(bk.cpu(), bp_matched_plain(y, geo, a, z0,
                                                          planes),
                               rtol=RTOL, atol=ATOL)
    fk = fp_ray_cuda(x.cuda(), geo, a.cuda(), z0)
    lhs = float((fk.double() * y.cuda().double()).sum())
    rhs = float((x.cuda().double() * bk.double()).sum())
    assert abs(lhs - rhs) / max(abs(lhs), abs(rhs)) <= ADJ_TOL
    assert torch.equal(bk, bp_matched_cuda(y.cuda(), geo, a.cuda(), z0,
                                           planes))
    assert kernels.counters()["bp_matched"]["launches"] == 2


@pytest.mark.parametrize("n_angles", [37, 50])
@pytest.mark.parametrize("part", ["full", "slab"])
def test_bp_matched_prime_n(cuda, part, n_angles):
    """N = 31 (no tile divides it), 37 and 50 angles over the circle (19
    and 26 x-dominant: no multiple of the 4 angles staged at a time); the
    whole volume and a slab starting at z0 = 11."""
    geo = ConeGeometry.nice(31)
    z0, planes = (0, 31) if part == "full" else (11, 13)
    _check_pair(geo, n_angles, z0, planes, seed=3)


def test_bp_matched_angle_chunks_give_the_same_bits(cuda, monkeypatch):
    """The kernel runs SEG_CHUNK angles at a time, each chunk carrying the
    sums in: one chunk of every angle, or chunks of 3, give the same bits
    as the default."""
    geo = ConeGeometry.nice(31)
    ang = circular_angles(50)
    a = torch.from_numpy(ang[dominant_axis_mask(ang)]).cuda()
    y = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (len(a),) + geo.n_detector).astype(np.float32)).cuda()
    want = bp_matched_cuda(y, geo, a, 5, 17)
    for chunk in (len(a), 3):
        monkeypatch.setattr(bp_matched_mod, "SEG_CHUNK", chunk)
        assert torch.equal(bp_matched_cuda(y, geo, a, 5, 17), want), chunk


@pytest.mark.parametrize("part", ["full", "slab"])
def test_bp_matched_offsets_and_unequal_detector(cuda, part):
    """A non-cubic volume, nu != nv and non-zero offsets everywhere."""
    geo = ConeGeometry(n_voxel=(23, 29, 37), s_voxel=(200.0, 240.0, 260.0),
                       n_detector=(27, 41), s_detector=(300.0, 380.0),
                       off_origin=(6.0, -9.0, 7.0), off_detector=(11.0, -13.0))
    z0, planes = (0, 23) if part == "full" else (9, 7)
    _check_pair(geo, 33, z0, planes, seed=4)


def test_bp_matched_windows_past_the_tables(cuda):
    """Fine detector pixels (many u per voxel row, many v per plane): the
    u windows outgrow the table, rows hold more than three u hits and the
    v windows outgrow their rows, so every on-the-fly path runs; still
    the plain version's result."""
    geo = ConeGeometry(n_voxel=(24, 24, 24), s_voxel=(256.0, 256.0, 256.0),
                       n_detector=(160, 160), s_detector=(409.6, 409.6))
    _check_pair(geo, 17, 0, 24, seed=5)
