"""The port's cached kernel wrappers (``repro_torch.kernels.ops``) and its
oracles (``repro_torch.kernels.ref``) against the reference's, on the CPU,
and ``recon --autotune`` on the CPU.

Bands: the projector oracles at the kernel band (rtol 2e-4, atol 5e-3,
``tests/test_backend.py:23``), ``tv_grad_ref`` at rtol = atol = 1e-5
(``tests/test_kernels.py:70``), ``flash_attention_ref`` in float32 at
rtol = atol = 2e-4 (``tests/test_kernels.py:84``).  The same numpy inputs
go through both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.geometry import ConeGeometry as JaxGeometry
from repro.kernels import ref as jref
from repro_torch import kernels
from repro_torch.core.geometry import (ConeGeometry, circular_angles,
                                       dominant_axis_mask)
from repro_torch.kernels import autotune, ops, ref

RTOL, ATOL = 2e-4, 5e-3
SHAPE = (14, 16, 16)
ANGLES = circular_angles(12)
X_ANGLES = ANGLES[dominant_axis_mask(ANGLES)]


def _geos(shape=SHAPE):
    return (JaxGeometry.nice(16).with_voxels(shape),
            ConeGeometry.nice(16).with_voxels(shape))


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_ops_wrappers_cache_their_launchers():
    """A repeat call with new angle values hits the launcher cache and
    builds nothing (the reference's regression test for its per-call
    jit rebuild, tests/test_backend.py:204-230)."""
    _, tg = _geos()
    vol = torch.from_numpy(_rand(SHAPE, 0))
    proj = torch.from_numpy(_rand((len(ANGLES),) + tg.n_detector, 1))
    ops.clear_cache()
    ops.fp_ray_project(vol, tg, X_ANGLES)
    before = ops.cache_info()["fp"]
    assert before.misses == 1
    ops.fp_ray_project(vol, tg, X_ANGLES + 0.01)
    after = ops.cache_info()["fp"]
    assert after.hits == before.hits + 1 and after.misses == before.misses
    ops.bp_voxel_backproject(proj, tg, ANGLES)
    ops.bp_voxel_backproject(proj, tg, ANGLES + 0.01)
    info = ops.cache_info()["bp"]
    assert info.misses == 1 and info.hits >= 1
    ops.tv_gradient_fused(vol)
    ops.tv_gradient_fused(vol * 2)
    assert ops.cache_info()["tv"].misses == 1
    q = torch.from_numpy(_rand((1, 4, 8, 8), 2))
    k = torch.from_numpy(_rand((1, 2, 8, 8), 3))
    ops.flash_attention(q, k, k)
    ops.flash_attention(q * 2, k, k)
    assert ops.cache_info()["flash"].misses == 1
    # another configuration is another launcher
    ops.fp_ray_project(vol, tg, X_ANGLES, config=1)
    assert ops.cache_info()["fp"].misses == 2
    ops.clear_cache()
    assert ops.cache_info()["fp"].currsize == 0


def test_ops_wrappers_take_the_ports_knobs_only():
    _, tg = _geos()
    vol = torch.from_numpy(_rand(SHAPE, 0))
    with pytest.raises(TypeError):
        ops.fp_ray_project(vol, tg, X_ANGLES, slab_planes=16)
    with pytest.raises(TypeError):
        ops.bp_voxel_backproject(vol, tg, ANGLES, z_block=16)
    with pytest.raises(ValueError, match="unknown weight"):
        ops.bp_voxel_backproject(torch.zeros((len(ANGLES),) + tg.n_detector),
                                 tg, ANGLES, weight="fbp")


def test_fp_ray_ref_matches_reference():
    jg, tg = _geos()
    vol = _rand(SHAPE, 4)
    want = np.asarray(jref.fp_ray_ref(jnp.asarray(vol), jg, X_ANGLES))
    got = ref.fp_ray_ref(torch.from_numpy(vol), tg, X_ANGLES).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # the wrapper (the plain version on the CPU) agrees with the oracle
    np.testing.assert_allclose(
        ops.fp_ray_project(torch.from_numpy(vol), tg, X_ANGLES).numpy(),
        got, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("weight", ["fdk", "pmatched", "none"])
def test_bp_voxel_ref_matches_reference(weight):
    jg, tg = _geos()
    proj = _rand((len(ANGLES),) + tg.n_detector, 5)
    want = np.asarray(jref.bp_voxel_ref(jnp.asarray(proj), jg, ANGLES,
                                        weight=weight))
    got = ref.bp_voxel_ref(torch.from_numpy(proj), tg, ANGLES,
                           weight=weight).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        ops.bp_voxel_backproject(torch.from_numpy(proj), tg, ANGLES,
                                 weight=weight).numpy(),
        got, rtol=RTOL, atol=ATOL)


def test_tv_grad_ref_matches_reference():
    vol = _rand((9, 12, 13), 6)
    want = np.asarray(jref.tv_grad_ref(jnp.asarray(vol)))
    got = ref.tv_grad_ref(torch.from_numpy(vol)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        ops.tv_gradient_fused(torch.from_numpy(vol)).numpy(), got,
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal,window,softcap", [
    (True, None, None), (True, 5, 20.0), (False, None, 30.0)])
def test_flash_attention_ref_matches_reference(causal, window, softcap):
    q = _rand((2, 4, 24, 16), 7)
    k = _rand((2, 2, 24, 16), 8)
    v = _rand((2, 2, 24, 16), 9)
    want = np.asarray(jref.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, softcap=softcap))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = ref.flash_attention_ref(tq, tk, tv, causal=causal, window=window,
                                  softcap=softcap).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(
        ops.flash_attention(tq, tk, tv, causal=causal, window=window,
                            softcap=softcap).numpy(),
        got, rtol=2e-4, atol=2e-4)


def test_kernels_package_exports_and_builds_nothing():
    assert kernels.autotune is autotune and kernels.ops is ops
    assert kernels.ref is ref
    assert set(autotune._KINDS) == {"fp", "bp", "bp_matched"}
    from repro_torch.kernels import build
    assert build._LIBS == {}


def test_recon_autotune_on_the_cpu_changes_nothing(monkeypatch):
    """``reconstruct(..., autotune=True)`` on the CPU: tuning is on, the
    plain versions have no tiles, and the result is the untuned one."""
    from repro_torch.launch import recon
    monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)
    monkeypatch.delenv("REPRO_AUTOTUNE_CACHE", raising=False)
    autotune.clear()
    try:
        base = recon.reconstruct("cgls", n=16, n_angles=16, iters=3,
                                 device="cpu", verbose=False)
        tuned = recon.reconstruct("cgls", n=16, n_angles=16, iters=3,
                                  device="cpu", verbose=False,
                                  autotune=True)
        assert autotune.enabled() and autotune.table() == {}
        assert tuned.rel_err == base.rel_err
        assert torch.equal(tuned.rec, base.rec)
        # the CLI flag: through the scheduler, on the CPU
        autotune.enable(None)
        rec, rel = recon.main(["--alg", "cgls", "--n", "16", "--angles",
                               "16", "--iters", "3", "--device", "cpu",
                               "--autotune"])
        assert autotune.enabled() and rel == pytest.approx(base.rel_err,
                                                           rel=1e-6)
    finally:
        autotune.enable(None)
        autotune.clear()
