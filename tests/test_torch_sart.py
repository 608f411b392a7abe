"""FDK and the SART family on the port against the JAX package.

* ``filter_projections`` and ``fdk`` against the reference's; FDK of the
  analytic sphere within rel_err 0.25 (tests/test_algorithms.py:23-24);
* ``ossart`` / ``sirt`` / ``sart`` against the reference's after 2
  iterations at 2e-3; streamed OS-SART against plain at 2e-3
  (tests/test_algorithms.py:77-78);
* the step-wise run gives the same bits as the one-shot run;
* a reference OS-SART run exported after one iteration with its
  ``checkpoint_state`` resumes in the port and lands on the reference's
  second iterate at 2e-3;
* the recon driver on the CPU for every newly ported algorithm.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.algorithms import fdk as jax_fdk
from repro.core.algorithms import filter_projections as jax_filter
from repro.core.algorithms import ossart as jax_ossart
from repro.core.algorithms import sart as jax_sart
from repro.core.algorithms import sirt as jax_sirt
from repro.core.algorithms import stepwise as jax_stepwise
from repro.core.geometry import ConeGeometry as JaxGeometry
from repro.core.operator import CTOperator as JaxOperator
from repro_torch.core import phantoms
from repro_torch.core.algorithms import (checkpoint_state, fdk,
                                         filter_projections, get_algorithm,
                                         ossart, restore_state, sart, sirt)
from repro_torch.core.geometry import ConeGeometry, circular_angles
from repro_torch.core.operator import CTOperator
from repro_torch.core.splitting import MemoryModel
from repro_torch.launch import recon

TOL = 2e-3
CPU = "cpu"
GEO, JGEO = ConeGeometry.nice(16), JaxGeometry.nice(16)
ANGLES = circular_angles(8)
SUBSET = 4


@pytest.fixture(scope="module")
def proj():
    return phantoms.sphere_projection_analytic(GEO, ANGLES)


def _tiny():
    """About a third of the volume plus room for the projection buffers
    (tests/test_adjoint.py:53-58)."""
    nz, ny, nx = GEO.n_voxel
    nv, nu = GEO.n_detector
    return MemoryModel(device_bytes=(nz * ny * nx * 4) // 3
                       + 12 * len(ANGLES) * nv * nu, usable_fraction=1.0)


def _op(mode="plain", backend="cuda"):
    return CTOperator(GEO, ANGLES, mode=mode, backend=backend, device=CPU,
                      memory=_tiny() if mode == "stream" else None)


# --------------------------------------------------------------------------
# FDK
# --------------------------------------------------------------------------

def test_filter_projections_matches_reference():
    geo_kw = dict(n_voxel=(14, 20, 26), s_voxel=(200.0, 240.0, 260.0),
                  n_detector=(18, 22), s_detector=(300.0, 380.0),
                  off_origin=(6.0, -9.0, 7.0), off_detector=(11.0, -13.0))
    for tg, jg in ((GEO, JGEO), (ConeGeometry(**geo_kw),
                                 JaxGeometry(**geo_kw))):
        rng = np.random.default_rng(0)
        y = rng.standard_normal((5,) + tg.n_detector).astype(np.float32)
        want = np.asarray(jax_filter(jnp.asarray(y), jg, ANGLES[:5]))
        got = filter_projections(torch.from_numpy(y), tg).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-4,
                                   atol=2e-4 * np.abs(want).max())


@pytest.mark.parametrize("backend", ["cuda", "ref"])
def test_fdk_matches_reference(proj, backend):
    want = np.asarray(jax_fdk(jnp.asarray(proj), JGEO, ANGLES,
                              op=JaxOperator(JGEO, ANGLES, backend="pallas")))
    got = fdk(proj, GEO, ANGLES, op=_op(backend=backend)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_fdk_reconstructs_the_analytic_sphere():
    geo = ConeGeometry.nice(32)
    angles = circular_angles(64)
    vol = phantoms.sphere(geo)
    proj = phantoms.sphere_projection_analytic(geo, angles)
    rec = fdk(proj, geo, angles, device=CPU).numpy()
    assert np.linalg.norm(rec - vol) / np.linalg.norm(vol) < 0.25
    streamed = fdk(proj, geo, angles, op=CTOperator(
        geo, angles, mode="stream", device=CPU,
        memory=MemoryModel(device_bytes=40_000, usable_fraction=1.0)))
    np.testing.assert_allclose(streamed.numpy(), rec, rtol=TOL, atol=TOL)


# --------------------------------------------------------------------------
# SART family
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_ossart2(proj):
    return np.asarray(jax_ossart(proj, JGEO, ANGLES, n_iter=2,
                                 subset_size=SUBSET,
                                 op=JaxOperator(JGEO, ANGLES,
                                                backend="pallas")))


@pytest.mark.parametrize("mode,backend", [("plain", "cuda"), ("plain", "ref"),
                                          ("stream", "cuda")])
def test_ossart_matches_reference(proj, jax_ossart2, mode, backend):
    op = _op(mode, backend)
    assert op.plan.streams == (mode == "stream")
    got = ossart(proj, GEO, ANGLES, n_iter=2, subset_size=SUBSET, op=op)
    assert got.device == op.data_device
    np.testing.assert_allclose(got.numpy(), jax_ossart2, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", ["sirt", "sart"])
def test_sirt_and_sart_match_reference(proj, name):
    jfn, fn = {"sirt": (jax_sirt, sirt), "sart": (jax_sart, sart)}[name]
    want = np.asarray(jfn(proj, JGEO, ANGLES, n_iter=2))
    got = fn(proj, GEO, ANGLES, n_iter=2, op=_op()).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert np.linalg.norm(got - phantoms.sphere(GEO)) < np.linalg.norm(
        phantoms.sphere(GEO))


def test_streamed_ossart_matches_plain(proj):
    plain = ossart(proj, GEO, ANGLES, n_iter=2, subset_size=3, op=_op(),
                   bp_weight="fdk")
    streamed = ossart(proj, GEO, ANGLES, n_iter=2, subset_size=3,
                      op=_op("stream"), bp_weight="fdk")
    np.testing.assert_allclose(streamed.numpy(), plain.numpy(), rtol=TOL,
                               atol=TOL)


def test_stepwise_is_bit_identical_to_one_shot(proj):
    op = _op()
    xs = []
    one_shot = ossart(proj, GEO, ANGLES, n_iter=3, subset_size=SUBSET, op=op,
                      callback=lambda it, x: xs.append(x))
    alg = get_algorithm("ossart")
    assert alg.ckpt_fields == ("x", "lmbda", "it")
    assert alg.resume_params == ("lmbda",) and alg.iterative
    st = alg.init(proj, GEO, ANGLES, op=op, subset_size=SUBSET)
    for _ in range(3):
        st = alg.step(st)
    assert st.it == 3 and len(xs) == 3
    assert torch.equal(alg.finalize(st), one_shot)
    # a port checkpoint round-trips bit-identically
    st2 = alg.init(proj, GEO, ANGLES, op=op, subset_size=SUBSET)
    st2 = alg.step(st2)
    st3 = restore_state(alg, alg.init(proj, GEO, ANGLES, op=op,
                                      subset_size=SUBSET),
                        checkpoint_state(alg, st2))
    for _ in range(2):
        st3 = alg.step(st3)
    assert torch.equal(st3.x, one_shot)
    fdk_alg = get_algorithm("fdk")
    assert not fdk_alg.iterative and fdk_alg.ckpt_fields == ("x", "it")
    st = fdk_alg.step(fdk_alg.init(proj, GEO, ANGLES, op=op))
    assert st.it == 1
    assert torch.equal(fdk_alg.finalize(st), fdk(proj, GEO, ANGLES, op=op))


@pytest.mark.parametrize("mode", ["plain", "stream"])
def test_resume_from_a_jax_checkpoint(proj, jax_ossart2, mode):
    jalg = jax_stepwise.get_algorithm("ossart")
    jop = JaxOperator(JGEO, ANGLES, backend="pallas")
    jst = jalg.step(jalg.init(proj, JGEO, ANGLES, op=jop,
                              subset_size=SUBSET))
    ck = jax_stepwise.checkpoint_state(jalg, jst)
    assert isinstance(ck["x"], np.ndarray) and ck["it"] == 1
    alg = get_algorithm("ossart")
    op = _op(mode)
    st = restore_state(alg, alg.init(proj, GEO, ANGLES, op=op,
                                     subset_size=SUBSET), ck)
    assert st.it == 1 and st.x.device == op.data_device
    st = alg.step(st)
    assert st.it == 2
    np.testing.assert_allclose(alg.finalize(st).numpy(), jax_ossart2,
                               rtol=TOL, atol=TOL)


# --------------------------------------------------------------------------
# the recon driver
# --------------------------------------------------------------------------

@pytest.mark.parametrize("alg,mode", [("ossart", "plain"), ("fdk", "plain"),
                                      ("sirt", "stream"), ("sart", "plain")])
def test_recon_cli_cpu(capsys, alg, mode):
    # the scheduler holds a job to the budget: a forced plain job gets
    # the default one (its footprint is above 40000 B)
    budget = ["--device-bytes", "40000"] if mode == "stream" else []
    recon.main(["--alg", alg, "--n", "16", "--angles", "12", "--iters", "2",
                "--mode", mode, "--device", "cpu"] + budget)
    out = capsys.readouterr().out
    steps = 1 if alg == "fdk" else 2
    assert f"[recon] {alg} N=16 angles=12 iters={steps} mode={mode}" in out
    rel = float(out.split("rel_err=")[1].split()[0])
    assert 0.0 < rel < 1.0
    res = recon.reconstruct(alg, n=16, n_angles=12, iters=2, mode=mode,
                            device_bytes=40000, device=CPU, verbose=False)
    assert res.residuals == [] and len(res.seconds) == steps
    assert abs(res.rel_err - rel) < 1e-4


def test_recon_ossart_uses_the_reference_subsets():
    """``--alg ossart`` runs subsets of n_angles // 8 angles, as the
    reference's driver does (launch/recon.py:59-62)."""
    seen = []
    recon.reconstruct("ossart", n=16, n_angles=16, iters=1, device=CPU,
                      verbose=False,
                      callback=lambda it, st: seen.append(st.subsets))
    assert [len(s) for s in seen[0]] == [2] * 8
