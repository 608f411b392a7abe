"""ASD-POCS and FISTA-TV on the port against the JAX package.

* 3 iterations of the port's ``asd_pocs`` against the reference's
  (``backend="pallas"``, interpret mode) at the algorithm band 2e-3
  (tests/test_adjoint.py:199), iterate by iterate, with the adaptive
  scalars (dtvg, dp_first, lmbda) at 1e-4 relative, in plain and stream
  mode;
* 3 iterations of ``fista_tv`` against the reference's at 2e-3, plain and
  streamed, with one explicit L handed to both (the two power iterations
  start from different random vectors); the port's own L against the
  reference's;
* the step-wise runs give the same bits as the one-shot runs, and a port
  checkpoint resumes bit-identically;
* a reference run exported after one iteration with its
  ``checkpoint_state`` resumes in the port and lands on the reference's
  later iterates at 2e-3;
* the recon driver on the CPU for both algorithms, with the reference
  driver's parameters.
"""

import numpy as np
import pytest
import torch

from repro.core.algorithms import stepwise as jax_stepwise
from repro.core.geometry import ConeGeometry as JaxGeometry
from repro.core.operator import CTOperator as JaxOperator
from repro_torch import kernels
from repro_torch.core import phantoms
from repro_torch.core.algorithms import (asd_pocs, checkpoint_state,
                                         fista_tv, get_algorithm,
                                         restore_state)
from repro_torch.core.geometry import ConeGeometry, circular_angles
from repro_torch.core.operator import CTOperator
from repro_torch.core.splitting import MemoryModel
from repro_torch.launch import recon

TOL = 2e-3                       # tests/test_adjoint.py:199
SCALAR_RTOL = 1e-4
CPU = "cpu"
GEO, JGEO = ConeGeometry.nice(16), JaxGeometry.nice(16)
ANGLES = circular_angles(8)
SUBSET = 4
ITERS = 3
#: one explicit L for both packages (as tests/test_serve.py:268 passes
#: one): about 1.05 ||A||^2 at this geometry, so the iterates converge
L_FIXED = 30000.0


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


def _op(mode="plain", bp_weight="pmatched"):
    return CTOperator(GEO, ANGLES, mode=mode, backend="cuda", device=CPU,
                      bp_weight=bp_weight,
                      memory=_tiny() if mode == "stream" else None)


def _jax_run(name, proj, iters, **params):
    """The reference's step-wise run: (state after each step, its
    checkpoint after the first)."""
    jalg = jax_stepwise.get_algorithm(name)
    jop = JaxOperator(JGEO, ANGLES, backend="pallas",
                      bp_weight=jalg.default_bp_weight)
    st = jalg.init(proj, JGEO, ANGLES, op=jop, **params)
    xs, scalars, ck = [], [], None
    for _ in range(iters):
        st = jalg.step(st)
        xs.append(np.asarray(st.x))
        scalars.append({f: getattr(st, f) for f in jalg.ckpt_fields
                        if f not in ("x", "y")})
        if ck is None:
            ck = jax_stepwise.checkpoint_state(jalg, st)
    return xs, scalars, ck


def _close(a: float, b: float, rtol=SCALAR_RTOL) -> bool:
    return abs(a - b) <= rtol * max(abs(a), abs(b))


# --------------------------------------------------------------------------
# ASD-POCS
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_asd(proj):
    return _jax_run("asd_pocs", proj, ITERS, subset_size=SUBSET)


@pytest.mark.parametrize("mode,r_max", [("plain", None), ("stream", None),
                                        ("plain", 0.01)])
def test_asd_pocs_matches_reference(proj, jax_asd, mode, r_max):
    """The default r_max, and a small one (0.01) under which the TV step
    outruns it every iteration, so the adaptive branch shrinks dtvg.  (A
    large alpha would test the branch too, but TV steps far above the
    smoothing scale make the descent chaotic: the iterates of the two
    packages then part by 2e-2 to 7e-2 from ulp-level differences.)"""
    params = dict(subset_size=SUBSET)
    if r_max is None:
        xs_want, scalars_want, _ = jax_asd
    else:
        params["r_max"] = r_max
        xs_want, scalars_want, _ = _jax_run("asd_pocs", proj, ITERS,
                                            **params)
    op = _op(mode)
    assert op.plan.streams == (mode == "stream")
    alg = get_algorithm("asd_pocs")
    st = alg.init(proj, GEO, ANGLES, op=op, **params)
    kernels.reset_counters()
    for want, sw in zip(xs_want, scalars_want):
        st = alg.step(st)
        assert st.x.device == op.data_device
        np.testing.assert_allclose(st.x.numpy(), want, rtol=TOL, atol=TOL)
        for f in ("dtvg", "dp_first", "lmbda"):
            assert _close(getattr(st, f), float(sw[f])), (f, getattr(st, f),
                                                          sw[f])
        assert st.it == sw["it"]
    c = kernels.counters()
    assert c["tv_grad"]["plain_calls"] == 20 * ITERS
    assert c["bp_voxel"]["plain_calls"] > 0 and c["fp_ray"]["plain_calls"] > 0
    assert c["bp_matched"]["plain_calls"] == 0
    shrunk = st.dtvg < st.alpha * st.dp_first
    assert shrunk == (r_max is not None)
    got = asd_pocs(proj, GEO, ANGLES, n_iter=ITERS, op=op, **params)
    np.testing.assert_allclose(got.numpy(), xs_want[-1], rtol=TOL, atol=TOL)


def test_asd_pocs_stepwise_is_bit_identical_to_one_shot(proj):
    op = _op()
    xs = []
    one_shot = asd_pocs(proj, GEO, ANGLES, n_iter=ITERS, subset_size=SUBSET,
                        op=op, callback=lambda it, x: xs.append(x))
    alg = get_algorithm("asd_pocs")
    st = alg.init(proj, GEO, ANGLES, op=op, subset_size=SUBSET)
    for _ in range(ITERS):
        st = alg.step(st)
    assert st.it == ITERS and len(xs) == ITERS
    assert torch.equal(alg.finalize(st), one_shot)
    # a port checkpoint resumes bit-identically (the OS-SART factors are
    # rebuilt lazily from the restored iterate)
    st2 = alg.step(alg.init(proj, GEO, ANGLES, op=op, subset_size=SUBSET))
    ck = checkpoint_state(alg, st2)
    assert set(ck) == {"x", "lmbda", "dtvg", "dp_first", "it"}
    st3 = restore_state(alg, alg.init(proj, GEO, ANGLES, op=op,
                                      subset_size=SUBSET), ck)
    assert st3.data_state is None
    for _ in range(ITERS - 1):
        st3 = alg.step(st3)
    assert torch.equal(st3.x, one_shot)
    assert (st3.dtvg, st3.dp_first, st3.lmbda) == (st.dtvg, st.dp_first,
                                                   st.lmbda)


@pytest.mark.parametrize("mode", ["plain", "stream"])
def test_asd_pocs_resumes_from_a_jax_checkpoint(proj, jax_asd, mode):
    xs_want, scalars_want, ck = jax_asd
    assert isinstance(ck["x"], np.ndarray) and ck["it"] == 1
    alg = get_algorithm("asd_pocs")
    op = _op(mode)
    params = {k: ck[k] for k in alg.resume_params}
    st = restore_state(alg, alg.init(proj, GEO, ANGLES, op=op,
                                     subset_size=SUBSET, **params), ck)
    assert st.it == 1 and st.x.device == op.data_device
    for want, sw in zip(xs_want[1:], scalars_want[1:]):
        st = alg.step(st)
        np.testing.assert_allclose(st.x.numpy(), want, rtol=TOL, atol=TOL)
        assert _close(st.dtvg, float(sw["dtvg"]))
    assert st.it == ITERS


# --------------------------------------------------------------------------
# FISTA-TV
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_fista(proj):
    return _jax_run("fista", proj, ITERS, L=L_FIXED)


@pytest.mark.parametrize("mode", ["plain", "stream"])
def test_fista_matches_reference(proj, jax_fista, mode):
    xs_want, scalars_want, _ = jax_fista
    op = _op(mode, bp_weight="matched")
    alg = get_algorithm("fista")
    st = alg.init(proj, GEO, ANGLES, op=op, L=L_FIXED)
    kernels.reset_counters()
    for want, sw in zip(xs_want, scalars_want):
        st = alg.step(st)
        assert st.x.device == op.data_device
        np.testing.assert_allclose(st.x.numpy(), want, rtol=TOL, atol=TOL)
        assert st.t == sw["t"] and st.it == sw["it"]
    c = kernels.counters()
    assert c["fp_ray"]["plain_calls"] > 0
    assert c["bp_matched"]["plain_calls"] > 0
    assert c["tv_grad"]["plain_calls"] == 0
    got = fista_tv(proj, GEO, ANGLES, n_iter=ITERS, L=L_FIXED, op=op)
    np.testing.assert_allclose(got.numpy(), xs_want[-1], rtol=TOL, atol=TOL)


def test_fista_power_iteration_L_against_reference():
    """The port's L (a torch.Generator start vector) against the
    reference's (jax.random), both 1.05 times 6 power iterations: they
    agree to 5e-2 relative.  Measured 1.3e-2 at this geometry; the power
    iteration converges slowly here, and two seeds of one package already
    differ by up to 4.5e-2 after 6 iterations."""
    jop = JaxOperator(JGEO, ANGLES, backend="ref", bp_weight="matched")
    want = jop.norm_squared_est(n_iter=6) * 1.05
    st = get_algorithm("fista").init(np.zeros((len(ANGLES),)
                                              + GEO.n_detector, np.float32),
                                     GEO, ANGLES, op=_op(bp_weight="matched"))
    assert _close(st.L, want, rtol=5e-2), (st.L, want)
    assert not _close(st.L, want, rtol=1e-3)


def test_fista_stepwise_is_bit_identical_to_one_shot(proj):
    op = _op(bp_weight="matched")
    one_shot = fista_tv(proj, GEO, ANGLES, n_iter=ITERS, L=L_FIXED, op=op)
    alg = get_algorithm("fista_tv")
    st = alg.init(proj, GEO, ANGLES, op=op, L=L_FIXED)
    for _ in range(ITERS):
        st = alg.step(st)
    assert torch.equal(alg.finalize(st), one_shot)
    st2 = alg.step(alg.init(proj, GEO, ANGLES, op=op, L=L_FIXED))
    ck = checkpoint_state(alg, st2)
    assert set(ck) == {"x", "y", "t", "L", "it"}
    st3 = restore_state(alg, alg.init(proj, GEO, ANGLES, op=op, L=ck["L"]),
                        ck)
    for _ in range(ITERS - 1):
        st3 = alg.step(st3)
    assert torch.equal(st3.x, one_shot) and st3.t == st.t


@pytest.mark.parametrize("mode", ["plain", "stream"])
def test_fista_resumes_from_a_jax_checkpoint(proj, jax_fista, mode):
    xs_want, _, ck = jax_fista
    assert all(isinstance(ck[f], np.ndarray) for f in ("x", "y"))
    alg = get_algorithm("fista")
    op = _op(mode, bp_weight="matched")
    params = {k: ck[k] for k in alg.resume_params}
    assert params == {"L": L_FIXED}
    st = restore_state(alg, alg.init(proj, GEO, ANGLES, op=op, **params), ck)
    assert st.it == 1 and st.y.device == op.data_device
    for want in xs_want[1:]:
        st = alg.step(st)
        np.testing.assert_allclose(st.x.numpy(), want, rtol=TOL, atol=TOL)
    assert st.it == ITERS


# --------------------------------------------------------------------------
# the recon driver
# --------------------------------------------------------------------------

@pytest.mark.parametrize("alg,mode", [("asd_pocs", "plain"),
                                      ("asd_pocs", "stream"),
                                      ("fista", "plain"),
                                      ("fista", "stream")])
def test_recon_cli_cpu(capsys, alg, mode):
    # the scheduler holds a job to the budget: a forced plain job gets
    # the default one (its footprint is above 40000 B)
    budget = ["--device-bytes", "40000"] if mode == "stream" else []
    recon.main(["--alg", alg, "--n", "16", "--angles", "24", "--iters", "2",
                "--mode", mode, "--device", "cpu"] + budget)
    out = capsys.readouterr().out
    assert f"[recon] {alg} N=16 angles=24 iters=2 mode={mode}" in out
    rel = float(out.split("rel_err=")[1].split()[0])
    assert 0.0 < rel < 1.0


def test_recon_uses_the_reference_driver_parameters():
    """ASD-POCS with its defaults (subsets of 20, 20 TV steps), FISTA with
    L from the power iteration and 20 ROF steps
    (src/repro/launch/recon.py:59-62, 261-264)."""
    seen = {}
    for alg in ("asd_pocs", "fista"):
        res = recon.reconstruct(
            alg, n=16, n_angles=24, iters=1, device=CPU, verbose=False,
            callback=lambda it, st, a=alg: seen.setdefault(a, st))
        assert res.residuals == [] and len(res.seconds) == 1
        assert res.op.bp_weight == get_algorithm(alg).default_bp_weight
    asd, fista = seen["asd_pocs"], seen["fista"]
    assert asd.subset_size == 20 and asd.tv_iters == 20
    assert [len(s) for s in asd.data_state.subsets] == [20, 4]
    assert fista.tv_iters == 20 and fista.tv_lambda == 20.0
    assert fista.L > 1.0
