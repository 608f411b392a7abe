"""The slice as a whole: CGLS on the port against CGLS on the JAX package.

* 6 iterations of the port's CGLS match 6 iterations of the reference's
  (``backend="pallas"``, interpret mode) at 2e-3, the band of
  tests/test_adjoint.py:199, in plain and stream mode;
* the step-wise run is bit-identical to the one-shot ``cgls()``;
* a reference run stopped after 3 iterations and exported with its
  ``checkpoint_state`` resumes in the port for 3 more and lands on the
  reference's uninterrupted 6-iteration result at 2e-3;
* the data set, the recon entry point and the registry.
"""

import numpy as np
import pytest
import torch

from repro.core.algorithms import cgls as jax_cgls
from repro.core.algorithms import stepwise as jax_stepwise
from repro.core.geometry import ConeGeometry as JaxGeometry
from repro.core.operator import CTOperator as JaxOperator
from repro.data import make_ct_dataset as jax_make_ct_dataset
from repro_torch.core import phantoms
from repro_torch.core.algorithms import (cgls, checkpoint_state,
                                         get_algorithm, restore_state)
from repro_torch.core.geometry import ConeGeometry, circular_angles
from repro_torch.core.operator import CTOperator
from repro_torch.core.splitting import MemoryModel
from repro_torch.data import make_ct_dataset
from repro_torch.launch import recon

GEO = ConeGeometry.nice(16)
JGEO = JaxGeometry.nice(16)
ANGLES = circular_angles(8)
TOL = 2e-3
CPU = "cpu"


@pytest.fixture(scope="module")
def proj():
    return phantoms.sphere_projection_analytic(GEO, ANGLES)


@pytest.fixture(scope="module")
def jax_x6(proj):
    return np.asarray(jax_cgls(proj, JGEO, ANGLES, n_iter=6,
                               op=JaxOperator(JGEO, ANGLES,
                                              backend="pallas")))


def _tiny():
    nz, ny, nx = GEO.n_voxel
    nv, nu = GEO.n_detector
    return MemoryModel(device_bytes=(nz * ny * nx * 4) // 3
                       + 12 * len(ANGLES) * nv * nu, usable_fraction=1.0)


@pytest.mark.parametrize("mode,backend", [("plain", "cuda"), ("plain", "ref"),
                                          ("stream", "cuda")])
def test_cgls_matches_jax(proj, jax_x6, mode, backend):
    op = CTOperator(GEO, ANGLES, mode=mode, backend=backend, device=CPU,
                    memory=_tiny() if mode == "stream" else None)
    assert op.plan.streams == (mode == "stream")
    got = cgls(proj, GEO, ANGLES, n_iter=6, op=op).numpy()
    np.testing.assert_allclose(got, jax_x6, rtol=TOL, atol=TOL)
    res = np.linalg.norm(op.A(got).numpy() - proj)
    assert res < 0.5 * np.linalg.norm(proj)


def test_stepwise_is_bit_identical_to_one_shot(proj):
    op = CTOperator(GEO, ANGLES, backend="cuda", device=CPU)
    norms = []
    one_shot = cgls(proj, GEO, ANGLES, n_iter=4, op=op,
                    callback=lambda it, x, r: norms.append(r))
    alg = get_algorithm("cgls")
    st = alg.init(proj, GEO, ANGLES, op=op)
    for _ in range(4):
        st = alg.step(st)
    assert st.it == 4
    assert torch.equal(alg.finalize(st), one_shot)
    assert norms == sorted(norms, reverse=True)
    # a port checkpoint round-trips bit-identically too
    st2 = alg.init(proj, GEO, ANGLES, op=op)
    for _ in range(2):
        st2 = alg.step(st2)
    ck = checkpoint_state(alg, st2)
    assert set(ck) == {"x", "r", "p", "gamma", "it"}
    st3 = restore_state(alg, alg.init(proj, GEO, ANGLES, op=op), ck)
    for _ in range(2):
        st3 = alg.step(st3)
    assert torch.equal(st3.x, one_shot)


@pytest.mark.parametrize("mode", ["plain", "stream"])
def test_resume_from_a_jax_checkpoint(proj, jax_x6, mode):
    jalg = jax_stepwise.get_algorithm("cgls")
    jop = JaxOperator(JGEO, ANGLES, backend="pallas")
    jst = jalg.init(proj, JGEO, ANGLES, op=jop)
    for _ in range(3):
        jst = jalg.step(jst)
    ck = jax_stepwise.checkpoint_state(jalg, jst)
    assert all(isinstance(ck[f], np.ndarray) for f in ("x", "r", "p",
                                                       "gamma"))
    alg = get_algorithm("cgls")
    op = CTOperator(GEO, ANGLES, mode=mode, backend="cuda", device=CPU,
                    memory=_tiny())
    st = restore_state(alg, alg.init(proj, GEO, ANGLES, op=op), ck)
    assert st.it == 3 and st.x.device == op.data_device
    for _ in range(3):
        st = alg.step(st)
    assert st.it == 6
    np.testing.assert_allclose(alg.finalize(st).numpy(), jax_x6, rtol=TOL,
                               atol=TOL)


def test_registry_points_to_the_roadmap():
    assert get_algorithm("cgls").default_bp_weight == "matched"
    for name in ("ossart", "fista", "fdk", "asd_pocs"):
        with pytest.raises(ValueError, match="ROADMAP"):
            get_algorithm(name)
    with pytest.raises(ValueError, match="unknown algorithm"):
        get_algorithm("nope")


def test_make_ct_dataset_matches_reference():
    vol, angles, proj = make_ct_dataset(GEO, 12, device=CPU)
    jvol, jangles, jproj = jax_make_ct_dataset(JGEO, 12)
    np.testing.assert_array_equal(vol.numpy(), jvol)
    np.testing.assert_array_equal(angles, jangles)
    np.testing.assert_allclose(proj.numpy(), jproj, rtol=2e-4, atol=5e-3)
    _, _, noisy = make_ct_dataset(GEO, 12, noise_rel=0.05, seed=3,
                                  device=CPU)
    _, _, jnoisy = jax_make_ct_dataset(JGEO, 12, noise_rel=0.05, seed=3)
    np.testing.assert_allclose(noisy.numpy(), jnoisy, rtol=2e-4, atol=5e-3)
    with pytest.raises(ValueError, match="unknown phantom"):
        make_ct_dataset(GEO, 4, phantom="cat", device=CPU)


def test_recon_entry_point_cpu(capsys):
    recon.main(["--alg", "cgls", "--n", "16", "--angles", "12", "--iters",
                "3", "--mode", "stream", "--device-bytes", "40000",
                "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[recon] cgls N=16 angles=12 iters=3 mode=stream" in out
    rel = float(out.split("rel_err=")[1].split()[0])
    assert 0.0 < rel < 1.0
    res = recon.reconstruct("cgls", n=16, n_angles=12, iters=3,
                            mode="plain", device=CPU, verbose=False)
    assert abs(res.rel_err - rel) < 2e-3
    assert len(res.seconds) == 3 and len(res.residuals) == 4
    assert all(b < a for a, b in zip(res.residuals, res.residuals[1:]))
