"""The port's TV regularisation against the JAX package.

* ``minimize_tv`` at rtol 1e-4, atol 1e-5 (20 steps of the closed form
  against 20 steps of ``jax.grad``);
* ``rof_denoise``, ``_grad3`` and ``_div3`` against the reference, and
  ``_div3`` as the adjoint of ``_grad3``: <grad u, p> = -<u, div p>;
* ``halo_overhead``, and the port's float32 norm.

The TV gradient these run on is tested in tests/test_torch_tv_grad.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import regularization as jreg
from repro_torch.core import regularization as reg


def _vol(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# --------------------------------------------------------------------------
# the TV minimiser
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape,hyper,n_iters", [
    ((16, 16, 16), 0.5, 20), ((13, 7, 9), 0.05, 10), ((2, 9, 7), 0.2, 5)])
def test_minimize_tv_matches_reference(shape, hyper, n_iters):
    v = _vol(shape, seed=4)
    t = torch.from_numpy(v.copy())
    got = reg.minimize_tv(t, hyper=hyper, n_iters=n_iters)
    assert torch.equal(t, torch.from_numpy(v)), "the input was modified"
    want = np.asarray(jreg.minimize_tv(jnp.asarray(v), hyper=hyper,
                                       n_iters=n_iters))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    # each step moves the iterate by hyper in norm, and TV falls
    assert float(reg.tv_value(got)) < float(reg.tv_value(t))
    step = reg.minimize_tv(t, hyper=hyper, n_iters=1) - t
    assert abs(float(torch.linalg.norm(step)) - hyper) < 1e-4 * hyper + 1e-6


# --------------------------------------------------------------------------
# the ROF prox
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(16, 16, 16), (13, 7, 9), (1, 6, 5),
                                   (2, 6, 5), (6, 2, 1)])
def test_grad3_and_div3_match_reference(shape):
    rng = np.random.default_rng(5)
    u = rng.standard_normal(shape).astype(np.float32)
    p = [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]
    for got, want in zip(reg._grad3(torch.from_numpy(u)),
                         jreg._grad3(jnp.asarray(u))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = reg._div3(*(torch.from_numpy(q) for q in p)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jreg._div3(*(jnp.asarray(q) for q in p))),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", [(8, 9, 10), (2, 5, 7), (6, 2, 3),
                                   (4, 5, 2)])
def test_div3_is_the_negative_adjoint_of_grad3(shape):
    """<grad u, p> = -<u, div p> (in float64 dot products), for shapes with
    an axis of size 2 too.  An axis of size 1 has grad 0 and div p = p, so
    the identity holds there only for p = 0 on that axis, as in the
    reference."""
    rng = np.random.default_rng(6)
    u = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    p = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
         for _ in range(3)]
    lhs = sum(float((g.double() * q.double()).sum())
              for g, q in zip(reg._grad3(u), p))
    rhs = -float((u.double() * reg._div3(*p).double()).sum())
    assert abs(lhs - rhs) <= 1e-5 * max(abs(lhs), abs(rhs))


@pytest.mark.parametrize("shape,lam,n_iters", [
    ((16, 16, 16), 10.0, 30), ((13, 7, 9), 3.0, 20), ((2, 9, 7), 50.0, 8)])
def test_rof_denoise_matches_reference(shape, lam, n_iters):
    v = _vol(shape, seed=7)
    got = reg.rof_denoise(torch.from_numpy(v), lam=lam, n_iters=n_iters)
    want = np.asarray(jreg.rof_denoise(jnp.asarray(v), lam=lam,
                                       n_iters=n_iters))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    assert float(reg.tv_value(got)) < float(reg.tv_value(torch.from_numpy(v)))


def test_halo_overhead_matches_reference():
    for planes, halo in ((64, 4), (10, 3), (0, 2)):
        assert reg.halo_overhead(planes, halo) == jreg.halo_overhead(planes,
                                                                     halo)


def test_norm_is_accurate_on_large_float32_vectors():
    """The port's norm, used by minimize_tv, ASD-POCS's dp and dg, the
    power iteration and the driver's rel_err, agrees with the float64 norm
    to fp32 rounding where torch's CPU float32 ``linalg.norm`` does not
    (0.96 % off at 512^3 elements, torch 2.13 CPU; a streamed ASD-POCS
    step at N=512 takes dp from a host volume)."""
    from repro_torch.core.device import norm
    x = torch.rand(1 << 24, generator=torch.Generator().manual_seed(0)) * 0.3
    want = float(torch.linalg.norm(x.double()))
    assert abs(float(norm(x)) - want) <= 1e-7 * want
    assert abs(float(torch.linalg.norm(x)) - want) > 1e-4 * want
    v = torch.from_numpy(_vol((5, 6, 7), seed=8))
    assert torch.allclose(norm(v), torch.linalg.norm(v.reshape(-1)),
                          rtol=1e-6, atol=0.0)
    assert norm(v).dim() == 0 and norm(v).dtype == torch.float32
