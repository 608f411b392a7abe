"""The port's TV-gradient kernel module against the JAX package.

* ``tv_grad_plain`` (the oracle of ``csrc/tv_grad.cu``) against the
  reference's ``tv_gradient`` (``jax.grad`` of ``tv_value``) and against
  the Pallas ``tv_grad_pallas`` in interpret mode, over the shapes of
  tests/test_kernels.py:62-70, odd shapes and shapes with an axis of size
  1 or 2, on random volumes and on the piecewise-constant Shepp-Logan
  phantom (zero differences, so m = eps), at the kernel's band rtol 1e-5,
  atol 1e-5 (tests/test_kernels.py:70);
* the closed form against torch autograd of the port's ``tv_value``, and
  ``tv_value`` against the reference's;
* the wrapper's dispatch, counters and refusals.

The CUDA kernel itself is held against ``tv_grad_plain`` on the card by
tests/test_torch_cuda_tv.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import regularization as jreg
from repro.core.geometry import ConeGeometry as JaxGeometry
from repro.core.phantoms import shepp_logan as jax_shepp_logan
from repro.kernels.tv_grad import tv_grad_pallas
from repro_torch import kernels
from repro_torch.core import regularization as reg
from repro_torch.core.geometry import ConeGeometry
from repro_torch.core.phantoms import shepp_logan
from repro_torch.kernels.tv_grad import tv_grad, tv_grad_cuda, tv_grad_plain

RTOL, ATOL = 1e-5, 1e-5          # tests/test_kernels.py:70
#: the reference's tv_gradient (jax.grad of tv_value), compiled once per
#: shape rather than op by op
jax_tv_gradient = jax.jit(jreg.tv_gradient, static_argnums=1)
ODD_SHAPES = [(13, 7, 9), (15, 11, 17), (1, 5, 6), (2, 9, 7), (6, 1, 5),
              (6, 2, 5), (5, 6, 1), (5, 6, 2), (1, 1, 4), (2, 2, 2)]


def _vol(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _plain(v):
    return tv_grad_plain(torch.from_numpy(v)).numpy()


# --------------------------------------------------------------------------
# the TV gradient
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape,zb", [
    ((16, 16, 16), 4), ((16, 16, 16), 8), ((32, 16, 24), 4),
    ((32, 16, 24), 8), ((48, 8, 8), 4), ((48, 8, 8), 8)])
def test_tv_grad_plain_matches_pallas_and_jax_grad(shape, zb):
    v = _vol(shape)
    got = _plain(v)
    want = np.asarray(tv_grad_pallas(jnp.asarray(v), z_block=zb,
                                     interpret=True))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL)
    np.testing.assert_allclose(got, np.asarray(jax_tv_gradient(
        jnp.asarray(v), 1e-6)), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", ODD_SHAPES)
def test_tv_grad_plain_takes_any_shape(shape):
    """Odd shapes and axes of size 1 or 2: the edge rules (a forward
    difference is 0 at the last index, a backward term 0 at index 0) and
    the diagonal neighbours of m_{i-z}, m_{i-y}, m_{i-x} at the edges.
    The Pallas wrapper needs Nz % z_block == 0, so it takes one block of
    Nz planes."""
    v = _vol(shape, seed=1)
    got = _plain(v)
    assert got.shape == shape
    np.testing.assert_allclose(got, np.asarray(jax_tv_gradient(
        jnp.asarray(v), 1e-6)), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(tv_grad_pallas(
        jnp.asarray(v), z_block=shape[0], interpret=True)),
        rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("eps", [1e-6, 1e-2])
def test_tv_grad_plain_on_the_shepp_logan_phantom(eps):
    """Piecewise constant: most differences are exactly 0, so m = eps and
    d/m is 0 there, and O(1) across the edges."""
    n = 24
    vol = shepp_logan(ConeGeometry.nice(n))
    np.testing.assert_array_equal(vol, jax_shepp_logan(JaxGeometry.nice(n)))
    got = tv_grad_plain(torch.from_numpy(vol), eps).numpy()
    want = np.asarray(jax_tv_gradient(jnp.asarray(vol), eps))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert (got == 0).mean() > 0.5 and np.abs(got).max() > 0.1


def test_tv_grad_closed_form_is_the_gradient_of_tv_value():
    """The plain version against torch autograd of the port's tv_value,
    and tv_value against the reference's."""
    v = _vol((9, 10, 11), seed=2)
    t = torch.from_numpy(v).requires_grad_(True)
    value = reg.tv_value(t)
    value.backward()
    np.testing.assert_allclose(_plain(v), t.grad.numpy(), rtol=RTOL,
                               atol=ATOL)
    want = float(jreg.tv_value(jnp.asarray(v)))
    assert abs(float(value.detach()) - want) <= 1e-5 * abs(want)
    for eps in (1e-6, 0.5):
        f = reg._tv_field(torch.from_numpy(v), eps).numpy()
        np.testing.assert_allclose(
            f, np.asarray(jreg._tv_field(jnp.asarray(v), eps)),
            rtol=1e-6, atol=1e-7)


def test_tv_grad_wrapper_dispatch_counters_and_refusals():
    v = torch.from_numpy(_vol((6, 7, 8), seed=3))
    kernels.reset_counters()
    assert torch.equal(tv_grad(v), tv_grad_plain(v))
    assert torch.equal(reg.tv_gradient(v, 1e-3), tv_grad_plain(v, 1e-3))
    c = kernels.counters()["tv_grad"]
    assert c == {"launches": 0, "plain_calls": 4}
    with pytest.raises(ValueError, match="CUDA tensor"):
        tv_grad_cuda(v)
    with pytest.raises(ValueError, match="float32"):
        tv_grad(v.double())
    with pytest.raises(ValueError, match="Nz, Ny, Nx"):
        tv_grad(v[0])
    assert tv_grad_cuda.launches == 0
