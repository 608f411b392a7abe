"""The port's halo-split TV regularisers (paper SS2.3, Fig 6) against the
JAX package's.

The JAX side runs on the conftest mesh ``host_mesh`` (4, 2) (and
``mesh82`` (2, 4)); the port side on meshes of ``torch.device("cpu")`` of
the same shapes, where every shard shares one device, so a shard's in-place
update must not reach its neighbour.  Inputs are drawn by numpy from
seeds.  Bands are the reference's (tests/test_regularization.py):

* ``dist_minimize_tv`` with the exact norm, n_inner 1, 2 and 4: rtol 1e-4,
  atol 1e-5 (against the reference's halo-split and monolithic results);
* the paper's no-sync norm: within 2 % of the exact one;
* ``dist_rof_denoise``, n_inner 2 and 4: rtol 1e-3, atol 1e-5;
* the halo-split gradient (``tv_gradient`` over a padded slab's in-volume
  planes) against autograd of the ported masked objective
  ``_tv_value_masked``, and that objective's value against the
  reference's: rtol = atol = 1e-5 (tests/test_regularization.py:22).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.core import regularization as jreg
from repro.core.compat import shard_map
from repro_torch import kernels
from repro_torch.core import regularization as reg
from repro_torch.core.distributed import halo_exchange
from repro_torch.launch.mesh import make_host_mesh

SHAPE = (32, 12, 12)
TV_BAND = dict(rtol=1e-4, atol=1e-5)
ROF_BAND = dict(rtol=1e-3, atol=1e-5)
GRAD_BAND = dict(rtol=1e-5, atol=1e-5)


def _vol(seed, shape=SHAPE):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _mesh(model_axis, n=8):
    return make_host_mesh(model_axis, devices=["cpu"] * n)


@pytest.mark.parametrize("n_inner", [1, 2, 4])
def test_dist_tv_exact_norm_matches_reference(host_mesh, n_inner):
    v = _vol(2)
    with host_mesh:
        want = np.asarray(jreg.dist_minimize_tv(
            host_mesh, hyper=0.1, n_iters=8, n_inner=n_inner,
            approx_norm=False)(jnp.asarray(v)))
    mono = np.asarray(jreg.minimize_tv(jnp.asarray(v), hyper=0.1, n_iters=8))
    got = reg.dist_minimize_tv(_mesh(2), hyper=0.1, n_iters=8,
                               n_inner=n_inner, approx_norm=False)(v)
    np.testing.assert_allclose(got.numpy(), want, **TV_BAND)
    np.testing.assert_allclose(got.numpy(), mono, **TV_BAND)
    np.testing.assert_allclose(
        got.numpy(), reg.minimize_tv(torch.from_numpy(v), 0.1, 8).numpy(),
        **TV_BAND)


def test_dist_tv_approx_norm_converges(host_mesh):
    """Paper SS2.3: the no-sync norm estimate changes the result by < 2 %,
    reduces TV, and follows the reference's estimate."""
    v = _vol(3)
    mesh = _mesh(2)
    approx = reg.dist_minimize_tv(mesh, 0.1, 12, 4, approx_norm=True)(v)
    exact = reg.dist_minimize_tv(mesh, 0.1, 12, 4, approx_norm=False)(v)
    rel = float(torch.linalg.norm(approx - exact) / torch.linalg.norm(exact))
    assert rel < 0.02, rel
    assert float(reg.tv_value(approx)) < float(reg.tv_value(
        torch.from_numpy(v)))
    with host_mesh:
        want = np.asarray(jreg.dist_minimize_tv(
            host_mesh, 0.1, 12, 4, approx_norm=True)(jnp.asarray(v)))
    np.testing.assert_allclose(approx.numpy(), want, **TV_BAND)


@pytest.mark.parametrize("n_inner", [2, 4])
def test_dist_rof_matches_reference(host_mesh, n_inner):
    v = _vol(4)
    with host_mesh:
        want = np.asarray(jreg.dist_rof_denoise(
            host_mesh, lam=10.0, n_iters=8, n_inner=n_inner)(jnp.asarray(v)))
    mono = np.asarray(jreg.rof_denoise(jnp.asarray(v), lam=10.0, n_iters=8))
    got = reg.dist_rof_denoise(_mesh(2), lam=10.0, n_iters=8,
                               n_inner=n_inner)(v)
    np.testing.assert_allclose(got.numpy(), want, **ROF_BAND)
    np.testing.assert_allclose(got.numpy(), mono, **ROF_BAND)


def test_four_model_shards(mesh82):
    """The (2, 4) mesh: both regularisers still follow the monolithic
    iteration and the reference's halo split."""
    v = _vol(5)
    mesh = _mesh(4)
    with mesh82:
        want_tv = np.asarray(jreg.dist_minimize_tv(
            mesh82, 0.1, 8, 2, approx_norm=False)(jnp.asarray(v)))
        want_rof = np.asarray(jreg.dist_rof_denoise(
            mesh82, 10.0, 8, 2)(jnp.asarray(v)))
    got_tv = reg.dist_minimize_tv(mesh, 0.1, 8, 2, approx_norm=False)(v)
    got_rof = reg.dist_rof_denoise(mesh, 10.0, 8, 2)(v)
    np.testing.assert_allclose(got_tv.numpy(), want_tv, **TV_BAND)
    np.testing.assert_allclose(got_rof.numpy(), want_rof, **ROF_BAND)


@pytest.mark.parametrize("n_shards,depth", [(2, 1), (4, 2), (4, 3)])
def test_halo_gradient_is_autograd_of_the_masked_objective(n_shards, depth):
    """Over each padded slab, the gradient dist_minimize_tv takes (the TV
    gradient of the in-volume planes, 0 on out-of-volume halo planes) is
    autograd of ``_tv_value_masked``, and on the owned planes it is the
    monolithic gradient."""
    v = torch.from_numpy(_vol(6, (24, 10, 9)))
    slabs = list(v.split(24 // n_shards))
    mono = reg.tv_gradient(v, 1e-6).split(24 // n_shards)
    for j, vp in enumerate(halo_exchange(slabs, depth)):
        padded = vp.shape[0]
        lo, hi, g, own = reg._halo_gradient(vp, depth, j, n_shards, 1e-6)
        full = torch.zeros_like(vp)
        full[lo:hi] = g
        x = vp.clone().requires_grad_(True)
        reg._tv_value_masked(
            x, reg._fake_plane_mask(padded, depth, j, n_shards),
            reg._global_last_mask(padded, depth, j, n_shards),
            1e-6).backward()
        torch.testing.assert_close(full, x.grad, **GRAD_BAND)
        torch.testing.assert_close(own, mono[j], **GRAD_BAND)
        assert own.shape[0] == slabs[j].shape[0]


def test_masks_and_masked_value_match_reference(host_mesh):
    """``_fake_plane_mask``, ``_global_last_mask`` and the masked TV value
    of every shard of the (4, 2) mesh equal the reference's."""
    depth, planes = 3, 16
    padded = planes + 2 * depth
    v = _vol(7)

    def body(xs):
        vp = jreg.halo_exchange(xs, depth, "model")
        m = jreg._fake_plane_mask(padded, depth, "model", 2)
        dzm = jreg._global_last_mask(padded, depth, "model", 2)
        val = jreg._tv_value_masked(vp, m, dzm, 1e-6)
        return m, dzm, jnp.broadcast_to(val, (1,))

    fn = jax.jit(shard_map(body, mesh=host_mesh,
                           in_specs=P("model", None, None),
                           out_specs=(P("model"), P("model"), P("model")),
                           check_vma=False))
    with host_mesh:
        masks, dz_masks, vals = (np.asarray(a) for a in fn(jnp.asarray(v)))
    vps = halo_exchange(list(torch.from_numpy(v).split(planes)), depth)
    for j in range(2):
        m = reg._fake_plane_mask(padded, depth, j, 2)
        dzm = reg._global_last_mask(padded, depth, j, 2)
        np.testing.assert_array_equal(m.numpy(),
                                      masks[j * padded:(j + 1) * padded])
        np.testing.assert_array_equal(
            dzm.numpy(), dz_masks[j * padded:(j + 1) * padded])
        np.testing.assert_allclose(
            float(reg._tv_value_masked(vps[j], m, dzm, 1e-6)), vals[j],
            **GRAD_BAND)


def test_shards_of_one_device_do_not_alias():
    """Every shard of a 2 x 2 mesh of one device updates its padded slab in
    place: the result equals the 1 x 1 mesh's, and the input is left as it
    was."""
    v = torch.from_numpy(_vol(8))
    before = v.clone()
    wide = reg.dist_minimize_tv(_mesh(2, 4), 0.1, 8, 2, approx_norm=False)(v)
    one = reg.dist_minimize_tv(_mesh(1, 1), 0.1, 8, 2, approx_norm=False)(v)
    assert torch.equal(v, before)
    torch.testing.assert_close(wide, one, **TV_BAND)
    rof = reg.dist_rof_denoise(_mesh(2, 4), 10.0, 4, 2)(v)
    assert torch.equal(v, before)
    torch.testing.assert_close(rof, reg.rof_denoise(v, 10.0, 4), **ROF_BAND)


def test_one_gradient_per_model_index():
    """The data-axis replicas compute nothing: per inner iteration one TV
    gradient (the plain version here) per model shard."""
    kernels.reset_counters()
    reg.dist_minimize_tv(_mesh(2), 0.1, 6, 3)(_vol(9))
    c = kernels.counters()["tv_grad"]
    assert c == {"launches": 0, "plain_calls": 2 * 6}


def test_halo_deeper_than_a_slab_raises():
    with pytest.raises(ValueError, match="halo depth"):
        reg.dist_minimize_tv(_mesh(4), 0.1, 8, 9)(_vol(1))
    with pytest.raises(ValueError, match="not divisible"):
        reg.dist_rof_denoise(_mesh(4, 4), 10.0, 2, 1)(_vol(1, (30, 8, 8)))
