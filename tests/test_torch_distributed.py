"""The port's sharded operators over a device mesh, against the JAX package.

The JAX side runs on the conftest meshes (``host_mesh`` (4, 2), ``mesh82``
(2, 4)); the port side on meshes of ``torch.device("cpu")`` of the same
shapes, where every shard shares one device, so every exchange must write
to fresh storage.  Inputs are drawn by numpy from seeds.  Bands are the
reference's (tests/test_distributed.py, tests/test_comm_schedule.py), each
on the comparison the reference makes:

* dist FP (psum, ring) vs the in-core FP: rtol = atol = 1e-4; vs the
  reference's dist FP: the kernel band rtol 2e-4, atol 5e-3
  (tests/test_backend.py:23), within which the port's in-core FP agrees
  with the reference's at N=32 (98 of 16384 values differ by more than
  1e-4, at most 1.2e-3, in the in-core FP already);
* dist BP (fdk, none), the 13-angle pad mask, the matched adjoint: rtol
  2e-4, atol 2e-3;
* ``halo_exchange``: element for element;
* the reduction schedules among themselves: 1e-6;
* the dominance split: bit for bit against the both-variants fallback,
  and it builds only the variants used;
* ``recon --mode dist`` on the CPU.

The ``"cuda"`` backend runs its kernels' plain versions here (the tensors
lie on the CPU), so the plumbing around the kernels is what is tested.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.core import distributed as jdist
from repro.core.compat import shard_map
from repro.core.geometry import ConeGeometry as JaxGeometry
from repro.core.operator import CTOperator as JaxOperator
from repro_torch import obs
from repro_torch.core import backend as bk
from repro_torch.core.distributed import (ShardStreams, _reduce_partial,
                                          dist_backproject,
                                          dist_forward_project,
                                          halo_exchange, pad_angles)
from repro_torch.core.geometry import ConeGeometry, circular_angles
from repro_torch.core.operator import CTOperator
from repro_torch.launch import recon
from repro_torch.launch.mesh import (Mesh, make_host_mesh, make_pod_mesh,
                                     pod_device_groups)

GEO = ConeGeometry.nice(32)
JGEO = JaxGeometry.nice(32)
GEO16 = ConeGeometry.nice(16)
ANGLES = circular_angles(16)
BAND_FP = dict(rtol=1e-4, atol=1e-4)
BAND_KERNEL = dict(rtol=2e-4, atol=5e-3)
BAND_BP = dict(rtol=2e-4, atol=2e-3)
CPU8 = ["cpu"] * 8


def _mesh(model_axis):
    return make_host_mesh(model_axis, devices=CPU8)


def _rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def _jax_fp(host_mesh, reduce, seed):
    vol = _rand(seed, GEO.n_voxel)
    fp = jdist.dist_forward_project(host_mesh, JGEO, reduce=reduce)
    with host_mesh:
        return vol, np.asarray(fp(jnp.asarray(vol), jnp.asarray(ANGLES)))


# --------------------------------------------------------------------------
# forward and back projection against the reference's sharded operators
# --------------------------------------------------------------------------

@pytest.mark.parametrize("reduce", ["psum", "ring"])
def test_dist_forward_matches_plain_and_reference(host_mesh, reduce):
    vol, want = _jax_fp(host_mesh, reduce, 0)
    got = dist_forward_project(_mesh(2), GEO, reduce=reduce,
                               backend="cuda")(vol, ANGLES)
    assert got.shape == want.shape and got.device.type == "cpu"
    plain = CTOperator(GEO, ANGLES, backend="cuda", device="cpu").A(vol)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **BAND_FP)
    np.testing.assert_allclose(got.numpy(), want, **BAND_KERNEL)


@pytest.mark.parametrize("weight", ["fdk", "none"])
def test_dist_backproject_matches_plain_and_reference(host_mesh, weight):
    proj = _rand(2, (len(ANGLES),) + GEO.n_detector)
    jbp = jdist.dist_backproject(host_mesh, JGEO, weight=weight)
    with host_mesh:
        want = np.asarray(jbp(jnp.asarray(proj), jnp.asarray(ANGLES)))
    got = dist_backproject(_mesh(2), GEO, weight=weight,
                           backend="cuda")(proj, ANGLES)
    plain = CTOperator(GEO, ANGLES, backend="cuda", device="cpu").At(
        proj, weight=weight)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **BAND_BP)
    np.testing.assert_allclose(got.numpy(), want, **BAND_BP)


def test_pad_angles_matches_reference():
    for angles, multiple in (([0.1, 0.2, 0.3], 4), ([0.1, 0.2], 2),
                             (list(circular_angles(13)), 4)):
        a = np.asarray(angles, np.float32)
        got, want = pad_angles(a, multiple), jdist.pad_angles(a, multiple)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    a, valid = pad_angles(np.asarray([0.1, 0.2, 0.3], np.float32), 4)
    assert len(a) == 4 and valid.tolist() == [True, True, True, False]


def test_operator_dist_consumes_pad_mask(host_mesh):
    """13 angles on a data axis of 4: the padded duplicates neither appear
    in the forward output nor add to the backprojection."""
    angles = circular_angles(13)
    vol = _rand(5, GEO.n_voxel)
    proj = _rand(6, (len(angles),) + GEO.n_detector)
    jop = JaxOperator(JGEO, angles, mode="dist", mesh=host_mesh)
    with host_mesh:
        want_fp = np.asarray(jop.A(jnp.asarray(vol)))
        want_bp = np.asarray(jop.At(jnp.asarray(proj), weight="fdk"))
    op = CTOperator(GEO, angles, mode="dist", mesh=_mesh(2), backend="cuda")
    got_fp = op.A(vol)
    assert got_fp.shape[0] == len(angles)
    plain = CTOperator(GEO, angles, backend="cuda", device="cpu")
    np.testing.assert_allclose(got_fp.numpy(), plain.A(vol).numpy(),
                               **BAND_FP)
    np.testing.assert_allclose(got_fp.numpy(), want_fp, **BAND_KERNEL)
    np.testing.assert_allclose(op.At(proj, weight="fdk").numpy(), want_bp,
                               **BAND_BP)


def test_dist_backproject_matched_is_exact_adjoint():
    """The sharded matched BP equals the plain exact adjoint (padded
    angles included), and pairs with the sharded FP to 1e-4."""
    angles = circular_angles(13)
    proj = _rand(7, (len(angles),) + GEO16.n_detector)
    vol = _rand(8, GEO16.n_voxel)
    want = CTOperator(GEO16, angles, backend="cuda", device="cpu").At(
        proj, weight="matched").numpy()
    op = CTOperator(GEO16, angles, mode="dist", mesh=_mesh(2),
                    backend="cuda")
    aty = op.At(proj, weight="matched")
    np.testing.assert_allclose(aty.numpy(), want, **BAND_BP)
    lhs = float(np.vdot(op.A(vol).numpy().astype(np.float64).ravel(),
                        proj.astype(np.float64).ravel()))
    rhs = float(np.vdot(vol.astype(np.float64).ravel(),
                        aty.numpy().astype(np.float64).ravel()))
    assert abs(lhs - rhs) / max(abs(lhs), abs(rhs)) < 1e-4


def test_dist_equals_in_core_operator():
    """Every weight of the sharded Aᵀ and the sharded A equal the in-core
    operator's within the kernel band, on both backends."""
    geo = GEO16
    vol = _rand(9, geo.n_voxel)
    proj = _rand(10, (len(ANGLES),) + geo.n_detector)
    for backend in ("ref", "cuda"):
        d = CTOperator(geo, ANGLES, mode="dist", mesh=_mesh(2),
                       backend=backend)
        p = CTOperator(geo, ANGLES, backend=backend, device="cpu")
        assert d.data_device == torch.device("cpu") and d.plan.n_devices == 2
        torch.testing.assert_close(d.A(vol), p.A(vol), rtol=2e-4, atol=5e-3)
        for w in ("matched", "pmatched"):
            torch.testing.assert_close(d.At(proj, weight=w),
                                       p.At(proj, weight=w), rtol=2e-4,
                                       atol=5e-3)


# --------------------------------------------------------------------------
# halo exchange and the reduction schedules
# --------------------------------------------------------------------------

def test_halo_exchange_matches_reference(host_mesh):
    n_model, planes, depth = host_mesh.shape["model"], 4, 2
    x = np.arange(n_model * planes * 6, dtype=np.float32).reshape(
        n_model * planes, 2, 3)
    fn = jax.jit(shard_map(lambda xs: jdist.halo_exchange(xs, depth, "model"),
                           mesh=host_mesh, in_specs=P("model", None, None),
                           out_specs=P("model", None, None),
                           check_vma=False))
    with host_mesh:
        want = np.asarray(fn(jnp.asarray(x))).reshape(
            n_model, planes + 2 * depth, 2, 3)
    slabs = list(torch.from_numpy(x).split(planes))
    got = halo_exchange(slabs, depth)
    for j in range(n_model):
        np.testing.assert_array_equal(got[j].numpy(), want[j])
        # fresh storage: an in-place write on one shard reaches no other
        assert got[j].data_ptr() != slabs[j].data_ptr()
    got[0].add_(1.0)
    np.testing.assert_array_equal(slabs[0].numpy(), x[:planes])
    with pytest.raises(ValueError, match="halo depth"):
        halo_exchange(slabs, planes + 1)


def test_dist_reduction_schedules_match(mesh82):
    """ring and hier on 4 model shards give the psum result within 1e-6,
    and the psum result is the reference's within its band."""
    angles = circular_angles(8)
    vol = _rand(5, GEO.n_voxel)
    with mesh82:
        want = np.asarray(jdist.dist_forward_project(
            mesh82, JGEO, reduce="psum", backend="ref")(
                jnp.asarray(vol), jnp.asarray(angles)))
    outs = {r: dist_forward_project(_mesh(4), GEO, reduce=r,
                                    backend="cuda")(vol, angles).numpy()
            for r in ("psum", "ring", "hier")}
    np.testing.assert_allclose(outs["ring"], outs["psum"], rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(outs["hier"], outs["psum"], rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(outs["psum"], want, **BAND_KERNEL)


def _ring_order(j, members):
    """``j``'s own part, then its predecessors among ``members``."""
    i = members.index(j)
    return [members[(i - h) % len(members)] for h in range(len(members))]


def _summed(parts, order):
    out = None
    for m in order:
        out = parts[m] if out is None else out + parts[m]
    return out


@pytest.mark.parametrize("schedule", ["psum", "ring", "hier"])
def test_reduce_partial_follows_the_reference_hops(schedule):
    """The first shard gets the sum in the summation order the reference's
    hop pattern gives it (what the reference's out_specs keeps), in fresh
    storage, through ``n - 1`` copies: only its own chain runs."""
    from repro_torch.core.plan import hier_group_size
    for n in (2, 4, 6):
        parts = [torch.from_numpy(_rand(20 + m, (3, 5))) for m in range(n)]
        shards = ShardStreams(["cpu"] * n)
        copies = []
        copy = shards.copy
        shards.copy = lambda t, src, dst: copies.append((src, dst)) or \
            copy(t, src, dst)
        got = _reduce_partial(parts, schedule, shards, range(n))
        g = hier_group_size(n)
        if schedule == "psum":
            want = _summed(parts, range(n))
        elif schedule == "ring":
            want = _summed(parts, _ring_order(0, list(range(n))))
        else:
            groups = [_summed(parts, _ring_order(
                r, [(r // g) * g + q for q in range(g)]))
                for r in ((-h * g) % n for h in range(n // g))]
            want = _summed(groups, range(len(groups)))
        assert torch.equal(got, want), (schedule, n)
        assert all(got.data_ptr() != p.data_ptr() for p in parts)
        assert len(copies) == n - 1, (schedule, n, copies)
    with pytest.raises(ValueError, match="unknown reduction"):
        _reduce_partial(parts, "tree", shards, range(n))


def test_operators_take_only_a_data_model_mesh():
    """The sharded operators read the mesh's (data, model) grid; a mesh
    with other axes is refused, by the operator too."""
    pod = make_pod_mesh(2, model_axis=2, devices=CPU8)
    with pytest.raises(ValueError, match="a \\(data, model\\) mesh"):
        dist_forward_project(pod, GEO)
    with pytest.raises(ValueError, match="a \\(data, model\\) mesh"):
        CTOperator(GEO, ANGLES, mode="dist", mesh=pod)


# --------------------------------------------------------------------------
# dominance split
# --------------------------------------------------------------------------

def test_dominance_split_matches_both_variants():
    vol = _rand(7, GEO16.n_voxel)
    mesh = _mesh(2)
    split = dist_forward_project(mesh, GEO16, backend="cuda")
    both = dist_forward_project(mesh, GEO16, backend="cuda",
                                dominance_split=False)
    # same kernels on the same shards: the host regrouping moves no bit
    assert torch.equal(split(vol, ANGLES), both(vol, ANGLES))


def test_dominance_split_skips_unused_variant():
    vol = _rand(3, GEO.n_voxel)
    xdom = np.asarray([0.0, 0.1, -0.1, 0.05, 0.2, -0.2, 0.15, -0.05],
                      np.float32)        # all x-dominant
    bk.clear_dispatch_cache()
    dist_forward_project(_mesh(2), GEO, backend="cuda")(vol, xdom)
    fp_keys = [k for k in bk.dispatch_cache_keys() if k[1] == "fp"]
    assert fp_keys, "no FP kernel was built at all"
    assert all(k[3] is True for k in fp_keys), fp_keys


# --------------------------------------------------------------------------
# spans, meshes, the operator's surface, recon --mode dist
# --------------------------------------------------------------------------

def test_dist_spans():
    tracer = obs.Tracer(enabled=True)
    prev = obs.set_tracer(tracer)
    try:
        op = CTOperator(GEO16, ANGLES, mode="dist", mesh=_mesh(2),
                        backend="cuda")
        vol = _rand(11, GEO16.n_voxel)
        op.At(op.A(vol), weight="matched")
        op.At(op.A(vol), weight="fdk")
    finally:
        obs.set_tracer(prev)
    names = [s.name for s in tracer.spans(cat="compute")]
    assert names.count("dist_fp") == 4          # two dominance groups, x2
    assert names.count("dist_bp_matched") == 2 and names.count("dist_bp") == 1
    s = tracer.spans(name="dist_fp")[0]
    assert s.attrs["data_shards"] == 4 and s.attrs["model_shards"] == 2
    assert s.attrs["reduce"] == op.plan.comm.reduction
    assert len(tracer.spans(cat="reduce")) == 2


def test_meshes():
    m = make_host_mesh(2, devices=CPU8)
    assert m.shape == {"data": 4, "model": 2} and m.size == 8
    assert m.axis_names == ("data", "model")
    assert all(d == torch.device("cpu") for d in m.devices.flat)
    with pytest.raises(ValueError, match="model axis of 3"):
        make_host_mesh(3, devices=CPU8)
    pm = make_pod_mesh(2, model_axis=2, devices=CPU8)
    assert pm.shape == {"pod": 2, "data": 2, "model": 2}
    groups = pod_device_groups(pm)
    assert len(groups) == 2 and all(len(g) == 4 for g in groups)
    assert len(pod_device_groups(m)) == 1
    with pytest.raises(ValueError, match="equal pods"):
        make_pod_mesh(3, devices=CPU8)
    with pytest.raises(ValueError, match="not divisible by model_axis"):
        make_pod_mesh(2, model_axis=2, devices=["cpu"] * 6)
    with pytest.raises(ValueError, match="mesh"):
        dist_forward_project(pm, GEO, backend="ref")
    with pytest.raises(ValueError, match="not divisible"):
        dist_backproject(make_host_mesh(3, devices=["cpu"] * 3),
                         GEO.with_voxels((32, 32, 32)), backend="ref")
    with pytest.raises(ValueError, match="all lie on CUDA"):
        ShardStreams([torch.device("cpu"), torch.device("meta")])
    assert isinstance(m, Mesh) and "cpu" in repr(m)


def test_mesh_needs_the_card_unless_given_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_host_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_pod_mesh(1)
    with pytest.raises(ValueError, match="needs a mesh"):
        CTOperator(GEO, ANGLES, mode="dist", device="cpu")


def test_dist_operator_warmup_and_kernel_config():
    bk.clear_dispatch_cache()
    op = CTOperator(GEO, ANGLES, mode="dist", mesh=_mesh(2), backend="cuda")
    op.warmup()
    keys = bk.dispatch_cache_keys()
    # bp_matched's scratch angles under the default budget, then the tile
    # configuration (0: tuning is off)
    assert ("cuda", "bp_matched", GEO, 16, True, 8, 0) in keys
    assert ("cuda", "bp_matched", GEO, 16, False, 8, 0) in keys
    op.warmup("fdk")
    assert ("cuda", "bp", GEO, 16, "fdk", 0) in bk.dispatch_cache_keys()
    assert op.kernel_config() == {"fp.config": 0, "bp_matched.config": 0,
                                  "bp.config": 0, "autotuned": False}


def test_dist_cgls_matches_plain_cgls():
    """The algorithms run unchanged on the dist operator: 3 CGLS
    iterations within 2e-3 of the in-core iterate."""
    from repro_torch.core.algorithms.cgls import cgls
    angles = circular_angles(12)
    geo = ConeGeometry.nice(16)
    proj = CTOperator(geo, angles, backend="cuda", device="cpu").A(
        _rand(12, geo.n_voxel))
    runs = [cgls(proj, geo, angles, n_iter=3,
                 op=CTOperator(geo, angles, backend="cuda", **kw))
            for kw in (dict(device="cpu"),
                       dict(mode="dist", mesh=_mesh(4)))]
    torch.testing.assert_close(runs[1], runs[0], rtol=2e-3, atol=2e-3)


def test_recon_dist_on_the_cpu(capsys):
    recon.main(["--alg", "ossart", "--n", "16", "--angles", "36", "--iters",
                "2", "--mode", "dist", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[recon] ossart N=16 angles=36 iters=2 mode=dist" in out
    res = recon.reconstruct("cgls", n=16, n_angles=12, iters=2, mode="dist",
                            device="cpu", mesh=_mesh(2), verbose=False)
    plain = recon.reconstruct("cgls", n=16, n_angles=12, iters=2,
                              device="cpu", verbose=False)
    assert res.op.bp_weight == "matched" and res.op.mesh.shape["data"] == 4
    torch.testing.assert_close(res.rec, plain.rec, rtol=2e-3, atol=2e-3)
    assert 0.0 < res.rel_err < 1.0
