"""The port's fleet (``repro_torch.serve.pool`` / ``steal``,
``MultiPodDriver``) against the reference's, on the CPU: pods from pod
meshes of CPU devices, routing by modeled makespan, the work-stealing
cases of tests/test_serve_pods.py, the threaded fleet driver against solo
runs, surfaced pod errors, fleet summaries and retired-pod compaction.

Each decision is taken by both packages on the same sequence, with the
unit costs either cold (the 1.0 s fallback) or injected into both, never
measured: the owning pod, the stolen job ids (by submission index), the
victim and the fleet events must be the same.  Every result of the port
equals its solo run (the algorithm stepped directly on the port's
operator) bit for bit, and the reference's within rtol = atol = 2e-3
(tests/test_adjoint.py:199)."""

import functools
import os
import time
import types

import numpy as np
import pytest
import torch

import repro.obs as jax_obs
import repro.serve as jserve
from repro.core.algorithms import cgls as jcgls
from repro.core.algorithms import ossart as jossart
from repro.core.geometry import ConeGeometry as JConeGeometry
from repro.core.splitting import MemoryModel as JMemoryModel
from repro_torch import obs
from repro_torch import serve
from repro_torch.core import phantoms
from repro_torch.core.algorithms.stepwise import get_algorithm
from repro_torch.core.geometry import ConeGeometry, circular_angles
from repro_torch.core.operator import CTOperator
from repro_torch.core.splitting import MemoryModel
from repro_torch.launch.mesh import (Mesh, make_host_mesh, make_pod_mesh,
                                     pod_device_groups)
from repro_torch.serve import (JobStatus, MultiPodDriver, MultiPodScheduler,
                               Pod, PodSpec, ReconJob, StealPolicy,
                               modeled_job_seconds, pods_from_mesh,
                               steal_pass)
from repro_torch.serve.steal import fleet_units, pod_load, steal_once

CPU = torch.device("cpu")
GEO = ConeGeometry.nice(16)
ANGLES = circular_angles(12)
PROJ = phantoms.sphere_projection_analytic(GEO, ANGLES)
BIG_N, BIG_ANGLES = 32, circular_angles(16)
BIG_PROJ = phantoms.sphere_projection_analytic(ConeGeometry.nice(BIG_N),
                                               BIG_ANGLES)
KIB = 1024
BAND = dict(rtol=2e-3, atol=2e-3)          # tests/test_adjoint.py:199
PARAMS = {"cgls": {}, "ossart": {"subset_size": 4}}


def _port_pod(name, kib=220, devices=1):
    return Pod(PodSpec(name, n_devices=devices,
                       memory=MemoryModel(kib * KIB, 1.0),
                       devices=(CPU,) * devices))


def _ref_pod(name, kib=220, devices=1):
    return jserve.Pod(jserve.PodSpec(name, n_devices=devices,
                                     memory=JMemoryModel(kib * KIB, 1.0)))


#: one namespace per package, so that a scenario is written once
PORT = types.SimpleNamespace(
    serve=serve, obs=obs, pod=_port_pod,
    job=lambda alg="cgls", prio=0, n_iter=2, **kw: ReconJob(
        alg, GEO, ANGLES, kw.pop("projections", PROJ), n_iter=n_iter,
        priority=prio, **{"params": dict(PARAMS.get(alg, {})), **kw}),
    big_job=lambda n_iter: ReconJob(
        "ossart", ConeGeometry.nice(BIG_N), BIG_ANGLES, BIG_PROJ,
        n_iter=n_iter, params={"subset_size": 16}))
REF = types.SimpleNamespace(
    serve=jserve, obs=jax_obs, pod=_ref_pod,
    job=lambda alg="cgls", prio=0, n_iter=2, **kw: jserve.ReconJob(
        alg, JConeGeometry.nice(16), ANGLES, kw.pop("projections", PROJ),
        n_iter=n_iter, priority=prio,
        **{"params": dict(PARAMS.get(alg, {})), **kw}),
    big_job=lambda n_iter: jserve.ReconJob(
        "ossart", JConeGeometry.nice(BIG_N), BIG_ANGLES, BIG_PROJ,
        n_iter=n_iter, params={"subset_size": 16}))


def _pods(pkg, n=2, kib=220, devices=1):
    return [pkg.pod(f"p{i}", kib, devices) for i in range(n)]


@functools.lru_cache(maxsize=None)
def _solo(alg, n_iter):
    """The port's uninterrupted run: the algorithm stepped directly."""
    a = get_algorithm(alg)
    op = CTOperator(GEO, ANGLES, bp_weight=a.default_bp_weight, device=CPU)
    st = a.init(PROJ, GEO, ANGLES, op=op, **PARAMS[alg])
    for _ in range(n_iter):
        st = a.step(st)
    return a.finalize(st).numpy()


@functools.lru_cache(maxsize=None)
def _ref(alg, n_iter):
    fn = jcgls if alg == "cgls" else jossart
    return np.asarray(fn(PROJ, JConeGeometry.nice(16), ANGLES,
                         n_iter=n_iter, **PARAMS[alg]))


def _check_result(image, alg, n_iter):
    np.testing.assert_array_equal(image, _solo(alg, n_iter))
    np.testing.assert_allclose(image, _ref(alg, n_iter), **BAND)


def _traced(pkg, fn):
    """``fn()`` under a fresh tracer of package ``pkg``: (result, events)."""
    tracer = pkg.obs.Tracer(enabled=True)
    prev = pkg.obs.set_tracer(tracer)
    try:
        out = fn()
    finally:
        pkg.obs.set_tracer(prev)
    return out, tracer.events()


def _kinds(events, ids):
    """(kind, job index, pod) of every fleet event."""
    return [(e.name, ids.index(e.attrs["job"]) if e.attrs.get("job") in ids
             else None, e.attrs.get("pod")) for e in events]


# --------------------------------------------------------------------------
# pods from meshes
# --------------------------------------------------------------------------

def test_pods_from_mesh_and_device_groups(monkeypatch):
    """A pod mesh of CPU devices gives one pod per pod index, each slot
    on its device; a mesh without a pod axis is one pod; the groups are
    the reference's; a pod without pins lies on the card and raises
    without one (it never falls back to the CPU)."""
    pods = pods_from_mesh(make_pod_mesh(2, devices=["cpu"] * 4),
                          memory=MemoryModel(220 * KIB, 1.0))
    assert [p.name for p in pods] == ["pod0", "pod1"]
    assert [p.n_devices for p in pods] == [2, 2]
    assert all(s.device == CPU and s.stream is None
               for p in pods for s in p.pool.slots)
    (one,) = pods_from_mesh(make_host_mesh(devices=["cpu"] * 3))
    assert one.n_devices == 3
    from repro.launch.mesh import pod_device_groups as jgroups

    class FakeMesh:
        devices = np.arange(6).reshape(2, 3)
        axis_names = ("pod", "data")
    for names in (("pod", "data"), ("data", "model")):
        FakeMesh.axis_names = names
        assert pod_device_groups(FakeMesh()) == jgroups(FakeMesh())
    grid = np.empty(2, dtype=object)
    grid[:] = [CPU, CPU]
    assert len(pod_device_groups(Mesh(grid.reshape(2, 1),
                                      ("pod", "data")))) == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Pod(PodSpec("unpinned"))


def test_multipod_rejects_duplicate_names_and_empty():
    for pkg in (PORT, REF):
        with pytest.raises(ValueError, match="duplicate"):
            pkg.serve.MultiPodScheduler(_pods(pkg, 1) + _pods(pkg, 1))
        with pytest.raises(ValueError, match="at least one"):
            pkg.serve.MultiPodScheduler([])


# --------------------------------------------------------------------------
# routing by modeled makespan (cold pods: the same units in both)
# --------------------------------------------------------------------------

def _route_oversized(pkg):
    """A 32^3 OS-SART streams in slabs on a 220 KiB pod of three devices
    but is resident on one 8 MiB device: it goes to the big pod."""
    small, big = pkg.pod("small", 220, 3), pkg.pod("big", 8 * KIB)
    mps = pkg.serve.MultiPodScheduler([small, big], steal=False)
    job = pkg.big_job(1)
    costs = [pkg.serve.modeled_job_seconds(job, p) for p in (small, big)]
    jid = mps.submit(job)
    return [mps.owner(jid).name, mps.home(jid), costs]


def _route_balance(pkg):
    mps = pkg.serve.MultiPodScheduler(_pods(pkg), steal=False)
    return [mps.owner(mps.submit(pkg.job(n_iter=4))).name
            for _ in range(4)]


def _route_infeasible(pkg):
    mps = pkg.serve.MultiPodScheduler(_pods(pkg, kib=100), steal=False)
    jid = mps.submit(pkg.job(memory_hint_bytes=10 * 1024 * KIB))
    mps.run(max_rounds=2)
    rec = mps.record(jid)
    return [mps.owner(jid).name, rec.status.value, "exceeds" in rec.error]


def _route_pinned(pkg):
    mps = pkg.serve.MultiPodScheduler(_pods(pkg), steal=False)
    out = [mps.owner(mps.submit(pkg.job(), pod=pin)).name
           for pin in (1, "p0")]
    with pytest.raises(KeyError, match="no pod named"):
        mps.submit(pkg.job(), pod="nope")
    return out


@pytest.mark.parametrize("scenario", [_route_oversized, _route_balance,
                                      _route_infeasible, _route_pinned],
                         ids=["oversized", "balance", "infeasible",
                              "pinned"])
def test_routing_equals_the_reference(scenario):
    got, want = scenario(PORT), scenario(REF)
    assert got == want
    if scenario is _route_oversized:
        assert got[0] == "big" and got[2][1] < got[2][0]
    if scenario is _route_balance:
        assert set(got) == {"p0", "p1"}
    if scenario is _route_infeasible:
        assert got[1:] == ["failed", True]


# --------------------------------------------------------------------------
# work stealing
# --------------------------------------------------------------------------

def _steal_parked(pkg, tmp):
    """Four jobs pinned to pod 0, nothing run yet: a cold steal pass
    moves from the tail while the move does not invert the imbalance."""
    mps = pkg.serve.MultiPodScheduler(_pods(pkg), transfer_dir=tmp)
    ids = [mps.submit(pkg.job(n_iter=3), pod=0) for _ in range(4)]
    (moved, events) = _traced(pkg, mps.steal_pass)
    mps.run()
    return ([ids.index(j) for j in moved], _kinds(events, ids),
            [mps.owner(j).name for j in ids], mps, ids)


def test_steal_moves_parked_jobs_as_the_reference(tmp_path):
    moved, log, owners, mps, ids = _steal_parked(PORT, str(tmp_path / "a"))
    jmoved, jlog, jowners, _, _ = _steal_parked(REF, str(tmp_path / "b"))
    assert (moved, log, owners) == (jmoved, jlog, jowners)
    assert moved == [3, 2] and set(owners) == {"p0", "p1"}
    assert [k for k, _, _ in log] == ["export", "import"] * 2
    m = mps.metrics()
    assert m.stolen_out == m.stolen_in == len(mps.stolen_jobs) == 2
    for j in ids:
        assert mps.record(j).status is JobStatus.COMPLETED
        _check_result(mps.result(j), "cgls", 3)
        # consumed on import: nothing left to resurrect
        assert not os.path.exists(os.path.join(str(tmp_path / "a"),
                                               "jobs", j))


def _steal_preempted(pkg, tmp):
    """A job parked mid-progress (preempted with its checkpoint) is
    stolen and resumes on the thief."""
    pods = _pods(pkg, kib=100)                    # one resident job a pod
    victim = pods[0].scheduler
    a = victim.submit(pkg.job("ossart", n_iter=6))
    victim.run(max_quanta=2)
    hi = victim.submit(pkg.job(prio=9, n_iter=2))
    victim.step_quantum()
    done = victim.records[a].iterations_done
    status = victim.records[a].status.value
    moved = pkg.serve.steal_pass(pods, tmp)
    thief = pods[1].scheduler
    out = [moved == [a], status, done, thief.records[a].iterations_done]
    thief.run()
    victim.run()
    return out, thief.result(a), victim.result(hi)


def test_steal_preempted_job_resumes_on_the_thief(tmp_path):
    got, image, hi = _steal_preempted(PORT, str(tmp_path / "a"))
    want, _, _ = _steal_preempted(REF, str(tmp_path / "b"))
    assert got == want and got[:2] == [True, "preempted"] and got[2] >= 1
    _check_result(np.asarray(image), "ossart", 6)
    _check_result(np.asarray(hi), "cgls", 2)


def _steal_lazy(pkg, tmp):
    pods = _pods(pkg, kib=100)
    busy = pods[0].scheduler.submit(pkg.job(n_iter=2))
    lazy = pods[0].scheduler.submit(pkg.job(projections=lambda: PROJ))
    pods[0].scheduler.admit()
    first = pkg.serve.steal_pass(pods, tmp)         # unresolvable ref
    second = pkg.serve.steal_pass(pods, tmp, data_refs={lazy: lambda: PROJ})
    for p in pods:
        p.scheduler.run()
    return ([first, second == [lazy]], pods[1].scheduler.result(lazy),
            pods[0].scheduler.result(busy))


def test_steal_skips_lazy_jobs_without_data_refs(tmp_path):
    got, lazy, busy = _steal_lazy(PORT, str(tmp_path / "a"))
    assert got == _steal_lazy(REF, str(tmp_path / "b"))[0] == [[], True]
    _check_result(lazy, "cgls", 2)
    _check_result(busy, "cgls", 2)


def _steal_budget(pkg, tmp):
    """Nothing moves that the thief could never hold, nor a job that
    streams in many slabs under the thief's budget and would invert the
    imbalance (the slab-pass multiplier prices it)."""
    out = []
    big, tiny = pkg.pod("big", 8 * KIB), pkg.pod("tiny", 100)
    hold = big.scheduler.submit(pkg.job(memory_hint_bytes=7000 * KIB,
                                        n_iter=1))
    big.scheduler.submit(pkg.job(memory_hint_bytes=5000 * KIB, n_iter=1))
    big.scheduler.admit()
    out.append(pkg.serve.steal_pass([big, tiny], tmp))
    big.scheduler.run()
    out.append(big.scheduler.records[hold].status.value)
    big, small = pkg.pod("big2", 8 * KIB), pkg.pod("small", 220)
    job = pkg.big_job(4)
    out.append(small.scheduler.job_passes(job))
    big.scheduler.submit(pkg.job(memory_hint_bytes=7800 * KIB, n_iter=2))
    big.scheduler.submit(job)
    big.scheduler.admit()
    out.append(pkg.serve.steal_pass([big, small], tmp))
    return out


def test_steal_respects_the_thief_budget_and_slab_cost(tmp_path):
    got = _steal_budget(PORT, str(tmp_path / "a"))
    assert got == _steal_budget(REF, str(tmp_path / "b"))
    assert got[0] == [] and got[1] == "completed"
    assert got[2] > 3.0 and got[3] == []


def _steal_thresholds(pkg, tmp):
    pods = _pods(pkg)
    ids = [pods[0].scheduler.submit(pkg.job(n_iter=2)) for _ in range(3)]
    none = pkg.serve.steal_pass(
        pods, tmp, policy=pkg.serve.StealPolicy(min_imbalance_seconds=1e9))
    kept = pkg.serve.steal_pass(
        pods, tmp, policy=pkg.serve.StealPolicy(min_victim_queue_after=2,
                                                max_jobs_per_pass=8))
    return [none, [ids.index(j) for j in kept],
            len(pods[0].scheduler.steal_candidates())]


def test_steal_policy_thresholds(tmp_path):
    got = _steal_thresholds(PORT, str(tmp_path / "a"))
    assert got == _steal_thresholds(REF, str(tmp_path / "b"))
    assert got[0] == [] and len(got[1]) <= 1 and got[2] >= 2


def test_steal_import_failure_reclaims_the_job(tmp_path, monkeypatch):
    """The thief's import fails after the export: the victim re-adopts
    the job and the steal accounting cancels out."""
    victim, thief = _pods(PORT, kib=100)
    hold = victim.scheduler.submit(PORT.job(n_iter=2))
    parked = victim.scheduler.submit(PORT.job(n_iter=2))
    victim.scheduler.admit()

    def broken_import(transfer_dir, job_id, data_refs=None):
        raise OSError("transfer mount gone")

    monkeypatch.setattr(thief.scheduler, "import_job", broken_import)
    assert steal_once(victim, thief, str(tmp_path)) is None
    assert parked in victim.scheduler.records
    m = victim.scheduler.metrics
    assert m.stolen_out == 0 and m.stolen_in == 0
    victim.scheduler.run()
    for jid in (hold, parked):
        _check_result(victim.scheduler.result(jid), "cgls", 2)


def _unit_skew(pkg, tmp):
    """A warm pod (EMAs injected) full of parked work and a cold idle
    one: routing and stealing compare both on one unit scale, so the
    cold pod takes the next job and is the thief."""
    warm, cold = _pods(pkg)
    held = [warm.scheduler.submit(pkg.job(n_iter=4)) for _ in range(4)]
    warm.scheduler.admit()
    warm.scheduler._step_ema, warm.scheduler._init_ema = 0.01, 0.02
    unit, init = pkg.serve.steal.fleet_units([warm, cold])
    loads = [pkg.serve.steal.pod_load(p.scheduler, 1, unit=unit, init=init)
             for p in (warm, cold)]
    mps = pkg.serve.MultiPodScheduler([warm, cold], transfer_dir=tmp)
    routed = mps.submit(pkg.job(n_iter=2))
    ids = held + [routed]
    moved = mps.steal_pass()
    out = [loads, mps.owner(routed).name, [ids.index(j) for j in moved],
           all(j in cold.scheduler.records for j in moved)]
    mps.run()
    return out, [mps.result(j) for j in ids]


def test_route_and_steal_share_one_unit_scale(tmp_path):
    got, images = _unit_skew(PORT, str(tmp_path / "a"))
    assert got == _unit_skew(REF, str(tmp_path / "b"))[0]
    assert got[0][0] > got[0][1] and got[1] == "p1" and got[3]
    for image, n_iter in zip(images, (4, 4, 4, 4, 2)):
        _check_result(image, "cgls", n_iter)


def _pinned_pairing(pkg, tmp):
    """Equal injected unit costs: pod a holds two 4-iteration jobs, pod b
    one 1-iteration job; the pass moves from a only, never b's own job
    back (the pairing is pinned for the pass)."""
    a, b = _pods(pkg, kib=800)
    a_jobs = [a.scheduler.submit(pkg.job(n_iter=4)) for _ in range(2)]
    tiny = b.scheduler.submit(pkg.job(n_iter=1))
    a.scheduler._step_ema = b.scheduler._step_ema = 1.0
    moved = pkg.serve.steal_pass([a, b], tmp)
    out = [[a_jobs.index(j) for j in moved], tiny in b.scheduler.records]
    for pod in (a, b):
        pod.scheduler.run()
    images = [(a if j in a.scheduler.records else b).scheduler.result(j)
              for j in a_jobs]
    return out, images


def test_steal_pass_pins_its_pairing(tmp_path):
    got, images = _pinned_pairing(PORT, str(tmp_path / "a"))
    assert got == _pinned_pairing(REF, str(tmp_path / "b"))[0]
    assert got[0] and got[1]
    for image in images:
        _check_result(image, "cgls", 4)


def test_no_device_tensor_crosses_pods(tmp_path):
    """A job submitted with a tensor of projections reaches the thief as
    what the transfer directory holds (a host array read back), never as
    the victim's tensor."""
    pods = _pods(PORT)
    tensor = torch.from_numpy(PROJ.copy())
    ids = [pods[0].scheduler.submit(PORT.job(n_iter=2, projections=tensor))
           for _ in range(3)]
    moved = steal_pass(pods, str(tmp_path))
    assert moved
    for j in moved:
        got = pods[1].scheduler.records[j].job.projections
        assert isinstance(got, np.ndarray) and got is not PROJ
        np.testing.assert_array_equal(got, PROJ)
    for p in pods:
        p.scheduler.run()
    for j in ids:
        owner = pods[1] if j in moved else pods[0]
        _check_result(owner.scheduler.result(j), "cgls", 2)


# --------------------------------------------------------------------------
# the threaded fleet driver
# --------------------------------------------------------------------------

def test_multipod_driver_steals_and_matches_solo_runs(tmp_path):
    mps = MultiPodScheduler(_pods(PORT), transfer_dir=str(tmp_path))
    jids = [mps.submit(PORT.job(n_iter=3), pod=0) for _ in range(6)]
    MultiPodDriver(mps).run(timeout=300)
    assert mps.idle
    for j in jids:
        assert mps.record(j).status is JobStatus.COMPLETED
        _check_result(mps.result(j), "cgls", 3)
    s = mps.summary()
    assert s["completed"] == s["submitted"] == 6
    assert s["stolen_in"] == s["stolen_out"] == len(mps.stolen_jobs)
    assert set(s["pods"]) == {"p0", "p1"}


@pytest.mark.parametrize("where", ["steal-pass", "pod-driver"])
def test_multipod_driver_surfaces_errors(monkeypatch, tmp_path, where):
    """An internal error of the control thread or of one pod's driver
    stops the whole fleet and is raised from run()."""
    mps = MultiPodScheduler(_pods(PORT), transfer_dir=str(tmp_path))
    mps.submit(PORT.job(n_iter=50), pod=0)

    def broken(*a, **k):
        raise OSError("transfer filesystem gone")

    if where == "steal-pass":
        monkeypatch.setattr(mps, "steal_pass", broken)
    else:
        monkeypatch.setattr(mps.pods[1].scheduler, "admit", broken)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="internal error"):
        MultiPodDriver(mps).run(timeout=120)
    assert time.monotonic() - t0 < 60


# --------------------------------------------------------------------------
# fleet summaries and retired-pod compaction
# --------------------------------------------------------------------------

def _summary(pkg):
    mps = pkg.serve.MultiPodScheduler(_pods(pkg), steal=False,
                                      retired_pod_ttl_seconds=0.0)
    for p in ("p0", "p1"):
        mps.submit(pkg.job(n_iter=1), pod=p)
    mps.run()
    mps.remove_pod("p1")
    s = mps.summary()
    return s, mps


def test_fleet_summary_and_compaction_as_the_reference():
    s, mps = _summary(PORT)
    js, _ = _summary(REF)
    assert set(s) == set(js)
    assert set(s["pods"]) == set(js["pods"]) == {"p0"}
    assert s["retired_pods"]["p1"]["compacted"] is True
    for key in ("completed", "submitted", "jobs_stolen",
                "scale_down_events"):
        assert s[key] == js[key]
    assert not mps.retired_pods and len(mps.retired_summaries) == 1
    with pytest.raises(ValueError, match="already used"):
        mps.add_pod(_port_pod("p1"))


def test_retired_pod_keeps_results_until_its_ttl():
    mps = MultiPodScheduler(_pods(PORT), steal=False,
                            retired_pod_ttl_seconds=0.05)
    jids = [mps.submit(PORT.job(n_iter=1), pod=p) for p in ("p0", "p1")]
    mps.run()
    mps.remove_pod("p1")
    assert mps.compact_retired() == 0
    _check_result(mps.result(jids[1]), "cgls", 1)
    time.sleep(0.06)
    assert mps.compact_retired() == 1
    assert mps.retired_summaries[0].job_statuses[jids[1]] == "completed"
    assert mps.metrics().completed == 2
    with pytest.raises(KeyError, match="compacted"):
        mps.result(jids[1])
    with pytest.raises(KeyError, match="unknown job"):
        mps.owner("never-submitted")
    unit, init = fleet_units(mps.pods)
    assert pod_load(mps.pods[0].scheduler, 1, unit=unit, init=init) == 0.0
    assert modeled_job_seconds(PORT.job(n_iter=2), mps.pods[0]) > 0
    assert StealPolicy().max_jobs_per_pass == 16
