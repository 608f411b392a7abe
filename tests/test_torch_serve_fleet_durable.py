"""The port's durable fleet against the reference's, on the CPU: the fleet
manifest, ``snapshot_fleet`` / ``drain_fleet`` / ``restore_fleet`` onto a
pod mesh of CPU devices (a mismatched mesh refused; without a mesh the
pods lie on the card, so a host without one raises), ``recover_transfers``,
the export, import and drain rows of the crash matrix
(tests/test_fault_tolerance.py:181-251) over the port's own write seams
(``test_torch_serve_durable.SEAMS``), each package restoring the other's
fleet snapshot, and ``recon.main --pods 2 --device cpu`` with a resume
and the exporters.

Every restored job is held bit for bit against an uninterrupted run of
the port; one resumed from the reference's snapshot within the algorithm
band of the reference's uninterrupted run (rtol = atol = 2e-3,
tests/test_adjoint.py:199)."""

import functools
import json
import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch

import repro.serve as jserve
from repro.core.algorithms import cgls as jcgls
from repro.core.geometry import ConeGeometry as JConeGeometry
from repro.core.splitting import MemoryModel as JMemoryModel
from test_torch_serve_durable import SEAMS, SimulatedKill, kill_at
from repro_torch.checkpoint import PreemptionGuard
from repro_torch.core import phantoms
from repro_torch.core.algorithms.stepwise import get_algorithm
from repro_torch.core.geometry import ConeGeometry, circular_angles
from repro_torch.core.operator import CTOperator
from repro_torch.core.splitting import MemoryModel
from repro_torch.launch import recon
from repro_torch.launch.mesh import make_pod_mesh
from repro_torch.serve import (Autoscaler, AutoscalePolicy, JobStatus,
                               MultiPodDriver, MultiPodScheduler, Pod,
                               PodSpec, ReconJob, drain_pod)
from repro_torch.serve.pool import FLEET_MANIFEST

CPU = torch.device("cpu")
GEO = ConeGeometry.nice(16)
ANGLES = circular_angles(12)
PROJ = phantoms.sphere_projection_analytic(GEO, ANGLES)
KIB = 1024
BAND = dict(rtol=2e-3, atol=2e-3)          # tests/test_adjoint.py:199


def _mem(kib=220):
    return MemoryModel(device_bytes=kib * KIB, usable_fraction=1.0)


def _jmem(kib=220):
    return JMemoryModel(device_bytes=kib * KIB, usable_fraction=1.0)


def _pod(name, kib=220, guard=None):
    return Pod(PodSpec(name, memory=_mem(kib), devices=(CPU,)), guard=guard)


def _job(n_iter=4):
    return ReconJob("cgls", GEO, ANGLES, PROJ, n_iter=n_iter)


def _jjob(n_iter=4):
    return jserve.ReconJob("cgls", JConeGeometry.nice(16), ANGLES, PROJ,
                           n_iter=n_iter)


def _cpu_mesh(pods=2):
    return make_pod_mesh(pods, devices=["cpu"] * pods)


@functools.lru_cache(maxsize=None)
def _solo(n_iter):
    a = get_algorithm("cgls")
    op = CTOperator(GEO, ANGLES, device=CPU)
    st = a.init(PROJ, GEO, ANGLES, op=op)
    for _ in range(n_iter):
        st = a.step(st)
    return a.finalize(st).numpy()


@functools.lru_cache(maxsize=None)
def _ref(n_iter):
    return np.asarray(jcgls(PROJ, JConeGeometry.nice(16), ANGLES,
                            n_iter=n_iter))


def _manifest(root):
    with open(os.path.join(root, FLEET_MANIFEST)) as f:
        return json.load(f)


# --------------------------------------------------------------------------
# the manifest and restore_fleet
# --------------------------------------------------------------------------

def test_fleet_manifest_equals_the_reference(tmp_path):
    """The same fleet in both packages writes the same ``fleet.json``
    (no devices in it), and a directory without one is not a fleet."""
    for mod in (MultiPodScheduler, jserve.MultiPodScheduler):
        with pytest.raises(FileNotFoundError, match="fleet.json"):
            mod.restore_fleet(str(tmp_path / "empty"))
    roots = {}
    for name, pods, job in (
            ("port", [Pod(PodSpec("a", memory=_mem(220), devices=(CPU,))),
                      Pod(PodSpec("b", n_devices=2, memory=_mem(800),
                                  devices=(CPU, CPU), placement="pack",
                                  max_jobs_per_device=3))], _job),
            ("ref", [jserve.Pod(jserve.PodSpec("a", memory=_jmem(220))),
                     jserve.Pod(jserve.PodSpec(
                         "b", n_devices=2, memory=_jmem(800),
                         placement="pack", max_jobs_per_device=3))], _jjob)):
        root = str(tmp_path / name)
        mod = MultiPodScheduler if name == "port" else \
            jserve.MultiPodScheduler
        mps = mod(pods, snapshot_root=root)
        ids = [mps.submit(job(2)) for _ in range(3)]
        mps.snapshot_fleet()
        m = _manifest(root)
        roots[name] = (m["pods"], [m["homes"][j] for j in ids],
                       sorted(m), sorted(os.listdir(os.path.join(root,
                                                                 "pods"))))
    assert roots["port"] == roots["ref"]
    assert roots["port"][0][1]["n_devices"] == 2


def _kill9_restore(mesh_fn, tmp_path, pkg):
    """Kill -9 semantics: an autoscaled fleet snapshotted, then run past
    the snapshot and thrown away; restore_fleet rebuilds membership and
    jobs from the disk alone."""
    root = str(tmp_path / f"fleet-{pkg}")
    if pkg == "port":
        mps = MultiPodScheduler([_pod("seed")], snapshot_root=root,
                                transfer_dir=str(tmp_path / "xp"))
        asc = Autoscaler(mps, [PodSpec("burst", memory=_mem())],
                         AutoscalePolicy(scale_down_backlog_seconds=1e-9),
                         device="cpu")
        job = _job
    else:
        mps = jserve.MultiPodScheduler(
            [jserve.Pod(jserve.PodSpec("seed", memory=_jmem()))],
            snapshot_root=root, transfer_dir=str(tmp_path / "xr"))
        asc = jserve.Autoscaler(
            mps, [jserve.PodSpec("burst", memory=_jmem())],
            jserve.AutoscalePolicy(scale_down_backlog_seconds=1e-9))
        job = _jjob
    jids = [mps.submit(job(5)) for _ in range(4)]
    assert asc.step().direction == "up"
    assert mps.snapshot_fleet() == len(jids)
    mps.autoscaler = None
    for pod in mps.pods_snapshot():
        pod.scheduler.step_quantum()
    mps.snapshot_fleet()
    snap = {j: mps.record(j).iterations_done for j in jids}
    for pod in mps.pods_snapshot():
        pod.scheduler.step_quantum()         # progress past the snapshot
    del mps
    mod = MultiPodScheduler if pkg == "port" else jserve.MultiPodScheduler
    restored = mod.restore_fleet(root, **mesh_fn())
    out = [sorted(p.name for p in restored.pods),
           sorted(jids.index(j) for j in restored.restored_jobs),
           [restored.record(j).iterations_done == snap[j] for j in jids]]
    devices = {str(s.device) for p in restored.pods
               for s in p.pool.slots} if pkg == "port" else None
    restored.run()
    return out, devices, [restored.result(j) for j in jids]


def test_kill9_then_restore_fleet_onto_a_cpu_pod_mesh(tmp_path):
    got, devices, images = _kill9_restore(
        lambda: {"mesh": _cpu_mesh()}, tmp_path, "port")
    want, _, _ = _kill9_restore(dict, tmp_path, "ref")
    assert got == want
    assert got[0] == ["burst-as0", "seed"] and got[1] == [0, 1, 2, 3]
    assert all(got[2]) and devices == {"cpu"}
    for image in images:
        np.testing.assert_array_equal(image, _solo(5))
        np.testing.assert_allclose(image, _ref(5), **BAND)


def test_restore_fleet_refuses_a_mismatched_mesh_and_never_the_cpu(
        tmp_path, monkeypatch):
    root = str(tmp_path / "fleet")
    mps = MultiPodScheduler([_pod("p0"), _pod("p1")], snapshot_root=root)
    mps.submit(_job(3))
    mps.drain_fleet()
    with pytest.raises(ValueError, match="3 pod groups"):
        MultiPodScheduler.restore_fleet(root, mesh=_cpu_mesh(3))
    with pytest.raises(ValueError, match="has 2 devices"):
        MultiPodScheduler.restore_fleet(
            root, mesh=make_pod_mesh(2, devices=["cpu"] * 4))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MultiPodScheduler.restore_fleet(root)
    monkeypatch.undo()
    # the refusals touched nothing: the right mesh restores and finishes
    restored = MultiPodScheduler.restore_fleet(root, mesh=_cpu_mesh())
    restored.run()
    (jid,) = restored.restored_jobs
    np.testing.assert_array_equal(restored.result(jid), _solo(3))


def test_drain_fleet_restore_roundtrip_threaded(tmp_path):
    """The guard fires under the threaded driver: the whole fleet is
    parked and persisted, and a restored fleet finishes bit for bit."""
    root = str(tmp_path / "fleet")
    guard = PreemptionGuard(install_handler=False)
    mps = MultiPodScheduler([_pod("p0", guard=guard),
                             _pod("p1", guard=guard)], steal=False,
                            snapshot_root=root)
    jids = [mps.submit(_job(8)) for _ in range(3)]

    def trigger():
        deadline = time.monotonic() + 60
        while (max(mps.record(j).iterations_done for j in jids) < 1
               and time.monotonic() < deadline):
            time.sleep(0.001)
        guard.trigger()
    killer = threading.Thread(target=trigger)
    killer.start()
    MultiPodDriver(mps).run(timeout=120)
    killer.join()
    done = {j: mps.result(j) for j in jids
            if mps.record(j).status is JobStatus.COMPLETED}
    assert all(mps.record(j).status in (JobStatus.PREEMPTED,
                                        JobStatus.PENDING)
               for j in jids if j not in done)
    restored = MultiPodScheduler.restore_fleet(root, mesh=_cpu_mesh())
    assert set(restored.restored_jobs) == set(jids) - set(done)
    MultiPodDriver(restored).run(timeout=120)
    for j in jids:
        got = done[j] if j in done else restored.result(j)
        np.testing.assert_array_equal(got, _solo(8))


def test_restore_fleet_twice_keeps_homes(tmp_path):
    root = str(tmp_path / "fleet")
    mps = MultiPodScheduler([_pod("p0"), _pod("p1")], snapshot_root=root,
                            transfer_dir=str(tmp_path / "xfer"))
    jid = mps.submit(_job(4))
    home = mps.home(jid)
    mps.run(max_rounds=1)
    mps.drain_fleet()
    r1 = MultiPodScheduler.restore_fleet(root, mesh=_cpu_mesh())
    assert r1.home(jid) == home
    del r1                                   # a second kill, no drain
    r2 = MultiPodScheduler.restore_fleet(root, mesh=_cpu_mesh())
    assert r2.home(jid) == home
    r2.run()
    np.testing.assert_array_equal(r2.result(jid), _solo(4))


# --------------------------------------------------------------------------
# recover_transfers
# --------------------------------------------------------------------------

def _stranded(pkg, tmp):
    """One transfer directory holding every kind of copy a crash leaves:
    an orphan (exported, never imported), a torn export (no spec), a
    consumed one (spec flipped terminal) and a duplicate of a job a pod
    already owns.  Returns (decisions by job index, the fleet, ids)."""
    tdir = os.path.join(tmp, "xfer")
    if pkg == "port":
        pods, job = [_pod("v", 100), _pod("t", 100)], _job
        mod = MultiPodScheduler
    else:
        pods = [jserve.Pod(jserve.PodSpec(n, memory=_jmem(100)))
                for n in ("v", "t")]
        mod, job = jserve.MultiPodScheduler, _jjob
    mps = mod(pods, steal=False, transfer_dir=tdir)
    v, t = pods
    ids = [mps.submit(job(3), pod="v") for _ in range(4)]
    v.scheduler.admit()                      # ids[0] runs, the rest park
    orphan, terminal, dup = ids[1], ids[2], ids[3]
    assert v.scheduler.export_job(orphan, tdir)
    assert v.scheduler.export_job(terminal, tdir)
    spec_path = os.path.join(tdir, "jobs", terminal, "spec.json")
    with open(spec_path) as f:
        spec = json.load(f)
    with open(spec_path, "w") as f:
        json.dump(dict(spec, status="stolen"), f)
    assert v.scheduler.export_job(dup, tdir)
    backup = os.path.join(tmp, "backup")
    shutil.copytree(os.path.join(tdir, "jobs", dup), backup)
    t.scheduler.import_job(tdir, dup)
    shutil.copytree(backup, os.path.join(tdir, "jobs", dup))
    os.makedirs(os.path.join(tdir, "jobs", "torn-export"))
    out = mps.recover_transfers()
    decisions = [[ids.index(j) for j in out["imported"]],
                 sorted(ids.index(j) for j in out["dropped"]),
                 os.path.isdir(os.path.join(tdir, "jobs", "torn-export")),
                 sorted(ids.index(j) for j in mps.recovered_jobs)]
    return decisions, mps, ids


def test_recover_transfers_sorts_every_stranded_copy(tmp_path):
    got, mps, ids = _stranded("port", str(tmp_path / "p"))
    want, _, _ = _stranded("ref", str(tmp_path / "r"))
    assert got == want == [[1], [2, 3], True, [1]]
    mps.run()
    for j in (ids[0], ids[1], ids[3]):
        np.testing.assert_array_equal(mps.result(j), _solo(3))


# --------------------------------------------------------------------------
# the crash matrix: export, import and drain rows over the port's seams
# --------------------------------------------------------------------------

def _fleet(tmp_path, n_iter=4):
    """Two pods with durable snapshots: job 0 running on the victim (one
    quantum of progress), job 1 parked there, both committed to disk by a
    clean fleet snapshot."""
    root, transfer = str(tmp_path / "fleet"), str(tmp_path / "transfer")
    mps = MultiPodScheduler([_pod("v", 100), _pod("t", 100)], steal=False,
                            transfer_dir=transfer, snapshot_root=root)
    jobs = [mps.submit(_job(n_iter), pod="v") for _ in range(2)]
    vict, thief = mps.pods
    vict.scheduler.step_quantum()
    assert mps.snapshot_fleet() == len(jobs)
    return mps, root, transfer, vict, thief, jobs


def _recover_and_check(root, transfer, jobs, baseline, ran, n_iter=4):
    """Disk-only rebuild: every job once, no committed iteration lost,
    nothing replayed that had not run, bit for bit at the end."""
    mps = MultiPodScheduler.restore_fleet(root, transfer_dir=transfer,
                                          mesh=_cpu_mesh())
    for j in jobs:
        owners = [p.name for p in mps.pods if j in p.scheduler.records]
        assert len(owners) == 1, f"job {j} restored on {owners or 'none'}"
        assert baseline[j] <= mps.record(j).iterations_done <= ran[j]
    mps.run()
    for j in jobs:
        np.testing.assert_array_equal(mps.result(j), _solo(n_iter))


def _hand_off(phase):
    """The phase's durable operation on a fresh fleet."""
    def export(mps, vict, thief, transfer, jobs):
        vict.scheduler.export_job(jobs[1], transfer)

    def import_(mps, vict, thief, transfer, jobs):
        thief.scheduler.import_job(transfer, jobs[1])

    def drain(mps, vict, thief, transfer, jobs):
        drain_pod(vict, [thief], transfer, timeout=30.0)
    return {"export": export, "import": import_, "drain": drain}[phase]


@pytest.mark.parametrize("seam", list(SEAMS))
@pytest.mark.parametrize("phase", ["export", "import", "drain"])
def test_crash_matrix(tmp_path, phase, seam):
    """A kill before and after the seam's first write inside the phase
    (the row of tests/test_fault_tolerance.py for each ``when``): the job
    comes back exactly once whether it had moved, was on the wire, or
    never left."""
    for when in ("before", "after"):
        case = tmp_path / when
        mps, root, transfer, vict, thief, jobs = _fleet(case)
        baseline = {j: mps.record(j).iterations_done for j in jobs}
        if phase == "import":
            assert vict.scheduler.export_job(jobs[1], transfer)
        with kill_at(seam, when):
            try:
                _hand_off(phase)(mps, vict, thief, transfer, jobs)
            except SimulatedKill:
                pass
        del mps
        _recover_and_check(root, transfer, jobs, baseline, dict(baseline))


# --------------------------------------------------------------------------
# each package restores the other's fleet snapshot
# --------------------------------------------------------------------------

@pytest.mark.parametrize("direction", ["reference-to-port",
                                       "port-to-reference"])
def test_each_package_restores_the_others_fleet_snapshot(tmp_path,
                                                         direction):
    root = str(tmp_path / "fleet")
    if direction == "reference-to-port":
        src = jserve.MultiPodScheduler(
            [jserve.Pod(jserve.PodSpec(n, memory=_jmem()))
             for n in ("p0", "p1")], snapshot_root=root)
        jids = [src.submit(_jjob(5)) for _ in range(3)]
    else:
        src = MultiPodScheduler([_pod("p0"), _pod("p1")],
                                snapshot_root=root)
        jids = [src.submit(_job(5)) for _ in range(3)]
    src.run(max_rounds=1)
    src.drain_fleet()
    progress = {j: src.record(j).iterations_done for j in jids}
    homes = {j: src.home(j) for j in jids}
    if direction == "reference-to-port":
        dst = MultiPodScheduler.restore_fleet(root, mesh=_cpu_mesh())
    else:
        dst = jserve.MultiPodScheduler.restore_fleet(root)
    assert sorted(dst.restored_jobs) == sorted(jids)
    assert {p.name for p in dst.pods} == {"p0", "p1"}
    assert {j: dst.record(j).iterations_done for j in jids} == progress
    assert {j: dst.home(j) for j in jids} == homes
    assert max(progress.values()) >= 1
    dst.run()
    for j in jids:
        image = np.asarray(dst.result(j))
        np.testing.assert_allclose(image, _ref(5), **BAND)
        np.testing.assert_allclose(image, _solo(5), **BAND)


# --------------------------------------------------------------------------
# recon's CLI: --pods 2 on the CPU
# --------------------------------------------------------------------------

def test_recon_main_resumes_a_fleet_snapshot(tmp_path, capsys):
    """A fleet parked after two rounds is resumed by ``recon.main`` with
    the same --snapshot-dir and finishes bit for bit as an uninterrupted
    direct run of the same data set."""
    from repro_torch.data import make_ct_dataset
    snap = str(tmp_path / "snap")
    vol, angles, proj = make_ct_dataset(GEO, 12, device="cpu")
    mps = MultiPodScheduler([_pod("pod0"), _pod("pod1")],
                            snapshot_root=snap,
                            transfer_dir=str(tmp_path / "xfer"))
    jid = mps.submit(ReconJob("cgls", GEO, angles, proj, n_iter=5))
    mps.run(max_rounds=2)
    assert 0 < mps.record(jid).iterations_done < 5
    mps.drain_fleet()
    del mps
    rec, rel = recon.main(["--alg", "cgls", "--n", "16", "--angles", "12",
                           "--iters", "5", "--pods", "2", "--device", "cpu",
                           "--device-bytes", str(220 * KIB),
                           "--snapshot-dir", snap])
    out = capsys.readouterr().out
    assert f"resuming {jid} on a restored 2-pod fleet" in out
    direct = recon.reconstruct("cgls", n=16, n_angles=12, iters=5,
                               device=CPU, verbose=False)
    np.testing.assert_array_equal(rec, direct.rec.numpy())
    assert rel == pytest.approx(direct.rel_err, abs=1e-6)


def test_recon_main_pods_with_the_exporters(tmp_path, capsys):
    """``--pods 2`` with a snapshot directory, the Prometheus file, the
    calibration report and the live endpoint: the single pod's rel_err to
    the last bit, a fleet manifest, and the calibration, SLO and
    memory-margin families."""
    from repro_torch import obs
    argv = ["--alg", "cgls", "--n", "16", "--angles", "12", "--iters", "3",
            "--device", "cpu"]
    _, single = recon.main(argv)
    prom = str(tmp_path / "recon.prom")
    snap = str(tmp_path / "snap")
    prev = obs.set_tracer(obs.Tracer())
    try:
        rec, rel = recon.main(argv + ["--pods", "2", "--snapshot-dir", snap,
                                      "--prometheus", prom,
                                      "--calibration-report",
                                      "--metrics-port", "0"])
    finally:
        obs.set_tracer(prev)
    out = capsys.readouterr().out
    assert rel == single
    assert "[recon] live metrics at http://127.0.0.1:" in out
    assert "[recon] pod fleet x2: job ran on pod" in out
    report = json.loads(out[out.index("\n{") + 1:out.rindex("}") + 1])
    assert set(report) == {"calibration", "memory", "slo"}
    assert report["calibration"]["samples_by_kind"]["step"] >= 2
    with open(prom) as f:
        text = f.read()
    for fam in ("repro_calibration_samples_total",
                "repro_slo_attainment_ratio", "repro_memory_margin_ratio"):
        assert f"# TYPE {fam} " in text
    assert [p["name"] for p in _manifest(snap)["pods"]] == ["pod0", "pod1"]


def test_recon_refuses_dist_with_pods_and_pins_on_the_cpu():
    with pytest.raises(ValueError, match="cannot be combined with --pods"):
        recon.main(["--mode", "dist", "--pods", "2", "--device", "cpu"])
    with pytest.raises(ValueError, match="--pin-devices"):
        recon.main(["--n", "16", "--angles", "12", "--iters", "1",
                    "--pods", "2", "--pin-devices", "--device", "cpu"])
