"""The port's durable serving state against the reference's, on the CPU:
checkpoints (round trip, the manifest, each package restoring the
other's), scheduler snapshots and restore, export / import between
schedulers, a snapshot written by the reference's scheduler resumed by
the port's, the threaded driver killed and rebuilt, the single-pod crash
matrix of tests/test_fault_tolerance.py:158 over the port's own write
seams, and ``recon.main`` resuming a job a SIGTERM parked.

Every resumed run is held bit for bit against an uninterrupted run of the
port; a run resumed from the reference's state within the algorithm band
of the reference's uninterrupted run (rtol = atol = 2e-3,
tests/test_adjoint.py:199).
"""

import contextlib
import functools
import importlib
import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint as jckpt
import repro.serve as jserve
from repro.core.geometry import ConeGeometry as JConeGeometry
from repro.core.splitting import MemoryModel as JMemoryModel
from repro_torch.checkpoint import (CheckpointManager, PreemptionGuard,
                                    latest_step, manifest_target,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.core import phantoms
from repro_torch.core.algorithms.stepwise import get_algorithm
from repro_torch.core.geometry import ConeGeometry, circular_angles
from repro_torch.core.operator import CTOperator
from repro_torch.core.splitting import MemoryModel
from repro_torch.launch import recon
from repro_torch.serve import (AsyncDriver, DevicePool, JobExecutor,
                               JobStatus, ReconJob, Scheduler)

CPU = torch.device("cpu")
GEO = ConeGeometry.nice(16)
JGEO = JConeGeometry.nice(16)
ANGLES = circular_angles(12)
PROJ = phantoms.sphere_projection_analytic(GEO, ANGLES)
KIB = 1024
BAND = dict(rtol=2e-3, atol=2e-3)          # tests/test_adjoint.py:199


def _mem(kib=100):
    return MemoryModel(device_bytes=kib * KIB, usable_fraction=1.0)


def _sched(kib=100, n=1, **kw):
    return Scheduler(pool=DevicePool(n, _mem(kib), devices=[CPU] * n), **kw)


def _job(alg="cgls", n_iter=4, **kw):
    if alg == "ossart":
        kw.setdefault("params", {"subset_size": 4})
    return ReconJob(alg, GEO, ANGLES, PROJ, n_iter=n_iter, **kw)


@functools.lru_cache(maxsize=None)
def _solo(alg, n_iter):
    """Uninterrupted run of the port: the algorithm stepped directly."""
    a = get_algorithm(alg)
    op = CTOperator(GEO, ANGLES, bp_weight=a.default_bp_weight, device=CPU)
    st = a.init(PROJ, GEO, ANGLES, op=op,
                **({"subset_size": 4} if alg == "ossart" else {}))
    for _ in range(n_iter):
        st = a.step(st)
    return a.finalize(st).numpy()


def _wait_for(cond, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.001)


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------

def _tree(bf16):
    """The same tree for both packages: ``bf16`` makes its bfloat16 leaf."""
    rng = np.random.default_rng(1)
    return {"state.x": rng.standard_normal((3, 4)).astype(np.float32),
            "angles": np.arange(5, dtype=np.float32),
            "it": 3, "lmbda": 0.5, "flag": True,
            "nested": {"b": [np.arange(4, dtype=np.int64), 7],
                       "a": bf16(np.linspace(-2, 2, 6, dtype=np.float32))}}


def _torch_bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16)


def _jax_bf16(x):
    return jnp.asarray(x, jnp.bfloat16)


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


def test_checkpoint_round_trip_commit_and_gc(tmp_path):
    d = str(tmp_path / "ck")
    tree = _tree(_torch_bf16)
    tree["dev"] = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    for step in (1, 2, 3, 4):
        save_checkpoint(d, step, tree, keep=2)
    assert latest_step(d) == 4
    assert sorted(os.listdir(d)) == ["step_00000003", "step_00000004"]
    os.makedirs(os.path.join(d, "step_00000009.tmp"))       # never committed
    os.makedirs(os.path.join(d, "step_00000008"))            # no COMMIT
    assert latest_step(d) == 4
    got = restore_checkpoint(d, 4, tree)
    np.testing.assert_array_equal(got["state.x"], tree["state.x"])
    np.testing.assert_array_equal(got["dev"], tree["dev"].numpy())
    assert got["nested"]["a"].dtype == torch.bfloat16
    assert torch.equal(got["nested"]["a"], tree["nested"]["a"])
    assert int(got["it"]) == 3 and bool(got["flag"])
    on = restore_checkpoint(d, 4, tree, device=CPU)
    assert isinstance(on["nested"]["b"][0], torch.Tensor)
    assert torch.equal(on["nested"]["b"][0], torch.arange(4))
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(d, 4, dict(tree, dev=torch.zeros(3, 2)))
    with pytest.raises(KeyError):
        restore_checkpoint(d, 4, dict(tree, extra=np.zeros(1)))
    with pytest.raises(ValueError, match="flat"):
        manifest_target(d, 4)


def test_manifest_equals_the_reference(tmp_path):
    """The same tree saved by both packages: the same leaf keys (JAX's
    ``keystr``), files, shapes and dtypes."""
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "ref")
    save_checkpoint(ours, 7, _tree(_torch_bf16))
    jckpt.save_checkpoint(theirs, 7, _tree(_jax_bf16))
    got, want = _manifest(ours, 7), _manifest(theirs, 7)
    assert got == want
    flat, _ = jax.tree_util.tree_flatten_with_path(_tree(_jax_bf16))
    assert sorted(got["leaves"]) == sorted(jax.tree_util.keystr(p)
                                           for p, _ in flat)
    assert got["leaves"]["['nested']['a']"]["dtype"] == "bfloat16"


@pytest.mark.parametrize("direction", ["reference-to-port",
                                       "port-to-reference"])
def test_each_package_restores_the_others_checkpoint(tmp_path, direction):
    d = str(tmp_path / "ck")
    if direction == "reference-to-port":
        jckpt.save_checkpoint(d, 5, _tree(_jax_bf16))
        got = restore_checkpoint(d, 5, _tree(_torch_bf16))
        bf = got["nested"]["a"].view(torch.int16).numpy()
    else:
        save_checkpoint(d, 5, _tree(_torch_bf16))
        got = jckpt.restore_checkpoint(d, 5, _tree(_jax_bf16))
        bf = np.asarray(got["nested"]["a"]).view(np.int16)
    want = _tree(np.asarray)
    np.testing.assert_array_equal(got["state.x"], want["state.x"])
    np.testing.assert_array_equal(got["nested"]["b"][0],
                                  want["nested"]["b"][0])
    assert int(got["nested"]["b"][1]) == 7 and float(got["lmbda"]) == 0.5
    np.testing.assert_array_equal(
        bf, np.asarray(_jax_bf16(want["nested"]["a"])).view(np.int16))


def test_checkpoint_manager_keeps_one_write_outstanding(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=2)
    x = torch.zeros(4)
    for step in range(3):
        x.add_(1.0)
        mgr.save(step, {"x": x})          # a host copy: later adds unseen
        assert mgr._thread is not None
    mgr.wait()
    assert mgr._thread is None and mgr.last_saved == 2
    step, got = mgr.restore_latest({"x": x}, device=CPU)
    assert step == 2 and torch.equal(got["x"], torch.full((4,), 3.0))


# --------------------------------------------------------------------------
# scheduler snapshots, restore, export / import
# --------------------------------------------------------------------------

def test_guard_drains_durably_and_a_fresh_scheduler_resumes(tmp_path):
    """A SIGTERM-equivalent under the threaded driver parks and persists
    the running job; a fresh scheduler restores it and finishes bit for
    bit; completion stales the snapshot out."""
    d = str(tmp_path / "snap")
    guard = PreemptionGuard(install_handler=False)
    sched = _sched(220, guard=guard, snapshot_dir=d)
    jid = sched.submit(_job(n_iter=8))
    killer = threading.Thread(target=lambda: (_wait_for(
        lambda: sched.records[jid].iterations_done >= 1), guard.trigger()))
    killer.start()
    AsyncDriver(sched).run(timeout=120)
    killer.join(timeout=60)
    assert not killer.is_alive()
    rec = sched.records[jid]
    assert rec.status is JobStatus.PREEMPTED and rec.checkpoint is not None
    assert 1 <= rec.iterations_done < 8
    fresh = _sched(220, snapshot_dir=d)
    assert fresh.restore(d) == 1
    assert fresh.records[jid].iterations_done == rec.iterations_done
    fresh.run()
    np.testing.assert_array_equal(fresh.result(jid), _solo("cgls", 8))
    assert _sched(220).restore(d) == 0


def test_export_and_import_between_schedulers(tmp_path):
    transfer = str(tmp_path / "transfer")
    src, dst = _sched(100, snapshot_dir=str(tmp_path / "snap")), _sched(100)
    busy = src.submit(_job(n_iter=3))
    parked = src.submit(_job("ossart", n_iter=3))
    src.step_quantum()
    assert src.records[parked].status is JobStatus.PENDING
    with pytest.raises(ValueError, match="aliases"):
        src.export_job(parked, str(tmp_path / "snap"))
    assert not src.export_job(busy, transfer)            # running: never
    assert src.export_job(parked, transfer)
    assert parked not in src.records and src.metrics.stolen_out == 1
    assert dst.import_job(transfer, parked) == parked
    assert not os.path.exists(os.path.join(transfer, "jobs", parked))
    with pytest.raises(ValueError, match="no resumable job"):
        dst.import_job(transfer, parked)
    src.run()
    dst.run()
    np.testing.assert_array_equal(src.result(busy), _solo("cgls", 3))
    np.testing.assert_array_equal(dst.result(parked), _solo("ossart", 3))


def test_reference_snapshot_resumes_on_the_port(tmp_path):
    """A CGLS job snapshotted by the reference's scheduler after one
    quantum finishes on the port's, within the band of the reference's
    uninterrupted run; the reference's backend names map to the port's
    ("pallas": the CUDA kernels), and an unknown one is refused."""
    d = str(tmp_path / "snap")
    jsched = jserve.Scheduler(n_devices=1, memory=JMemoryModel(
        device_bytes=220 * KIB, usable_fraction=1.0))
    jid = jsched.submit(jserve.ReconJob("cgls", JGEO, ANGLES, PROJ,
                                        n_iter=4, backend="ref"))
    jsched.step_quantum()
    assert jsched.snapshot(d) == 1                   # a live snapshot
    jsched.run()
    want = np.asarray(jsched.result(jid))
    spec_path = os.path.join(d, "jobs", jid, "spec.json")
    with open(spec_path) as f:
        spec = json.load(f)
    assert spec["status"] == "running" and spec["backend"] == "ref"
    for backend in ("tpu-magic", "pallas"):
        with open(spec_path, "w") as f:
            json.dump(dict(spec, backend=backend), f)
        if backend == "tpu-magic":
            with pytest.raises(ValueError, match="does not know"):
                _sched(220).restore(d)
    port = _sched(220)
    assert port.restore(d) == 1
    rec = port.records[jid]
    assert rec.iterations_done == 1 and rec.job.backend == "cuda"
    assert rec.status is JobStatus.PREEMPTED
    port.run()
    assert rec.status is JobStatus.COMPLETED, rec.error
    np.testing.assert_allclose(port.result(jid), want, **BAND)


def test_async_driver_kill_and_rebuild_is_bit_identical(tmp_path):
    """Stop the threaded driver mid-run (periodic live snapshots on),
    throw the scheduler away, rebuild a fresh one from disk alone and
    finish: bit-identical to uninterrupted runs, progress never behind
    the last snapshot."""
    d = str(tmp_path / "snap")
    s1 = _sched(100, snapshot_dir=d)                 # one resident at a time
    a, b = s1.submit(_job("ossart", n_iter=6)), s1.submit(_job(n_iter=5))
    driver = AsyncDriver(s1, snapshot_every_seconds=1e-3)
    driver.start()
    _wait_for(lambda: s1.records[a].iterations_done >= 2)
    driver.stop()                                    # "kill -9" at a boundary
    s1.snapshot(d)
    ran = {j: s1.records[j].iterations_done for j in (a, b)}
    s2 = _sched(100, snapshot_dir=d)
    n = s2.restore(d)
    assert n == sum(not s1.records[j].done for j in (a, b)) >= 1
    for j in s2.records:
        assert s2.records[j].iterations_done == ran[j]
    AsyncDriver(s2).run(timeout=120)
    for j, want in ((a, _solo("ossart", 6)), (b, _solo("cgls", 5))):
        src = s2 if j in s2.records else s1
        np.testing.assert_array_equal(src.result(j), want)
    assert _sched(100).restore(d) == 0


def test_cancel_truncation_and_lazy_refs_on_restore(tmp_path):
    """A cancelled job is staled out; a truncated snapshot and a lazy job
    without its data ref are refused loudly; with the ref it resumes."""
    d = str(tmp_path / "snap")
    sched = _sched(100, snapshot_dir=d)
    busy = sched.submit(_job(n_iter=3))
    victim = sched.submit(_job(n_iter=2))
    lazy = sched.submit(ReconJob("cgls", GEO, ANGLES, lambda: PROJ,
                                 n_iter=3))
    sched.step_quantum()
    assert sched.snapshot(d, include_running=False) == 2
    assert sched.cancel(victim)
    sched.drain(d)
    with pytest.raises(ValueError, match="lazy"):
        _sched(100).restore(d)
    fresh = _sched(100)
    assert fresh.restore(d, data_refs={lazy: lambda: PROJ}) == 2
    assert victim not in fresh.records
    fresh.run()
    np.testing.assert_array_equal(fresh.result(busy), _solo("cgls", 3))
    np.testing.assert_array_equal(fresh.result(lazy), _solo("cgls", 3))
    # a live spec whose committed step vanished
    d2 = str(tmp_path / "snap2")
    s = _sched(100)
    s.submit(_job(n_iter=3, job_id="trunc"))
    s.step_quantum()
    s.snapshot(d2)
    job_dir = os.path.join(d2, "jobs", "trunc")
    for step in os.listdir(job_dir):
        if step.startswith("step_"):
            os.remove(os.path.join(job_dir, step, "COMMIT"))
    with pytest.raises(ValueError, match="truncated"):
        _sched(100).restore(d2)


# --------------------------------------------------------------------------
# the crash matrix over the port's write seams
# --------------------------------------------------------------------------

#: the port's write seams (tests/faultpoints.py names the reference's):
#: seam -> (module holding the attribute, attribute)
SEAMS = {
    "save-checkpoint": ("repro_torch.serve.scheduler", "save_checkpoint"),
    "step-commit": ("repro_torch.checkpoint.sharded", "_write_commit"),
    "step-publish": ("repro_torch.checkpoint.sharded", "_publish"),
    "spec-write": ("repro_torch.serve.scheduler", "_atomic_write_json"),
    "spec-stale": ("repro_torch.serve.scheduler", "_set_spec_status"),
}
POINTS = [(seam, when) for seam in SEAMS for when in ("before", "after")]


class SimulatedKill(BaseException):
    """A crash at a seam; ``BaseException`` so that no ``except
    Exception`` of the code under test absorbs it."""


@contextlib.contextmanager
def kill_at(seam, when):
    """The seam's first call inside the context raises
    :class:`SimulatedKill`, before or after doing its write."""
    mod = importlib.import_module(SEAMS[seam][0])
    attr = SEAMS[seam][1]
    orig = getattr(mod, attr)
    fired = []

    def crash_site(*args, **kwargs):
        if fired:
            return orig(*args, **kwargs)
        fired.append(True)
        if when == "after":
            orig(*args, **kwargs)
        raise SimulatedKill(f"{seam}:{when}")

    setattr(mod, attr, crash_site)
    try:
        yield fired
    finally:
        setattr(mod, attr, orig)


@pytest.mark.parametrize("seam,when", POINTS,
                         ids=[f"{s}:{w}" for s, w in POINTS])
def test_crash_matrix_snapshot(tmp_path, seam, when):
    """Kill inside a periodic snapshot (running jobs included): a
    disk-only restore holds every job once, loses no committed iteration,
    replays nothing that had not run, and finishes bit for bit."""
    d = str(tmp_path / "snap")
    sched = _sched(220, snapshot_dir=d)
    jobs = [sched.submit(_job(n_iter=4)) for _ in range(2)]
    sched.step_quantum()
    baseline = {j: sched.records[j].iterations_done for j in jobs}
    assert sched.snapshot(d) >= 1                    # clean durable baseline
    sched.step_quantum()
    with kill_at(seam, when):
        try:
            sched.snapshot(d)
        except SimulatedKill:
            pass
    ran = {j: sched.records[j].iterations_done for j in jobs}
    fresh = _sched(220)
    assert fresh.restore(d) == len(jobs)
    for j in jobs:
        assert baseline[j] <= fresh.records[j].iterations_done <= ran[j]
    fresh.run()
    for j in jobs:
        np.testing.assert_array_equal(fresh.result(j), _solo("cgls", 4))


# --------------------------------------------------------------------------
# recon's CLI: a SIGTERM-parked job resumes from --snapshot-dir
# --------------------------------------------------------------------------

def test_recon_main_resumes_a_guard_parked_job(tmp_path, monkeypatch, capsys):
    d = str(tmp_path / "snap")
    argv = ["--alg", "cgls", "--n", "16", "--angles", "12", "--iters", "4",
            "--device", "cpu", "--snapshot-dir", d]
    guards = []

    class Guard(PreemptionGuard):
        def __init__(self):
            super().__init__(install_handler=False)
            guards.append(self)

    step = JobExecutor.step

    def step_then_sigterm(self):
        n = step(self)
        guards[-1].trigger()            # SIGTERM after the first step
        return n

    monkeypatch.setattr(recon, "PreemptionGuard", Guard)
    monkeypatch.setattr(JobExecutor, "step", step_then_sigterm)
    assert recon.main(argv) == (None, None)
    out = capsys.readouterr().out
    assert "preempted after" in out and d in out
    monkeypatch.setattr(JobExecutor, "step", step)
    rec, rel = recon.main(argv)
    out = capsys.readouterr().out
    assert "resuming job-" in out
    assert "[recon] cgls N=16 angles=12 iters=4 mode=auto" in out
    direct = recon.reconstruct("cgls", n=16, n_angles=12, iters=4,
                               device=CPU, verbose=False)
    np.testing.assert_array_equal(rec, direct.rec.numpy())
    assert rel == pytest.approx(direct.rel_err, abs=1e-6)


def test_recon_main_traces_the_scheduled_job(tmp_path, capsys):
    """``--trace`` writes a Chrome trace that holds the job's fleet events
    (submit, place, admit, a step per iteration, complete)."""
    from repro_torch import obs
    path = str(tmp_path / "trace.json")
    prev = obs.set_tracer(obs.Tracer())
    try:
        rec, rel = recon.main(["--alg", "ossart", "--n", "16", "--angles",
                               "16", "--iters", "2", "--device", "cpu",
                               "--trace", path])
    finally:
        obs.set_tracer(prev)
    assert "chrome trace ->" in capsys.readouterr().out
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e["name"] for e in events if e["ph"] == "i"]    # instants
    for kind in ("submit", "place", "admit", "complete"):
        assert names.count(kind) == 1, kind
    assert names.count("step") == 2 and 0.0 < rel < 1.0
    assert any(e["ph"] == "X" and e["name"] == "step" for e in events)
