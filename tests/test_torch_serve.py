"""The port's serving layer (``repro_torch.serve``) against the reference's
(``repro.serve``), on the CPU: queue order and cancellation, the metrics,
the footprint and cost model, the scheduler's decisions (placement,
victims, statuses, the fleet event log) on the same sequence, results
bit-identical to solo runs and within the algorithm band of the
reference's, weighted fair share, deadline admission under injected
clocks, and the isolation of a bad tenant.

Band: the algorithm iterates, rtol = atol = 2e-3 (tests/test_adjoint.py:199).
Deadline admission is driven by injected step-cost EMAs and a fake clock,
never by measured times.
"""

import functools

import numpy as np
import pytest
import torch

import repro.obs as jax_obs
import repro.serve as jserve
import repro.serve.scheduler as jsched_mod
from repro.core.geometry import ConeGeometry as JConeGeometry
from repro.core.splitting import MemoryModel as JMemoryModel
from repro_torch import obs
from repro_torch.core import phantoms
from repro_torch.core.algorithms.stepwise import get_algorithm
from repro_torch.core.geometry import ConeGeometry, circular_angles
from repro_torch.core.operator import CTOperator
from repro_torch.core.splitting import MemoryModel
from repro_torch.serve import (AsyncDriver, DevicePool, JobExecutor,
                               JobStatus, PriorityJobQueue, ReconJob,
                               Scheduler, ServeMetrics,
                               estimate_job_footprint, merge_metrics,
                               percentile)
from repro_torch.serve import executor as executor_mod
from repro_torch.serve import scheduler as sched_mod
from repro_torch.serve.job import JobRecord
from repro_torch.serve.scheduler import modeled_step_passes

CPU = torch.device("cpu")
GEO = ConeGeometry.nice(16)
JGEO = JConeGeometry.nice(16)
ANGLES = circular_angles(12)
PROJ = phantoms.sphere_projection_analytic(GEO, ANGLES)
KIB = 1024
BAND = dict(rtol=2e-3, atol=2e-3)          # tests/test_adjoint.py:199
PARAMS = {"cgls": {}, "ossart": {"subset_size": 4},
          "fista": {"tv_iters": 3, "L": 100.0},   # fixed L: no power it.
          "asd_pocs": {"subset_size": 4, "tv_iters": 3}}


def _mem(kib, frac=1.0):
    return MemoryModel(device_bytes=kib * KIB, usable_fraction=frac)


def _jmem(kib, frac=1.0):
    return JMemoryModel(device_bytes=kib * KIB, usable_fraction=frac)


def _pool(n, kib=1024, **kw):
    return DevicePool(n, _mem(kib), devices=[CPU] * n, **kw)


def _job(alg="cgls", prio=0, n_iter=2, projections=PROJ, **kw):
    kw.setdefault("params", dict(PARAMS.get(alg, {})))
    return ReconJob(alg, GEO, ANGLES, projections, n_iter=n_iter,
                    priority=prio, **kw)


def _jjob(alg="cgls", prio=0, n_iter=2, **kw):
    kw.setdefault("params", dict(PARAMS.get(alg, {})))
    return jserve.ReconJob(alg, JGEO, ANGLES, PROJ, n_iter=n_iter,
                           priority=prio, **kw)


@functools.lru_cache(maxsize=None)
def _solo(alg, n_iter, mode="plain", kib=1024):
    """The same algorithm stepped directly on the port's operator."""
    a = get_algorithm(alg)
    op = CTOperator(GEO, ANGLES, mode=mode, bp_weight=a.default_bp_weight,
                    memory=_mem(kib), device=CPU)
    st = a.init(PROJ, GEO, ANGLES, op=op, **PARAMS[alg])
    for _ in range(n_iter if a.iterative else 1):
        st = a.step(st)
    return a.finalize(st).numpy()


# --------------------------------------------------------------------------
# queue and metrics
# --------------------------------------------------------------------------

def test_queue_order_requeue_and_cancellation():
    """Priority first, FIFO within a priority, a requeued record keeps its
    place, cancelled records never pop: as the reference's queue."""
    ops = [("push", 0, 0), ("push", 5, 1), ("push", 0, 2), ("push", 5, 3),
           ("pop",), ("cancel", 2), ("requeue",), ("pop",), ("pop",),
           ("cancel", 9), ("pop",), ("pop",)]

    def drive(queue_cls, job_fn, rec_cls):
        q, recs, out, last = queue_cls(), {}, [], None
        for op in ops:
            if op[0] == "push":
                recs[op[2]] = rec_cls(job=job_fn(prio=op[1],
                                                 job_id=f"j{op[2]}"),
                                      seq=op[2])
                q.push(recs[op[2]])
            elif op[0] == "pop":
                last = q.pop()
                out.append(None if last is None else last.job.job_id)
            elif op[0] == "requeue":
                q.push(last)
            else:
                out.append(q.cancel(f"j{op[1]}"))
            out.append((len(q), q.peek_priority()))
        return out

    got = drive(PriorityJobQueue, _job, JobRecord)
    want = drive(jserve.PriorityJobQueue, _jjob, jserve.JobRecord)
    assert got == want
    assert got[0:2] == [(1, 0), (2, 5)]


def test_percentile_and_metrics_equal_the_reference():
    rng = np.random.default_rng(0)
    for xs in ([], [3.5], [4.0, 1.0, 3.0, 2.0], list(rng.random(17))):
        for p in (0, 5, 50, 95, 100):
            assert percentile(xs, p) == jserve.percentile(xs, p)

    def fill(m):
        m.submitted, m.failed, m.preemptions = 5, 1, 2
        for dt in (0.5, 0.25, 1.0):
            m.record_step(dt)
        m.record_completion(2.0, 0.5)
        m.record_completion(3.0, 0.25)
        m.record_phases({"compute": 1.5, "h2d": 0.25})
        m.record_calibration("step", 0.4, 0.5)
        m.record_calibration("admit", None, 0.5)
        m.memory_modeled_peak_bytes = 123
        m.wall_start, m.wall_end = 10.0, 14.0
        return m

    got = fill(ServeMetrics()).summary(device_busy=[1.0, 2.5])
    want = fill(jserve.ServeMetrics()).summary(device_busy=[1.0, 2.5])
    assert got == want
    merged = merge_metrics([fill(ServeMetrics()), fill(ServeMetrics())])
    jmerged = jserve.merge_metrics([fill(jserve.ServeMetrics()),
                                    fill(jserve.ServeMetrics())])
    assert merged.summary() == jmerged.summary()


# --------------------------------------------------------------------------
# footprint and cost model
# --------------------------------------------------------------------------

@pytest.mark.parametrize("alg", ["cgls", "ossart", "fista", "asd_pocs",
                                 "fdk", "sirt"])
def test_footprint_and_passes_equal_the_reference(alg):
    """estimate_job_footprint and modeled_step_passes, field by field,
    over geometries, angle counts, budgets and forced modes."""
    for n, n_angles in ((16, 12), (32, 16), (24, 30)):
        geo, jgeo = ConeGeometry.nice(n), JConeGeometry.nice(n)
        ang = circular_angles(n_angles)
        for kib in (100, 220, 1024, 8192):
            for frac in (1.0, 0.95):
                for kw in ({}, {"mode": "plain"}, {"mode": "stream"},
                           {"memory_hint_bytes": 4321}):
                    job = ReconJob(alg, geo, ang, lambda: None, **kw)
                    jjob = jserve.ReconJob(alg, jgeo, ang, lambda: None,
                                           **kw)
                    try:
                        want = jserve.estimate_job_footprint(
                            jjob, _jmem(kib, frac))
                    except Exception as e:
                        with pytest.raises(type(e)):
                            estimate_job_footprint(job, _mem(kib, frac))
                        continue
                    got = estimate_job_footprint(job, _mem(kib, frac))
                    assert (got.bytes_on_device, got.streams) == \
                        (want.bytes_on_device, want.streams)
                    assert modeled_step_passes(job, _mem(kib, frac)) == \
                        jsched_mod.modeled_step_passes(jjob,
                                                       _jmem(kib, frac))


def test_pool_placement_policies_and_the_card_default(monkeypatch):
    """Spread and pack as the reference's; a pool without ``devices`` is
    on the card, and raises without one."""
    for policy in ("spread", "pack"):
        pool = _pool(2, 100, policy=policy)
        jpool = jserve.DevicePool(2, _jmem(100), policy=policy)
        for name, size in (("a", 10), ("b", 60), ("c", 30), ("d", 60)):
            s, js = pool.best_fit(size * KIB), jpool.best_fit(size * KIB)
            assert (s and s.index) == (js and js.index)
            if s is not None:
                pool.commit(s, name, size * KIB)
                jpool.commit(js, name, size * KIB)
        assert [s.free_bytes for s in pool.slots] == \
            [s.free_bytes for s in jpool.slots]
    assert all(s.stream is None and s.device == CPU
               for s in _pool(3).slots)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DevicePool(1, _mem(100))


# --------------------------------------------------------------------------
# the scheduler's decisions against the reference's
# --------------------------------------------------------------------------

def _fleet_log(mod_obs, ids):
    """(kind, job index, device) of every fleet event, job ids mapped to
    their submission index."""
    out = []
    for e in mod_obs.fleet_event_log():
        job = e.attrs.get("job")
        out.append((e.name, ids.index(job) if job in ids else None,
                    e.attrs.get("device")))
    return out


def _per_device_sequence(sched, job_fn):
    """The reference's per-device preemption scenario (tests/test_serve.py:
    465): dev0 = H(50K, prio 9, 12 iterations: 10 in the first quantum)
    + V0(30K); dev1 = V1(80K); a 60K prio-5 arrival evicts V1 only."""
    ids = [sched.submit(job_fn(prio=9, n_iter=12,
                                  memory_hint_bytes=50 * KIB)),
           sched.submit(job_fn(prio=0, n_iter=3, memory_hint_bytes=80 * KIB)),
           sched.submit(job_fn(prio=0, n_iter=3, memory_hint_bytes=30 * KIB))]
    sched.run(max_quanta=1)
    ids.append(sched.submit(job_fn(prio=5, n_iter=1,
                                   memory_hint_bytes=60 * KIB)))
    sched.step_quantum()
    mid = [(sched.records[j].status.value, sched.records[j].device,
            sched.records[j].preemptions) for j in ids]
    sched.run()
    end = [(sched.records[j].status.value, sched.records[j].device,
            sched.records[j].preemptions, sched.records[j].iterations_done)
           for j in ids]
    return ids, mid, end


def test_same_sequence_same_decisions_as_the_reference():
    """Submit, step and preempt through both schedulers on simulated
    two-slot pools: the same device per job, the same victim, the same
    statuses and the same fleet event sequence."""
    tracer, jtracer = obs.Tracer(enabled=True), jax_obs.Tracer(enabled=True)
    prev, jprev = obs.set_tracer(tracer), jax_obs.set_tracer(jtracer)
    try:
        sched = Scheduler(pool=_pool(2, 100))
        ids, mid, end = _per_device_sequence(sched, _job)
        log = _fleet_log(obs, ids)
        jsched = jserve.Scheduler(n_devices=2, memory=_jmem(100))
        jids, jmid, jend = _per_device_sequence(jsched, _jjob)
        jlog = _fleet_log(jax_obs, jids)
    finally:
        obs.set_tracer(prev)
        jax_obs.set_tracer(jprev)
    assert (mid, end) == (jmid, jend)
    assert mid[1] == ("preempted", 1, 1) and mid[2][2] == 0
    assert log == jlog
    assert [k for k, *_ in log].count("park") == 1
    assert sched.metrics.summary()["preemptions"] == 1
    np.testing.assert_array_equal(sched.result(ids[1]), _solo("cgls", 3))


# --------------------------------------------------------------------------
# results: bit-identical to solo runs, within the band of the reference
# --------------------------------------------------------------------------

_MIXED = [("cgls", "plain"), ("ossart", "plain"), ("fista", "plain"),
          ("asd_pocs", "plain"), ("cgls", "stream")]


@pytest.fixture(scope="module")
def mixed_run():
    """Five jobs packed on two CPU slots under one budget, interleaved by
    the cooperative loop, with an urgent arrival that parks a job."""
    sched = Scheduler(pool=_pool(2, 1024))
    ids = [sched.submit(_job(a, n_iter=3, mode=m)) for a, m in _MIXED]
    sched.run(max_quanta=1)
    urgent = sched.submit(_job("cgls", prio=7, n_iter=1,
                               memory_hint_bytes=1000 * KIB))
    sched.run()
    assert sched.records[urgent].status is JobStatus.COMPLETED
    assert sched.metrics.preemptions >= 1
    return sched, ids


@functools.lru_cache(maxsize=None)
def _reference_run():
    sched = jserve.Scheduler(n_devices=1, memory=_jmem(1024))
    ids = [sched.submit(_jjob(a, n_iter=3, mode=m)) for a, m in _MIXED]
    sched.run()
    return [np.asarray(sched.result(j)) for j in ids]


@pytest.mark.parametrize("i", range(len(_MIXED)),
                         ids=[f"{a}-{m}" for a, m in _MIXED])
def test_scheduled_results_equal_solo_runs_and_the_reference(mixed_run, i):
    sched, ids = mixed_run
    alg, mode = _MIXED[i]
    rec = sched.records[ids[i]]
    assert rec.status is JobStatus.COMPLETED, rec.error
    assert rec.streamed == (mode == "stream")
    assert isinstance(rec.result, np.ndarray)
    np.testing.assert_array_equal(rec.result, _solo(alg, 3, mode))
    np.testing.assert_allclose(rec.result, _reference_run()[i], **BAND)


def test_async_driver_two_slots_equal_solo_runs():
    sched = Scheduler(pool=_pool(2, 1024))
    ids = [sched.submit(_job("cgls", n_iter=2)),
           sched.submit(_job("ossart", n_iter=2)),
           sched.submit(_job("cgls", n_iter=3, prio=2))]
    AsyncDriver(sched).run(timeout=120)
    assert {sched.records[j].device for j in ids} == {0, 1}
    for j, (alg, n) in zip(ids, (("cgls", 2), ("ossart", 2), ("cgls", 3))):
        np.testing.assert_array_equal(sched.result(j), _solo(alg, n))


def test_job_projections_as_tensor_or_data_ref():
    """A torch tensor and a lazy data ref give the numpy array's result."""
    sched = Scheduler(pool=_pool(1))
    a = sched.submit(_job(projections=torch.from_numpy(PROJ)))
    b = sched.submit(ReconJob("cgls", GEO, ANGLES, lambda: PROJ, n_iter=2))
    sched.run()
    for j in (a, b):
        np.testing.assert_array_equal(sched.result(j), _solo("cgls", 2))


def test_operator_cache_is_keyed_by_device_and_prewarmed():
    executor_mod.clear_operator_cache()
    assert executor_mod.prewarm_jobs([_job(), _job(), _job("ossart")],
                                     _mem(1024), devices=[CPU]) == 2
    keys = executor_mod.operator_cache_keys()
    assert len(keys) == 2 and all(k[-1] == "cpu" for k in keys)
    assert {k[3] for k in keys} == {"matched", "pmatched"}
    ex = JobExecutor(_job(), "plain", _mem(1024), devices=[CPU])
    ex.start()
    assert ex.started and len(executor_mod.operator_cache_keys()) == 2
    ex.step()
    ex.step()
    assert ex.done and ex.checkpoint()["it"] == 2
    np.testing.assert_array_equal(ex.result(), _solo("cgls", 2))


# --------------------------------------------------------------------------
# fair share, deadline admission, bad tenants
# --------------------------------------------------------------------------

def test_weighted_fair_share_quantum_and_stride_claims():
    sched = Scheduler(pool=_pool(1))
    lo = sched.submit(_job("cgls", prio=0, n_iter=8))
    hi = sched.submit(_job("cgls", prio=3, n_iter=8))
    sched.step_quantum()
    assert sched.records[hi].iterations_done == 4
    assert sched.records[lo].iterations_done == 1
    slot = sched.pool.slots[0]
    counts = {lo: 0, hi: 0}
    for _ in range(5):
        run = sched.claim_step(slot)
        counts[run.record.job.job_id] += 1
        sched.finish_step(run, 0.0)     # bookkeeping only, no compute
    assert counts == {hi: 4, lo: 1}     # weights 4 and 1


class _Clock:
    """An injected ``time`` for the scheduler module."""

    def __init__(self, t):
        self.t = t

    def monotonic(self):
        return self.t

    @staticmethod
    def sleep(_s):
        pass


def _deadline_decisions(sched, job_fn, clock):
    sched._step_ema, sched._init_ema = 0.5, 1.0
    late = sched.submit(job_fn(n_iter=10, deadline_seconds=5.0))
    ok = sched.submit(job_fn(n_iter=2, deadline_seconds=3.0))
    aged = sched.submit(job_fn(n_iter=2, deadline_seconds=3.0))
    clock.t += 0.5                      # queue wait counts toward it
    models = [sched.modeled_completion_seconds(sched.records[j])
              for j in (late, ok, aged)]
    sched.records[aged].submit_time -= 1.0
    sched.admit()
    return models, [(sched.records[j].status.value,
                     sched.records[j].error is not None)
                    for j in (late, ok, aged)]


def test_deadline_admission_with_injected_clocks(monkeypatch):
    """With the EMAs injected (step 0.5 s, init 1.0 s) and a fake clock,
    both packages model the same completion times and reject the same
    jobs; with no observation the model abstains."""
    clock, jclock = _Clock(100.0), _Clock(100.0)
    monkeypatch.setattr(sched_mod, "time", clock)
    monkeypatch.setattr(jsched_mod, "time", jclock)
    got = _deadline_decisions(Scheduler(pool=_pool(1)), _job, clock)
    want = _deadline_decisions(jserve.Scheduler(n_devices=1,
                                                memory=_jmem(1024)),
                               _jjob, jclock)
    assert got == want
    assert got[0] == [6.5, 2.5, 2.5]
    assert [s for s, _ in got[1]] == ["failed", "running", "failed"]
    fresh = Scheduler(pool=_pool(1))
    j = fresh.submit(_job(deadline_seconds=1e-9))
    assert fresh.modeled_completion_seconds(fresh.records[j]) is None
    fresh.admit()
    assert fresh.records[j].status is JobStatus.RUNNING


def test_bad_tenants_fail_alone():
    """An unknown algorithm is refused at submission; a data ref that
    raises, a job that never fits and a step that raises fail their own
    job, and the healthy tenant completes."""
    sched = Scheduler(pool=_pool(1, 100))
    with pytest.raises(ValueError, match="unknown algorithm"):
        sched.submit(_job("not-an-algorithm"))
    bad_ref = sched.submit(ReconJob("cgls", GEO, ANGLES, lambda: 1 / 0,
                                    n_iter=2))
    huge = sched.submit(_job(memory_hint_bytes=10 * 1024 * KIB))
    wrong = sched.submit(_job(projections=PROJ[:, :8]))
    good = sched.submit(_job("cgls", n_iter=2))
    sched.run()
    recs = sched.records
    assert "init failed" in recs[bad_ref].error
    assert "exceeds" in recs[huge].error
    assert recs[wrong].status is JobStatus.FAILED
    assert recs[good].status is JobStatus.COMPLETED
    assert sched.metrics.failed == 3
    np.testing.assert_array_equal(sched.result(good), _solo("cgls", 2))
    with pytest.raises(RuntimeError, match="failed"):
        sched.result(bad_ref)


def test_bp_matched_scratch_is_sized_by_the_budget():
    """bp_matched's scratch, which no plan counts, takes at most the
    headroom a memory model leaves beside its usable bytes: the operator
    hands that chunk to every matched dispatch entry."""
    from repro_torch.core import backend as bk
    from repro_torch.kernels.bp_matched import SEG_CHUNK, seg_chunk_for
    big = ConeGeometry.nice(512)
    assert seg_chunk_for(big, MemoryModel()) == SEG_CHUNK == 8
    assert seg_chunk_for(big, MemoryModel(256 << 20)) == 8   # 12.8 MiB
    assert seg_chunk_for(big, MemoryModel(100 << 20)) == 5   # 5 MiB
    assert seg_chunk_for(big, MemoryModel(1 << 30, 1.0)) == 0
    bk.clear_dispatch_cache()
    # 1 KiB an angle at N=16: 51 KiB of headroom at 1 MiB, 5 at 100 KiB
    for mem, chunk in ((_mem(1024, 0.95), 8), (_mem(100, 0.95), 5)):
        op = CTOperator(GEO, ANGLES, mode="stream", memory=mem,
                        backend="cuda", device=CPU)
        op.warmup()
        keys = [k for k in bk.dispatch_cache_keys() if k[1] == "bp_matched"]
        # (cuda, bp_matched, geo, planes, xdom, seg_chunk, tile config)
        assert keys and all(k[5] == chunk for k in keys), keys
        bk.clear_dispatch_cache()


def test_async_driver_stress_many_slots_short_switch_interval():
    """More worker threads than cores, a short switch interval: every job
    completes once, bit-identical, and every slot's ledger returns to 0."""
    import sys
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        sched = Scheduler(pool=_pool(8, 200))
        ids = [sched.submit(_job("cgls", n_iter=2, prio=i % 3))
               for i in range(12)]
        AsyncDriver(sched).run(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert sched.metrics.completed == 12 and sched.idle
    assert all(s.committed_bytes == 0 and not s.jobs
               for s in sched.pool.slots)
    for j in ids:
        np.testing.assert_array_equal(sched.result(j), _solo("cgls", 2))
