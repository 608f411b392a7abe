"""The port's autoscaler, drain and live migration
(``repro_torch.serve.autoscale`` / ``steal``) against the reference's, on
the CPU: scale-up and scale-down, the hysteresis windows and cooldown, the
predictive scale-up, drains that move mid-progress jobs, the fits-nowhere
hook, template choice and pinned templates refused, pre-warm,
``migrate_once`` and ``park_job``, and the threaded fleet driver attaching
and detaching scaled pods.

Decisions are compared with the reference's on the same sequence, with
the clock, the load signal and the unit costs injected into both (never
measured): the scale events' direction and pod, the victim, the moved
jobs (by submission index) and the membership events.  Results equal the
port's solo runs bit for bit and the reference's within rtol = atol =
2e-3 (tests/test_adjoint.py:199)."""

import functools
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
from repro_torch import obs, serve
from repro_torch.core import phantoms
from repro_torch.core.algorithms.stepwise import get_algorithm
from repro_torch.core.geometry import ConeGeometry, circular_angles
from repro_torch.core.operator import CTOperator
from repro_torch.core.splitting import MemoryModel
from repro_torch.serve import (Autoscaler, AutoscalePolicy, JobStatus,
                               MultiPodDriver, MultiPodScheduler, Pod,
                               PodSpec, ReconJob)
from repro_torch.serve import executor as executor_mod

CPU = torch.device("cpu")
GEO = ConeGeometry.nice(16)
ANGLES = circular_angles(12)
PROJ = phantoms.sphere_projection_analytic(GEO, ANGLES)
KIB = 1024
BAND = dict(rtol=2e-3, atol=2e-3)          # tests/test_adjoint.py:199
PARAMS = {"cgls": {}, "ossart": {"subset_size": 4}}
MEMBERSHIP = ("pod-add", "pod-remove", "scale-up", "scale-down", "drain",
              "migrate")


def _mem(pkg, kib=220):
    cls = MemoryModel if pkg is PORT else JMemoryModel
    return cls(device_bytes=kib * KIB, usable_fraction=1.0)


def _port_pod(name, kib=220):
    return Pod(PodSpec(name, memory=_mem(PORT, kib), devices=(CPU,)))


def _ref_pod(name, kib=220):
    return jserve.Pod(jserve.PodSpec(name, memory=_mem(REF, kib)))


PORT = types.SimpleNamespace(
    serve=serve, obs=obs, pod=lambda *a: _port_pod(*a),
    job=lambda alg="cgls", prio=0, n_iter=2, **kw: ReconJob(
        alg, GEO, ANGLES, kw.pop("projections", PROJ), n_iter=n_iter,
        priority=prio, **{"params": dict(PARAMS.get(alg, {})), **kw}),
    # the port's spawned pods lie on the CPU only when asked
    asc=lambda *a, **kw: Autoscaler(*a, device="cpu", **kw))
REF = types.SimpleNamespace(
    serve=jserve, obs=jax_obs, pod=lambda *a: _ref_pod(*a),
    job=lambda alg="cgls", prio=0, n_iter=2, **kw: jserve.ReconJob(
        alg, JConeGeometry.nice(16), ANGLES, kw.pop("projections", PROJ),
        n_iter=n_iter, priority=prio,
        **{"params": dict(PARAMS.get(alg, {})), **kw}),
    asc=jserve.Autoscaler)


def _spec(pkg, name, kib=220, **kw):
    return pkg.serve.PodSpec(name, n_devices=1, memory=_mem(pkg, kib), **kw)


def _policy(pkg, **kw):
    for k, v in (("scale_up_backlog_seconds", 0.5),
                 ("scale_down_backlog_seconds", 0.05),
                 ("up_window_seconds", 0.0), ("down_window_seconds", 0.0),
                 ("cooldown_seconds", 0.0), ("min_pods", 1),
                 ("max_pods", 3)):
        kw.setdefault(k, v)
    return pkg.serve.AutoscalePolicy(**kw)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@functools.lru_cache(maxsize=None)
def _solo(alg, n_iter):
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


def _events(evs):
    return [(e.direction, e.pod, e.n_pods, e.t, e.predicted) for e in evs]


def _traced(pkg, fn):
    tracer = pkg.obs.Tracer(enabled=True)
    prev = pkg.obs.set_tracer(tracer)
    try:
        out = fn()
    finally:
        pkg.obs.set_tracer(prev)
    return out, [(e.name, e.attrs.get("pod"), e.attrs.get("src"),
                  e.attrs.get("dst")) for e in tracer.events()
                 if e.name in MEMBERSHIP]


def _both(scenario, tmp_path):
    """``scenario(pkg, tmp)`` traced in both packages: the port's return
    value (which must equal the reference's in its first item) and its
    membership events (which must equal the reference's)."""
    (got, gev) = _traced(PORT, lambda: scenario(PORT, str(tmp_path / "p")))
    (want, wev) = _traced(REF, lambda: scenario(REF, str(tmp_path / "r")))
    assert got[0] == want[0]
    assert gev == wev
    return got, gev


# --------------------------------------------------------------------------
# policy validation, elasticity
# --------------------------------------------------------------------------

def test_policy_validation_and_pinned_templates_refused(monkeypatch):
    for pkg in (PORT, REF):
        with pytest.raises(ValueError, match="band inverted"):
            pkg.serve.AutoscalePolicy(scale_up_backlog_seconds=1.0,
                                      scale_down_backlog_seconds=2.0)
        with pytest.raises(ValueError, match="min_pods"):
            pkg.serve.AutoscalePolicy(min_pods=3, max_pods=1)
        with pytest.raises(ValueError, match="at least one PodSpec"):
            pkg.asc(pkg.serve.MultiPodScheduler([pkg.pod("p0")]), [])
    with pytest.raises(ValueError, match="must not pin devices"):
        Autoscaler(MultiPodScheduler([PORT.pod("p0")]),
                   [_spec(PORT, "pinned", devices=(CPU,))])
    # without a device, a spawned pod lies on the card: none here
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    asc = Autoscaler(MultiPodScheduler([PORT.pod("p0")]),
                     [_spec(PORT, "burst")], _policy(PORT))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        asc._scale_up(0.0, 1.0)


def _grow_and_shrink(pkg, tmp):
    """Scripted load on a FakeClock: up twice (the cap is 3), a quiet
    band, then down twice once the fleet is idle (all loads 0, so the
    victims go by name)."""
    clock = FakeClock()
    mps = pkg.serve.MultiPodScheduler([pkg.pod("seed")], transfer_dir=tmp)
    script = iter([10.0, 10.0, 0.3])
    load = {"fn": lambda pods: next(script)}
    asc = pkg.asc(mps, [_spec(pkg, "burst")], _policy(pkg), clock=clock,
                  load_fn=lambda pods: load["fn"](pods))
    jids = [mps.submit(pkg.job(n_iter=4)) for _ in range(6)]
    for _ in range(3):
        asc.step()
        clock.t += 1.0
    rounds = 0
    while not mps.idle:
        for pod in mps.pods_snapshot():
            pod.scheduler.step_quantum()
        mps.steal_pass()
        rounds += 1
        assert rounds < 200
    load["fn"] = lambda pods: 0.0
    while len(mps.pods) > 1:
        assert asc.step() is not None
        clock.t += 1.0
    s = mps.summary()
    return ([_events(asc.events), s["scale_up_events"],
             s["scale_down_events"], s["completed"], s["pods_online_peak"],
             sorted(p.name for p in mps.retired_pods)],
            [mps.result(j) for j in jids])


def test_autoscaler_grows_and_shrinks_as_the_reference(tmp_path):
    (got, images), events = _both(_grow_and_shrink, tmp_path)
    assert [e[:3] for e in got[0]] == [("up", "burst-as0", 2),
                                       ("up", "burst-as1", 3),
                                       ("down", "burst-as0", 2),
                                       ("down", "burst-as1", 1)]
    assert got[1:] == [2, 2, 6, 3, ["burst-as0", "burst-as1"]]
    assert [k for k, *_ in events] == ["pod-add", "scale-up"] * 2 + \
        ["drain", "pod-remove", "scale-down"] * 2
    for image in images:
        _check_result(image, "cgls", 4)


def _oscillating(pkg, tmp, **policy):
    clock = FakeClock()
    mps = pkg.serve.MultiPodScheduler([pkg.pod("seed")], transfer_dir=tmp)
    loads = iter([10.0, 0.0] * 100)
    asc = pkg.asc(mps, [_spec(pkg, "burst")], _policy(pkg, **policy),
                  clock=clock, load_fn=lambda pods: next(loads))
    while clock.t < 50.0:
        asc.step()
        clock.t += 0.5
    return (_events(asc.events),)


@pytest.mark.parametrize("policy", [
    dict(cooldown_seconds=10.0, max_pods=4),
    dict(up_window_seconds=2.0, down_window_seconds=2.0)],
    ids=["cooldown", "windows"])
def test_oscillating_load_cannot_thrash_the_fleet(tmp_path, policy):
    (got,), _ = _both(lambda pkg, tmp: _oscillating(pkg, tmp, **policy),
                      tmp_path)
    if "cooldown_seconds" in policy:
        assert 0 < len(got) <= 50.0 / 10.0 + 1
    else:
        assert got == []


def _boundaries(pkg, tmp):
    """A dip resets the window; a sustained signal fires at exactly the
    window's end, up and down."""
    clock = FakeClock()
    mps = pkg.serve.MultiPodScheduler([pkg.pod("seed")], transfer_dir=tmp)
    load = {"v": 10.0}
    asc = pkg.asc(mps, [_spec(pkg, "burst")],
                  _policy(pkg, up_window_seconds=2.0,
                          down_window_seconds=2.0, max_pods=2),
                  clock=clock, load_fn=lambda pods: load["v"])
    out = []
    for i in range(12):
        load["v"] = 0.3 if i % 3 == 2 else 10.0
        out.append(asc.step())
        clock.t += 1.0
    for v in (10.0, 10.0, 10.0, 0.0, 0.0, 0.0, 0.0):
        load["v"] = v
        ev = asc.step()
        out.append(None if ev is None else ev.direction)
        clock.t += 1.0
    return (out, _events(asc.events))


def test_hysteresis_window_resets_and_fires_at_the_boundary(tmp_path):
    (got, events), _ = _both(_boundaries, tmp_path)
    assert got[:12] == [None] * 12
    assert got[12:] == [None, None, "up", None, None, "down", None]
    assert [e[0] for e in events] == ["up", "down"]


def _predictive(pkg, tmp, on):
    """The load climbs inside the band; with a 2 s init EMA on the seed
    pod its slope crosses the high watermark within the lead time."""
    clock = FakeClock()
    mps = pkg.serve.MultiPodScheduler([pkg.pod("seed")], transfer_dir=tmp)
    mps.pods[0].scheduler._init_ema = 2.0
    ramp = iter([0.1, 0.25, 0.4, 0.45])
    asc = pkg.asc(mps, [_spec(pkg, "burst")],
                  _policy(pkg, predictive_scale_up=on, max_pods=2),
                  clock=clock,
                  load_fn=lambda pods: next(ramp))
    for _ in range(4):
        asc.step()
        clock.t += 1.0
    return (_events(asc.events), asc.summary()["predicted_scale_ups"])


@pytest.mark.parametrize("on", [True, False], ids=["on", "off"])
def test_predictive_scale_up(tmp_path, on):
    (events, predicted), _ = _both(
        lambda pkg, tmp: _predictive(pkg, tmp, on), tmp_path)
    if on:
        # 0.25 + 0.15/s x 2 s crosses 0.5 at t = 1
        assert events == [("up", "burst-as0", 2, 1.0, True)]
        assert predicted == 1
    else:
        assert events == [] and predicted == 0


# --------------------------------------------------------------------------
# scale-down drains
# --------------------------------------------------------------------------

def _drain_mid_progress(pkg, tmp):
    """p0 holds an OS-SART job parked mid-progress, p1 two long CGLS
    jobs; with equal injected unit costs p0 is the least loaded, so the
    scale-down drains it and the job resumes on p1."""
    p0, p1 = pkg.pod("p0", 100), pkg.pod("p1", 100)
    mps = pkg.serve.MultiPodScheduler([p0, p1], steal=False,
                                      transfer_dir=tmp)
    vic = mps.submit(pkg.job("ossart", n_iter=6), pod="p0")
    for _ in range(3):
        p0.scheduler.step_quantum()
    done = mps.record(vic).iterations_done
    other = [mps.submit(pkg.job(n_iter=10), pod="p1") for _ in range(2)]
    p1.scheduler.step_quantum()
    for p in (p0, p1):
        p.scheduler._step_ema, p.scheduler._init_ema = 1.0, 0.5
    asc = pkg.asc(mps, [_spec(pkg, "t", 100)], _policy(pkg),
                  load_fn=lambda pods: 0.0)
    ev = asc.step()
    out = [ev.direction, ev.pod, asc.drained_jobs == [vic], done,
           mps.record(vic).iterations_done, [p.name for p in mps.pods]]
    mps.run()
    return (out, mps.result(vic), [mps.result(j) for j in other])


def test_scale_down_drains_a_mid_progress_job(tmp_path):
    (got, image, others), events = _both(_drain_mid_progress, tmp_path)
    assert got == ["down", "p0", True, got[3], got[3], ["p1"]]
    assert got[3] >= 1
    assert ("drain", "p0", None, None) in events
    _check_result(image, "ossart", 6)
    for o in others:
        _check_result(o, "cgls", 10)


def _drain_aborts(pkg, tmp):
    """A lazy job without a resolver cannot move: the drain aborts, the
    pod stays in service with admission resumed."""
    p0, p1 = pkg.pod("p0", 100), pkg.pod("p1", 100)
    mps = pkg.serve.MultiPodScheduler([p0, p1], steal=False,
                                      transfer_dir=tmp)
    hold = mps.submit(pkg.job(n_iter=2), pod="p0")
    lazy = mps.submit(pkg.job(projections=lambda: PROJ), pod="p0")
    p0.scheduler.admit()
    for _ in range(3):
        mps.submit(pkg.job(n_iter=8), pod="p1")
    asc = pkg.asc(mps, [_spec(pkg, "t", 100)], _policy(pkg),
                  load_fn=lambda pods: 0.0)
    out = [asc.step(), asc.aborted_scale_downs,
           sorted(p.name for p in mps.pods), p0.draining,
           p0.scheduler.admission_paused]
    mps.autoscaler = None
    mps.run()
    return (out, mps.result(hold), mps.result(lazy))


def test_scale_down_aborts_when_a_job_cannot_move(tmp_path):
    (got, hold, lazy), _ = _both(_drain_aborts, tmp_path)
    assert got == [None, 1, ["p0", "p1"], False, False]
    _check_result(hold, "cgls", 2)
    _check_result(lazy, "cgls", 2)


def _drain_pod(pkg, tmp):
    p0, p1 = pkg.pod("p0", 8 * KIB), pkg.pod("p1", 8 * KIB)
    jids = [p0.scheduler.submit(pkg.job(n_iter=3)) for _ in range(3)]
    p0.scheduler.step_quantum()
    moved = pkg.serve.drain_pod(p0, [p1], tmp)
    out = [sorted(jids.index(j) for j in moved), p0.scheduler.idle,
           p0.scheduler.admission_paused]
    p1.scheduler.run()
    images = [p1.scheduler.result(j) for j in jids]
    big, tiny = pkg.pod("big", 8 * KIB), pkg.pod("tiny", 100)
    kept = big.scheduler.submit(pkg.job(n_iter=1,
                                        memory_hint_bytes=5000 * KIB))
    with pytest.raises(RuntimeError, match="cannot move"):
        pkg.serve.drain_pod(big, [tiny], tmp + "2")
    out += [kept in big.scheduler.records, big.scheduler.admission_paused]
    return (out, images)


def test_drain_pod_moves_everything_within_survivor_budgets(tmp_path):
    (got, images), _ = _both(_drain_pod, tmp_path)
    assert got == [[0, 1, 2], True, True, True, False]
    for image in images:
        _check_result(image, "cgls", 3)


# --------------------------------------------------------------------------
# scale-up: the fits-nowhere hook, template choice, errors, pre-warm
# --------------------------------------------------------------------------

def _fits_nowhere(pkg, tmp):
    mps = pkg.serve.MultiPodScheduler([pkg.pod("small")], transfer_dir=tmp)
    asc = pkg.asc(mps, [_spec(pkg, "big", 8 * KIB)], _policy(pkg))
    jid = mps.submit(pkg.job(n_iter=1, memory_hint_bytes=5000 * KIB))
    owner = mps.owner(jid).name
    mps.run(autoscaler=asc)
    return ([owner, mps.record(jid).status.value], mps.result(jid))


def test_scale_up_for_a_job_that_fits_no_live_pod(tmp_path):
    (got, image), events = _both(_fits_nowhere, tmp_path)
    assert got == ["big-as0", "completed"]
    assert events[:2] == [("pod-add", "big-as0", None, None),
                          ("scale-up", "big-as0", None, None)]
    _check_result(image, "cgls", 1)


def _template_fit(pkg, tmp):
    out = []
    for seed_kib, templates, hint in (
            (220, [("big", 8 * KIB), ("small", 220)], None),
            (8 * KIB, [("small", 220), ("big", 8 * KIB)], 5000 * KIB)):
        mps = pkg.serve.MultiPodScheduler([pkg.pod("seed", seed_kib)],
                                          transfer_dir=tmp)
        asc = pkg.asc(mps, [_spec(pkg, n, k) for n, k in templates],
                      _policy(pkg, max_pods=4), load_fn=lambda pods: 10.0)
        out.append(asc._pick_template())
        mps.pods[0].scheduler.pause_admission()
        kw = {} if hint is None else {"memory_hint_bytes": hint}
        jids = [mps.submit(pkg.job(n_iter=1, **kw), pod="seed")
                for _ in range(3 if hint is None else 1)]
        out.append(asc.step().pod)
        mps.autoscaler = None
        for p in mps.pods:
            p.scheduler.resume_admission()
        mps.run()
        out.append([mps.record(j).status.value for j in jids])
    return (out,)


def test_scale_up_picks_the_template_by_queued_footprint_fit(tmp_path):
    (got,), _ = _both(_template_fit, tmp_path)
    assert got[0] is None and got[1] == "small-as0"
    assert got[4] == "big-as0"
    assert got[2] == ["completed"] * 3 and got[5] == ["completed"]


def _scale_up_errors(pkg, tmp):
    mps = pkg.serve.MultiPodScheduler([pkg.pod("seed")], transfer_dir=tmp)
    asc = pkg.asc(mps, [_spec(pkg, "bad", placement="bogus")], _policy(pkg))
    with pytest.raises(ValueError, match="placement"):
        asc._scale_up(0.0, 1.0)
    out = [[p.name for p in mps.pods], asc.events]
    assert mps._fleet_lock.acquire(timeout=1)
    mps._fleet_lock.release()
    mps2 = pkg.serve.MultiPodScheduler(
        [pkg.pod("seed"), pkg.pod("burst-as0")], transfer_dir=tmp + "2")
    asc2 = pkg.asc(mps2, [_spec(pkg, "burst")], _policy(pkg, max_pods=4))
    out.append(asc2._scale_up(0.0, 1.0).pod)
    cap = pkg.asc(mps2, [_spec(pkg, "t")], _policy(pkg, max_pods=3))
    out.append(cap._scale_up(0.0, 1.0))      # at the cap
    return (out,)


def test_scale_up_surfaces_errors_and_retries_name_collisions(tmp_path):
    (got,), _ = _both(_scale_up_errors, tmp_path)
    assert got == [["seed"], [], "burst-as1", None]


@pytest.mark.parametrize("prewarm", [True, False], ids=["on", "off"])
def test_scale_up_prewarms_the_operator_cache(tmp_path, prewarm):
    """With pre-warm the scale-up builds the queued jobs' operator (one:
    four identical acquisitions) on the new pod's device, before any
    quantum runs there; without it the cache stays cold."""
    clock = FakeClock()
    mps = MultiPodScheduler([PORT.pod("seed")],
                            transfer_dir=str(tmp_path / "xfer"))
    asc = PORT.asc(mps, [_spec(PORT, "burst")],
                   _policy(PORT, prewarm=prewarm), clock=clock)
    executor_mod.clear_operator_cache()
    jids = [mps.submit(PORT.job(n_iter=2)) for _ in range(4)]
    assert executor_mod.operator_cache_keys() == ()
    ev = asc.step()
    assert ev is not None and ev.direction == "up"
    keys = executor_mod.operator_cache_keys()
    if not prewarm:
        assert keys == ()
        return
    assert len(keys) == 1 and keys[0][-1] == "cpu"
    while not mps.idle:
        for pod in mps.pods_snapshot():
            pod.scheduler.step_quantum()
        mps.steal_pass()
        clock.t += 1.0
        asc.step()
    for j in jids:
        _check_result(mps.result(j), "cgls", 2)


# --------------------------------------------------------------------------
# live migration and park_job
# --------------------------------------------------------------------------

def _migrate(pkg, tmp, thief_jobs=0):
    """A CGLS job running on p0 (one step done, a second job parked
    behind it) moves to p1 at its step boundary; with ``thief_jobs``
    queued on p1 the move would invert the imbalance and is refused."""
    p0, p1 = pkg.pod("p0", 100), pkg.pod("p1", 100)
    mps = pkg.serve.MultiPodScheduler([p0, p1], steal=False,
                                      transfer_dir=tmp)
    mig = mps.submit(pkg.job(n_iter=4), pod="p0")
    parked = mps.submit(pkg.job(n_iter=3), pod="p0")
    loads = [mps.submit(pkg.job(n_iter=8), pod="p1")
             for _ in range(thief_jobs)]
    p0.scheduler.step_quantum()
    p0.scheduler._step_ema, p0.scheduler._init_ema = 1.0, 0.5
    moved = pkg.serve.migrate_once(p0, p1, tmp, units=(1.0, 0.5))
    ids = [mig, parked] + loads
    out = [None if moved is None else ids.index(moved),
           mps.owner(mig).name, mps.record(mig).iterations_done,
           mps.record(mig).status.value]
    mps.run()
    return (out, [mps.result(j) for j in ids])


@pytest.mark.parametrize("thief_jobs", [0, 2], ids=["moves", "refused"])
def test_migrate_once_as_the_reference(tmp_path, thief_jobs):
    (got, images), events = _both(
        lambda pkg, tmp: _migrate(pkg, tmp, thief_jobs), tmp_path)
    if thief_jobs:
        assert got == [None, "p0", 1, "running"] and events == []
    else:
        assert got == [0, "p1", 1, "preempted"]
        assert events == [("migrate", None, "p0", "p1")]
    for image, n in zip(images, [4, 3] + [8] * thief_jobs):
        _check_result(image, "cgls", n)


def _steal_pass_migrates(pkg, tmp):
    """Nothing parked on the victim: a pass with a migration threshold
    moves its one running job live; without one it moves nothing."""
    out = []
    for threshold in (None, 0.0):
        p0, p1 = pkg.pod("p0", 100), pkg.pod("p1", 100)
        jid = p0.scheduler.submit(pkg.job(n_iter=5))
        p0.scheduler.step_quantum()
        p0.scheduler._step_ema, p0.scheduler._init_ema = 1.0, 0.0
        policy = pkg.serve.StealPolicy(
            migrate_min_imbalance_seconds=threshold)
        moved = pkg.serve.steal_pass([p0, p1], tmp, policy=policy)
        out.append(moved == [jid])
        for p in (p0, p1):
            p.scheduler.run()
        owner = p1 if jid in p1.scheduler.records else p0
        out.append(owner.name)
        image = owner.scheduler.result(jid)
    return (out, image)


def test_steal_pass_migrates_when_nothing_is_parked(tmp_path):
    (got, image), _ = _both(_steal_pass_migrates, tmp_path)
    assert got == [False, "p0", True, "p1"]
    _check_result(image, "cgls", 5)


def _park(pkg, tmp):
    pod = pkg.pod("p0", 1024)
    a = pod.scheduler.submit(pkg.job(n_iter=4))
    b = pod.scheduler.submit(pkg.job(n_iter=4))
    pod.scheduler.step_quantum()
    out = [pod.scheduler.park_job(a), pod.scheduler.park_job("nope"),
           pod.scheduler.park_job(a)]
    rec = pod.scheduler.records[a]
    out += [rec.status.value, rec.checkpoint is not None,
            pod.scheduler.records[b].status.value]
    pod.scheduler.run()
    return (out, [pod.scheduler.result(j) for j in (a, b)])


def test_park_job_parks_one_running_job(tmp_path):
    (got, images), _ = _both(_park, tmp_path)
    assert got == [True, False, True, "preempted", True, "running"]
    for image in images:
        _check_result(image, "cgls", 4)


# --------------------------------------------------------------------------
# the threaded fleet driver follows the membership
# --------------------------------------------------------------------------

def test_multipod_driver_attaches_and_detaches_scaled_pods(tmp_path):
    mps = MultiPodScheduler([PORT.pod("seed")],
                            transfer_dir=str(tmp_path / "xfer"))
    load = {"v": 10.0}
    asc = PORT.asc(mps, [_spec(PORT, "burst")],
                   _policy(PORT, max_pods=2),
                   load_fn=lambda pods: load["v"])
    jids = [mps.submit(PORT.job(n_iter=6)) for _ in range(4)]
    drv = MultiPodDriver(mps, autoscaler=asc)
    drv.start()
    try:
        deadline = time.monotonic() + 120
        while len(drv.drivers) < 2:
            assert drv.error is None and time.monotonic() < deadline
            time.sleep(0.001)
        assert drv.wait(timeout=120)
        load["v"] = 0.0
        while len(drv.drivers) > 1:
            assert drv.error is None and time.monotonic() < deadline
            time.sleep(0.001)
    finally:
        drv.stop()
    assert drv.error is None
    assert [e.direction for e in asc.events] == ["up", "down"]
    assert len(mps.pods) == 1 and len(mps.retired_pods) == 1
    for j in jids:
        assert mps.record(j).status is JobStatus.COMPLETED
        _check_result(mps.result(j), "cgls", 6)
