"""The port's serving layer on the card: scheduled jobs running the CUDA
kernels, each slot on a CUDA stream of its own, step boundaries that are
real synchronisation points, durable snapshots of card state, and
``bp_matched``'s scratch sized by the memory model's headroom.

Every test here needs a CUDA device and ``nvcc`` (the kernels build at
first use) and skips without one.  The file imports nothing of JAX, so it
runs where the port runs:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda_serve.py -q

A scheduled result is held bit for bit against its solo run: the same
algorithm stepped directly on the port's operator in the same mode, on
the card.
"""

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core.algorithms.stepwise import get_algorithm
from repro_torch.core.geometry import (ConeGeometry, circular_angles,
                                       dominant_axis_mask)
from repro_torch.core.operator import CTOperator
from repro_torch.core.splitting import MemoryModel
from repro_torch.kernels.bp_matched import bp_matched_cuda, seg_chunk_for
from repro_torch.serve import (AsyncDriver, DevicePool, JobExecutor,
                               JobStatus, ReconJob, Scheduler)

pytestmark = pytest.mark.cuda

GEO = ConeGeometry.nice(32)
ANGLES = circular_angles(24)
PARAMS = {"cgls": {}, "ossart": {"subset_size": 8},
          "fista": {"tv_iters": 3, "L": 100.0},
          "asd_pocs": {"subset_size": 8, "tv_iters": 3}}
MEM = MemoryModel(device_bytes=1 << 30)
STREAM_MEM = MemoryModel(device_bytes=200_000)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only there)")
    return torch.device("cuda", 0)


def _proj(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    vol = torch.rand(GEO.n_voxel, generator=g, device=cuda)
    return CTOperator(GEO, ANGLES, device=cuda).A(vol)


def _solo(alg, n_iter, proj, mode="plain", mem=MEM):
    a = get_algorithm(alg)
    op = CTOperator(GEO, ANGLES, mode=mode, bp_weight=a.default_bp_weight,
                    memory=mem, device=proj.device)
    st = a.init(proj, GEO, ANGLES, op=op, **PARAMS[alg])
    for _ in range(n_iter):
        st = a.step(st)
    return a.finalize(st).cpu().numpy()


def _job(alg, proj, n_iter=2, **kw):
    return ReconJob(alg, GEO, ANGLES, proj, n_iter=n_iter,
                    params=dict(PARAMS[alg]), **kw)


@pytest.mark.parametrize("alg", ["cgls", "ossart", "fista", "asd_pocs"])
def test_scheduled_job_equals_its_solo_run(cuda, alg):
    proj = _proj(cuda)
    sched = Scheduler(pool=DevicePool(1, MEM))
    assert sched.pool.slots[0].device == cuda
    kernels.reset_counters()
    jid = sched.submit(_job(alg, proj))
    sched.run()
    rec = sched.records[jid]
    assert rec.status is JobStatus.COMPLETED, rec.error
    c = kernels.counters()
    assert all(v["plain_calls"] == 0 for v in c.values()), c
    assert c["fp_ray"]["launches"] > 0
    np.testing.assert_array_equal(rec.result, _solo(alg, 2, proj))


def test_streamed_job_is_routed_and_equals_its_solo_run(cuda):
    proj = _proj(cuda)
    sched = Scheduler(pool=DevicePool(1, STREAM_MEM))
    jid = sched.submit(_job("cgls", proj))
    sched.run()
    rec = sched.records[jid]
    assert rec.status is JobStatus.COMPLETED and rec.streamed, rec.error
    np.testing.assert_array_equal(
        rec.result, _solo("cgls", 2, proj, "stream", STREAM_MEM))


def test_two_slots_on_one_card_have_their_own_streams(cuda):
    proj = _proj(cuda)
    pool = DevicePool(2, MEM, devices=[cuda, cuda])
    s0, s1 = (s.stream for s in pool.slots)
    assert s0 is not None and s1 is not None and s0 != s1
    assert s0 != torch.cuda.current_stream(cuda)
    sched = Scheduler(pool=pool)
    ids = [sched.submit(_job("cgls", proj, n_iter=3)),
           sched.submit(_job("ossart", proj, n_iter=3))]
    AsyncDriver(sched).run(timeout=300)
    assert {sched.records[j].device for j in ids} == {0, 1}
    for j, alg in zip(ids, ("cgls", "ossart")):
        np.testing.assert_array_equal(sched.result(j), _solo(alg, 3, proj))


def test_a_step_returns_once_its_stream_is_done(cuda):
    proj = _proj(cuda)
    stream = torch.cuda.Stream(cuda)
    ex = JobExecutor(_job("cgls", proj, n_iter=3), "plain", MEM,
                     devices=[cuda], stream=stream)
    ex.start()
    assert stream.query()
    for _ in range(3):
        ex.step()
        assert stream.query()        # nothing of the step left queued
    assert ex.result().shape == GEO.n_voxel


def test_snapshot_of_card_state_resumes_bit_identical(cuda, tmp_path):
    proj = _proj(cuda)
    d = str(tmp_path / "snap")
    sched = Scheduler(pool=DevicePool(1, MEM), snapshot_dir=d)
    jid = sched.submit(_job("cgls", proj, n_iter=4))
    sched.step_quantum()
    assert sched.drain(d) == 1
    fresh = Scheduler(pool=DevicePool(1, MEM))
    assert fresh.restore(d) == 1
    assert fresh.records[jid].iterations_done == 1
    fresh.run()
    np.testing.assert_array_equal(fresh.result(jid), _solo("cgls", 4, proj))


def test_bp_matched_scratch_fits_the_headroom(cuda):
    """Any scratch chunk gives the same bits; a budget whose headroom
    holds not one angle is refused; the chunk follows the budget."""
    ang = ANGLES[dominant_axis_mask(ANGLES)]
    a = torch.from_numpy(ang).to(cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    y = torch.randn((len(ang),) + GEO.n_detector, generator=g, device=cuda)
    want = bp_matched_cuda(y, GEO, a)
    for chunk in (1, 3, len(ang)):
        assert torch.equal(bp_matched_cuda(y, GEO, a, seg_chunk=chunk), want)
    with pytest.raises(ValueError, match="headroom"):
        bp_matched_cuda(y, GEO, a, seg_chunk=0)
    assert seg_chunk_for(GEO, MemoryModel(512 << 20)) == 8
    assert seg_chunk_for(GEO, MemoryModel(40_000)) == 0
    tight = MemoryModel(device_bytes=400_000, usable_fraction=1.0)
    op = CTOperator(GEO, ANGLES, mode="stream", memory=tight, device=cuda)
    with pytest.raises(ValueError, match="headroom"):
        op.At(y.new_zeros((len(ANGLES),) + GEO.n_detector))
