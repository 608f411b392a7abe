"""The port's fleet on the card: pods sharing one GPU, each slot on a CUDA
stream of its own; a steal and a live migration between two pods of
``cuda:0`` bit for bit as solo runs, with both slots' streams idle after
the hand-off; ``restore_fleet`` onto a pod mesh of ``cuda:0`` (the pins
re-derived) and without a mesh (the pods on the current card); and a
two-GPU fleet where the machine has two cards.

Every test here needs a CUDA device and ``nvcc`` (the kernels build at
first use) and skips without one.  The file imports nothing of JAX, so it
runs where the port runs:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda_fleet.py -q
"""

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core.algorithms.stepwise import get_algorithm
from repro_torch.core.geometry import ConeGeometry, circular_angles
from repro_torch.core.operator import CTOperator
from repro_torch.core.splitting import MemoryModel
from repro_torch.launch.mesh import make_pod_mesh
from repro_torch.serve import (JobStatus, MultiPodDriver, MultiPodScheduler,
                               Pod, PodSpec, ReconJob, migrate_once,
                               pods_from_mesh, steal_pass)
from repro_torch.serve.steal import fleet_units

pytestmark = pytest.mark.cuda

GEO = ConeGeometry.nice(32)
ANGLES = circular_angles(24)
PARAMS = {"cgls": {}, "ossart": {"subset_size": 8}}
#: one job resident a pod at a time (a job reserves 688128 B), so the rest
#: of its queue stays parked; the 5 % headroom holds bp_matched's scratch
MEM = MemoryModel(device_bytes=1_000_000)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only there)")
    return torch.device("cuda", 0)


def _proj(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    vol = torch.rand(GEO.n_voxel, generator=g, device=cuda)
    return CTOperator(GEO, ANGLES, device=cuda).A(vol)


def _solo(alg, n_iter, proj):
    a = get_algorithm(alg)
    op = CTOperator(GEO, ANGLES, bp_weight=a.default_bp_weight,
                    memory=MEM, device=proj.device)
    st = a.init(proj, GEO, ANGLES, op=op, **PARAMS[alg])
    for _ in range(n_iter):
        st = a.step(st)
    return a.finalize(st).cpu().numpy()


def _job(alg, proj, n_iter=3):
    return ReconJob(alg, GEO, ANGLES, proj, n_iter=n_iter,
                    params=dict(PARAMS[alg]), mode="plain")


def _streams_idle(pods):
    return all(s.stream.query() for p in pods for s in p.pool.slots)


def test_pods_share_the_card_on_streams_of_their_own(cuda):
    pods = [Pod(PodSpec(f"p{i}", n_devices=2, memory=MEM))
            for i in range(2)]
    slots = [s for p in pods for s in p.pool.slots]
    assert all(s.device == cuda for s in slots)
    assert len({s.stream.cuda_stream for s in slots}) == 4


def test_steal_between_pods_of_one_card_is_bit_identical(cuda, tmp_path):
    proj = _proj(cuda)
    pods = [Pod(PodSpec(f"p{i}", memory=MEM)) for i in range(2)]
    mps = MultiPodScheduler(pods, transfer_dir=str(tmp_path))
    kernels.reset_counters()
    ids = [mps.submit(_job(alg, proj), pod=0)
           for alg in ("cgls", "ossart", "cgls")]
    moved = mps.steal_pass()
    assert moved and all(j in pods[1].scheduler.records for j in moved)
    # the thief holds what the transfer directory held: host arrays
    for j in moved:
        assert isinstance(pods[1].scheduler.records[j].job.projections,
                          np.ndarray)
    MultiPodDriver(mps).run(timeout=300)
    c = kernels.counters()
    for name in ("fp_ray", "bp_matched", "bp_voxel"):
        assert c[name]["launches"] > 0 and c[name]["plain_calls"] == 0
    assert _streams_idle(pods)
    for j, alg in zip(ids, ("cgls", "ossart", "cgls")):
        assert mps.record(j).status is JobStatus.COMPLETED, \
            mps.record(j).error
        np.testing.assert_array_equal(mps.result(j), _solo(alg, 3, proj))


def test_migration_between_pods_of_one_card_is_bit_identical(cuda,
                                                             tmp_path):
    """A running CGLS job parks at its step boundary on p0, leaves its
    stream through the transfer directory and resumes on p1's."""
    proj = _proj(cuda)
    pods = [Pod(PodSpec(f"p{i}", memory=MEM)) for i in range(2)]
    mps = MultiPodScheduler(pods, steal=False, transfer_dir=str(tmp_path))
    mig = mps.submit(_job("cgls", proj, 4), pod=0)
    parked = mps.submit(_job("cgls", proj, 2), pod=0)
    pods[0].scheduler.step_quantum()
    assert mps.record(mig).iterations_done == 1
    assert migrate_once(pods[0], pods[1], str(tmp_path),
                        units=fleet_units(pods)) == mig
    assert _streams_idle(pods)
    assert mps.owner(mig).name == "p1"
    assert mps.record(mig).status is JobStatus.PREEMPTED
    MultiPodDriver(mps).run(timeout=300)
    assert _streams_idle(pods)
    np.testing.assert_array_equal(mps.result(mig), _solo("cgls", 4, proj))
    np.testing.assert_array_equal(mps.result(parked),
                                  _solo("cgls", 2, proj))


@pytest.mark.parametrize("with_mesh", [True, False],
                         ids=["pod-mesh", "no-mesh"])
def test_restore_fleet_onto_the_card(cuda, tmp_path, with_mesh):
    """A drained fleet restored onto a pod mesh of cuda:0 (the pins
    re-derived from it) or with no mesh (the pods on the current card)
    finishes bit for bit."""
    proj = _proj(cuda)
    root = str(tmp_path / "fleet")
    mesh = make_pod_mesh(2, devices=["cuda:0"] * 2)
    mps = MultiPodScheduler(pods_from_mesh(mesh, memory=MEM),
                            snapshot_root=root)
    jids = [mps.submit(_job("cgls", proj, 4)) for _ in range(2)]
    mps.run(max_rounds=1)
    assert mps.drain_fleet() >= 1
    restored = MultiPodScheduler.restore_fleet(
        root, mesh=mesh if with_mesh else None)
    assert sorted(restored.restored_jobs) == sorted(jids)
    assert {p.name for p in restored.pods} == {"pod0", "pod1"}
    assert all(s.device == cuda and s.stream is not None
               for p in restored.pods for s in p.pool.slots)
    assert all((p.spec.devices is not None) == with_mesh
               for p in restored.pods)
    MultiPodDriver(restored).run(timeout=300)
    want = _solo("cgls", 4, proj)
    for j in jids:
        np.testing.assert_array_equal(restored.result(j), want)


def test_two_gpu_fleet(tmp_path):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    mesh = make_pod_mesh(2, devices=["cuda:0", "cuda:1"])
    pods = pods_from_mesh(mesh, memory=MEM)
    assert [str(p.pool.slots[0].device) for p in pods] == ["cuda:0",
                                                          "cuda:1"]
    proj = _proj(torch.device("cuda", 0))
    mps = MultiPodScheduler(pods, transfer_dir=str(tmp_path))
    ids = [mps.submit(_job("cgls", proj), pod=0) for _ in range(3)]
    assert steal_pass(mps.pods, str(tmp_path))
    MultiPodDriver(mps).run(timeout=300)
    assert {mps.owner(j).name for j in ids} == {"pod0", "pod1"}
    want = _solo("cgls", 3, proj)
    for j in ids:
        np.testing.assert_array_equal(mps.result(j), want)
