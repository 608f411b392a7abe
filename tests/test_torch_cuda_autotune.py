"""The tile configurations of ``fp_ray``, ``bp_matched`` and ``bp_voxel``
and the measured autotuner on the card.

Every compiled configuration must give configuration 0's bits (N=61 with
a 67 x 71 detector and 13 angles, and N=64), ``tune`` must refuse a
candidate whose output differs in one bit, a CGLS step of a ``CTOperator``
under a tuned table must equal the untuned one bit for bit, and
``tools/torch_autotune.py --smoke`` must pass on the card.

Every test here needs a CUDA device and ``nvcc`` (the kernels build at
first use) and skips without a device.  The file imports nothing of JAX:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda_autotune.py -q
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core.geometry import (ConeGeometry, circular_angles,
                                       dominant_axis_mask)
from repro_torch.kernels import autotune, build
from repro_torch.kernels.bp_matched import bp_matched_cuda
from repro_torch.kernels.bp_voxel import bp_voxel_cuda
from repro_torch.kernels.fp_ray import fp_ray_cuda

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = {"N=61": (ConeGeometry.nice(61, n_detector=(67, 71)), 13),
         "N=64": (ConeGeometry.nice(64), 48)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only there)")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _reset_autotune(monkeypatch):
    monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)
    monkeypatch.delenv("REPRO_AUTOTUNE_CACHE", raising=False)
    autotune.enable(None)
    autotune.clear()
    yield
    autotune.enable(None)
    autotune.clear()


def _randn(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32)).cuda()


def _calls(geo, n_angles):
    """Each tuned kernel as ``f(config)`` on seeded inputs: the whole
    volume and a z0 > 0 slab for the Joseph pair."""
    ang = circular_angles(n_angles)
    a_x = torch.from_numpy(ang[dominant_axis_mask(ang)]).cuda()
    a = torch.from_numpy(ang).cuda()
    nz = geo.n_voxel[0]
    z0, z1 = nz // 3, 2 * nz // 3 + 1
    vol = _randn(geo.n_voxel, 1)
    y = _randn((a_x.numel(),) + geo.n_detector, 2)
    p = _randn((a.numel(),) + geo.n_detector, 3)
    slab = vol[z0:z1].contiguous()
    return {
        "fp_ray": lambda c: torch.cat([
            fp_ray_cuda(vol, geo, a_x, 0, c),
            fp_ray_cuda(slab, geo, a_x, z0, c)]),
        "bp_matched": lambda c: torch.cat([
            bp_matched_cuda(y, geo, a_x, config=c),
            bp_matched_cuda(y, geo, a_x, z0, z1 - z0, config=c)]),
        "bp_voxel": lambda c: torch.cat([
            bp_voxel_cuda(p, geo, a, w, z, pl, c)
            for w in ("fdk", "pmatched") for z, pl in ((0, nz), (z0, z1 - z0))
        ]),
    }


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("name", ["fp_ray", "bp_matched", "bp_voxel"])
def test_every_configuration_gives_configuration_0s_bits(cuda, name, case):
    geo, n_angles = CASES[case]
    call = _calls(geo, n_angles)[name]
    want = call(0)
    cfgs = build.configs(name)
    assert len(cfgs) > 1 and cfgs[0]
    for i in range(1, len(cfgs)):
        got = call(i)
        assert torch.equal(got, want), (
            f"{name} {case} configuration {i} {cfgs[i]}: "
            f"{int((got != want).sum())} elements differ")
    torch.cuda.synchronize()


def test_unknown_configuration_raises(cuda):
    geo, n_angles = CASES["N=64"]
    n = len(build.configs("fp_ray"))
    with pytest.raises(RuntimeError, match="CUDA error"):
        _calls(geo, n_angles)["fp_ray"](n)


def test_tune_refuses_a_candidate_that_differs_in_one_bit(cuda, monkeypatch):
    geo = ConeGeometry.nice(32)
    real = autotune._run

    def flipped(kind, g, planes, cfg, device):
        out = real(kind, g, planes, cfg, device)
        if cfg["config"] == 1:
            out = out.clone()
            out.view(-1).view(torch.int32)[7] ^= 1     # one bit
        return out
    monkeypatch.setattr(autotune, "_run", flipped)
    autotune.enable(True)
    rep = autotune.tune("fp", geo, device=cuda, repeats=1)
    assert rep.refused == [1]
    assert rep.candidates[1]["seconds"] is None
    assert all(c["bit_equal"] for c in rep.candidates if c["config"] != 1)
    assert rep.winner != 1


def test_tuned_cgls_step_is_bit_equal(cuda):
    from repro_torch.core.algorithms.stepwise import get_algorithm
    from repro_torch.core.operator import CTOperator
    geo = ConeGeometry.nice(32)
    angles = circular_angles(24)
    proj = _randn((len(angles),) + geo.n_detector, 4)
    alg = get_algorithm("cgls")

    def one_step():
        op = CTOperator(geo, angles, device=cuda)
        st = alg.step(alg.init(proj, geo, angles, op=op))
        return st.x.clone(), op.kernel_config()
    want, cfg0 = one_step()
    assert cfg0["fp.config"] == cfg0["bp_matched.config"] == 0
    autotune.enable(True)
    with autotune._LOCK:             # each kind at its last configuration
        for kind in ("fp", "bp_matched", "bp"):
            last = len(autotune.configs(kind)) - 1
            planes = geo.n_voxel[0] if kind == "bp" else None
            autotune._TABLE[autotune.shape_class(kind, geo, planes, cuda)] = \
                dict(autotune.configs(kind)[last], config=last)
    got, cfg = one_step()
    assert cfg["fp.config"] > 0 and cfg["bp_matched.config"] > 0
    assert cfg["autotuned"] is True and "fp.rows_per" in cfg
    assert torch.equal(got, want)


def test_tool_smoke_on_the_card(cuda):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "tools/torch_autotune.py",
                          "--smoke", "--device", "cuda"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "SMOKE OK" in out.stdout
