"""Reconstruction entry point: runs a step-wise algorithm directly.

Port of the reconstruction path of ``repro/launch/recon.py``, without the
serving layer (it arrives in a later slice): builds the Shepp-Logan data
set, a :class:`CTOperator` in the requested mode, and steps the algorithm
from :mod:`repro_torch.core.algorithms.stepwise` to the end.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.recon --alg cgls --n 64 \
        --angles 96 --iters 10 --mode plain
    # out-of-core on a small simulated device budget:
    PYTHONPATH=src python -m repro_torch.launch.recon --alg cgls --n 64 \
        --angles 96 --iters 4 --mode stream --device-bytes 2000000
    # OS-SART (subsets of n_angles // 8), SIRT, SART, or one-shot FDK:
    PYTHONPATH=src python -m repro_torch.launch.recon --alg ossart --n 64 \
        --angles 96 --iters 2
    PYTHONPATH=src python -m repro_torch.launch.recon --alg fdk --n 64 \
        --angles 96
    # the TV-regularised pair, with the reference's defaults (ASD-POCS:
    # subsets of 20, 20 TV steps; FISTA: L by power iteration, 20 ROF steps):
    PYTHONPATH=src python -m repro_torch.launch.recon --alg asd_pocs \
        --n 64 --angles 96 --iters 2
    PYTHONPATH=src python -m repro_torch.launch.recon --alg fista --n 64 \
        --angles 96 --iters 2
    # sharded over a mesh of every GPU present (angles over "data"):
    PYTHONPATH=src python -m repro_torch.launch.recon --alg ossart --n 64 \
        --angles 96 --iters 2 --mode dist
    # the plain-PyTorch versions on the CPU (dist: a mesh of one CPU shard):
    ... --device cpu

Prints ``[recon] ... rel_err=...`` like the reference.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, List, Optional

import torch

from ..core.algorithms.stepwise import get_algorithm
from ..core.device import DeviceLike, norm, resolve_device
from ..core.geometry import ConeGeometry
from ..core.operator import CTOperator
from ..core.splitting import MemoryModel
from ..data import make_ct_dataset
from .mesh import make_host_mesh


@dataclasses.dataclass
class ReconResult:
    """What one run produced: the image, its error against the phantom,
    the wall seconds of every step (each ends in a device sync) and, for
    an algorithm whose state carries a residual (CGLS), its norm before
    the first and after every step (empty for the others)."""
    rec: torch.Tensor
    rel_err: float
    residuals: List[float]
    seconds: List[float]
    op: CTOperator


def _job_params(algname: str, n_angles: int) -> dict:
    """Algorithm parameters the driver sets (as the reference's: the
    others, FISTA and ASD-POCS included, run with their defaults)."""
    if algname == "ossart":
        return {"subset_size": max(n_angles // 8, 1)}
    return {}


def reconstruct(algname: str = "cgls", n: int = 64, n_angles: int = 96,
                iters: int = 10, mode: str = "plain", device_bytes: int = 0,
                device: DeviceLike = None, verbose: bool = True,
                dataset=None, callback: Optional[Callable] = None,
                mesh=None) -> ReconResult:
    """Reconstruct the N^3 Shepp-Logan phantom from ``n_angles``
    projections with ``iters`` iterations of ``algname`` (one step for a
    direct algorithm such as FDK).  ``dataset`` reuses a
    ``make_ct_dataset`` result for the same geometry; ``callback(it,
    state)`` runs after every step.  ``mode="dist"`` shards over ``mesh``
    (default, as the reference's driver: a (data, model) = (n, 1) mesh of
    every GPU present, or of ``device`` when that is the CPU); every mode
    backprojects with the algorithm's weight (the matched adjoint for CGLS
    and FISTA, pmatched otherwise), as the reference's dist mode does."""
    alg = get_algorithm(algname)
    dev = resolve_device(device)
    geo = ConeGeometry.nice(n)
    vol, angles, proj = (dataset if dataset is not None
                         else make_ct_dataset(geo, n_angles, device=dev))
    mem = (MemoryModel(device_bytes=device_bytes) if device_bytes
           else MemoryModel())
    if mode == "dist" and mesh is None:
        mesh = make_host_mesh(
            model_axis=1, devices=None if dev.type == "cuda" else [dev])
    op = CTOperator(geo, angles, mode=mode, bp_weight=alg.default_bp_weight,
                    mesh=mesh, memory=mem, device=dev)
    t_start = time.perf_counter()
    st = alg.init(proj, geo, angles, op=op, **_job_params(algname, n_angles))
    has_r = hasattr(st, "r")
    residuals = [float(norm(st.r))] if has_r else []
    seconds = []
    for it in range(iters if alg.iterative else 1):
        t0 = time.perf_counter()
        st = alg.step(st)
        if has_r:
            residuals.append(float(norm(st.r)))   # syncs
        elif dev.type == "cuda":
            torch.cuda.synchronize(dev)
        seconds.append(time.perf_counter() - t0)
        if callback is not None:
            callback(it, st)
    rec = alg.finalize(st)
    vol_d = vol.to(rec.device)
    rel = float(norm(rec - vol_d) / norm(vol_d))
    if verbose:
        print(f"[recon] {algname} N={n} angles={n_angles} "
              f"iters={len(seconds)} "
              f"mode={mode} device={dev}: rel_err={rel:.4f} "
              f"({time.perf_counter() - t_start:.1f}s)")
    return ReconResult(rec=rec, rel_err=rel, residuals=residuals,
                       seconds=seconds, op=op)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--alg", default="cgls",
                    choices=("cgls", "ossart", "sirt", "sart", "fdk",
                             "fista", "asd_pocs"))
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--angles", type=int, default=96)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--mode", default="plain",
                    choices=("plain", "stream", "dist"))
    ap.add_argument("--device-bytes", type=int, default=0,
                    help="per-device memory budget the planner splits for")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="where to run (default: the card; cpu runs the "
                         "plain-PyTorch versions)")
    args = ap.parse_args(argv)
    reconstruct(args.alg, args.n, args.angles, args.iters, args.mode,
                args.device_bytes, device=args.device)


if __name__ == "__main__":
    main()
