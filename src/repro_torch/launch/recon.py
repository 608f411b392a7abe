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
    # the plain-PyTorch versions on the CPU:
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
from ..core.device import DeviceLike, resolve_device
from ..core.geometry import ConeGeometry
from ..core.operator import CTOperator
from ..core.splitting import MemoryModel
from ..data import make_ct_dataset


@dataclasses.dataclass
class ReconResult:
    """What one run produced: the image, its error against the phantom,
    the residual norm before the first and after every iteration, and the
    wall seconds of every iteration (each ends in a device sync)."""
    rec: torch.Tensor
    rel_err: float
    residuals: List[float]
    seconds: List[float]
    op: CTOperator


def reconstruct(algname: str = "cgls", n: int = 64, n_angles: int = 96,
                iters: int = 10, mode: str = "plain", device_bytes: int = 0,
                device: DeviceLike = None, verbose: bool = True,
                dataset=None,
                callback: Optional[Callable] = None) -> ReconResult:
    """Reconstruct the N^3 Shepp-Logan phantom from ``n_angles``
    projections with ``iters`` iterations of ``algname``.  ``dataset``
    reuses a ``make_ct_dataset`` result for the same geometry;
    ``callback(it, state)`` runs after every iteration."""
    alg = get_algorithm(algname)
    dev = resolve_device(device)
    geo = ConeGeometry.nice(n)
    vol, angles, proj = (dataset if dataset is not None
                         else make_ct_dataset(geo, n_angles, device=dev))
    mem = (MemoryModel(device_bytes=device_bytes) if device_bytes
           else MemoryModel())
    op = CTOperator(geo, angles, mode=mode, bp_weight=alg.default_bp_weight,
                    memory=mem, device=dev)
    t_start = time.perf_counter()
    st = alg.init(proj, geo, angles, op=op)
    residuals = [float(torch.linalg.norm(st.r))]
    seconds = []
    for it in range(iters):
        t0 = time.perf_counter()
        st = alg.step(st)
        residuals.append(float(torch.linalg.norm(st.r)))   # syncs
        seconds.append(time.perf_counter() - t0)
        if callback is not None:
            callback(it, st)
    rec = alg.finalize(st)
    vol_d = vol.to(rec.device)
    rel = float(torch.linalg.norm(rec - vol_d) / torch.linalg.norm(vol_d))
    if verbose:
        print(f"[recon] {algname} N={n} angles={n_angles} iters={iters} "
              f"mode={mode} device={dev}: rel_err={rel:.4f} "
              f"({time.perf_counter() - t_start:.1f}s)")
    return ReconResult(rec=rec, rel_err=rel, residuals=residuals,
                       seconds=seconds, op=op)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--alg", default="cgls")
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--angles", type=int, default=96)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--mode", default="plain", choices=("plain", "stream"))
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
