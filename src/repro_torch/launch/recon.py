"""Reconstruction entry point: a thin client of the serving scheduler.

Port of ``repro/launch/recon.py``.  :func:`main` (the CLI) builds a
:class:`~repro_torch.serve.ReconJob` from its arguments, submits it to
a :class:`~repro_torch.serve.Scheduler` with one slot
(``Scheduler(pool=DevicePool(1, ...), guard=PreemptionGuard(),
snapshot_dir=...)``) and drives it with the threaded
:class:`~repro_torch.serve.AsyncDriver`, as :func:`serve` does; the
scheduler picks the execution mode (in-core "plain" vs out-of-core
"stream") from the planned footprint unless ``--mode`` forces one.
``--mode dist`` bypasses the scheduler and steps the algorithm over a
mesh directly, as the reference's ``_run_monolithic`` does.
``--snapshot-dir`` makes the run restart-safe: a SIGTERM parks the job's
step-wise checkpoint durably, and re-running the same command resumes it
bit-identically instead of starting over.  ``--pods N`` serves the job
through a fleet of N one-slot pods instead (:class:`~repro_torch.serve.
MultiPodScheduler` + :class:`~repro_torch.serve.MultiPodDriver`: routing
and work stealing); with ``--snapshot-dir`` the *fleet* is durable — each
pod snapshots into its own subdirectory, a ``fleet.json`` manifest
records the membership, and a re-run rebuilds the fleet with
``MultiPodScheduler.restore_fleet`` and resumes bit-identically.  Pods lie
on ``--device`` (by default all on the current card, each slot on a CUDA
stream of its own); ``--pin-devices`` pins them to the GPUs present
through a pod mesh, and the restore hands the same mesh back to
``restore_fleet`` to re-derive the pins the manifest does not record.

``--trace out.json`` enables the tracer and writes a Chrome trace (per-slab
H2D / compute / D2H spans and the scheduler's fleet events);
``--prometheus out.prom`` writes a Prometheus text snapshot at exit (the
tracer's phase totals and counters plus the calibration, SLO and
memory-margin families); ``--metrics-port N`` serves the same exposition
live over HTTP for the duration of the run (``/metrics``; 0 picks a free
port), and ``--calibration-report`` prints the modeled-vs-measured
calibration ledger, the memory margins and the SLO report as JSON at exit.
Every one of them turns the tracer on.

``--autotune`` (``reconstruct(..., autotune=True)``) turns on the measured
tile autotuner of the projector kernels (:mod:`repro_torch.kernels.
autotune`, as ``REPRO_AUTOTUNE=1``): the first use of each (kernel,
geometry shape) on the card checks every compiled tile configuration
against the default bit for bit, times the ones that agree and memoises
the winner; with ``REPRO_AUTOTUNE_CACHE=path`` the table persists across
runs (pre-bake it with ``tools/torch_autotune.py``).  Every configuration
gives the same bits, so the flag changes times, never results.

:func:`reconstruct` is the direct path: it steps the algorithm on a
:class:`CTOperator` in the requested mode without the scheduler (every
mode, dist included), and returns the per-step seconds and residuals the
scheduler's own timing is held against.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.recon --alg cgls --n 64 \
        --angles 96 --iters 10                  # --mode auto: scheduled
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
    # restart-safe: SIGTERM parks the job, the same command resumes it
    PYTHONPATH=src python -m repro_torch.launch.recon --alg cgls --n 64 \
        --angles 96 --iters 60 --snapshot-dir /tmp/recon-snap
    # a fleet of two pods on the card, durable, with the exporters:
    PYTHONPATH=src python -m repro_torch.launch.recon --alg cgls --n 64 \
        --angles 96 --iters 10 --pods 2 --snapshot-dir /tmp/fleet-snap \
        --prometheus /tmp/recon.prom --calibration-report --metrics-port 0
    # tuned tiles, the table kept across runs:
    REPRO_AUTOTUNE_CACHE=/tmp/tiles.json PYTHONPATH=src python -m \
        repro_torch.launch.recon --alg cgls --n 64 --angles 96 --autotune
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
import json
import os
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..checkpoint import PreemptionGuard
from ..core.algorithms.stepwise import get_algorithm
from ..core.device import DeviceLike, norm, resolve_device
from ..core.geometry import ConeGeometry
from ..core.operator import CTOperator
from ..core.splitting import MemoryModel
from ..data import make_ct_dataset
from ..kernels import autotune as _autotune
from ..serve import (AsyncDriver, DevicePool, JobStatus, MultiPodDriver,
                     MultiPodScheduler, Pod, PodSpec, ReconJob, Scheduler)
from ..serve.pool import FLEET_MANIFEST
from .mesh import make_host_mesh, make_pod_mesh, pod_device_groups


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
                mesh=None, backend: Optional[str] = None,
                autotune: bool = False) -> ReconResult:
    """Reconstruct the N^3 Shepp-Logan phantom from ``n_angles``
    projections with ``iters`` iterations of ``algname`` (one step for a
    direct algorithm such as FDK).  ``dataset`` reuses a
    ``make_ct_dataset`` result for the same geometry; ``callback(it,
    state)`` runs after every step.  ``mode="dist"`` shards over ``mesh``
    (default, as the reference's driver: a (data, model) = (n, 1) mesh of
    every GPU present, or of ``device`` when that is the CPU); every mode
    backprojects with the algorithm's weight (the matched adjoint for CGLS
    and FISTA, pmatched otherwise), as the reference's dist mode does.
    ``backend`` names the kernel backend ("ref" | "cuda"; None: by
    device).  ``autotune`` turns the tile autotuner on for the process
    (``--autotune``).  No scheduler is involved: see :func:`serve`."""
    if autotune:
        _autotune.enable(True)
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
                    mesh=mesh, memory=mem, device=dev, backend=backend)
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


def serve(algname: str = "cgls", n: int = 64, n_angles: int = 96,
          iters: int = 10, mode: str = "auto", device_bytes: int = 0,
          device: DeviceLike = None, snapshot_dir: str = "",
          backend: Optional[str] = None, verbose: bool = True
          ) -> Tuple[Optional[np.ndarray], Optional[float]]:
    """Reconstruct the N^3 Shepp-Logan phantom through the scheduler: one
    job on a one-slot pool on ``device``, driven by the
    :class:`AsyncDriver`.  ``mode`` "auto" lets the scheduler choose plain
    or stream from the footprint.  With ``snapshot_dir`` a job parked
    there by an earlier run is resumed instead of a new one submitted.
    Returns ``(image, rel_err)`` on the host, or ``(None, None)`` when a
    SIGTERM parked the job."""
    dev = resolve_device(device)
    geo = ConeGeometry.nice(n)
    vol, angles, proj = make_ct_dataset(geo, n_angles, device=dev)
    mem = (MemoryModel(device_bytes=device_bytes) if device_bytes
           else MemoryModel())
    guard = PreemptionGuard()
    try:
        sched = Scheduler(pool=DevicePool(1, mem, devices=[dev]),
                          guard=guard, snapshot_dir=snapshot_dir or None)
        t0 = time.perf_counter()
        if snapshot_dir and sched.restore(snapshot_dir):
            jid = next(iter(sched.records))   # resume the parked job
            if verbose:
                done = sched.records[jid].iterations_done
                print(f"[recon] resuming {jid} from snapshot "
                      f"({done} iterations already done)")
        else:
            jid = sched.submit(ReconJob(
                algname, geo, angles, proj, n_iter=iters,
                params=_job_params(algname, n_angles),
                mode=None if mode == "auto" else mode, backend=backend))
        AsyncDriver(sched).run()
    finally:
        guard.uninstall()
    record = sched.records[jid]
    if record.status is JobStatus.PREEMPTED:   # SIGTERM parked it
        if verbose:
            where = (f"; snapshot in {snapshot_dir} -- re-run to resume"
                     if snapshot_dir
                     else " (no --snapshot-dir: progress lost)")
            print(f"[recon] preempted after {record.iterations_done}/"
                  f"{iters} iterations{where}")
        return None, None
    rec = sched.result(jid)
    vol_h = vol.cpu()
    rel = float(norm(torch.from_numpy(rec) - vol_h) / norm(vol_h))
    if verbose:
        print(f"[recon] {algname} N={n} angles={n_angles} "
              f"iters={record.iterations_done} mode={mode} device={dev} "
              f"({'stream' if record.streamed else 'plain'}, scheduled): "
              f"rel_err={rel:.4f} ({time.perf_counter() - t0:.1f}s)")
    return rec, rel


def serve_fleet(algname: str = "cgls", n: int = 64, n_angles: int = 96,
                iters: int = 10, mode: str = "auto", device_bytes: int = 0,
                device: DeviceLike = None, snapshot_dir: str = "",
                backend: Optional[str] = None, verbose: bool = True,
                pods: int = 2, pin_devices: bool = False
                ) -> Tuple[Optional[np.ndarray], Optional[float]]:
    """:func:`serve` through a fleet of ``pods`` one-slot pods (``recon
    --pods``): the job is routed to the pod whose topology models the
    cheapest completion and the :class:`MultiPodDriver` runs every pod
    (idle pods steal parked work).  Pods lie on ``device``, or with
    ``pin_devices`` on the GPUs present split into ``pods`` groups of a
    pod mesh.  With ``snapshot_dir`` the fleet is durable: a fleet
    snapshot left there by an earlier run (``fleet.json``) is restored
    onto the same mesh and its job resumed instead of a new one
    submitted."""
    if mode == "dist":
        raise ValueError("--mode dist bypasses the scheduler and cannot be "
                         "combined with --pods")
    dev = resolve_device(device)
    mesh = None
    if pin_devices:
        if dev.type != "cuda":
            raise ValueError("--pin-devices pins pods to the GPUs present; "
                             f"it cannot be combined with --device {dev}")
        # every GPU, split into `pods` groups along a leading "pod" axis;
        # on restore the same mesh re-derives the pins
        mesh = make_pod_mesh(pods)
    elif dev.type != "cuda":
        mesh = make_pod_mesh(pods, devices=[dev] * pods)
    geo = ConeGeometry.nice(n)
    vol, angles, proj = make_ct_dataset(geo, n_angles, device=dev)
    mem = (MemoryModel(device_bytes=device_bytes) if device_bytes
           else MemoryModel())
    root = snapshot_dir or None
    guard = PreemptionGuard()
    try:
        if root and os.path.isfile(os.path.join(root, FLEET_MANIFEST)):
            # a previous run left a fleet snapshot: rebuild membership +
            # parked jobs and resume them instead of starting over
            mps = MultiPodScheduler.restore_fleet(root, guard=guard,
                                                  mesh=mesh)
        else:
            groups = (pod_device_groups(mesh) if mesh is not None
                      else [None] * pods)
            mps = MultiPodScheduler(
                [Pod(PodSpec(f"pod{i}", memory=mem,
                             devices=None if g is None else tuple(g)),
                     guard=guard) for i, g in enumerate(groups)],
                snapshot_root=root)
        t0 = time.perf_counter()
        if mps.restored_jobs:
            jid = mps.restored_jobs[0]
            if verbose:
                done = mps.record(jid).iterations_done
                print(f"[recon] resuming {jid} on a restored "
                      f"{len(mps.pods)}-pod fleet "
                      f"({done} iterations already done)")
        else:
            jid = mps.submit(ReconJob(
                algname, geo, angles, proj, n_iter=iters,
                params=_job_params(algname, n_angles),
                mode=None if mode == "auto" else mode, backend=backend))
        # periodic per-pod snapshots make a kill -9 recoverable too
        MultiPodDriver(mps, snapshot_every_seconds=1.0 if root else 0.0
                       ).run()
    finally:
        guard.uninstall()
    record = mps.record(jid)
    # parked states only: a FAILED job falls through to mps.result() and
    # raises its real error
    if record.status in (JobStatus.PREEMPTED, JobStatus.PENDING):
        if verbose:
            where = (f"; fleet snapshot in {root} -- re-run to resume"
                     if root else " (no --snapshot-dir: progress lost)")
            print(f"[recon] fleet preempted after "
                  f"{record.iterations_done}/{iters} iterations{where}")
        return None, None
    rec = mps.result(jid)
    vol_h = vol.cpu()
    rel = float(norm(torch.from_numpy(rec) - vol_h) / norm(vol_h))
    if verbose:
        print(f"[recon] pod fleet x{len(mps.pods)}: job ran on "
              f"{mps.owner(jid).name}")
        print(f"[recon] {algname} N={n} angles={n_angles} "
              f"iters={record.iterations_done} mode={mode} device={dev} "
              f"({'stream' if record.streamed else 'plain'}, scheduled): "
              f"rel_err={rel:.4f} ({time.perf_counter() - t0:.1f}s)")
    return rec, rel


def _write_observability(args, server) -> None:
    """The exit outputs of ``--trace``, ``--prometheus`` and
    ``--calibration-report``; stops the live endpoint."""
    if args.trace:
        obs.write_chrome_trace(args.trace)
        print(f"[recon] chrome trace -> {args.trace}")
    if args.prometheus:
        # the full exposition: tracer families plus the calibration /
        # SLO / memory-margin families
        with open(args.prometheus, "w") as f:
            f.write(obs.metrics_text())
        print(f"[recon] prometheus snapshot -> {args.prometheus}")
    if args.calibration_report:
        report = {
            "calibration": obs.CalibrationLedger.from_events().report(),
            "memory": [m.as_dict() for m in obs.memory_calibration()],
            "slo": obs.slo_report(),
        }
        print(json.dumps(report, indent=2, sort_keys=True))
    if server is not None:
        server.stop()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--alg", default="cgls",
                    choices=("cgls", "ossart", "sirt", "sart", "fdk",
                             "fista", "asd_pocs"))
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--angles", type=int, default=96)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--mode", default="auto",
                    choices=("auto", "plain", "stream", "dist"),
                    help="auto: the scheduler picks plain or stream from "
                         "the planned footprint; dist bypasses it")
    ap.add_argument("--backend", default="auto",
                    choices=("auto", "ref", "cuda"),
                    help="kernel backend: the CUDA kernels (cuda), the "
                         "plain-PyTorch versions (ref), or by device (auto)")
    ap.add_argument("--device-bytes", type=int, default=0,
                    help="per-device memory budget (placement, streaming)")
    ap.add_argument("--snapshot-dir", default="",
                    help="durable checkpoint directory: SIGTERM parks the "
                         "job there; re-running resumes bit-identically")
    ap.add_argument("--pods", type=int, default=1,
                    help="serve through a fleet of this many one-slot "
                         "pods (routing + work stealing); with "
                         "--snapshot-dir the fleet is durable")
    ap.add_argument("--pin-devices", action="store_true",
                    help="pin the pods to the GPUs present through a pod "
                         "mesh (the GPU count must divide into --pods); "
                         "a restore re-derives the pins from the same mesh")
    ap.add_argument("--trace", default="",
                    help="enable tracing and write a Chrome-trace JSON "
                         "here (open at https://ui.perfetto.dev)")
    ap.add_argument("--prometheus", default="",
                    help="write a Prometheus text snapshot (phase totals, "
                         "counters, calibration / SLO / memory-margin "
                         "families) here at exit")
    ap.add_argument("--metrics-port", type=int, default=-1,
                    help="serve the live Prometheus exposition over HTTP "
                         "on this port for the run (0: a free port)")
    ap.add_argument("--calibration-report", action="store_true",
                    help="print the calibration ledger, memory margins "
                         "and SLO report as JSON at exit")
    ap.add_argument("--autotune", action="store_true",
                    help="measure the projector kernels' tile "
                         "configurations on first use instead of taking "
                         "the default (as REPRO_AUTOTUNE=1; keep the "
                         "winners across runs with REPRO_AUTOTUNE_CACHE="
                         "path or pre-bake them with tools/torch_autotune.py)")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="where to run (default: the card; cpu runs the "
                         "plain-PyTorch versions)")
    args = ap.parse_args(argv)
    backend = None if args.backend == "auto" else args.backend
    if args.autotune:
        _autotune.enable(True)
    if args.mode == "dist" and args.pods > 1:
        raise ValueError("--mode dist bypasses the scheduler and cannot be "
                         "combined with --pods")
    # every observability output needs the tracer on: the exporters read
    # its ring buffer, the live endpoint re-reads it per scrape, and the
    # calibration ledger folds its fleet event log
    server = None
    if (args.trace or args.prometheus or args.calibration_report
            or args.metrics_port >= 0):
        obs.get_tracer().enable()
        if args.metrics_port >= 0:
            server = obs.MetricsServer(port=args.metrics_port)
            server.start()
            print(f"[recon] live metrics at {server.url}")
    try:
        if args.mode == "dist":
            res = reconstruct(args.alg, args.n, args.angles, args.iters,
                              "dist", args.device_bytes, device=args.device,
                              backend=backend)
            return res.rec, res.rel_err
        if args.pods > 1:
            return serve_fleet(args.alg, args.n, args.angles, args.iters,
                               args.mode, args.device_bytes,
                               device=args.device,
                               snapshot_dir=args.snapshot_dir,
                               backend=backend, pods=args.pods,
                               pin_devices=args.pin_devices)
        return serve(args.alg, args.n, args.angles, args.iters, args.mode,
                     args.device_bytes, device=args.device,
                     snapshot_dir=args.snapshot_dir, backend=backend)
    finally:
        # written even on a preempted exit: the partial timeline is what
        # one looks at after a preemption
        _write_observability(args, server)


if __name__ == "__main__":
    main()
