#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

Builds the port's CUDA kernels from the sources in this checkout, holds
each against its plain-PyTorch version (parity, the adjoint identity of
the Joseph pair, bit-identical repeat launches), drives the port's paths
at N=512 (512^3 volume, 512^2 detector, 512 angles) through its own entry
points, and prints the kernels' measurements.  The paths:

* CGLS with the Joseph A (``fp_ray``) and its exact adjoint
  (``bp_matched``), in-core and streamed out-of-core;
* FDK on the voxel-driven backprojector (``bp_voxel``), in-core;
* OS-SART on ``fp_ray`` and ``bp_voxel``, in-core and streamed;
* ASD-POCS: OS-SART sweeps on ``fp_ray`` and ``bp_voxel`` and TV steepest
  descent on the TV-gradient kernel (``tv_grad``), in-core and streamed;
* FISTA-TV on ``fp_ray`` and ``bp_matched`` with the ROF prox, in-core.

Each path is run with the kernel counters set to 0 just before it and read
just after, and must have launched the kernels it runs (and called none of
their plain versions).

    python3 chip_smoke.py            # the whole run (one GPU)
    python3 chip_smoke.py --quick    # build and kernel checks at N=64 only

Every phase raises on failure, so the exit code is nonzero unless all of
them pass.  Without a CUDA device, or without the repository around it,
the script exits nonzero before printing any result.  The last line is
``{"ok": true, "device": {...}}``; the line before it is a JSON object of
per-kernel numbers, and the one before that the card's name and power
limit from nvidia-smi.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# the card's published peaks (H100 SXM data sheet; full 700 W limit)
PEAK_FP32 = 67e12          # FLOP/s, fp32 outside the tensor cores
PEAK_BYTES = 3.35e12       # bytes/s, HBM3
#: fp32 operations per ray-plane sample (per voxel-angle pair in A^T): the
#: two y blends, the z blend and the accumulation
OPS_PER_SAMPLE = 8
#: fp32 operations per voxel-angle pair in bp_voxel's inner loop, counted
#: in csrc/bp_voxel.cu: fv 3, floor and fraction 2, tap weights 5, the four
#: taps 7, depth weight and accumulation 2
OPS_PER_PAIR_VOXEL = 19
#: fp32 operations per voxel in tv_grad's body, counted in csrc/tv_grad.cu:
#: 15 at the voxel, 13 for each of the three backward terms (a sqrt and a
#: division counted as one each)
OPS_PER_VOXEL_TV = 54
RTOL, ATOL = 2e-4, 5e-3    # kernel vs plain (tests/test_backend.py:23)
TV_RTOL, TV_ATOL = 1e-5, 1e-5   # tv_grad vs plain (tests/test_kernels.py:70)
SCALAR_RTOL = 1e-4         # ASD-POCS's dtvg / dp_first, streamed vs plain
TV_STEPS = 20              # tv_grad launches per ASD-POCS iteration
ADJ_TOL = 1e-4             # relative adjoint defect (tests/test_adjoint.py)
CGLS_TOL = 2e-3            # algorithm iterates (tests/test_adjoint.py:199)
SART_TOL = 2e-3            # streamed vs plain (tests/test_algorithms.py:77)
#: the kernels each path runs (its counter check)
PATH_KERNELS = {"cgls": ("fp_ray", "bp_matched"), "fdk": ("bp_voxel",),
                "ossart": ("fp_ray", "bp_voxel"),
                "asd_pocs": ("fp_ray", "bp_voxel", "tv_grad"),
                "fista": ("fp_ray", "bp_matched")}


def log(msg: str) -> None:
    print(msg, flush=True)


def run(cmd) -> str:
    return subprocess.run(cmd, check=True, capture_output=True,
                          text=True).stdout.strip()


def check_close(name, got, want, rtol=RTOL, atol=ATOL) -> float:
    import torch
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    max_err = float(err.max())
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} of {bad.numel()} elements outside "
            f"rtol={rtol} atol={atol} (max |err| {max_err:.3g})")
    log(f"  {name}: max |err| {max_err:.3g} (rtol {rtol}, atol {atol})")
    return max_err


def adjoint_defect(fx, y, x, aty) -> float:
    lhs = float((fx.double() * y.double()).sum())
    rhs = float((x.double() * aty.double()).sum())
    return abs(lhs - rhs) / max(abs(lhs), abs(rhs), 1e-30)


def check_image(res, geo) -> None:
    """A reconstruction is finite, of the volume's shape, and closer to
    the phantom than the zero image."""
    import torch
    if tuple(res.rec.shape) != tuple(geo.n_voxel):
        raise AssertionError(f"image shape {tuple(res.rec.shape)}")
    if not bool(torch.isfinite(res.rec).all()):
        raise AssertionError("image has non-finite values")
    if not 0.0 < res.rel_err < 1.0:
        raise AssertionError(f"rel_err {res.rel_err}")


def check_counts(counts, path: str, what: str) -> None:
    """The kernels of ``path`` were launched and their plain versions not
    called; nothing is asked of the other kernels."""
    for name in PATH_KERNELS[path]:
        c = counts[name]
        if c["launches"] <= 0 or c["plain_calls"] != 0:
            raise AssertionError(f"{name}: {what} ran {c}")


def launches_between(before, after):
    return {k: after[k] - before[k] for k in before}


def cuda_ms(fn, reps: int) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()`` after a warm-up."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def once_ms(fn):
    """(milliseconds, result) of one synchronised call."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def phase_environment():
    import torch
    log("== environment")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"torch.version.cuda {torch.version.cuda}")
    from repro_torch.kernels import build
    nvcc = run([build.nvcc_path(), "--version"]).splitlines()
    log("nvcc: " + next((s for s in nvcc if "release" in s), nvcc[-1]))
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"])
    log(f"nvidia-smi: {smi}")
    return smi.splitlines()[0]


def phase_build():
    from repro_torch.kernels import build
    log("== build")
    t0 = time.perf_counter()
    secs = build.build(verbose=True)
    log(f"built {sorted(secs)} in {time.perf_counter() - t0:.1f}s "
        f"(per library: {', '.join(f'{k} {v:.1f}s' for k, v in secs.items())})")


def phase_kernel_checks(n: int, n_angles: int):
    """Each kernel against its plain version on the card: x and y
    dominance, whole volume and a z0 > 0 slab; the adjoint identity of the
    pair; bit-identical repeat launches."""
    import torch
    from repro_torch.core.geometry import (ConeGeometry, circular_angles,
                                           dominant_axis_mask)
    from repro_torch.core.projector import _rotate_vol_90
    from repro_torch.kernels.bp_matched import (bp_matched_cuda,
                                                bp_matched_plain)
    from repro_torch.kernels.fp_ray import fp_ray_cuda, fp_ray_plain
    log(f"== kernel checks at N={n}, {n_angles} angles")
    geo = ConeGeometry.nice(n)
    angles = circular_angles(n_angles)
    mask = dominant_axis_mask(angles)
    gen = torch.Generator(device="cuda").manual_seed(0)
    vol = torch.randn(geo.n_voxel, generator=gen, device="cuda")
    z0, z1 = n // 3, (2 * n) // 3
    for dom, ang in (("x", angles[mask]), ("y", angles[~mask])):
        a = torch.from_numpy(ang).cuda()
        v = vol
        if dom == "y":       # the backend's -90 deg rotation trick
            v = _rotate_vol_90(vol).contiguous()
            a = a - torch.pi / 2
        for part, slab, zz in (("full", v, 0), ("slab", v[z0:z1], z0)):
            slab = slab.contiguous()
            tag = f"{dom}-dominant {part}"
            fk = fp_ray_cuda(slab, geo, a, z0=zz)
            check_close(f"fp_ray {tag}", fk, fp_ray_plain(slab, geo, a, zz))
            y = torch.randn(fk.shape, generator=gen, device="cuda")
            bk = bp_matched_cuda(y, geo, a, z0=zz, z_planes=slab.shape[0])
            check_close(f"bp_matched {tag}", bk,
                        bp_matched_plain(y, geo, a, zz, slab.shape[0]))
            rel = adjoint_defect(fk, y, slab, bk)
            log(f"  adjoint defect {tag}: {rel:.3g}")
            if not rel <= ADJ_TOL:
                raise AssertionError(f"adjoint defect {rel:.3g} > {ADJ_TOL}")
            if not torch.equal(fk, fp_ray_cuda(slab, geo, a, z0=zz)):
                raise AssertionError(f"fp_ray {tag}: repeat launch differs")
            if not torch.equal(bk, bp_matched_cuda(y, geo, a, z0=zz,
                                                   z_planes=slab.shape[0])):
                raise AssertionError(f"bp_matched {tag}: repeat launch "
                                     "differs")
    torch.cuda.synchronize()
    log("  repeat launches bit-identical")


def phase_main_plain(n: int, n_angles: int, iters: int):
    import torch
    from repro_torch import kernels
    from repro_torch.core.geometry import ConeGeometry
    from repro_torch.data import make_ct_dataset
    from repro_torch.launch.recon import reconstruct
    log(f"== main path, plain mode: N={n}, {n_angles} angles, "
        f"{iters} CGLS iterations")
    geo = ConeGeometry.nice(n)
    kernels.reset_counters()
    t0 = time.perf_counter()
    ds = make_ct_dataset(geo, n_angles, device="cuda")
    torch.cuda.synchronize()
    log(f"  data set in {time.perf_counter() - t0:.1f}s "
        "(phantom on the host, projections by the fp_ray kernel)")
    snaps = {}
    per_iter = []

    def cb(it, st):
        per_iter.append({k: v["launches"]
                         for k, v in kernels.counters().items()})
        if it == 1:
            snaps["x2"] = st.x.clone()
    torch.cuda.reset_peak_memory_stats()
    res = reconstruct("cgls", n=n, n_angles=n_angles, iters=iters,
                      mode="plain", device="cuda", dataset=ds, callback=cb)
    counts = kernels.counters()
    log(f"  seconds per iteration {[round(s, 3) for s in res.seconds]}, "
        f"rel_err {res.rel_err:.4f}, residuals "
        f"{[round(r, 2) for r in res.residuals]}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"  counters {counts}")
    check_image(res, geo)
    if not all(b < a for a, b in zip(res.residuals, res.residuals[1:])):
        raise AssertionError(f"residual did not fall: {res.residuals}")
    check_counts(counts, "cgls", "plain CGLS")
    launches_per_iter = launches_between(per_iter[0], per_iter[1])
    log(f"  launches per CGLS iteration {launches_per_iter}")
    return ds, snaps["x2"], counts, launches_per_iter


def phase_main_stream(n: int, n_angles: int, ds, x2_plain, device_bytes):
    import torch
    from repro_torch import kernels, obs
    from repro_torch.core.geometry import ConeGeometry
    from repro_torch.core.plan import plan
    from repro_torch.core.splitting import MemoryModel
    from repro_torch.core.streaming import stream_backward, stream_forward
    from repro_torch.launch.recon import reconstruct
    log(f"== main path, streamed: N={n}, {n_angles} angles, device budget "
        f"{device_bytes / 2**20:.0f} MiB")
    vol, angles, proj = ds
    pl = plan(ConeGeometry.nice(n), n_angles, 1,
              MemoryModel(device_bytes=device_bytes))
    log(f"  plan: fp {pl.forward.n_slabs} slabs x chunk "
        f"{pl.forward.angle_chunk}, bp {pl.backward.n_slabs} slabs x chunk "
        f"{pl.backward.angle_chunk}, prefetch depth {pl.comm.prefetch_depth}")
    if pl.forward.n_slabs < 3 or pl.backward.n_slabs < 3:
        raise AssertionError("the budget should split FP and BP into >= 3 "
                             "slabs")
    tracer = obs.Tracer(enabled=True)
    prev = obs.set_tracer(tracer)
    kernels.reset_counters()
    try:
        t0 = time.perf_counter()
        res = reconstruct("cgls", n=n, n_angles=n_angles, iters=2,
                          mode="stream", device_bytes=device_bytes,
                          device="cuda", dataset=ds)
        wall = time.perf_counter() - t0
    finally:
        obs.set_tracer(prev)
    counts = kernels.counters()
    log(f"  seconds per iteration {[round(s, 3) for s in res.seconds]}, "
        f"rel_err {res.rel_err:.4f}; counters {counts}")
    # host-clock span totals: compute spans end in a device sync, so they
    # hold the kernels' time; the rest of the wall time is host work
    phases = tracer.phase_seconds()
    log(f"  span seconds over the whole run ({wall:.2f} s wall, "
        f"init + 2 iterations): "
        + ", ".join(f"{k} {v:.3f}" for k, v in sorted(phases.items()))
        + f", outside spans {wall - sum(phases.values()):.3f}")
    check_counts(counts, "cgls", "streamed CGLS")
    check_image(res, res.op.geo)
    check_close("stream CGLS x2 vs plain CGLS x2", res.rec,
                x2_plain.cpu(), rtol=CGLS_TOL, atol=CGLS_TOL)
    op = res.op
    serial = op.plan.with_prefetch(0).comm
    geo = op.geo
    fa = stream_forward(vol, geo, angles, op.plan, device="cuda")
    fb = stream_forward(vol, geo, angles, op.plan, device="cuda",
                        comm=serial)
    if not torch.equal(fa, fb):
        raise AssertionError("stream A: prefetch depth changed the bits")
    ba = stream_backward(proj, geo, angles, op.plan, device="cuda")
    bb = stream_backward(proj, geo, angles, op.plan, device="cuda",
                         comm=serial)
    if not torch.equal(ba, bb):
        raise AssertionError("stream At: prefetch depth changed the bits")
    log(f"  A and At bit-identical at prefetch depth "
        f"{op.plan.comm.prefetch_depth} and 0")
    return counts


def phase_bp_voxel_checks(n: int, n_angles: int):
    """bp_voxel against its plain version on the card for each weight,
    over the whole volume and a z_start > 0 slab, plus an odd,
    non-power-of-two shape; repeat launches bit-identical."""
    import torch
    from repro_torch.core.geometry import ConeGeometry, circular_angles
    from repro_torch.kernels.bp_voxel import bp_voxel_cuda, bp_voxel_plain
    n_odd, a_odd = 61, 37
    log(f"== bp_voxel checks at N={n}, {n_angles} angles and at N={n_odd}, "
        f"{a_odd} angles")
    gen = torch.Generator(device="cuda").manual_seed(1)
    for nn, na in ((n, n_angles), (n_odd, a_odd)):
        geo = ConeGeometry.nice(nn)
        a = torch.from_numpy(circular_angles(na)).cuda()
        y = torch.randn((na,) + geo.n_detector, generator=gen, device="cuda")
        for weight in ("fdk", "pmatched", "none"):
            for part, z0, planes in (("full", 0, nn),
                                     ("slab", nn // 3, nn // 3 + 1)):
                tag = f"bp_voxel N={nn} {weight} {part}"
                got = bp_voxel_cuda(y, geo, a, weight, z0, planes)
                check_close(tag, got,
                            bp_voxel_plain(y, geo, a, weight, z0, planes))
                if not torch.equal(got, bp_voxel_cuda(y, geo, a, weight, z0,
                                                      planes)):
                    raise AssertionError(f"{tag}: repeat launch differs")
    torch.cuda.synchronize()
    log("  repeat launches bit-identical")


def phase_fdk(n: int, n_angles: int, ds):
    import torch
    from repro_torch import kernels
    from repro_torch.core.geometry import ConeGeometry
    from repro_torch.launch.recon import reconstruct
    log(f"== FDK, plain mode: N={n}, {n_angles} angles")
    geo = ConeGeometry.nice(n)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counters()
    res = reconstruct("fdk", n=n, n_angles=n_angles, mode="plain",
                      device="cuda", dataset=ds)
    counts = kernels.counters()
    log(f"  seconds {[round(s, 3) for s in res.seconds]}, rel_err "
        f"{res.rel_err:.4f}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"counters {counts}")
    check_image(res, geo)
    check_counts(counts, "fdk", "FDK")
    return counts


def phase_ossart_plain(n: int, n_angles: int, ds, iters: int):
    import torch
    from repro_torch import kernels
    from repro_torch.core.geometry import ConeGeometry
    from repro_torch.launch.recon import reconstruct
    log(f"== OS-SART, plain mode: N={n}, {n_angles} angles, subsets of "
        f"{max(n_angles // 8, 1)}, {iters} iterations")
    geo = ConeGeometry.nice(n)
    per_iter = []

    def cb(it, st):
        torch.cuda.synchronize()
        per_iter.append({k: v["launches"]
                         for k, v in kernels.counters().items()})
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counters()
    t0 = time.perf_counter()
    res = reconstruct("ossart", n=n, n_angles=n_angles, iters=iters,
                      mode="plain", device="cuda", dataset=ds, callback=cb)
    wall = time.perf_counter() - t0
    counts = kernels.counters()
    launches_per_iter = launches_between(per_iter[0], per_iter[1])
    log(f"  seconds per iteration {[round(s, 3) for s in res.seconds]} "
        f"({wall:.2f} s with init), rel_err {res.rel_err:.4f}, peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"  counters {counts}; launches per OS-SART iteration "
        f"{launches_per_iter}")
    check_image(res, geo)
    check_counts(counts, "ossart", "plain OS-SART")
    return res.rec, counts, launches_per_iter


def phase_ossart_stream(n: int, n_angles: int, ds, x_plain, device_bytes):
    import torch
    from repro_torch import kernels, obs
    from repro_torch.core.geometry import ConeGeometry
    from repro_torch.core.streaming import stream_backward
    from repro_torch.launch.recon import reconstruct
    log(f"== OS-SART, streamed: N={n}, {n_angles} angles, device budget "
        f"{device_bytes / 2**20:.0f} MiB, 2 iterations")
    _, angles, proj = ds
    tracer = obs.Tracer(enabled=True)
    prev = obs.set_tracer(tracer)
    kernels.reset_counters()
    try:
        t0 = time.perf_counter()
        res = reconstruct("ossart", n=n, n_angles=n_angles, iters=2,
                          mode="stream", device_bytes=device_bytes,
                          device="cuda", dataset=ds)
        wall = time.perf_counter() - t0
    finally:
        obs.set_tracer(prev)
    counts = kernels.counters()
    pl = res.op.plan
    log(f"  plan: fp {pl.forward.n_slabs} slabs, bp {pl.backward.n_slabs} "
        f"slabs x chunk {pl.backward.angle_chunk}, prefetch depth "
        f"{pl.comm.prefetch_depth}")
    log(f"  seconds per iteration {[round(s, 3) for s in res.seconds]}, "
        f"rel_err {res.rel_err:.4f}; counters {counts}")
    phases = tracer.phase_seconds()
    log(f"  span seconds over the whole run ({wall:.2f} s wall, "
        f"init + 2 iterations): "
        + ", ".join(f"{k} {v:.3f}" for k, v in sorted(phases.items()))
        + f", outside spans {wall - sum(phases.values()):.3f}")
    check_counts(counts, "ossart", "streamed OS-SART")
    check_image(res, ConeGeometry.nice(n))
    check_close("stream OS-SART x2 vs plain OS-SART x2", res.rec,
                x_plain.cpu(), rtol=SART_TOL, atol=SART_TOL)
    geo = res.op.geo
    ba = stream_backward(proj, geo, angles, pl, weight="pmatched",
                         device="cuda")
    bb = stream_backward(proj, geo, angles, pl, weight="pmatched",
                         device="cuda", comm=pl.with_prefetch(0).comm)
    if not torch.equal(ba, bb):
        raise AssertionError("stream At(pmatched): prefetch depth changed "
                             "the bits")
    log(f"  At(pmatched) bit-identical at prefetch depth "
        f"{pl.comm.prefetch_depth} and 0")
    return counts


def phase_tv_grad_checks(n: int):
    """tv_grad against its plain version on the card: an N^3 and an odd
    volume, volumes of 1 and 2 planes; seeded random values and the
    piecewise-constant Shepp-Logan phantom (zero differences, so m = eps);
    repeat launches bit-identical."""
    import torch
    from repro_torch.core import phantoms
    from repro_torch.core.geometry import ConeGeometry
    from repro_torch.kernels.tv_grad import tv_grad_cuda, tv_grad_plain
    shapes = ((n, n, n), (61, 37, 45), (1, 64, 64), (2, 64, 64))
    log(f"== tv_grad checks at {', '.join(str(s) for s in shapes)}")
    gen = torch.Generator(device="cuda").manual_seed(2)
    same = 0
    for shape in shapes:
        vols = {"random": torch.randn(shape, generator=gen, device="cuda")}
        if min(shape) > 2:
            vols["shepp-logan"] = torch.from_numpy(phantoms.shepp_logan(
                ConeGeometry.nice(n).with_voxels(shape))).cuda()
        for kind, v in vols.items():
            tag = f"tv_grad {shape} {kind}"
            got = tv_grad_cuda(v)
            want = tv_grad_plain(v)
            check_close(tag, got, want, rtol=TV_RTOL, atol=TV_ATOL)
            same += int(torch.equal(got, want))
            if not torch.equal(got, tv_grad_cuda(v)):
                raise AssertionError(f"{tag}: repeat launch differs")
    torch.cuda.synchronize()
    log(f"  repeat launches bit-identical; {same} of the cases equal to the "
        "plain version bit for bit")


def phase_asd_pocs_plain(n: int, n_angles: int, ds, iters: int):
    import torch
    from repro_torch import kernels
    from repro_torch.core.geometry import ConeGeometry
    from repro_torch.launch.recon import reconstruct
    log(f"== ASD-POCS, plain mode: N={n}, {n_angles} angles, the reference "
        f"driver's subsets of 20 and {TV_STEPS} TV steps, {iters} "
        "iterations")
    geo = ConeGeometry.nice(n)
    per_iter = []
    first = {}

    def cb(it, st):
        torch.cuda.synchronize()
        per_iter.append({k: v["launches"]
                         for k, v in kernels.counters().items()})
        if it == 0:
            first.update(x=st.x.cpu(), dtvg=st.dtvg, dp_first=st.dp_first)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counters()
    t0 = time.perf_counter()
    res = reconstruct("asd_pocs", n=n, n_angles=n_angles, iters=iters,
                      mode="plain", device="cuda", dataset=ds, callback=cb)
    wall = time.perf_counter() - t0
    counts = kernels.counters()
    per = launches_between(per_iter[0], per_iter[1])
    log(f"  seconds per iteration {[round(s, 3) for s in res.seconds]} "
        f"(the first builds the {len(res.op.subset_indices(20))} subsets' "
        f"factors; {wall:.2f} s in all), rel_err {res.rel_err:.4f}, peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"  after iteration 1: dtvg {first['dtvg']!r}, dp_first "
        f"{first['dp_first']!r}")
    log(f"  counters {counts}; launches per ASD-POCS iteration {per}")
    check_image(res, geo)
    check_counts(counts, "asd_pocs", "plain ASD-POCS")
    if per["tv_grad"] != TV_STEPS:
        raise AssertionError(f"{per['tv_grad']} tv_grad launches in an "
                             f"iteration, expected {TV_STEPS}")
    return first, counts, per


def phase_asd_pocs_stream(n: int, n_angles: int, ds, first, device_bytes):
    import torch
    from repro_torch import kernels, obs
    from repro_torch.core.geometry import ConeGeometry
    from repro_torch.launch.recon import reconstruct
    log(f"== ASD-POCS, streamed: N={n}, {n_angles} angles, device budget "
        f"{device_bytes / 2**20:.0f} MiB, 1 iteration")
    got = {}
    tracer = obs.Tracer(enabled=True)
    prev = obs.set_tracer(tracer)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counters()
    try:
        t0 = time.perf_counter()
        res = reconstruct(
            "asd_pocs", n=n, n_angles=n_angles, iters=1, mode="stream",
            device_bytes=device_bytes, device="cuda", dataset=ds,
            callback=lambda it, st: got.update(dtvg=st.dtvg,
                                               dp_first=st.dp_first))
        wall = time.perf_counter() - t0
    finally:
        obs.set_tracer(prev)
    counts = kernels.counters()
    log(f"  seconds per iteration {[round(s, 3) for s in res.seconds]}, "
        f"rel_err {res.rel_err:.4f}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; counters "
        f"{counts}")
    phases = tracer.phase_seconds()
    log(f"  span seconds over the whole run ({wall:.2f} s wall, "
        f"1 iteration with the lazy init): "
        + ", ".join(f"{k} {v:.3f}" for k, v in sorted(phases.items()))
        + f", outside spans {wall - sum(phases.values()):.3f}")
    check_counts(counts, "asd_pocs", "streamed ASD-POCS")
    if counts["tv_grad"]["launches"] != TV_STEPS:
        raise AssertionError(f"tv_grad launched {counts['tv_grad']} times")
    check_image(res, ConeGeometry.nice(n))
    check_close("stream ASD-POCS x1 vs plain ASD-POCS x1", res.rec,
                first["x"], rtol=SART_TOL, atol=SART_TOL)
    for key in ("dtvg", "dp_first"):
        a, b = got[key], first[key]
        rel = abs(a - b) / max(abs(a), abs(b))
        log(f"  {key}: streamed {a!r}, plain {b!r}, relative difference "
            f"{rel:.3g}")
        if not rel <= SCALAR_RTOL:
            raise AssertionError(f"{key} differs by {rel:.3g} > "
                                 f"{SCALAR_RTOL}")
    return counts


def phase_fista_plain(n: int, n_angles: int, ds, iters: int):
    import torch
    from repro_torch import kernels
    from repro_torch.core.geometry import ConeGeometry
    from repro_torch.launch.recon import reconstruct
    log(f"== FISTA-TV, plain mode: N={n}, {n_angles} angles, L from 6 power "
        f"iterations, 20 ROF steps, {iters} iterations")
    geo = ConeGeometry.nice(n)
    per_iter = []
    seen = {}

    def cb(it, st):
        torch.cuda.synchronize()
        per_iter.append({k: v["launches"]
                         for k, v in kernels.counters().items()})
        seen["L"] = st.L
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counters()
    t0 = time.perf_counter()
    res = reconstruct("fista", n=n, n_angles=n_angles, iters=iters,
                      mode="plain", device="cuda", dataset=ds, callback=cb)
    wall = time.perf_counter() - t0
    counts = kernels.counters()
    per = launches_between(per_iter[0], per_iter[1])
    log(f"  seconds per iteration {[round(s, 3) for s in res.seconds]}, "
        f"init (power iteration) {wall - sum(res.seconds):.2f} s, L "
        f"{seen['L']!r}, rel_err {res.rel_err:.4f}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"  counters {counts}; launches per FISTA iteration {per}")
    check_image(res, geo)
    check_counts(counts, "fista", "plain FISTA")
    return counts, per


def _row(name, source, replaces, launches, err, ms, plain_ms, t_ops,
         t_bytes):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None}


def _time_kernel(name, kern, plain, rtol=RTOL, atol=ATOL):
    """(CUDA-event median of 5, plain ms once, max |err|) of one kernel."""
    import torch
    ms = cuda_ms(kern, reps=5)
    plain_ms, want = once_ms(plain)
    got = kern()
    err = check_close(f"{name} at main shapes", got, want, rtol, atol)
    del want, got
    torch.cuda.empty_cache()
    return ms, plain_ms, err


def phase_times(n: int, n_angles: int, ds, launches, per_iter, smi):
    """Each kernel at its main path's shapes: CUDA-event median, the plain
    version once, the error between them, and the bound.  The Joseph pair
    takes the whole volume and one dominance group of angles (a CGLS
    launch), bp_voxel the whole volume and every angle with the pmatched
    weight (FDK's launch, with OS-SART's weight), tv_grad a whole volume
    of seeded random values (an ASD-POCS launch)."""
    import torch
    from repro_torch.core.geometry import ConeGeometry, dominant_axis_mask
    from repro_torch.kernels.bp_matched import (bp_matched_cuda,
                                                bp_matched_plain)
    from repro_torch.kernels.bp_voxel import bp_voxel_cuda, bp_voxel_plain
    from repro_torch.kernels.fp_ray import fp_ray_cuda, fp_ray_plain
    from repro_torch.kernels.tv_grad import tv_grad_cuda, tv_grad_plain
    log(f"== kernel times at the main path's shapes (card: {smi})")
    geo = ConeGeometry.nice(n)
    vol, angles, proj = ds
    mask = dominant_axis_mask(angles)
    idx = torch.from_numpy(mask.nonzero()[0]).cuda()
    a = torch.from_numpy(angles[mask]).cuda()
    y = proj.index_select(0, idx).contiguous()
    nz, ny, nx = geo.n_voxel
    nv, nu = geo.n_detector
    n_a = a.numel()
    samples = n_a * nv * nu * nx
    vol_bytes, proj_bytes = nz * ny * nx * 4, n_a * nv * nu * 4 + n_a * 32
    t_ops = OPS_PER_SAMPLE * samples / PEAK_FP32
    t_bytes = (vol_bytes + proj_bytes) / PEAK_BYTES
    rel = adjoint_defect(fp_ray_cuda(vol, geo, a), y, vol,
                         bp_matched_cuda(y, geo, a))
    log(f"  adjoint defect of the kernel pair at the main shapes: {rel:.3g}")
    if not rel <= ADJ_TOL:
        raise AssertionError(f"adjoint defect {rel:.3g} > {ADJ_TOL}")
    rows = []
    for name, kern, plain, src, replaces in (
            ("fp_ray", lambda: fp_ray_cuda(vol, geo, a),
             lambda: fp_ray_plain(vol, geo, a),
             "src/repro_torch/kernels/csrc/fp_ray.cu",
             "src/repro/kernels/fp_ray.py:62"),
            ("bp_matched", lambda: bp_matched_cuda(y, geo, a),
             lambda: bp_matched_plain(y, geo, a),
             "src/repro_torch/kernels/csrc/bp_matched.cu",
             "src/repro/kernels/bp_matched.py:43")):
        ms, plain_ms, err = _time_kernel(name, kern, plain)
        rows.append(_row(name, src, replaces, launches[name], err, ms,
                         plain_ms, t_ops, t_bytes))
    # bp_voxel at FDK's shape: every angle, the whole volume
    a_all = torch.from_numpy(angles).cuda()
    p_all = proj.contiguous()
    pairs = nz * ny * nx * a_all.numel()
    v_ops = OPS_PER_PAIR_VOXEL * pairs / PEAK_FP32
    v_bytes = (vol_bytes + a_all.numel() * (nv * nu * 4 + 32)) / PEAK_BYTES
    ms, plain_ms, err = _time_kernel(
        "bp_voxel", lambda: bp_voxel_cuda(p_all, geo, a_all, "pmatched"),
        lambda: bp_voxel_plain(p_all, geo, a_all, "pmatched"))
    rows.append(_row("bp_voxel", "src/repro_torch/kernels/csrc/bp_voxel.cu",
                     "src/repro/kernels/bp_voxel.py:32", launches["bp_voxel"],
                     err, ms, plain_ms, v_ops, v_bytes))
    del p_all
    torch.cuda.empty_cache()
    # tv_grad over the whole volume: each voxel read once, written once
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(geo.n_voxel, generator=gen, device="cuda")
    ms, plain_ms, err = _time_kernel(
        "tv_grad", lambda: tv_grad_cuda(x), lambda: tv_grad_plain(x),
        TV_RTOL, TV_ATOL)
    rows.append(_row("tv_grad", "src/repro_torch/kernels/csrc/tv_grad.cu",
                     "src/repro/kernels/tv_grad.py:35", launches["tv_grad"],
                     err, ms, plain_ms,
                     OPS_PER_VOXEL_TV * x.numel() / PEAK_FP32,
                     2 * vol_bytes / PEAK_BYTES))
    del x
    torch.cuda.empty_cache()
    log("  library: none for any of the four. No single PyTorch call "
        "projects along rays or transposes that gather; for bp_voxel, "
        "grid_sample would need an A*Nz*Ny*Nx intermediate "
        f"({pairs * 4 / 1e9:.0f} GB here); the TV gradient's closed form "
        "has no single call (autograd of tv_value is many ops)")
    for row in rows:
        log(f"  {row['name']}: {row['ms']:.3f} ms (median of 5), plain "
            f"{row['plain_ms']:.1f} ms, bound {row['bound_ms']:.3f} ms "
            f"({row['bound_by']}), launches per iteration "
            + ", ".join(f"{path} {per[row['name']]}"
                        for path, per in per_iter.items()
                        if per[row['name']])
            + f", {row['launches']} on the main paths")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="build and check the kernels at N=64 only")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    smi = phase_environment()
    phase_build()
    if args.quick:
        phase_kernel_checks(64, 48)
        phase_bp_voxel_checks(64, 48)
        phase_tv_grad_checks(64)
        log(f"quick run passed in {time.perf_counter() - t_start:.0f}s")
        return 0
    phase_kernel_checks(128, 96)
    phase_bp_voxel_checks(128, 96)
    phase_tv_grad_checks(128)
    n, n_angles = 512, 512
    ds, x2, c_cgls, per_cgls = phase_main_plain(n, n_angles, iters=3)
    c_cgls_stream = phase_main_stream(n, n_angles, ds, x2,
                                      device_bytes=256 << 20)
    del x2
    c_fdk = phase_fdk(n, n_angles, ds)
    x_sart, c_sart, per_sart = phase_ossart_plain(n, n_angles, ds, iters=2)
    c_sart_stream = phase_ossart_stream(n, n_angles, ds, x_sart,
                                        device_bytes=256 << 20)
    del x_sart
    torch.cuda.empty_cache()
    first, c_asd, per_asd = phase_asd_pocs_plain(n, n_angles, ds, iters=2)
    torch.cuda.empty_cache()
    c_asd_stream = phase_asd_pocs_stream(n, n_angles, ds, first,
                                         device_bytes=256 << 20)
    del first
    torch.cuda.empty_cache()
    c_fista, per_fista = phase_fista_plain(n, n_angles, ds, iters=2)
    torch.cuda.empty_cache()
    runs = (c_cgls, c_cgls_stream, c_fdk, c_sart, c_sart_stream, c_asd,
            c_asd_stream, c_fista)
    launches = {k: sum(c[k]["launches"] for c in runs) for k in c_cgls}
    rows = phase_times(n, n_angles, ds, launches,
                       {"CGLS": per_cgls, "OS-SART": per_sart,
                        "ASD-POCS": per_asd, "FISTA": per_fista}, smi)
    log(f"total {time.perf_counter() - t_start:.0f}s")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
