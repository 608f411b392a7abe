#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

Builds the port's CUDA kernels from the sources in this checkout, holds
each against its plain-PyTorch version (parity, the adjoint identity of
the pair, bit-identical repeat launches), drives the main path — CGLS with
the Joseph A and its exact adjoint, in-core and streamed out-of-core — at
N=512 (512^3 volume, 512^2 detector, 512 angles) through the port's own
entry points, and prints the kernels' measurements.

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
RTOL, ATOL = 2e-4, 5e-3    # kernel vs plain (tests/test_backend.py:23)
ADJ_TOL = 1e-4             # relative adjoint defect (tests/test_adjoint.py)
CGLS_TOL = 2e-3            # algorithm iterates (tests/test_adjoint.py:199)


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
    for name, c in counts.items():
        if c["launches"] <= 0 or c["plain_calls"] != 0:
            raise AssertionError(f"{name}: main path ran {c}")
    launches_per_iter = {k: per_iter[1][k] - per_iter[0][k]
                         for k in per_iter[0]}
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
    for name, c in counts.items():
        if c["launches"] <= 0 or c["plain_calls"] != 0:
            raise AssertionError(f"{name}: streamed path ran {c}")
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


def phase_times(n: int, n_angles: int, ds, launches, per_iter, smi):
    """Each kernel at the main path's shapes (the whole volume, one
    dominance group of angles): CUDA-event median, the plain version once,
    the error between them, and the bound."""
    import torch
    from repro_torch.core.geometry import ConeGeometry, dominant_axis_mask
    from repro_torch.kernels.bp_matched import (bp_matched_cuda,
                                                bp_matched_plain)
    from repro_torch.kernels.fp_ray import fp_ray_cuda, fp_ray_plain
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
    rel = adjoint_defect(fp_ray_cuda(vol, geo, a), y, vol,
                         bp_matched_cuda(y, geo, a))
    log(f"  adjoint defect of the kernel pair at the main shapes: {rel:.3g}")
    if not rel <= ADJ_TOL:
        raise AssertionError(f"adjoint defect {rel:.3g} > {ADJ_TOL}")
    rows = []
    t_bytes = (vol_bytes + proj_bytes) / PEAK_BYTES
    bound = max(t_ops, t_bytes)
    for name, kern, plain, route_src, replaces in (
            ("fp_ray", lambda: fp_ray_cuda(vol, geo, a),
             lambda: fp_ray_plain(vol, geo, a),
             "src/repro_torch/kernels/csrc/fp_ray.cu",
             "src/repro/kernels/fp_ray.py:62"),
            ("bp_matched", lambda: bp_matched_cuda(y, geo, a),
             lambda: bp_matched_plain(y, geo, a),
             "src/repro_torch/kernels/csrc/bp_matched.cu",
             "src/repro/kernels/bp_matched.py:43")):
        ms = cuda_ms(kern, reps=5)
        plain_ms, want = once_ms(plain)
        got = kern()
        err = check_close(f"{name} at main shapes", got, want)
        del want, got
        torch.cuda.empty_cache()
        row = {"name": name, "route": "cuda", "source": route_src,
               "replaces": replaces, "launches": launches[name],
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound * 1e3,
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "library_ms": None}
        log(f"  {name}: {ms:.3f} ms (median of 5), plain {plain_ms:.1f} ms, "
            f"bound {bound * 1e3:.3f} ms ({row['bound_by']}), "
            f"{per_iter[name]} launches per CGLS iteration, "
            f"{launches[name]} on the main path")
        rows.append(row)
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
        log(f"quick run passed in {time.perf_counter() - t_start:.0f}s")
        return 0
    phase_kernel_checks(128, 96)
    n, n_angles = 512, 512
    ds, x2, counts_plain, per_iter = phase_main_plain(n, n_angles, iters=3)
    counts_stream = phase_main_stream(n, n_angles, ds, x2,
                                      device_bytes=256 << 20)
    launches = {k: counts_plain[k]["launches"]
                + counts_stream[k]["launches"] for k in counts_plain}
    rows = phase_times(n, n_angles, ds, launches, per_iter, smi)
    log(f"total {time.perf_counter() - t_start:.0f}s")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
