#!/usr/bin/env python3
"""Probe builds of the port's ``fp_ray``, ``bp_voxel`` and ``tv_grad`` kernels.

With no ``ncu`` on the card's machine, what holds a kernel back is read off
variants of it, each timed by CUDA events at the main path's shape (N = 512:
512^3 volume, 512^2 detector; ``fp_ray`` on the 257 x-dominant of 512
angles, ``bp_voxel`` on all 512 with the pmatched weight):

* ``base``    the kernel as it is;
* ``noload``  every ``__ldg`` gather replaced by a value made from its
              address (the memory system's share);
* ``nodiv``   ``__fdiv_rn(a, b)`` as ``a * (1 / b)``, the reciprocal of an
              invariant divisor hoisted (the IEEE divisions' share);
* ``floor``   ``floorf`` by adding 1.5 * 2^23 rounding down (the conversion
              pipe's share; exact for |x| < 2^22);
* ``planes32`` (``bp_voxel``) 32 planes per thread, not 8 (the
              per-angle terms' share).

Of the redesigned kernels (a tree whose ``bp_voxel`` is a template over
the weight) it builds tile variants instead: ``fp_ray`` with 2, 4
(``base``) or 8 rows a thread, 8 with registers for 6 blocks an SM
(``rows8b6``), 4 with registers for 10 (``b10``); ``bp_voxel`` with 2 or 3
(``base``) window buffers, registers for 3 blocks an SM, not 4
(``minb3``), and 16 planes a thread with 36-row windows and registers for
6 blocks (``tz16``).

Each variant is built from a copy of a source tree's ``csrc/`` with the
substitution made in the text or by a macro, with ``-Xptxas -v``; the
script prints each kernel's registers and its blocks per SM from
``cudaOccupancyMaxActiveBlocksPerMultiprocessor``.

``--parent DIR`` names the ``csrc/`` of another tree (for instance the
parent commit's, unpacked with ``git archive``): its kernels are probed as
above, and the checkout's own kernels (through their wrappers) are timed
against them in turns (parent, this, this, parent) and compared: ``fp_ray``
bit for bit, ``bp_voxel`` within the projector band.

``--kernel tv_grad`` probes ``tv_grad`` instead, on a 512^3 volume of
seeded random values.  Of the one-thread-per-voxel kernel (PR 13) it builds
``base``, ``onem`` (only the voxel's own magnitude: the three recomputed
ones' share; a wrong output, for timing only), ``rcp`` (``__frcp_rn`` for
``__fdiv_rn(1, m)``) and ``noload``; of the tiled kernel (``kZC`` planes a
block, a thread ``kRowsPer`` rows of a column) the variants ``rows4`` (4
rows a thread, 8 warps a block, registers for 4 blocks an SM: the first
tiled design), ``minb8`` (registers for 8 blocks an SM, not 6),
``stages3`` and ``stages6`` (window buffers, not 4), ``zc16`` and ``zc64``
(planes a chunk, not 32), ``nomath`` (the voxel's r as a sum, not a square root
and a reciprocal: their share), ``nostore`` (no output written: the
writes' share) and ``scalar`` (the 4-byte cp.async window of an Nx that is
not a multiple of 4, not TMA); ``nomath`` and ``nostore`` give wrong
outputs and serve timing only.  For each tree it counts the cases of
``chip_smoke.py``'s ``tv_grad_cases`` (N = 128) that its kernel gives equal
to ``tv_grad_plain`` bit for bit; with ``--parent`` it times the two trees
in turns and compares them bit for bit at 512^3 on the random volume and
on the Shepp-Logan phantom.

    python3 tools/probe_projectors.py                  # this tree's variants
    python3 tools/probe_projectors.py --parent build/parent/csrc
    python3 tools/probe_projectors.py --kernel tv_grad [--parent DIR]

The last line is a JSON object of every number printed.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

OUT = ROOT / "build" / "probe_projectors"
RTOL, ATOL = 2e-4, 5e-3

# (name, wrapper prelude, text substitutions)
PRELUDE = {
    "base": "",
    "noload": """
__device__ __forceinline__ float probe_ldg(const float* p) {
  return (float)((unsigned)(size_t)p & 1023u) * 1e-3f;
}
#define __ldg(p) probe_ldg(p)
""",
    "nodiv": "#define __fdiv_rn(a, b) __fmul_rn((a), __frcp_rn(b))\n",
    "floor": """
__device__ __forceinline__ float probe_floor(float x) {
  return __fsub_rn(__fadd_rd(x, 12582912.0f), 12582912.0f);
}
#define floorf(x) probe_floor(x)
""",
}


#: PR 13's tv_grad with the three backward magnitudes replaced by the
#: voxel's own (timing only)
TV_ONEM = ((r"const float inv = __fdiv_rn\(1\.0f, magnitude\(bz, by, bx, "
            r"eps2\)\);", "const float inv = inv_m;"),)
TV_RCP = "#define __fdiv_rn(a, b) __frcp_rn(b)\n"


def wrapper(src: Path, kernel: str, prelude: str) -> str:
    """A translation unit that includes ``src`` after ``prelude`` and
    exports the occupancy of ``kernel`` (a function of ``src``)."""
    return f"""#include <cuda_runtime.h>
#include <math.h>
{prelude}
#include "{src}"
extern "C" int probe_occupancy(int threads, int smem) {{
  int n = -1;
  cudaFuncSetAttribute({kernel}, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, {kernel}, threads,
                                                    smem) != cudaSuccess)
    return -1;
  return n;
}}
"""


def build_variants(specs):
    """specs: [(tag, csrc dir, source, kernel, threads, prelude, subs)].
    Returns
    {tag: (CDLL, ptxas report)}; one nvcc each, all started together."""
    from repro_torch.kernels import build
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tag, csrc, source, kernel, _, prelude, subs in specs:
        d = OUT / tag
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(csrc, d)
        text = (d / source).read_text()
        for pat, rep in subs:
            text, n = re.subn(pat, rep, text)
            if n == 0:
                raise RuntimeError(f"{tag}: no match for {pat!r}")
        (d / source).write_text(text)
        unit = d / f"probe_{tag}.cu"
        unit.write_text(wrapper(d / source, kernel, prelude))
        lib = d / f"lib{tag}.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v",
               "-o", str(lib), str(unit)]
        procs[tag] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      lib)
    libs = {}
    for tag, (p, lib) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"probe build {tag} failed:\n{log}")
        regs = re.findall(r"Used (\d+) registers", log)
        spills = [int(b) for b in re.findall(r"(\d+) bytes spill stores",
                                             log)]
        if any(spills):
            regs = [f"{r} (spills {b} B)" for r, b in zip(regs, spills)]
        libs[tag] = (ctypes.CDLL(str(lib)), regs)
    return libs


def cuda_ms(fn, reps=5):
    import torch
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def tv_specs(tree: str, csrc: Path):
    """The tv_grad probe builds of one tree (see the module's doc)."""
    if "kZC" not in (csrc / "tv_grad.cu").read_text():
        return [(f"{tree}-tv-{var}", csrc, "tv_grad.cu", "tv_grad_kernel",
                 256, prelude, subs)
                for var, prelude, subs in (("base", "", ()),
                                           ("onem", "", TV_ONEM),
                                           ("rcp", TV_RCP, ()),
                                           ("noload", PRELUDE["noload"], ()))]
    st = r"constexpr int kStages = \d+;"
    mb = r"constexpr int kMinBlocks = \d+;"
    zc = r"constexpr int kZC = \d+;"
    specs = []
    for var, threads, subs in (
            ("base", 128, ()),
            ("rows4", 256, ((r"constexpr int kWarps = \d+;",
                             "constexpr int kWarps = 8;"),
                            (r"constexpr int kRowsPer = \d+;",
                             "constexpr int kRowsPer = 4;"),
                            (mb, "constexpr int kMinBlocks = 4;"))),
            ("minb8", 128, ((mb, "constexpr int kMinBlocks = 8;"),)),
            ("stages3", 128, ((st, "constexpr int kStages = 3;"),)),
            ("stages6", 128, ((st, "constexpr int kStages = 6;"),)),
            ("zc16", 128, ((zc, "constexpr int kZC = 16;"),)),
            ("zc64", 128, ((zc, "constexpr int kZC = 64;"),)),
            ("nomath", 128, ((r"const float r = __frcp_rn\(magnitude\("
                              r"dz, dy, dx, eps2\)\);",
                              "const float r = __fadd_rn(__fadd_rn(dz, dy),"
                              " dx);"),)),
            ("nostore", 128, ((r"if \(x < nx && ya \+ k < ny\) o\[",
                               "if (gk == 1234.5f) o["),)),
            ("scalar", 128, ((r"const bool tma = [^;]*;",
                              "const bool tma = false;"),))):
        kernel = "tv_grad_kernel<%s>" % ("false" if var == "scalar"
                                         else "true")
        specs.append((f"{tree}-tv-{var}", csrc, "tv_grad.cu", kernel,
                      threads, "", subs))
    return specs


def main_tv(args) -> int:
    """``--kernel tv_grad``: the probe builds of each tree timed at N^3, the
    bit-equal count on chip_smoke's cases, and the parent in turns."""
    import torch
    sys.path.insert(0, str(ROOT))
    from chip_smoke import tv_grad_cases
    from repro_torch.core import phantoms
    from repro_torch.core.geometry import ConeGeometry
    from repro_torch.kernels import build
    from repro_torch.kernels.tv_grad import tv_grad_cuda, tv_grad_plain
    smi = card()
    print(f"card: {smi}", flush=True)
    result = {"card": smi, "n": args.n}
    dev = torch.cuda.current_device()
    stream = torch.cuda.current_stream().cuda_stream
    eps2 = 1e-6 * 1e-6

    def tv_call(lib, v):
        fn = lib.tv_grad_launch
        fn.argtypes = build.TV_ARGTYPES
        fn.restype = ctypes.c_int
        out = torch.empty_like(v)

        def go():
            rc = fn(v.data_ptr(), out.data_ptr(), *v.shape, eps2, dev,
                    stream)
            if rc:
                raise RuntimeError(f"tv_grad probe launch: CUDA error {rc}")
            return out
        return go

    trees = [("self", build.CSRC)]
    if args.parent is not None:
        trees.append(("parent", args.parent.resolve()))
    specs = [s for tree, csrc in trees for s in tv_specs(tree, csrc)]
    threads = {spec[0]: spec[4] for spec in specs}
    t0 = time.perf_counter()
    libs = build_variants(specs)
    print(f"built {len(libs)} probe libraries in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

    n = args.n
    gen = torch.Generator(device="cuda").manual_seed(0)
    vol = torch.randn((n, n, n), generator=gen, device="cuda")
    probes = {}
    for tag, (lib, regs) in libs.items():
        ms = cuda_ms(tv_call(lib, vol), reps=9)
        occ = lib.probe_occupancy(threads[tag], 0)
        probes[tag] = {"ms": ms, "registers": regs, "blocks_per_sm": occ}
        print(f"  {tag}: {ms:.4f} ms, registers {regs}, blocks/SM {occ}",
              flush=True)
    result["probes"] = probes

    # each tree's kernel on chip_smoke's cases, against the plain version
    launch = {"self": tv_grad_cuda}
    if args.parent is not None:
        launch["parent"] = lambda v: tv_call(libs["parent-tv-base"][0],
                                             v)().clone()
    equal = {tree: [] for tree in launch}
    for kind, v in tv_grad_cases(128):
        want = tv_grad_plain(v)
        for tree, fn in launch.items():
            if torch.equal(fn(v), want):
                equal[tree].append(kind)
    n_cases = len(list(tv_grad_cases(128)))
    for tree, kinds in equal.items():
        print(f"  {tree}: {len(kinds)} of {n_cases} cases of chip_smoke's "
              "tv_grad_cases(128) equal to tv_grad_plain bit for bit",
              flush=True)
    result["bit_equal_cases"] = {t: len(k) for t, k in equal.items()}
    result["cases"] = n_cases

    if args.parent is not None:
        p_fn = tv_call(libs["parent-tv-base"][0], vol)
        s_fn = lambda: tv_grad_cuda(vol)                    # noqa: E731
        t = [cuda_ms(p_fn, 9), cuda_ms(s_fn, 9), cuda_ms(s_fn, 9),
             cuda_ms(p_fn, 9)]
        turns = {"parent_ms": [t[0], t[3]], "self_ms": [t[1], t[2]]}
        print(f"  tv_grad at {n}^3: parent {t[0]:.4f}, this {t[1]:.4f}, "
              f"this {t[2]:.4f}, parent {t[3]:.4f} ms", flush=True)
        phantom = torch.from_numpy(phantoms.shepp_logan(
            ConeGeometry.nice(n))).cuda()
        for kind, v in (("random", vol), ("shepp-logan", phantom)):
            want = tv_call(libs["parent-tv-base"][0], v)().clone()
            got = tv_grad_cuda(v)
            diff = int((got != want).sum())
            turns[f"differing_{kind}"] = diff
            print(f"  this vs parent at {n}^3, {kind}: {diff} of "
                  f"{want.numel()} outputs differ", flush=True)
            del want, got
        result["turns"] = turns
    print(json.dumps(result))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path,
                    help="csrc/ of the tree to compare with (its kernels "
                         "are probed, and this tree's timed against them)")
    ap.add_argument("--kernel", choices=("projectors", "tv_grad"),
                    default="projectors")
    ap.add_argument("--n", type=int, default=512)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("probe_projectors: no CUDA device", file=sys.stderr)
        return 2
    if args.kernel == "tv_grad":
        return main_tv(args)
    from repro_torch.core.geometry import (ConeGeometry, circular_angles,
                                           dominant_axis_mask)
    from repro_torch.kernels import build
    from repro_torch.kernels.bp_voxel import WEIGHTS, bp_voxel_cuda
    from repro_torch.kernels.fp_ray import (angle_constants, fp_ray_cuda,
                                            plane_centers)
    smi = card()
    print(f"card: {smi}", flush=True)
    result = {"card": smi, "n": args.n}

    n = args.n
    geo = ConeGeometry.nice(n)
    ang = circular_angles(n)
    a_x = torch.from_numpy(ang[dominant_axis_mask(ang)]).cuda()
    a_all = torch.from_numpy(ang).cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    vol = torch.randn(geo.n_voxel, generator=gen, device="cuda")
    proj = torch.randn((n,) + geo.n_detector, generator=gen, device="cuda")

    nz, ny, nx = geo.n_voxel
    nv, nu = geo.n_detector
    dz, dy, dx = geo.d_voxel
    dv, du = geo.d_detector
    offz, offy, offx = geo.off_origin
    offv, offu = geo.off_detector
    dev = torch.cuda.current_device()
    stream = torch.cuda.current_stream().cuda_stream
    c_x = angle_constants(geo, a_x)
    c_all = angle_constants(geo, a_all)
    xc = plane_centers(geo, vol.device)
    vol_t = vol.permute(2, 0, 1).contiguous()   # marching-plane layout
    fp_out = torch.empty((a_x.numel(), nv, nu), device="cuda")
    bp_out = torch.empty(geo.n_voxel, device="cuda")

    def fp_call(lib, v):
        fn = lib.fp_ray_launch
        fn.argtypes = build.FP_RAY_ARGTYPES
        fn.restype = ctypes.c_int

        def go():
            rc = fn(v.data_ptr(), c_x.data_ptr(), xc.data_ptr(),
                    fp_out.data_ptr(), c_x.shape[0], nz, ny, nx, nz, nv, nu,
                    dz, dy, dx, dv, du, offz, offy, offv, offu, 0.0, dev,
                    stream)
            if rc:
                raise RuntimeError(f"fp_ray probe launch: CUDA error {rc}")
            return fp_out
        return go

    def bp_call(lib):
        fn = lib.bp_voxel_launch
        fn.argtypes = build.VOXEL_ARGTYPES
        fn.restype = ctypes.c_int

        def go():
            rc = fn(proj.data_ptr(), c_all.data_ptr(), bp_out.data_ptr(),
                    c_all.shape[0], nz, ny, nx, nz, nv, nu, dz, dy, dx, dv,
                    du, offz, offy, offx, offv / dv, offu, geo.DSO, geo.DSD,
                    geo.DSO / geo.DSD, 0.0, WEIGHTS["pmatched"], dev, stream)
            if rc:
                raise RuntimeError(f"bp_voxel probe launch: CUDA error {rc}")
            return bp_out
        return go

    trees = [("self", build.CSRC)]
    if args.parent is not None:
        trees.append(("parent", args.parent.resolve()))
    specs = []
    for tree, csrc in trees:
        # the first designs (global gathers) get the macro variants; the
        # redesign (bp_voxel a template over the weight) its tile variants
        first = "template <int W>" not in (csrc / "bp_voxel.cu").read_text()
        if first:
            for var in ("base", "noload", "nodiv", "floor"):
                specs.append((f"{tree}-fp-{var}", csrc, "fp_ray.cu",
                              "fp_ray_kernel", 256, PRELUDE[var], ()))
            for var in ("base", "noload", "floor"):
                specs.append((f"{tree}-bp-{var}", csrc, "bp_voxel.cu",
                              "bp_voxel_kernel", 128, PRELUDE[var], ()))
            specs.append((f"{tree}-bp-planes32", csrc, "bp_voxel.cu",
                          "bp_voxel_kernel", 128, "",
                          ((r"constexpr int kPlanes = 8;",
                            "constexpr int kPlanes = 32;"),)))
            continue
        rows = r"constexpr int kRowsPer = 4;"
        fp_lb = r"__launch_bounds__\(kTU \* kWarps, 8\)"
        for var, subs in (
                ("base", ()),
                ("rows2", ((rows, "constexpr int kRowsPer = 2;"),)),
                ("rows8", ((rows, "constexpr int kRowsPer = 8;"),)),
                ("rows8b6", ((rows, "constexpr int kRowsPer = 8;"),
                             (fp_lb, "__launch_bounds__(kTU * kWarps, 6)"))),
                ("b10", ((fp_lb, "__launch_bounds__(kTU * kWarps, 10)"),))):
            specs.append((f"{tree}-fp-{var}", csrc, "fp_ray.cu",
                          "fp_ray_kernel", 128, "", subs))
        bp_lb = r"__launch_bounds__\(kThreads, 4\)"
        for var, subs in (
                ("base", ()),
                ("stages2", ((r"constexpr int kStages = 3;",
                              "constexpr int kStages = 2;"),)),
                ("minb3", ((bp_lb, "__launch_bounds__(kThreads, 3)"),)),
                ("tz16", ((r"constexpr int kTZ = 32;",
                           "constexpr int kTZ = 16;"),
                          (r"constexpr int kRows = 56;",
                           "constexpr int kRows = 36;"),
                          (bp_lb, "__launch_bounds__(kThreads, 6)")))):
            specs.append((f"{tree}-bp-{var}", csrc, "bp_voxel.cu",
                          "bp_voxel_kernel<1>", 256, "", subs))
    threads = {spec[0]: spec[4] for spec in specs}
    t0 = time.perf_counter()
    libs = build_variants(specs)
    print(f"built {len(libs)} probe libraries in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

    probes = {}
    for tag, (lib, regs) in libs.items():
        tree = tag.split("-")[0]
        if "-fp-" in tag:
            fn = fp_call(lib, vol_t)
        else:
            fn = bp_call(lib)
        ms = cuda_ms(fn)
        occ = lib.probe_occupancy(threads[tag], 0)
        probes[tag] = {"ms": ms, "registers": regs, "blocks_per_sm": occ}
        print(f"  {tag}: {ms:.3f} ms, registers {regs}, blocks/SM {occ}",
              flush=True)
    result["probes"] = probes

    if args.parent is not None:
        # this tree's kernels through their wrappers, in turns with the
        # parent's, and their outputs against the parent's
        p_fp = fp_call(libs["parent-fp-base"][0], vol_t)
        p_bp = bp_call(libs["parent-bp-base"][0])
        s_fp = lambda: fp_ray_cuda(vol, geo, a_x)           # noqa: E731
        s_bp = lambda: bp_voxel_cuda(proj, geo, a_all, "pmatched")  # noqa
        turns = {}
        for name, p, s in (("fp_ray", p_fp, s_fp), ("bp_voxel", p_bp, s_bp)):
            t = [cuda_ms(p), cuda_ms(s), cuda_ms(s), cuda_ms(p)]
            turns[name] = {"parent_ms": [t[0], t[3]], "self_ms": [t[1], t[2]]}
            print(f"  {name}: parent {t[0]:.3f}, this {t[1]:.3f}, this "
                  f"{t[2]:.3f}, parent {t[3]:.3f} ms", flush=True)
        want = p_fp().clone()
        got = s_fp()
        same = bool(torch.equal(got, want))
        turns["fp_ray"]["bit_identical_main"] = same
        turns["fp_ray"]["differing"] = int((got != want).sum())
        want = p_bp().clone()
        got = s_bp()
        err = (got - want).abs()
        turns["bp_voxel"]["max_abs_err_vs_parent"] = float(err.max())
        turns["bp_voxel"]["outside_band"] = int(
            (err > ATOL + RTOL * want.abs()).sum())
        print(f"  fp_ray vs parent at the main shape: bit-identical {same} "
              f"({turns['fp_ray']['differing']} differing); bp_voxel max "
              f"|err| {float(err.max()):.3g}, "
              f"{turns['bp_voxel']['outside_band']} outside the band",
              flush=True)
        result["turns"] = turns
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
