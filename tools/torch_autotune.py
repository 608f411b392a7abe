#!/usr/bin/env python
"""Pre-bake the port's tile autotune table, smoke-test the tuner, and hold
every tile configuration against another tree's kernels.

The port's measured autotuner (:mod:`repro_torch.kernels.autotune`) checks
each compiled tile configuration of ``fp_ray``, ``bp_matched`` and
``bp_voxel`` against configuration 0 bit for bit, times the ones that
agree per (kind, card, geometry shape) on first use and memoises the
winner; with ``REPRO_AUTOTUNE_CACHE=path`` the table persists across
processes.  This tool runs those measurements ahead of time on the card,
so that ``recon --autotune`` starts with a warm table:

    PYTHONPATH=src python tools/torch_autotune.py --n 256 --planes 256 86 \\
        --out tiles.json

``--smoke`` tunes a small geometry on the card (on the CPU, where there is
nothing to tune, it checks that configuration 0 comes back unmeasured),
round-trips the table through the JSON file, with an entry of another
platform kept as it was, and asserts the floor: the winner is
configuration 0 or beats it by the margin.  Prints ``SMOKE OK``.

``--parent DIR`` (on the card) builds the projector kernels of another
tree's ``csrc/`` (for example ``git archive <commit>
src/repro_torch/kernels/csrc | tar -x -C build/parent_tree``) and holds
every tile configuration of this tree against them bit for bit, at
``ConeGeometry.nice(--n)`` and at a prime shape (N=61, a 67 x 71 detector,
13 angles).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KINDS = ("fp", "bp", "bp_matched")


def _geometry(n: int, detector):
    from repro_torch.core.geometry import ConeGeometry
    return ConeGeometry.nice(n, n_detector=tuple(detector))


def bake(n: int, detector, planes, out: str, repeats: int) -> dict:
    """Tune every kernel kind for one geometry on the card and save the
    table; returns each report."""
    from repro_torch.kernels import autotune
    geo = _geometry(n, detector)
    autotune.enable(True)
    if out:
        os.environ["REPRO_AUTOTUNE_CACHE"] = out
    # fp and bp_matched are keyed at the whole volume (planes=None), as
    # the backend looks them up; bp at each slab height
    runs = [("fp", None), ("bp_matched", None)] + [("bp", p) for p in planes]
    results = {}
    for kind, pl in runs:
        rep = autotune.tune(kind, geo, planes=pl, repeats=repeats)
        results[rep.key] = {"winner": rep.winner,
                            "candidates": rep.candidates}
    if out:
        autotune.save(out)
    return results


def smoke(device: str) -> int:
    """Tune, persist, reload, and assert the floor and the bit check."""
    import torch
    from repro_torch.kernels import autotune

    geo = _geometry(16, (20, 24))
    autotune.clear()
    autotune.enable(True)
    fp0 = autotune.fingerprint()
    dev = torch.device(device)
    tuned = {}
    if dev.type == "cuda":
        for kind in KINDS:
            rep = autotune.tune(kind, geo, planes=16, device=dev, repeats=2)
            t0 = rep.candidates[0]["seconds"]
            win = rep.candidates[rep.winner]
            assert win["bit_equal"], f"{kind}: the winner failed the bit check"
            assert rep.winner == 0 or win["seconds"] < t0 * (
                1 - autotune.MARGIN), f"{kind}: floor violated: {rep}"
            tuned[kind] = {"winner": rep.winner, "refused": rep.refused,
                           "ms": [None if c["seconds"] is None
                                  else c["seconds"] * 1e3
                                  for c in rep.candidates]}
        assert autotune.fingerprint() > fp0, "tuning did not bump fingerprint"
    else:
        for kind in KINDS:
            got = autotune.get_blocks(kind, geo, planes=16, device=dev)
            assert got == {"config": 0}, f"{kind} on the CPU: {got}"
        assert autotune.table() == {}, "the CPU measured something"
    # another platform's entry (the reference's, for its CPU) rides along
    with autotune._LOCK:
        autotune._TABLE[("fp", "cpu", (16, 16, 16), (20, 24), None)] = {
            "slab_planes": 16}

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "tiles.json")
        autotune.save(path)
        before = autotune.table()
        autotune.clear()
        assert autotune.table() == {}, "clear() left entries behind"
        n = autotune.load(path)
        assert n == len(before), f"round-trip lost entries ({n}/{len(before)})"
        assert autotune.table() == before, "round-trip changed the table"
        with open(path) as f:
            doc = json.load(f)
        assert doc.get("version") == 1 and "entries" in doc

    if dev.type == "cuda":
        # a warm hit comes from the table, not from a measurement
        fp1 = autotune.fingerprint()
        for kind in KINDS:
            hit = autotune.get_blocks(kind, geo, planes=16, device=dev)
            assert hit == {"config": tuned[kind]["winner"]}, (kind, hit)
        assert autotune.fingerprint() == fp1, "a cache hit re-measured"

    autotune.enable(None)
    autotune.clear()
    print(json.dumps({"device": str(dev), "tuned": tuned}, indent=2,
                     sort_keys=True))
    print("SMOKE OK")
    return 0


def _parent_libs(csrc: Path) -> dict:
    """The other tree's projector libraries, built by nvcc into
    ``build/torch_autotune_parent/``."""
    from repro_torch.kernels import build
    out = ROOT / "build" / "torch_autotune_parent"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in ("fp_ray", "bp_matched", "bp_voxel"):
        lib = out / f"lib{name}.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib),
               str(csrc / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    libs = {}
    for name, (p, lib) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"parent build of {name} failed:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def _parent_entry(lib, name: str):
    """``lib``'s ``<name>_launch`` typed with its own signature: this
    tree's when it has tile configurations (called with configuration 0),
    else the one before them (no config argument)."""
    from repro_torch.kernels import build
    fn = getattr(lib, f"{name}_launch")
    fn.restype = ctypes.c_int
    tiled = hasattr(lib, f"{name}_configs")
    argtypes = list(build.ARGTYPES[name])
    config_at = {"fp_ray": 4, "bp_matched": 6,
                 "bp_voxel": len(argtypes) - 3}[name]
    if not tiled:
        del argtypes[config_at]
    fn.argtypes = argtypes

    def call(*args):
        args = list(args)
        if not tiled:
            del args[config_at]
        rc = fn(*args)
        if rc:
            raise RuntimeError(f"parent {name} launch: CUDA error {rc}")
    return call


def _cuda_ms(fn, reps: int = 5) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()`` after a warm-up."""
    import statistics

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


def parent_check(csrc: Path, n: int) -> int:
    """Every tile configuration of this tree against the other tree's
    kernels, bit for bit, and times configuration 0 against the other
    tree's kernels at ``nice(n)``."""
    import torch
    from repro_torch.core.geometry import (ConeGeometry, circular_angles,
                                           dominant_axis_mask)
    from repro_torch.kernels import build
    from repro_torch.kernels.bp_matched import bp_matched_cuda
    from repro_torch.kernels.bp_voxel import WEIGHTS, bp_voxel_cuda
    from repro_torch.kernels.fp_ray import (angle_constants, fp_ray_cuda,
                                            plane_centers)
    libs = _parent_libs(csrc.resolve())
    entries = {k: _parent_entry(lib, k) for k, lib in libs.items()}
    dev = torch.cuda.current_device()
    stream = torch.cuda.current_stream().cuda_stream
    prime = ConeGeometry.nice(61, n_detector=(67, 71))
    cases = ((f"N={n}", ConeGeometry.nice(n), circular_angles(n)),
             ("N=61 prime", prime, circular_angles(13)))
    result = {}
    all_equal = True
    for tag, geo, ang in cases:
        nz, ny, nx = geo.n_voxel
        nv, nu = geo.n_detector
        dz, dy, dx = geo.d_voxel
        dv, du = geo.d_detector
        offz, offy, offx = geo.off_origin
        offv, offu = geo.off_detector
        gen = torch.Generator(device="cuda").manual_seed(0)
        a_x = torch.from_numpy(ang[dominant_axis_mask(ang)]).cuda()
        a_all = torch.from_numpy(ang).cuda()
        vol = torch.randn(geo.n_voxel, generator=gen, device="cuda")
        y = torch.randn((a_x.numel(), nv, nu), generator=gen, device="cuda")
        proj = torch.randn((a_all.numel(), nv, nu), generator=gen,
                           device="cuda")
        c_x, c_all = angle_constants(geo, a_x), angle_constants(geo, a_all)
        xc = plane_centers(geo, vol.device)
        tail = (nz, ny, nx, nz, nv, nu, dz, dy, dx, dv, du, offz, offy,
                offv, offu, 0.0, dev, stream)
        # each parent call does its wrapper's copies too (the volume into
        # and the adjoint out of the marching-plane layout), as this
        # tree's calls through fp_ray_cuda / bp_matched_cuda do
        fp_out = torch.empty((a_x.numel(), nv, nu), device="cuda")
        out_t = torch.empty((nx, nz, ny), device="cuda")
        gs = torch.empty((min(8, a_x.numel()), nv, nu), device="cuda")
        bp_out = torch.empty(geo.n_voxel, device="cuda")

        def p_fp():
            vol_t = vol.permute(2, 0, 1).contiguous()
            entries["fp_ray"](vol_t.data_ptr(), c_x.data_ptr(),
                              xc.data_ptr(), fp_out.data_ptr(), 0,
                              c_x.shape[0], *tail)
            return fp_out

        def p_bm():
            entries["bp_matched"](y.data_ptr(), c_x.data_ptr(),
                                  xc.data_ptr(), out_t.data_ptr(),
                                  gs.data_ptr(), gs.shape[0], 0,
                                  c_x.shape[0], *tail)
            return out_t.permute(1, 2, 0).contiguous()

        def p_bp():
            entries["bp_voxel"](
                proj.data_ptr(), c_all.data_ptr(), bp_out.data_ptr(),
                c_all.shape[0], nz, ny, nx, nz, nv, nu, dz, dy, dx, dv, du,
                offz, offy, offx, offv / dv, offu, geo.DSO, geo.DSD,
                geo.DSO / geo.DSD, 0.0, WEIGHTS["pmatched"], 0, dev, stream)
            return bp_out
        parent = {"fp_ray": p_fp, "bp_matched": p_bm, "bp_voxel": p_bp}
        calls = {
            "fp_ray": lambda c: fp_ray_cuda(vol, geo, a_x, 0, c),
            "bp_matched": lambda c: bp_matched_cuda(y, geo, a_x, config=c),
            "bp_voxel": lambda c: bp_voxel_cuda(proj, geo, a_all,
                                                "pmatched", config=c)}
        for name, call in calls.items():
            want = parent[name]().clone()
            row = []
            for i, knobs in enumerate(build.configs(name)):
                got = call(i)
                same = bool(torch.equal(got, want))
                all_equal &= same
                row.append(dict(knobs, config=i, bit_equal=same,
                                differing=int((got != want).sum())))
            result[f"{name} {tag}"] = row
            print(f"  {name} {tag}: " + ", ".join(
                f"{r['config']} {'=' if r['bit_equal'] else '!='}"
                for r in row), flush=True)
            if tag == f"N={n}":
                # configuration 0 and the parent in turns: parent, this,
                # this, parent (CUDA-event medians of 5)
                t = [_cuda_ms(parent[name]), _cuda_ms(lambda: call(0)),
                     _cuda_ms(lambda: call(0)), _cuda_ms(parent[name])]
                result[f"{name} {tag} ms"] = {"parent": [t[0], t[3]],
                                              "configuration 0": t[1:3]}
                print(f"  {name} {tag}: parent {t[0]:.3f}, configuration 0 "
                      f"{t[1]:.3f}, {t[2]:.3f}, parent {t[3]:.3f} ms",
                      flush=True)
        del vol, y, proj, want, parent, calls
        torch.cuda.empty_cache()
    print(json.dumps({"parent": str(csrc), "bit_equal": all_equal,
                      "configs": result}))
    return 0 if all_equal else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=64,
                    help="cubic volume side for the baked geometry")
    ap.add_argument("--detector", type=int, nargs=2, default=None,
                    metavar=("NV", "NU"),
                    help="detector rows/cols (default: N x N)")
    ap.add_argument("--planes", type=int, nargs="*", default=None,
                    help="slab plane counts to bake for bp (default: the "
                         "full volume)")
    ap.add_argument("--out", default=os.environ.get("REPRO_AUTOTUNE_CACHE",
                                                    ""),
                    help="JSON table path (default REPRO_AUTOTUNE_CACHE)")
    ap.add_argument("--repeats", type=int, default=3,
                    help="timing repeats per candidate (median taken)")
    ap.add_argument("--smoke", action="store_true",
                    help="small-geometry tune + cache round-trip + floor")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="--smoke's device (default: the card when there "
                         "is one, else the CPU)")
    ap.add_argument("--parent", type=Path, default=None,
                    help="hold every tile configuration against this "
                         "csrc/ directory's kernels, bit for bit")
    args = ap.parse_args(argv)

    import torch
    if args.smoke:
        dev = args.device or ("cuda" if torch.cuda.is_available() else "cpu")
        return smoke(dev)
    if not torch.cuda.is_available():
        print("torch_autotune: no CUDA device (only --smoke runs on the "
              "CPU)", file=sys.stderr)
        return 2
    if args.parent is not None:
        return parent_check(args.parent, args.n)
    planes = args.planes or [args.n]
    detector = args.detector or (args.n, args.n)
    results = bake(args.n, detector, planes, args.out, args.repeats)
    print(json.dumps(results, indent=2, sort_keys=True))
    if args.out:
        print(f"table written to {args.out}")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "src"))
    sys.exit(main())
