#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

Builds the port's CUDA kernels from the sources in this checkout, holds
each against its plain-PyTorch version (parity, the adjoint identity of
the Joseph pair, bit-identical repeat launches), drives the port's paths
through its own entry points, and prints the kernels' measurements.  The
CT paths run at N=512 (512^3 volume, 512^2 detector, 512 angles):

* CGLS with the Joseph A (``fp_ray``) and its exact adjoint
  (``bp_matched``), in-core and streamed out-of-core;
* FDK on the voxel-driven backprojector (``bp_voxel``), in-core;
* OS-SART on ``fp_ray`` and ``bp_voxel``, in-core and streamed;
* ASD-POCS: OS-SART sweeps on ``fp_ray`` and ``bp_voxel`` and TV steepest
  descent on the TV-gradient kernel (``tv_grad``), in-core and streamed;
* FISTA-TV on ``fp_ray`` and ``bp_matched`` with the ROF prox, in-core;
* the multi-device layer, with several shards or lanes on the one card,
  each on a CUDA stream of its own (the cost of the path itself: its
  exchanges, reductions and stream overlap, not scaling across GPUs):
  the operator sharded over a 2 x 2 mesh (A on ``fp_ray``, Aᵀ on
  ``bp_matched`` and ``bp_voxel``) with 3 CGLS iterations, the psum, ring
  and hier reductions on a 1 x 4 mesh and a 13-angle pad-mask case; the
  halo-split TV (``tv_grad`` per shard) and ROF; streamed CGLS on two
  lanes with the Fig 9 timeline bins and a Chrome trace in
  ``chiprun_out/`` (and on two GPUs where the machine has them);
* the serving layer (``repro_torch.serve``), ``phase_serve``: ASD-POCS at
  N=256 and CGLS and OS-SART at N=512 packed on one slot of cuda:0 at a
  budget set from ``estimate_job_footprint``, a priority-5 CGLS at N=256
  that fits only by evicting an N=512 job, CGLS at N=512 routed to the
  streamed path by a 256 MiB budget, and two N=256 jobs on one and then
  on two slots of the card (a CUDA stream each) under the threaded
  driver; every job must end COMPLETED and equal its solo run (the
  algorithm stepped directly on the operator) bit for bit, and the
  phase prints each job's seconds per step against the direct run's and
  the reserved bytes against ``max_memory_allocated``;
* ``phase_serve_durable``: CGLS at N=256 parked by the PreemptionGuard
  after its first iteration into a snapshot under ``chiprun_out/``,
  restored by a fresh scheduler and finished bit for bit as an
  uninterrupted run (snapshot bytes, write seconds, preempt-to-resume
  seconds), then ``recon.main`` at N=512, mode auto, through the
  scheduler;
* ``phase_fleet``, the fleet (``repro_torch.serve.pool`` / ``steal`` /
  ``autoscale``, ``MultiPodDriver``) with its pods sharing cuda:0, each
  slot on its own stream: four jobs pinned to one pod and stolen by the
  other, a running CGLS N=512 migrated between pods at a step boundary,
  an autoscaler growing the fleet under backlog and draining a pod away,
  a fleet parked by the guard and restored onto the same pod mesh, and
  ``recon.main --pods 2`` with the Prometheus file, the calibration
  report and one scrape of the live endpoint; every result equals its
  solo run bit for bit and recon's rel_err the single pod's;
* the tile autotuner (``repro_torch.kernels.autotune``): ``fp_ray``,
  ``bp_matched`` and ``bp_voxel`` are each compiled in several tile
  configurations.  ``phase_tile_checks`` holds every configuration against
  configuration 0 bit for bit and against the plain version at the kernel
  band (N=64, a prime N=61 with a 67 x 71 detector and 13 angles, and a
  geometry past bp_voxel's window buffers); ``phase_autotune`` tunes the
  three kinds at N=512 (the whole volume and the streamed slab height) and
  N=256 and prints each candidate's ms, bit check and winner, times the
  default and the winner at the main path's shapes, saves the table under
  ``chiprun_out/`` and reloads it without a measurement, runs CGLS and
  OS-SART at N=512 with tuning on (the tuned table, then every kernel at
  its last configuration) bit-equal to the untuned runs, and runs
  ``recon.main --autotune`` twice at N=256 with ``REPRO_AUTOTUNE_CACHE``
  set, the second run measuring nothing.  The ``kernels`` line carries
  each tuned kernel's configuration at N=512 and its ms.

``bp_matched`` reads each voxel's taps off per-plane tables in shared
memory; ``bp_voxel`` reads its taps off a window of each angle's
projection staged in shared memory by cp.async; ``fp_ray`` computes each
(u, plane)'s u-part once for a thread's rows and skips the planes its rows
cannot reach in a slab; ``tv_grad`` forms one smoothed magnitude per voxel
from plane windows brought into shared memory by TMA.

The LM serving path runs gemma2-9b at full width and depth (42 layers,
bf16, seeded random weights made on the card):

* prefill of 2 prompts of 8192 tokens through the FlashAttention kernel
  (``flash_attention``), 42 launches per prefill, every one on its
  tensor-core path (bf16 wgmma; the float32 SIMT path serves float32
  inputs, as in the decode-vs-prefill check below);
* 32 decode steps on a 32768-slot ring cache (plain PyTorch ops);
* a torch.profiler window over one prefill and three decode steps (device
  time by kernel, device idle share);
* decode-equals-prefill in float32 at full width and 4 layers.

Then the other configs (``phase_lm_zoo``), each at full width and depth,
bf16, seeded weights on the card, one model resident at a time:
stablelm-1.6b (head dim 64), codeqwen1.5-7b (128), hubert-xlarge (an
encoder on seeded frame embeddings, head dim 80), deepseek-moe-16b and
moonshot-v1-16b-a3b (a dense first layer, then MoE layers of 64 experts,
top 6; head dim 128), minicpm3-4b (62 MLA layers: latent q and kv, plain
ops, no kernel), llama-3.2-vision-11b (32 GQA layers of Hq 32 / Hkv 8
at D 128 and 8 gated cross-attention layers over a seeded image context of
1600 patch embeddings; the gates, zero at init, set to 0.5), zamba2-7b
(81 Mamba2 layers, the chunked SSD in plain ops, and one shared attention
block of 32 heads of D 112 called from 13 of them) and xlstm-350m (18
mLSTM and 6 sLSTM layers in plain ops, no attention layer, an O(1) decode
state):

* prefill of 2 x 8192 tokens (prefill_32k cut to S 8192, batch 2), a
  warm-up and 3 timed, every one the same bits, each GQA layer's launch
  on the tensor-core kernel (none for MLA and cross-attention layers;
  one for each of zamba2's 13 shared-block call sites); the MoE configs'
  share of assignments dropped at capacity;
* 16 decode steps of the six decoders at batch 2 on 8192 cache slots
  (decode_32k cut from 32768 slots and batch 128); hubert's serve step is
  refused (no decode step);
* ``flash_attention`` timed at hubert's D 80 shape, at llama-vision's
  GQA-4 D 128 shape and at zamba2's first shared-block call (D 112);
* a torch.profiler window over one prefill and 3 decode steps of each MoE,
  MLA, VLM and hybrid config (device time by kernel, idle share), and
  zamba2's chunked SSD timed alone at a layer's prefill shape;
* decode-equals-prefill in float32 at 4 layers of each decoder's widths
  (llama-vision: 5, its whole pattern; zamba2: 9, three prelude Mamba2
  layers and one pattern repeat with its shared-block call, SSD chunks of
  8 so that the prefills span one, two and four chunks; xlstm-350m: one
  pattern unit, decoded from an empty cache as the reference hands decode
  a zero mLSTM state).

Then ``phase_train``, twice: ``launch/train.py`` trains xlstm-350m at full
width and one pattern unit (4 of its 24 layers, one step: its host-bound
sLSTM loop made the full-depth step 76-92 s) and stablelm-1.6b at full
width and depth (train_4k cut to batch 4 of 4096 tokens, 2 steps, cold
then warm; remat per pattern unit, the chunked cross-entropy, AdamW on
the cosine schedule); each GQA layer's attention runs the forward kernel
twice a step (the pass and its remat recompute) and the backward kernels
(``flash_attention_bwd``: Di, dK/dV, dQ; in bf16 its tensor-core path)
once, and no plain version runs; every loss and gradient norm is finite;
stablelm's next step runs under torch.profiler (device time by kernel).
For each config, one pattern unit (stablelm: one layer) in float32 trains
2 steps on the card and on the CPU from the same weights (losses,
gradient norms, parameters compared), and a run preempted after its 3rd
of 4 steps resumes from its checkpoint with the uninterrupted losses.
Then ``phase_train_sharded``: ``launch/train.py`` trains stablelm-1.6b at
full width and depth on a (data 2, model 2) mesh of four ``cuda:0``
shards (``ShardedLM``: tensor parallel over model, data parallel over
data, ZeRO-1), the same batch 4 x 4096 for 2 steps: ms per step,
tokens/s, peak memory, the bytes each collective moves per step, and the
flash forward and backward launches of its 4 shards, counted and
checked; one layer in float32 trains 2 steps on the mesh and on one
device of the card, from the same weights, compared.  Then
``phase_train_sharded_mla_xattn`` on the same mesh and batch, bf16:
minicpm3-4b at full width and 16 of its 62 layers (MLA head parallel in
plain ops, no flash launch; its third step profiled, and the device
time of its float32 attention core's kernels, forward and backward, read
from that profile for its share of the step) and
llama-3.2-vision-11b at one pattern unit (4 GQA layers on the flash
kernels, 32 forward and 16 backward launches a step, and a gated
cross-attention layer over 1600 seeded patch embeddings, the gates
opened to 0.5), each then in float32 (one MLA layer; the whole unit)
on the mesh against one device.  Then ``phase_train_sharded_zamba2`` on
the same mesh and batch, bf16: zamba2-7b at full width and 15 of its 81
layers (its 3-layer prelude and two pattern units; Mamba2 head parallel,
the shared attention block called at two sites, 16 forward and 8
backward flash launches a step at D 112), its third step profiled, and
the device time of its chunked SSD's kernels read from that profile for
its share of the step; then its prelude and one unit in float32 on the
mesh against one device.
``flash_attention``'s checks end with ``phase_flash_backward_checks``:
dq, dk and dv of the backward kernels against autograd of the plain
version at every head dim, S 1000 and 77, GQA 1/2/4, the masks and the
cap, float32 and bfloat16 (the bfloat16 ones on the tensor-core kernels),
repeat backward launches bit-identical, the forward's out unchanged by
asking for its row statistics, and a negative control; then one shard of
llama-vision's and of zamba2's mesh train shapes (2 x 4096, 16 / 4 heads
at D 128 and 16 / 16 at D 112, bfloat16, causal); the backward is timed
at stablelm's train shape (``phase_flash_bwd_times``) against its bound,
the plain version's autograd and torch's ``scaled_dot_product_attention``
backward (the yardstick only).  Each phase's seconds are printed, and the
total.

Each path is run with the kernel counters set to 0 just before it and read
just after, and must have launched the kernels it runs (and called none of
their plain versions).

    python3 chip_smoke.py            # the whole run (one GPU)
    python3 chip_smoke.py --quick    # build and kernel checks only (with
                                     # the tile checks)

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
PEAK_BF16 = 989e12         # FLOP/s, dense bf16 on the tensor cores
#: fp32 operations per ray-plane sample (per voxel-angle pair in A^T): the
#: two y blends, the z blend and the accumulation
OPS_PER_SAMPLE = 8
#: fp32 operations per voxel-angle pair in bp_voxel's inner loop, counted
#: in csrc/bp_voxel.cu: fv 3, floor and fraction 2, tap weights 5, the four
#: taps 7, depth weight and accumulation 2
OPS_PER_PAIR_VOXEL = 19
#: fp32 operations per voxel in tv_grad's body, counted in csrc/tv_grad.cu:
#: 21 at the voxel, 12 at each point of the ring (1/16 of the voxels at its
#: 32 x 32 tiles) and of a chunk's prologue (1/32 at its 32-plane chunks); a
#: sqrt and a reciprocal counted as one each
OPS_PER_VOXEL_TV = 21 + 12 * (1 / 16 + 1 / 32)
RTOL, ATOL = 2e-4, 5e-3    # kernel vs plain (tests/test_backend.py:23)
TV_RTOL, TV_ATOL = 1e-5, 1e-5   # tv_grad vs plain (tests/test_kernels.py:70)
SCALAR_RTOL = 1e-4         # ASD-POCS's dtvg / dp_first, streamed vs plain
TV_STEPS = 20              # tv_grad launches per ASD-POCS iteration
#: cases of tv_grad_cases(128) in which the PR 13 kernel equals the plain
#: version bit for bit: all 16 (tools/probe_projectors.py --kernel tv_grad
#: --parent counts them); the floor of phase_tv_grad_checks
TV_BIT_EQUAL = 16
ADJ_TOL = 1e-4             # relative adjoint defect (tests/test_adjoint.py)
CGLS_TOL = 2e-3            # algorithm iterates (tests/test_adjoint.py:199)
#: flash_attention vs plain, by type.  float32 as tests/test_kernels.py:84.
#: In bfloat16 both compute in float32 from the same inputs and round once,
#: so they differ by at most one unit in the last place (2^-8 to 2^-7 of
#: the value): rtol 1e-2.  The reference's 5e-2 (tests/test_kernels.py:98)
#: is above a typical output at the main shape (|out| ~ 0.02), where it
#: would not tell a kernel that drops the window from a right one.
FLASH_TOL = {"float32": (2e-4, 2e-4), "bfloat16": (1e-2, 1e-4)}
#: flash_attention's gradients (dq, dk, dv of the backward kernels) vs
#: autograd of the plain version: (rtol, atol), the atol absolute in
#: float32 and a fraction of the leaf's largest |g| in bfloat16.  float32:
#: the forward's band (both sum in float32, in other orders; 2.4e-5 at
#: most at S 1000 on the CPU).  bfloat16: both compute in float32 from the
#: same bf16 inputs (Di from the float32 out, as autograd; the tensor-core
#: kernels feed P and dS as bf16 hi/lo pairs, 2^-16 of each weight) and
#: round each leaf once, so they differ by about one bf16 ulp (2^-8: rtol
#: 1e-2); the 1e-3 of the leaf's max covers entries that cancel to near 0
#: (gradients scale with d_out and the widths, so a fixed atol would not).
FLASH_GRAD_TOL = {"float32": (2e-4, 2e-4), "bfloat16": (1e-2, 1e-3)}
#: the kernel's lse vs torch.logsumexp of the plain scores (the bf16
#: kernel's exp is ex2.approx and its cap within 2.4e-5 of a score at 50)
LSE_RTOL, LSE_ATOL = 1e-5, 1e-4
#: scale of the checks' random q: scores of std 4, so the soft-cap of 50
#: changes the softmax (at std 1 it moves no output out of the band)
FLASH_Q_SCALE = 4.0
#: head dims of the flash checks: gemma2's 256, the zoo's 64 (stablelm),
#: 80 (hubert) and 128 (codeqwen, deepseek, moonshot); zamba2's 112 is
#: checked at its own heads (phase_flash_checks)
FLASH_DIMS = (64, 80, 128, 256)
LM_RTOL, LM_ATOL = 1e-3, 1e-4  # decode vs forward (tests/test_models.py:86)
SART_TOL = 2e-3            # streamed vs plain (tests/test_algorithms.py:77)
#: the kernels each path runs (its counter check)
PATH_KERNELS = {"cgls": ("fp_ray", "bp_matched"), "fdk": ("bp_voxel",),
                "ossart": ("fp_ray", "bp_voxel"),
                "asd_pocs": ("fp_ray", "bp_voxel", "tv_grad"),
                "fista": ("fp_ray", "bp_matched"),
                "dist": ("fp_ray", "bp_matched", "bp_voxel"),
                "dist_tv": ("tv_grad",),
                "serve": ("fp_ray", "bp_matched", "bp_voxel", "tv_grad"),
                "fleet_migrate": ("fp_ray", "bp_matched", "bp_voxel"),
                "prefill": ("flash_attention",)}
DIST_TV_RTOL, DIST_TV_ATOL = 1e-4, 1e-5    # tests/test_regularization.py:33
DIST_ROF_RTOL, DIST_ROF_ATOL = 1e-3, 1e-5  # tests/test_regularization.py:61
SCHEDULE_TOL = 1e-6        # psum / ring / hier (tests/test_comm_schedule.py)
APPROX_NORM_TOL = 0.02     # paper SS2.3's no-sync norm (test_regularization)
#: the no-sync norm against the exact one on the large-step case, where a
#: step sqrt(2) off (the sqrt(n_shards) factor dropped) moves the result by
#: about 1 %; phase_dist_tv checks that such a step leaves this bound
APPROX_NORM_BIG_TOL = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def run(cmd) -> str:
    return subprocess.run(cmd, check=True, capture_output=True,
                          text=True).stdout.strip()


def check_close(name, got, want, rtol=RTOL, atol=ATOL) -> float:
    import torch
    err = (got.float() - want.float()).abs()
    bad = err > atol + rtol * want.float().abs()
    max_err = float(err.max())
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} of {bad.numel()} elements outside "
            f"rtol={rtol} atol={atol} (max |err| {max_err:.3g})")
    log(f"  {name}: max |err| {max_err:.3g} (rtol {rtol}, atol {atol})")
    return max_err


def outside_band(got, want, rtol, atol) -> int:
    """How many elements of ``got`` lie outside the band around ``want``."""
    err = (got.float() - want.float()).abs()
    return int((err > atol + rtol * want.float().abs()).sum())


def check_separates(name, want, wrong, rtol, atol, what) -> None:
    """The band around ``want`` excludes ``wrong``, the plain version with
    one feature dropped: a kernel that dropped it would fail its check."""
    n = outside_band(wrong, want, rtol, atol)
    log(f"  {name}: the plain version with {what} puts {n} of "
        f"{want.numel()} elements outside the band")
    if n == 0:
        raise AssertionError(f"{name}: the band does not tell {what} apart")


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


def flash_paths():
    """flash_attention's launches since the counters were set to 0, by
    kernel: the bfloat16 tensor-core one and the float32 SIMT one."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    wgmma = flash_attention_cuda.wgmma_launches
    return {"wgmma": wgmma, "simt": flash_attention_cuda.launches - wgmma}


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
    return ds, snaps["x2"], counts, launches_per_iter, res.rec


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
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
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
    # the data set and the in-core iterate stay on the card: the run's own
    # peak is what it adds to them
    log(f"  seconds per iteration {[round(s, 3) for s in res.seconds]}, "
        f"rel_err {res.rel_err:.4f}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"({(torch.cuda.max_memory_allocated() - base) / 2**20:.0f} MiB "
        f"above the {base / 2**30:.2f} GiB held before it); counters "
        f"{counts}")
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
    return counts, res.rec


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


#: a geometry whose bp_voxel windows are taller than a buffer for some
#: tiles and angles (detector rows of 0.92 mm under 1 mm voxels), with large
#: detector offsets: it drives bp_voxel's global-read path beside its
#: staged one (as tests/test_torch_projector_windows.py computes), and
#: fp_ray's taps off the detector's centre
OVERFLOW_GEO = dict(DSD=1536.0, DSO=1000.0, n_voxel=(40, 36, 44),
                    s_voxel=(40.0, 36.0, 44.0), n_detector=(76, 41),
                    s_detector=(70.0, 82.0), off_detector=(9.0, -13.0))


def phase_overflow_checks():
    """fp_ray and bp_voxel against their plain versions on OVERFLOW_GEO
    (whole volume and a slab), repeat launches bit-identical."""
    import torch
    from repro_torch.core.geometry import (ConeGeometry, circular_angles,
                                           dominant_axis_mask)
    from repro_torch.kernels.bp_voxel import bp_voxel_cuda, bp_voxel_plain
    from repro_torch.kernels.fp_ray import fp_ray_cuda, fp_ray_plain
    geo = ConeGeometry(**OVERFLOW_GEO)
    log(f"== fp_ray and bp_voxel on a geometry past bp_voxel's window "
        f"buffers: {OVERFLOW_GEO}")
    gen = torch.Generator(device="cuda").manual_seed(5)
    ang = circular_angles(40)
    a_x = torch.from_numpy(ang[dominant_axis_mask(ang)]).cuda()
    a = torch.from_numpy(ang).cuda()
    vol = torch.randn(geo.n_voxel, generator=gen, device="cuda")
    y = torch.randn((a.numel(),) + geo.n_detector, generator=gen,
                    device="cuda")
    for part, z0, planes in (("full", 0, geo.n_voxel[0]), ("slab", 7, 29)):
        slab = vol[z0:z0 + planes].contiguous()
        got = fp_ray_cuda(slab, geo, a_x, z0=z0)
        check_close(f"fp_ray {part}", got, fp_ray_plain(slab, geo, a_x, z0))
        if not torch.equal(got, fp_ray_cuda(slab, geo, a_x, z0=z0)):
            raise AssertionError(f"fp_ray {part}: repeat launch differs")
        for weight in ("fdk", "pmatched", "none"):
            got = bp_voxel_cuda(y, geo, a, weight, z0, planes)
            check_close(f"bp_voxel {weight} {part}", got,
                        bp_voxel_plain(y, geo, a, weight, z0, planes))
            if not torch.equal(got, bp_voxel_cuda(y, geo, a, weight, z0,
                                                  planes)):
                raise AssertionError(f"bp_voxel {weight} {part}: repeat "
                                     "launch differs")
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


#: phase_tv_grad_checks' shapes beside an N^3 volume: an odd volume;
#: volumes of 1 and 2 planes; Nz = 31, 32, 33 and 65 about csrc/tv_grad.cu's
#: chunk of 32 planes, with Ny and Nx cutting its 32 x 32 tiles, Nx % 4 == 0
#: (TMA) or not (4-byte copies); one row; one column
TV_SHAPES = ((61, 37, 45), (1, 64, 64), (2, 64, 64), (31, 20, 45),
             (32, 16, 64), (33, 17, 70), (65, 9, 33), (5, 1, 40), (6, 11, 1))


def tv_grad_cases(n: int):
    """(tag, volume on the card) for each case of phase_tv_grad_checks:
    seeded random values at (N, N, N) and every shape of TV_SHAPES, and the
    piecewise-constant Shepp-Logan phantom (zero differences, so m = eps)
    where every axis exceeds 2."""
    import torch
    from repro_torch.core import phantoms
    from repro_torch.core.geometry import ConeGeometry
    gen = torch.Generator(device="cuda").manual_seed(2)
    for shape in ((n, n, n),) + TV_SHAPES:
        yield f"{shape} random", torch.randn(shape, generator=gen,
                                             device="cuda")
        if min(shape) > 2:
            yield f"{shape} shepp-logan", torch.from_numpy(
                phantoms.shepp_logan(ConeGeometry.nice(n).with_voxels(
                    shape))).cuda()


def phase_tv_grad_checks(n: int):
    """tv_grad against its plain version on the card at every case of
    tv_grad_cases: within the band, equal bit for bit in at least as many
    cases as the PR 13 kernel (TV_BIT_EQUAL), repeat launches
    bit-identical."""
    import torch
    from repro_torch.kernels.tv_grad import tv_grad_cuda, tv_grad_plain
    log(f"== tv_grad checks at {(n, n, n)} and "
        + ", ".join(map(str, TV_SHAPES)))
    same = cases = 0
    for kind, v in tv_grad_cases(n):
        tag = f"tv_grad {kind}"
        got = tv_grad_cuda(v)
        want = tv_grad_plain(v)
        check_close(tag, got, want, rtol=TV_RTOL, atol=TV_ATOL)
        cases += 1
        same += int(torch.equal(got, want))
        if not torch.equal(got, tv_grad_cuda(v)):
            raise AssertionError(f"{tag}: repeat launch differs")
    torch.cuda.synchronize()
    log(f"  repeat launches bit-identical; {same} of the {cases} cases equal "
        "to the plain version bit for bit")
    if same < TV_BIT_EQUAL:
        raise AssertionError(f"tv_grad equals its plain version in {same} "
                             f"cases, the PR 13 kernel in {TV_BIT_EQUAL}")


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


# --------------------------------------------------------------------------
# the multi-device layer: shards and lanes on one card
# --------------------------------------------------------------------------

def same_card_mesh(data: int, model: int):
    from repro_torch.launch.mesh import make_host_mesh
    return make_host_mesh(model, devices=["cuda:0"] * (data * model))


def dist_shard_inputs(a_np, y, n_data: int, i: int, split: bool, device):
    """What data index ``i`` of a dist call gets, as ``CTOperator`` and the
    sharded operators split it: the angles padded to the data axis (zero
    projection rows for the pad), then, with ``split``, grouped by
    dominance and each group padded again.  ``[(xdom, angles, rows)]`` on
    ``device``, ``rows`` None when ``y`` is."""
    import numpy as np
    import torch
    from repro_torch.core.distributed import _dominance_groups, pad_angles

    def padded_rows(rows, n_pad):
        return torch.cat([rows, rows.new_zeros((n_pad,) + rows.shape[1:])])
    padded, valid = pad_angles(a_np, n_data)
    if y is not None and not valid.all():
        y = padded_rows(y, len(padded) - len(a_np))
    groups = (_dominance_groups(padded) if split
              else [(None, np.arange(len(padded)))])
    out = []
    for xdom, idx in groups:
        a, v = pad_angles(padded[idx], n_data)
        rows = slice(i * len(a) // n_data, (i + 1) * len(a) // n_data)
        yy = None
        if y is not None:
            yy = y[torch.from_numpy(idx).to(y.device)]
            if not v.all():
                yy = padded_rows(yy, len(a) - idx.size)
            yy = yy[rows].contiguous()
        out.append((xdom, torch.from_numpy(a[rows]).to(device), yy))
    return out


def check_dist_shards(geo, vol, angles, proj, a13, y13):
    """One shard's slab call of each kernel on the dist path, through the
    backend as the shard makes it, against the plain version on the same
    slab, angles and z0: shard (1, 1) of the 2 x 2 mesh (z0 = N/2, the
    second angle chunk) with 512 and with 13 angles (padded rows), and
    shard (0, 3) of the 1 x 4 mesh (z0 = 3N/4).  Made after the counted
    run, so these launches count nowhere."""
    import math
    from repro_torch.core.backend import get_backend
    from repro_torch.core.projector import _rotate_vol_90, _unrotate_vol_90
    from repro_torch.kernels.bp_matched import bp_matched_plain
    from repro_torch.kernels.bp_voxel import bp_voxel_plain
    from repro_torch.kernels.fp_ray import fp_ray_plain
    cuda = get_backend("cuda")

    def fp_plain(xdom, slab, a, z0):
        if not xdom:         # the backend's -90 deg rotation trick
            slab, a = _rotate_vol_90(slab).contiguous(), a - math.pi / 2
        return fp_ray_plain(slab, geo, a, z0)

    def bm_plain(xdom, y, a, z0, planes):
        s = bp_matched_plain(y, geo, a if xdom else a - math.pi / 2, z0,
                             planes)
        return s if xdom else _unrotate_vol_90(s).contiguous()
    nz = geo.n_voxel[0]
    for n_data, n_model, i, j, a_np, y, bp_weights in (
            (2, 2, 1, 1, angles, proj, ("pmatched", "fdk")),
            (2, 2, 1, 1, a13, y13, ("fdk",)),
            (1, 4, 0, 3, angles, None, ())):
        planes = nz // n_model
        z0 = j * planes
        slab = vol[z0:z0 + planes]
        tag = (f"shard ({i}, {j}) of {n_data} x {n_model}, {len(a_np)} "
               f"angles, z0 {z0}")
        for xdom, a, yy in dist_shard_inputs(a_np, y, n_data, i, True,
                                             vol.device):
            dom = "x" if xdom else "y"
            check_close(f"{tag}: fp_ray, {len(a)} {dom}-dominant angles",
                        cuda.fp(geo, xdom=xdom)(slab, a, z0),
                        fp_plain(xdom, slab, a, z0))
            if yy is not None:
                check_close(
                    f"{tag}: bp_matched, {len(a)} {dom}-dominant rows",
                    cuda.bp_matched(geo, planes=planes, xdom=xdom)(yy, a, z0),
                    bm_plain(xdom, yy, a, z0, planes))
        for w in bp_weights:
            (_, a, yy), = dist_shard_inputs(a_np, y, n_data, i, False,
                                            vol.device)
            check_close(f"{tag}: bp_voxel {w}, {len(a)} rows",
                        cuda.bp(geo, planes=planes, weight=w)(yy, a, z0),
                        bp_voxel_plain(yy, geo, a, w, z0, planes))


def phase_dist(n: int, n_angles: int, ds, x3_plain, smi):
    """The operator sharded over a 2 x 2 mesh of the card: A, Aᵀ (matched,
    pmatched, fdk) and 3 CGLS iterations through the kernels, the three
    reduction orders on a 1 x 4 mesh and 13 angles on the 2 x 2 mesh; then
    each against the in-core operator, and one shard's call of each kernel
    against its plain version."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.core.distributed import dist_forward_project
    from repro_torch.core.geometry import ConeGeometry, circular_angles
    from repro_torch.core.operator import CTOperator
    from repro_torch.launch.recon import reconstruct
    log(f"== dist: N={n}, {n_angles} angles, a 2 x 2 mesh of cuda:0 "
        f"shards (and 1 x 4 for the reductions); card: {smi}")
    geo = ConeGeometry.nice(n)
    vol, angles, proj = ds
    mesh = same_card_mesh(2, 2)
    a13 = circular_angles(13)
    gen = torch.Generator(device="cuda").manual_seed(4)
    y13 = torch.randn((13,) + geo.n_detector, generator=gen, device="cuda")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counters()
    op = CTOperator(geo, angles, mode="dist", mesh=mesh)
    fns = {"A": lambda: op.A(vol)}
    for w in ("matched", "pmatched", "fdk"):
        fns[w] = lambda w=w: op.At(proj, weight=w)
    got = {k: f() for k, f in fns.items()}
    res = reconstruct("cgls", n=n, n_angles=n_angles, iters=3, mode="dist",
                      device="cuda", dataset=ds, mesh=mesh)
    mesh14 = same_card_mesh(1, 4)
    red = {}
    for r in ("psum", "ring", "hier"):
        fns[r] = lambda fp=dist_forward_project(mesh14, geo, reduce=r): \
            fp(vol, angles)
        red[r] = fns[r]()
    op13 = CTOperator(geo, a13, mode="dist", mesh=mesh)
    got["A13"], got["At13"] = op13.A(vol), op13.At(y13, weight="fdk")
    got["At13m"] = op13.At(y13)
    torch.cuda.synchronize()
    counts = kernels.counters()
    peak = torch.cuda.max_memory_allocated()
    # timed after the counted run: CUDA-event medians of 3 after a warm-up
    ms = {k: cuda_ms(f, reps=3) for k, f in fns.items()}
    log(f"  A {ms['A']:.1f} ms, Aᵀ matched {ms['matched']:.1f} ms, "
        f"pmatched {ms['pmatched']:.1f} ms, fdk {ms['fdk']:.1f} ms (CUDA-"
        f"event medians of 3); CGLS seconds per iteration "
        f"{[round(t, 3) for t in res.seconds]}, rel_err {res.rel_err:.4f}; "
        f"A on 1 x 4 by psum {ms['psum']:.1f}, ring {ms['ring']:.1f}, hier "
        f"{ms['hier']:.1f} ms")
    log(f"  peak device memory {peak / 2**30:.2f} GiB ({(peak - base) / 2**20:.0f} "
        f"MiB above the {base / 2**30:.2f} GiB held before it); counters "
        f"{counts}")
    check_counts(counts, "dist", "the sharded operator")
    check_image(res, geo)
    plain = CTOperator(geo, angles)
    for key, want in (("A", lambda: plain.A(vol)),
                      ("matched", lambda: plain.At(proj)),
                      ("pmatched", lambda: plain.At(proj, weight="pmatched")),
                      ("fdk", lambda: plain.At(proj, weight="fdk"))):
        check_close(f"dist {key} vs in-core", got[key], want())
    rel = adjoint_defect(got["A"], proj, vol, got["matched"])
    log(f"  adjoint defect of the sharded pair: {rel:.3g}")
    if not rel <= ADJ_TOL:
        raise AssertionError(f"adjoint defect {rel:.3g} > {ADJ_TOL}")
    for r in ("ring", "hier"):
        check_close(f"A by {r} vs psum", red[r], red["psum"],
                    rtol=SCHEDULE_TOL, atol=SCHEDULE_TOL)
    check_close("A by psum (1 x 4) vs in-core", red["psum"], got["A"])
    plain13 = CTOperator(geo, a13)
    if tuple(got["A13"].shape) != (13,) + tuple(geo.n_detector):
        raise AssertionError(f"13-angle A has shape {tuple(got['A13'].shape)}")
    check_close("dist A, 13 angles vs in-core", got["A13"], plain13.A(vol))
    check_close("dist Aᵀ fdk, 13 angles vs in-core", got["At13"],
                plain13.At(y13, weight="fdk"))
    check_close("dist Aᵀ matched, 13 angles vs in-core", got["At13m"],
                plain13.At(y13))
    check_close("dist CGLS x3 vs in-core CGLS x3", res.rec,
                x3_plain.to(res.rec.device), rtol=CGLS_TOL, atol=CGLS_TOL)
    check_dist_shards(geo, vol, angles, proj, a13, y13)
    return counts


def phase_dist_tv(n: int, smi):
    """The halo-split TV minimiser and ROF on the 2 x 2 mesh's two model
    shards (both on cuda:0), on a seeded random N^3 volume, against the
    monolithic ones; the n_inner 1 halo gradient against the monolithic
    tv_grad bit for bit."""
    import torch
    from repro_torch import kernels
    from repro_torch.core import regularization as reg
    from repro_torch.core.distributed import halo_exchange
    log(f"== dist TV and ROF: a random {n}^3 volume, 2 model shards on "
        f"cuda:0; card: {smi}")
    mesh = same_card_mesh(2, 2)
    gen = torch.Generator(device="cuda").manual_seed(5)
    v = torch.randn((n, n, n), generator=gen, device="cuda")
    # a step of the reference test's size per voxel (0.1 at 32 x 12 x 12)
    hyper_big = 0.1 * (v.numel() / (32 * 12 * 12)) ** 0.5
    torch.cuda.synchronize()
    kernels.reset_counters()
    fns, got = {}, {}
    for key, hyper, approx in (("exact", 0.1, False), ("approx", 0.1, True),
                               ("exact_big", hyper_big, False),
                               ("approx_big", hyper_big, True)):
        fn = reg.dist_minimize_tv(mesh, hyper, 20, 4, approx_norm=approx)
        fns[key] = lambda fn=fn: fn(v)
        got[key] = fns[key]()
    fns["rof"] = lambda rof=reg.dist_rof_denoise(mesh, 10.0, 8, 4): rof(v)
    got["rof"] = fns["rof"]()
    halo = [reg._halo_gradient(vp, 1, j, 2, 1e-6)[3]
            for j, vp in enumerate(halo_exchange(list(v.split(n // 2)), 1))]
    torch.cuda.synchronize()
    counts = kernels.counters()
    log(f"  counters {counts}")
    check_counts(counts, "dist_tv", "the halo-split TV")
    # the no-sync norm with its sqrt(n_shards) factor dropped: a step
    # sqrt(2) larger, which the large-step bound must tell apart
    wrong_big = reg.dist_minimize_tv(mesh, hyper_big * 2 ** 0.5, 20, 4,
                                     approx_norm=True)(v)
    mono = {"exact": reg.minimize_tv(v, 0.1, 20),
            "exact_big": reg.minimize_tv(v, hyper_big, 20),
            "rof": reg.rof_denoise(v, 10.0, 8)}
    ms = {k: cuda_ms(fns[k], reps=3) for k in ("exact", "approx", "rof")}
    ms["mono"] = cuda_ms(lambda: reg.minimize_tv(v, 0.1, 20), reps=3)
    ms["mono_rof"] = cuda_ms(lambda: reg.rof_denoise(v, 10.0, 8), reps=3)
    log(f"  20 TV steps, n_inner 4: halo-split {ms['exact']:.1f} ms (exact "
        f"norm), {ms['approx']:.1f} ms (no-sync norm), monolithic "
        f"{ms['mono']:.1f} ms; ROF 8 steps: halo-split {ms['rof']:.1f} ms, "
        f"monolithic {ms['mono_rof']:.1f} ms (CUDA-event medians of 3)")
    for key in ("exact", "exact_big"):
        check_close(f"dist TV ({key}) vs monolithic", got[key], mono[key],
                    rtol=DIST_TV_RTOL, atol=DIST_TV_ATOL)

    def rel_diff(a, b):
        return float(torch.linalg.vector_norm(a - b)
                     / torch.linalg.vector_norm(b))
    for key in ("", "_big"):
        rel = rel_diff(got["approx" + key], got["exact" + key])
        log(f"  no-sync norm vs exact{key}: relative difference {rel:.3g}")
        if not rel < APPROX_NORM_TOL:
            raise AssertionError(f"approximate norm off by {rel:.3g}")
    rel = rel_diff(got["approx_big"], got["exact_big"])
    if not rel < APPROX_NORM_BIG_TOL:
        raise AssertionError(f"approximate norm off by {rel:.3g} on the "
                             f"large-step case (bound {APPROX_NORM_BIG_TOL})")
    rel_wrong = rel_diff(wrong_big, got["exact_big"])
    log(f"  the no-sync norm without its sqrt(n_shards) factor: relative "
        f"difference {rel_wrong:.3g} on the large-step case (bound "
        f"{APPROX_NORM_BIG_TOL})")
    if not rel_wrong >= APPROX_NORM_BIG_TOL:
        raise AssertionError("the large-step bound does not tell a step "
                             "sqrt(2) off apart")
    check_close("dist ROF vs monolithic", got["rof"], mono["rof"],
                rtol=DIST_ROF_RTOL, atol=DIST_ROF_ATOL)
    g = reg.tv_gradient(v)
    planes = n // 2
    for j, own in enumerate(halo):
        if not torch.equal(own, g[j * planes:(j + 1) * planes]):
            raise AssertionError(f"shard {j}'s halo gradient differs from "
                                 "the monolithic tv_grad")
    log("  n_inner 1: both shards' halo gradients equal the monolithic "
        "tv_grad bit for bit")
    return counts


def phase_stream_devices(n: int, n_angles: int, ds, x2_plain, device_bytes,
                         smi):
    """Streamed CGLS on two lanes of cuda:0 (a plan for 2 devices under the
    same per-device budget), then the Fig 9 bins of one A and one Aᵀ,
    every prefetch depth bit-identical, and a Chrome trace; on a machine
    with two GPUs the same on cuda:0 and cuda:1."""
    import torch
    from repro_torch import kernels, obs
    from repro_torch.core.algorithms.stepwise import get_algorithm
    from repro_torch.core.geometry import ConeGeometry
    from repro_torch.core.operator import CTOperator
    from repro_torch.core.splitting import MemoryModel
    from repro_torch.core.streaming import (Timeline, stream_backward,
                                            stream_forward)
    geo = ConeGeometry.nice(n)
    vol, angles, proj = ds
    vol_h, proj_h = vol.cpu(), proj.cpu()
    lanes = [["cuda:0", "cuda:0"]]
    if torch.cuda.device_count() >= 2:
        lanes.append(["cuda:0", "cuda:1"])
    counts = None
    for devs in lanes:
        log(f"== streamed CGLS on devices {devs}: N={n}, {n_angles} angles, "
            f"{device_bytes / 2**20:.0f} MiB per device, 2 iterations; "
            f"card: {smi}")
        op = CTOperator(geo, angles, mode="stream", devices=devs,
                        memory=MemoryModel(device_bytes=device_bytes))
        pl = op.plan
        log(f"  plan: {pl.n_devices} devices, fp {pl.forward.n_slabs} slabs "
            f"(angles {pl.forward.angle_ranges}), bp {pl.backward.n_slabs} "
            f"slabs x chunk {pl.backward.angle_chunk} (devices "
            f"{pl.backward.device_of_slab}), prefetch depth "
            f"{pl.comm.prefetch_depth}")
        alg = get_algorithm("cgls")
        tracer = obs.Tracer(enabled=True)
        prev = obs.set_tracer(tracer)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_counters()
        try:
            t0 = time.perf_counter()
            st = alg.init(proj_h, geo, angles, op=op)
            seconds = []
            for _ in range(2):
                t1 = time.perf_counter()
                st = alg.step(st)
                seconds.append(time.perf_counter() - t1)
            x = alg.finalize(st)
            wall = time.perf_counter() - t0
        finally:
            obs.set_tracer(prev)
        c = kernels.counters()
        if counts is None:
            counts = c
        peak = torch.cuda.max_memory_allocated()
        phases = tracer.phase_seconds()
        log(f"  seconds per iteration {[round(t, 3) for t in seconds]} "
            f"({wall:.2f} s with init); peak device memory "
            f"{peak / 2**30:.2f} GiB ({(peak - base) / 2**20:.0f} MiB above "
            f"the {base / 2**30:.2f} GiB held before it); counters {c}")
        log("  span seconds: " + ", ".join(
            f"{k} {v:.3f}" for k, v in sorted(phases.items()))
            + f", outside spans {wall - sum(phases.values()):.3f}")
        check_counts(c, "cgls", f"streamed CGLS on {devs}")
        check_close(f"stream CGLS x2 on {devs} vs in-core x2", x,
                    x2_plain.cpu(), rtol=CGLS_TOL, atol=CGLS_TOL)
        tag = "-".join(d.replace(":", "") for d in devs)
        out_dir = os.path.join(ROOT, "chiprun_out")
        os.makedirs(out_dir, exist_ok=True)
        trace_path = os.path.join(out_dir, f"stream_devices_{tag}.json")
        tracer.write_chrome_trace(trace_path)
        log(f"  Chrome trace of the run ({len(tracer.records())} records) "
            f"in {os.path.relpath(trace_path, ROOT)}")
        serial = pl.with_prefetch(0).comm
        for what, run_op in (
                ("A", lambda **kw: stream_forward(vol_h, geo, angles, pl,
                                                  devices=devs, **kw)),
                ("Aᵀ", lambda **kw: stream_backward(proj_h, geo, angles, pl,
                                                    devices=devs, **kw))):
            tl = Timeline()
            t0 = time.perf_counter()
            a = run_op(timeline=tl)
            wall = time.perf_counter() - t0
            if not torch.equal(a, run_op(comm=serial)):
                raise AssertionError(f"stream {what} on {devs}: prefetch "
                                     "depth changed the bits")
            fr = tl.fractions()
            log(f"  Fig 9 bins of one {what} ({wall:.3f} s): "
                + ", ".join(f"{k} {tl.bins[k]:.3f} s ({fr[k]:.1%})"
                            for k in ("staging", "compute", "other_memory"))
                + f"; bit-identical at prefetch depth "
                f"{pl.comm.prefetch_depth} and 0")
    return counts


# --------------------------------------------------------------------------
# the serving layer (repro_torch.serve)
# --------------------------------------------------------------------------

def check_completed(sched, jids, what: str) -> None:
    """Every job ended COMPLETED: a kernel that fails to build or launch
    fails its tenant alone, so the scheduler returns normally and only the
    record says so."""
    for jid in jids:
        rec = sched.records[jid]
        if rec.status.value != "completed":
            raise AssertionError(f"{what}: {jid} ({rec.job.algorithm} "
                                 f"N={rec.job.geo.n_voxel[0]}) ended "
                                 f"{rec.status.value}: {rec.error}")


def check_bits(name, got, want) -> None:
    import numpy as np
    want = want.detach().cpu().numpy() if hasattr(want, "detach") else want
    if got.shape != want.shape or not np.array_equal(got, want):
        n = int((got != want).sum()) if got.shape == want.shape else -1
        raise AssertionError(f"{name}: {n} elements differ from the solo "
                             "run's bits")
    log(f"  {name}: equal to its solo run bit for bit")


def step_seconds(tracer, jid):
    """The measured seconds of each step of job ``jid``, from the fleet
    events ``tracer`` recorded."""
    return [e.attrs["measured_s"] for e in tracer.events("step", job=jid)]


def phase_serve(n: int, ds, x_stream, device_bytes, smi):
    """The serving layer on cuda:0 at full width: four jobs of three
    algorithms on one slot, an urgent arrival that fits only by evicting
    an N=512 job; a CGLS job routed to the streamed path by a 256 MiB
    budget; two slots of one card, each on its own stream, under the
    threaded driver.  Every job must end COMPLETED and equal its solo run
    (``reconstruct()``: the algorithm stepped directly on the operator in
    the same mode) bit for bit."""
    import torch
    from repro_torch import kernels, obs
    from repro_torch.core.geometry import ConeGeometry
    from repro_torch.core.splitting import MemoryModel
    from repro_torch.data import make_ct_dataset
    from repro_torch.launch.recon import _job_params, reconstruct
    from repro_torch.serve import (AsyncDriver, DevicePool, ReconJob,
                                   Scheduler, estimate_job_footprint)
    t_phase = time.perf_counter()
    n_s = n // 2
    ds_s = make_ct_dataset(ConeGeometry.nice(n_s), n_s, device="cuda")
    data = {n: ds, n_s: ds_s}

    def job(alg, size, iters, **kw):
        _, angles, proj = data[size]
        return ReconJob(alg, ConeGeometry.nice(size), angles, proj,
                        n_iter=iters, params=_job_params(alg, len(angles)),
                        **kw)

    # (name, algorithm, N, iterations, priority); "urgent" arrives after
    # the first quantum.  The cheapest victim is the latest arrival of the
    # lowest priority, so ASD-POCS comes first and an N=512 job is it
    plan = [("asd256", "asd_pocs", n_s, 2, 0), ("cgls512", "cgls", n, 3, 0),
            ("ossart512", "ossart", n, 2, 0), ("urgent", "cgls", n_s, 2, 5)]
    fps = {name: estimate_job_footprint(job(alg, size, it, mode="plain"),
                                        MemoryModel()).bytes_on_device
           for name, alg, size, it, _ in plan}
    resident = fps["cgls512"] + fps["ossart512"] + fps["asd256"]
    mem = MemoryModel(device_bytes=int((resident + fps["urgent"] // 2)
                                       / 0.95) + 1)
    if not resident <= mem.usable < resident + fps["urgent"]:
        raise AssertionError("budget does not force an eviction")
    log(f"== serving: one slot of cuda:0 at a budget of "
        f"{mem.device_bytes / 2**30:.3f} GiB (usable {mem.usable} B); "
        "footprints " + ", ".join(f"{k} {v} B" for k, v in fps.items())
        + f"; card: {smi}")
    tracer = obs.Tracer(enabled=True)
    prev = obs.set_tracer(tracer)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counters()
    try:
        sched = Scheduler(pool=DevicePool(1, mem))
        ids = {}
        for name, alg, size, it, prio in plan[:3]:
            ids[name] = sched.submit(job(alg, size, it, mode="plain",
                                         priority=prio))
        t0 = time.perf_counter()
        sched.run(max_quanta=1)
        resident_bytes = {k: sched.records[j].footprint_bytes
                          for k, j in ids.items()
                          if sched.records[j].status.value == "running"}
        name, alg, size, it, prio = plan[3]
        ids[name] = sched.submit(job(alg, size, it, mode="plain",
                                     priority=prio))
        sched.run()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        check_completed(sched, ids.values(), "one-slot serving")
        parks = tracer.events("park")
        by_id = {j: k for k, j in ids.items()}
        victims = [by_id[e.attrs["job"]] for e in parks]
        log(f"  victim chosen for the urgent job: {victims} "
            f"(preemptions {sched.metrics.preemptions}); wall {wall:.2f} s")
        if len(victims) != 1 or victims[0] not in ("cgls512", "ossart512"):
            raise AssertionError(f"expected one N={n} victim, got {victims}")
        log("  reserved bytes of the jobs resident after the first quantum: "
            + ", ".join(f"{k} {v / 2**30:.3f} GiB"
                        for k, v in resident_bytes.items())
            + f" (sum {sum(resident_bytes.values()) / 2**30:.3f} GiB); "
            f"max_memory_allocated over the run {peak / 2**30:.3f} GiB "
            f"above the {base / 2**30:.2f} GiB held before it")

        # a CGLS job at N=512 under a 256 MiB budget: routed to stream
        small = MemoryModel(device_bytes=device_bytes)
        s2 = Scheduler(pool=DevicePool(1, small))
        j2 = s2.submit(job("cgls", n, 2))
        t0 = time.perf_counter()
        s2.run()
        wall2 = time.perf_counter() - t0
        check_completed(s2, [j2], "budget-routed CGLS")
        if not s2.records[j2].streamed:
            raise AssertionError("the 256 MiB CGLS job was not streamed")
        log(f"  CGLS N={n} under {device_bytes / 2**20:.0f} MiB: routed to "
            f"stream ({s2.records[j2].footprint_bytes} B reserved), "
            f"{wall2:.2f} s with init, s/step "
            f"{[round(t, 3) for t in step_seconds(tracer, j2)]}")

        # the same two jobs on one slot, then on two slots of cuda:0,
        # under the threaded driver
        walls = {}
        for n_slots in (1, 2):
            pool = DevicePool(n_slots, MemoryModel(device_bytes=8 << 30),
                              devices=["cuda:0"] * n_slots)
            streams = [s.stream for s in pool.slots]
            if None in streams or len(set(streams)) != n_slots:
                raise AssertionError("slots of one card share a stream")
            s3 = Scheduler(pool=pool)
            j3 = {"cgls256": s3.submit(job("cgls", n_s, 3, mode="plain")),
                  "ossart256": s3.submit(job("ossart", n_s, 2,
                                             mode="plain"))}
            t0 = time.perf_counter()
            AsyncDriver(s3).run(timeout=600)
            walls[n_slots] = time.perf_counter() - t0
            check_completed(s3, j3.values(), f"{n_slots}-slot serving")
        if {s3.records[j].device for j in j3.values()} != {0, 1}:
            raise AssertionError("the two jobs did not run on two slots")
        log(f"  CGLS and OS-SART at N={n_s} under the threaded driver: "
            f"{walls[1]:.3f} s on one slot, {walls[2]:.3f} s on two slots "
            f"of cuda:0 (streams {streams[0].cuda_stream:#x}, "
            f"{streams[1].cuda_stream:#x})")
    finally:
        obs.set_tracer(prev)
    # launches of the driven runs alone (concurrent workers may lose a
    # count, so this asks for > 0 of each kernel)
    counts = kernels.counters()
    log(f"  counters {counts}")
    check_counts(counts, "serve", "the serving phase")

    # solo runs: bits, and the scheduler's per-step overhead
    solo = {"cgls512": ("cgls", n, 3), "ossart512": ("ossart", n, 2),
            "asd256": ("asd_pocs", n_s, 2), "urgent": ("cgls", n_s, 2),
            "cgls256": ("cgls", n_s, 3), "ossart256": ("ossart", n_s, 2)}
    records = {k: sched.records[j] for k, j in ids.items()}
    records.update({k: s3.records[j] for k, j in j3.items()})
    solos = {}
    for name, (alg, size, it) in solo.items():
        res = reconstruct(alg, n=size, n_angles=len(data[size][1]),
                          iters=it, mode="plain", device="cuda",
                          dataset=data[size], verbose=False)
        rec = records[name]
        check_bits(f"{name} ({rec.preemptions} preemptions)", rec.result,
                   res.rec)
        solos[(alg, size, it)] = res.rec.cpu().numpy()
        if name in ids:
            sched_s = [round(s, 3) for s in step_seconds(tracer, ids[name])]
            log(f"    s/step scheduled {sched_s} against direct "
                f"{[round(s, 3) for s in res.seconds]}")
        del res
    check_bits("budget-routed streamed CGLS vs phase_main_stream's",
               s2.records[j2].result, x_stream)
    del ds_s, data
    torch.cuda.empty_cache()
    log(f"  phase_serve took {time.perf_counter() - t_phase:.1f} s")
    return counts, solos


def phase_serve_durable(n: int, smi):
    """A CGLS job at N=``n`` with durable snapshots under chiprun_out/: a
    SIGTERM-equivalent (the PreemptionGuard) after its first iteration
    parks and persists it, a fresh scheduler restores it and finishes bit
    for bit as an uninterrupted run; then ``recon.main`` at N=2n, mode
    auto, through the scheduler."""
    import shutil
    import threading
    import torch
    from repro_torch import kernels
    from repro_torch.checkpoint import PreemptionGuard
    from repro_torch.core.geometry import ConeGeometry
    from repro_torch.core.splitting import MemoryModel
    from repro_torch.data import make_ct_dataset
    from repro_torch.launch import recon
    from repro_torch.serve import (AsyncDriver, DevicePool, ReconJob,
                                   Scheduler)
    t_phase = time.perf_counter()
    iters = 6
    log(f"== durable serving: CGLS N={n}, {n} angles, {iters} iterations, "
        f"the guard fired after the first; card: {smi}")
    geo = ConeGeometry.nice(n)
    ds = make_ct_dataset(geo, n, device="cuda")
    _, angles, proj = ds
    snap = os.path.join(ROOT, "chiprun_out", "serve_snapshot")
    shutil.rmtree(snap, ignore_errors=True)
    mem = MemoryModel(device_bytes=4 << 30)
    kernels.reset_counters()
    guard = PreemptionGuard(install_handler=False)
    sched = Scheduler(pool=DevicePool(1, mem), guard=guard,
                      snapshot_dir=snap)
    jid = sched.submit(ReconJob("cgls", geo, angles, proj, n_iter=iters))
    snap_s = []
    snapshot = sched.snapshot

    def timed_snapshot(ckpt_dir, **kw):
        t = time.perf_counter()
        out = snapshot(ckpt_dir, **kw)
        snap_s.append(time.perf_counter() - t)
        return out
    sched.snapshot = timed_snapshot
    fired = []

    def trigger():
        while sched.records[jid].iterations_done < 1:
            time.sleep(0.001)
        fired.append(time.perf_counter())
        guard.trigger()
    killer = threading.Thread(target=trigger, daemon=True)
    killer.start()
    AsyncDriver(sched).run(timeout=600)
    t_parked = time.perf_counter()
    killer.join(timeout=60)
    rec = sched.records[jid]
    if rec.status.value != "preempted" or not snap_s:
        raise AssertionError(f"the guard did not park the job: "
                             f"{rec.status.value} {rec.error}")
    nbytes = sum(os.path.getsize(os.path.join(d, f))
                 for d, _, fs in os.walk(snap) for f in fs)
    t_restore = time.perf_counter()
    fresh = Scheduler(pool=DevicePool(1, mem))
    if fresh.restore(snap) != 1:
        raise AssertionError("restore found no parked job")
    fresh.admit()
    t_resumed = time.perf_counter()
    log(f"  parked after {rec.iterations_done} iteration(s); snapshot "
        f"{nbytes} B written in {snap_s[-1]:.3f} s "
        f"({nbytes / snap_s[-1] / 1e9:.3f} GB/s); guard to parked "
        f"{t_parked - fired[0]:.3f} s, restore + re-init "
        f"{t_resumed - t_restore:.3f} s: preempt-to-resume "
        f"{t_parked - fired[0] + t_resumed - t_restore:.3f} s")
    fresh.run()
    check_completed(fresh, [jid], "restored CGLS")
    counts = kernels.counters()
    check_counts(counts, "cgls", "durable serving")
    res = recon.reconstruct("cgls", n=n, n_angles=n, iters=iters,
                            mode="plain", device="cuda", dataset=ds,
                            verbose=False)
    check_bits(f"restored CGLS (resumed at iteration {rec.iterations_done})",
               fresh.result(jid), res.rec)
    shutil.rmtree(snap, ignore_errors=True)
    solo = res.rec.cpu().numpy()
    del ds, res, sched, fresh
    torch.cuda.empty_cache()
    log(f"== recon.main at N={2 * n}, mode auto, through the scheduler")
    t0 = time.perf_counter()
    out, rel = recon.main(["--alg", "cgls", "--n", str(2 * n), "--angles",
                           str(2 * n), "--iters", "2", "--mode", "auto"])
    if out is None or not 0.0 < rel < 1.0:
        raise AssertionError(f"recon.main: rel_err {rel}")
    log(f"  {time.perf_counter() - t0:.1f} s with the data set; "
        f"phase_serve_durable took {time.perf_counter() - t_phase:.1f} s")
    return counts, {("cgls", n, iters): solo}, rel


# --------------------------------------------------------------------------
# the fleet (repro_torch.serve.pool / steal / autoscale, MultiPodDriver)
# --------------------------------------------------------------------------

def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


class Handoffs:
    """Times every export and import of a set of pods and weighs what
    each export wrote to the transfer directory."""

    def __init__(self, pods, transfer_dir: str):
        self.exports, self.imports = [], []
        for pod in pods:
            self.wrap(pod.scheduler, transfer_dir)

    def wrap(self, sched, transfer_dir: str) -> None:
        export, import_ = sched.export_job, sched.import_job

        def timed_export(jid, tdir):
            t = time.perf_counter()
            ok = export(jid, tdir)
            dt = time.perf_counter() - t
            if ok:
                self.exports.append((jid, sched.name, dir_bytes(
                    os.path.join(tdir, "jobs", jid)), dt))
            return ok

        def timed_import(tdir, jid, data_refs=None):
            t = time.perf_counter()
            out = import_(tdir, jid, data_refs=data_refs)
            self.imports.append((jid, sched.name,
                                 time.perf_counter() - t))
            return out
        sched.export_job, sched.import_job = timed_export, timed_import

    def report(self) -> None:
        for (jid, src, nbytes, t_out), (_, dst, t_in) in zip(
                self.exports, self.imports):
            log(f"    hand-off {jid} {src} -> {dst}: {nbytes} B, export "
                f"{t_out:.3f} s ({nbytes / t_out / 1e9:.3f} GB/s), import "
                f"{t_in:.3f} s ({nbytes / t_in / 1e9:.3f} GB/s)")


def track_reserved(pods):
    """Peak of the bytes each pod's slots have reserved at once."""
    peak = {p.name: 0 for p in pods}
    for pod in pods:
        commit = pod.pool.commit

        def tracked(slot, job_id, nbytes, pod=pod, commit=commit):
            commit(slot, job_id, nbytes)
            peak[pod.name] = max(peak[pod.name], sum(
                s.committed_bytes for s in pod.pool.slots))
        pod.pool.commit = tracked
    return peak


def pod_report(pods, tracer, peak, base) -> None:
    """Per pod: steps, steals in and out, migrations in and out, the peak
    reserved bytes; and the card's max_memory_allocated over the run."""
    import torch
    migrations = tracer.events("migrate")
    for pod in pods:
        m = pod.scheduler.metrics
        log(f"    {pod.name}: {m.steps} steps, stolen in {m.stolen_in} / "
            f"out {m.stolen_out}, migrated in "
            f"{sum(e.attrs['dst'] == pod.name for e in migrations)} / out "
            f"{sum(e.attrs['src'] == pod.name for e in migrations)}, "
            f"reserved peak {peak.get(pod.name, 0) / 2**30:.3f} GiB")
    log(f"    reserved peaks summed {sum(peak.values()) / 2**30:.3f} GiB "
        f"against max_memory_allocated "
        f"{(torch.cuda.max_memory_allocated() - base) / 2**30:.3f} GiB "
        f"above the {base / 2**30:.2f} GiB held before")


def check_fleet_done(mps, jids, what: str) -> None:
    for jid in jids:
        rec = mps.record(jid)
        if rec.status.value != "completed":
            raise AssertionError(f"{what}: {jid} ({rec.job.algorithm} "
                                 f"N={rec.job.geo.n_voxel[0]}) ended "
                                 f"{rec.status.value}: {rec.error}")


def phase_fleet(n: int, ds, solos, rel_single, smi):
    """The fleet on cuda:0 at full width: pods share the card, each slot on
    a CUDA stream of its own.  Work stealing under the MultiPodDriver,
    live migration of a running N=512 CGLS job, an autoscaler growing and
    shrinking the fleet, a durable fleet drained by the guard and restored
    onto the same pod mesh, and ``recon.main --pods 2`` with the
    exporters.  Every result equals its solo run bit for bit (``solos``:
    the images of phase_serve and phase_serve_durable); each sub-run
    launches its kernels (and no plain version)."""
    import shutil
    import threading
    import urllib.request
    import torch
    from repro_torch import kernels, obs
    from repro_torch.checkpoint import PreemptionGuard
    from repro_torch.core.geometry import ConeGeometry
    from repro_torch.core.splitting import MemoryModel
    from repro_torch.data import make_ct_dataset
    from repro_torch.launch import recon
    from repro_torch.launch.mesh import make_pod_mesh, pod_device_groups
    from repro_torch.launch.recon import _job_params, reconstruct
    from repro_torch.serve import (Autoscaler, AutoscalePolicy,
                                   MultiPodDriver, MultiPodScheduler, Pod,
                                   PodSpec, ReconJob,
                                   estimate_job_footprint, migrate_once)
    from repro_torch.serve.steal import fleet_units
    t_phase = time.perf_counter()
    n_s = n // 2
    t0 = time.perf_counter()
    ds_s = make_ct_dataset(ConeGeometry.nice(n_s), n_s, device="cuda")
    data = {n: ds, n_s: ds_s}
    log(f"== fleet: pods on cuda:0, a CUDA stream per slot; N={n_s} data "
        f"set {time.perf_counter() - t0:.1f} s; card: {smi}")
    out_dir = os.path.join(ROOT, "chiprun_out", "fleet")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    totals = {k: {"launches": 0, "plain_calls": 0}
              for k in ("fp_ray", "bp_matched", "bp_voxel", "tv_grad")}

    def job(alg, size, iters, **kw):
        _, angles, proj = data[size]
        return ReconJob(alg, ConeGeometry.nice(size), angles, proj,
                        n_iter=iters, params=_job_params(alg, len(angles)),
                        **kw)

    def solo(alg, size, iters):
        key = (alg, size, iters)
        if key not in solos:
            res = reconstruct(alg, n=size, n_angles=len(data[size][1]),
                              iters=iters, mode="plain", device="cuda",
                              dataset=data[size], verbose=False)
            solos[key] = res.rec.cpu().numpy()
        return solos[key]

    def sub_run(path: str, what: str):
        """Counters and the peak set to 0 before a sub-run; returns a
        closure that checks and adds them after it."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_counters()

        def done():
            counts = kernels.counters()
            log(f"    counters {counts}")
            check_counts(counts, path, what)
            for k in totals:
                totals[k]["launches"] += counts[k]["launches"]
            return base
        return done

    tracer = obs.Tracer(enabled=True)
    prev = obs.set_tracer(tracer)
    try:
        # ---- 1. work stealing: four jobs pinned to pod0 -------------------
        plan = [("cgls512", "cgls", n, 3), ("ossart512", "ossart", n, 2),
                ("asd256", "asd_pocs", n_s, 2), ("cgls256", "cgls", n_s, 6)]
        fps = {name: estimate_job_footprint(job(alg, size, it, mode="plain"),
                                            MemoryModel()).bytes_on_device
               for name, alg, size, it in plan}
        # one N=512 job resident a pod at a time: the rest park behind it
        usable = max(fps.values()) + min(fps.values()) // 2
        mem = MemoryModel(device_bytes=int(usable / 0.95) + 1)
        log(f"-- steal: {', '.join(f'{k} {v} B' for k, v in fps.items())}; "
            f"two pods of {mem.device_bytes / 2**30:.3f} GiB, all four "
            "pinned to pod0")
        xfer = os.path.join(out_dir, "steal_xfer")
        pods = [Pod(PodSpec(f"pod{i}", memory=mem)) for i in range(2)]
        mps = MultiPodScheduler(pods, transfer_dir=xfer)
        hand = Handoffs(pods, xfer)
        peak = track_reserved(pods)
        done = sub_run("serve", "the stealing fleet")
        ids = {name: mps.submit(job(alg, size, it, mode="plain"), pod=0)
               for name, alg, size, it in plan}
        t0 = time.perf_counter()
        MultiPodDriver(mps).run(timeout=600)
        wall = time.perf_counter() - t0
        check_fleet_done(mps, ids.values(), "stealing fleet")
        base = done()
        stolen = [k for k, j in ids.items() if mps.owner(j).name == "pod1"]
        log(f"  {wall:.2f} s; stolen onto pod1: {stolen} (steal passes "
            f"moved {mps.stolen_jobs})")
        if not stolen:
            raise AssertionError("no job was stolen onto pod1")
        hand.report()
        pod_report(pods, tracer, peak, base)
        for name, alg, size, it in plan:
            steps = [round(t, 3) for t in step_seconds(tracer, ids[name])]
            check_bits(f"{name} on {mps.owner(ids[name]).name} (s/step "
                       f"{steps})", mps.result(ids[name]),
                       solo(alg, size, it))
        del mps, pods

        # ---- 2. live migration of a running CGLS N=512 --------------------
        log("-- migrate: CGLS N=512 running on pod0 (an OS-SART N=512 "
            "parked behind it) moves to pod1 after its first step")
        xfer = os.path.join(out_dir, "migrate_xfer")
        pods = [Pod(PodSpec(f"pod{i}", memory=mem)) for i in range(2)]
        mps = MultiPodScheduler(pods, steal=False, transfer_dir=xfer)
        hand = Handoffs(pods, xfer)
        peak = track_reserved(pods)
        done = sub_run("fleet_migrate", "the migrating fleet")
        mig = mps.submit(job("cgls", n, 3, mode="plain"), pod=0)
        parked = mps.submit(job("ossart", n, 2, mode="plain"), pod=0)
        pods[0].scheduler.step_quantum()       # admit, one iteration
        if mps.record(mig).iterations_done != 1:
            raise AssertionError("the CGLS job did not take one step")
        t0 = time.perf_counter()
        moved = migrate_once(pods[0], pods[1], xfer,
                             units=fleet_units(pods))
        t_mig = time.perf_counter() - t0
        if moved != mig:
            raise AssertionError(f"migrate_once moved {moved}, not {mig}")
        streams = [p.pool.slots[0].stream for p in pods]
        if not all(s.query() for s in streams):
            raise AssertionError("a slot's stream is busy after migrating")
        MultiPodDriver(mps).run(timeout=600)
        check_fleet_done(mps, [mig, parked], "migrating fleet")
        base = done()
        (_, _, nbytes, t_out), (_, _, t_in) = hand.exports[0], \
            hand.imports[0]
        reinit = [e.attrs["measured_s"]
                  for e in tracer.events("admit", job=mig)
                  if e.attrs.get("pod") == "pod1"]
        log(f"  migrated {mig} at iteration 1 in {t_mig:.3f} s: export "
            f"{nbytes} B in {t_out:.3f} s ({nbytes / t_out / 1e9:.3f} "
            f"GB/s), import {t_in:.3f} s ({nbytes / t_in / 1e9:.3f} GB/s), "
            f"re-init on pod1 {reinit[0]:.3f} s; both slots' streams idle "
            "after it")
        pod_report(pods, tracer, peak, base)
        steps = [(e.attrs["pod"], round(e.attrs["measured_s"], 3))
                 for e in tracer.events("step", job=mig)]
        check_bits(f"migrated CGLS N={n} (s/step by pod {steps})",
                   mps.result(mig), solo("cgls", n, 3))
        check_bits(f"OS-SART N={n} behind it", mps.result(parked),
                   solo("ossart", n, 2))
        del mps, pods

        # ---- 3. autoscaling: scale up under backlog, drain to scale down --
        mem_s = MemoryModel(device_bytes=int(
            estimate_job_footprint(job("cgls", n_s, 6, mode="plain"),
                                   MemoryModel()).bytes_on_device
            * 1.5 / 0.95) + 1)                 # one N=256 CGLS at a time
        log(f"-- autoscale: one seed pod of {mem_s.device_bytes / 2**20:.0f}"
            f" MiB, four CGLS N={n_s} (6 iterations), a template pod of the "
            "same budget")
        xfer = os.path.join(out_dir, "autoscale_xfer")
        mps = MultiPodScheduler([Pod(PodSpec("seed", memory=mem_s))],
                                transfer_dir=xfer)
        load = {"v": 10.0}
        asc = Autoscaler(
            mps, [PodSpec("burst", memory=mem_s)],
            AutoscalePolicy(scale_up_backlog_seconds=0.5,
                            scale_down_backlog_seconds=0.05,
                            down_window_seconds=0.0, cooldown_seconds=0.0,
                            min_pods=1, max_pods=2, prewarm=True),
            load_fn=lambda pods: load["v"])
        done = sub_run("cgls", "the autoscaled fleet")
        jids = [mps.submit(job("cgls", n_s, 6, mode="plain"))
                for _ in range(4)]
        drv = MultiPodDriver(mps, autoscaler=asc)
        t0 = time.monotonic()
        drv.start()
        try:
            deadline = time.monotonic() + 300
            while not any(p.name != "seed" and p.scheduler.metrics.steps
                          for p in mps.pods_snapshot()):
                if (drv.error is not None or mps.idle
                        or time.monotonic() > deadline):
                    raise AssertionError(
                        f"the scaled-up pod stepped no job: {drv.error}")
                time.sleep(0.001)
            t_step = time.monotonic() - t0
            attached = sorted(d.scheduler.name for d in drv.drivers)
        finally:
            drv.stop()
        if drv.error is not None:
            raise AssertionError(f"fleet driver: {drv.error!r}")
        up = [e for e in asc.events if e.direction == "up"]
        burst = next(p for p in mps.pods if p.name == up[0].pod)
        log(f"  scale-up to {up[0].pod} at load {up[0].load} decided "
            f"{up[0].t - t0:.3f} s after the driver started; drivers "
            f"{attached}; its first step done {t_step:.3f} s in "
            f"({burst.scheduler.metrics.steps} steps at the stop)")
        load["v"] = 0.0                        # the backlog clears
        t0 = time.perf_counter()
        ev = asc.step()
        if ev is None or ev.direction != "down" or not asc.drained_jobs:
            raise AssertionError(f"no drain moved a parked job: {ev}, "
                                 f"{asc.drained_jobs}")
        log(f"  scale-down: drained {ev.pod} in "
            f"{time.perf_counter() - t0:.3f} s, moved "
            f"{asc.drained_jobs} to {[p.name for p in mps.pods]}")
        MultiPodDriver(mps).run(timeout=600)
        check_fleet_done(mps, jids, "autoscaled fleet")
        done()
        log("  scale events: "
            f"{[(e.direction, e.pod, e.n_pods) for e in asc.events]}")
        want = solo("cgls", n_s, 6)
        for j in jids:
            check_bits(f"{j} (ran on {mps.owner(j).name})", mps.result(j),
                       want)
        del mps, asc, drv

        # ---- 4. a durable fleet: the guard, drain_fleet, restore_fleet ----
        root = os.path.join(out_dir, "fleet_snapshot")
        mesh = make_pod_mesh(2, devices=["cuda:0"] * 2)
        guard = PreemptionGuard(install_handler=False)
        pods = [Pod(PodSpec(f"pod{i}", memory=mem_s, devices=tuple(g)),
                    guard=guard)
                for i, g in enumerate(pod_device_groups(mesh))]
        mps = MultiPodScheduler(pods, steal=False, snapshot_root=root)
        done = sub_run("cgls", "the durable fleet")
        jids = [mps.submit(job("cgls", n_s, 6, mode="plain"))
                for _ in range(2)]

        def trigger():
            while max(mps.record(j).iterations_done for j in jids) < 1:
                time.sleep(0.001)
            guard.trigger()
        killer = threading.Thread(target=trigger, daemon=True)
        killer.start()
        MultiPodDriver(mps).run(timeout=600)
        killer.join(timeout=60)
        progress = {j: mps.record(j).iterations_done for j in jids}
        if not all(mps.record(j).status.value == "preempted"
                   for j in jids):
            raise AssertionError(
                "the guard did not park the fleet: "
                + str({j: mps.record(j).status.value for j in jids}))
        nbytes = dir_bytes(root)
        t0 = time.perf_counter()
        restored = MultiPodScheduler.restore_fleet(root, mesh=mesh)
        t_restore = time.perf_counter() - t0
        devs = {str(s.device) for p in restored.pods for s in p.pool.slots}
        if sorted(restored.restored_jobs) != sorted(jids) or \
                devs != {"cuda:0"}:
            raise AssertionError(f"restore_fleet: {restored.restored_jobs} "
                                 f"on {devs}")
        log(f"  parked at iterations {sorted(progress.values())}; fleet "
            f"snapshot {nbytes} B; restore_fleet onto the pod mesh "
            f"{t_restore:.3f} s (pins {sorted(devs)})")
        MultiPodDriver(restored).run(timeout=600)
        check_fleet_done(restored, jids, "restored fleet")
        done()
        for j in jids:
            check_bits(f"restored {j} (parked at {progress[j]})",
                       restored.result(j), want)
        del mps, restored, pods

        # ---- 5. recon.main --pods 2 with the exporters --------------------
        del ds_s, data
        torch.cuda.empty_cache()
        snap = os.path.join(out_dir, "recon_snapshot")
        prom = os.path.join(out_dir, "recon.prom")
        # one scrape of the live endpoint while recon runs: sent as the
        # server starts, and the server's stop waits for its answer
        scrapes, scrapers = [], []
        start, stop = obs.MetricsServer.start, obs.MetricsServer.stop

        def start_and_scrape(self):
            port = start(self)

            def scrape():
                try:
                    with urllib.request.urlopen(self.url, timeout=60) as r:
                        scrapes.append((r.status, r.read().decode()))
                except Exception as e:
                    scrapes.append((None, repr(e)))
            scrapers.append(threading.Thread(target=scrape, daemon=True))
            scrapers[-1].start()
            return port

        def join_and_stop(self):
            for t in scrapers:
                t.join(timeout=60)
            stop(self)
        obs.MetricsServer.start = start_and_scrape
        obs.MetricsServer.stop = join_and_stop
        obs.set_tracer(obs.Tracer())
        done = sub_run("cgls", "recon.main --pods 2")
        t0 = time.perf_counter()
        try:
            _, rel = recon.main(["--alg", "cgls", "--n", str(n), "--angles",
                                 str(n), "--iters", "2", "--pods", "2",
                                 "--snapshot-dir", snap, "--prometheus",
                                 prom, "--calibration-report",
                                 "--metrics-port", "0"])
        finally:
            obs.MetricsServer.start, obs.MetricsServer.stop = start, stop
            obs.set_tracer(tracer)
        done()
        with open(prom) as f:
            text = f.read()
        families = ("repro_calibration_samples_total",
                    "repro_slo_attainment_ratio",
                    "repro_memory_margin_ratio")
        missing = [f for f in families if f"# TYPE {f}" not in text]
        if missing or len(scrapes) != 1 or scrapes[0][0] != 200 or \
                "repro_slo_attainment_ratio" not in scrapes[0][1]:
            raise AssertionError(f"exporters: missing {missing}, scrapes "
                                 f"{[(c, t[:80]) for c, t in scrapes]}")
        if rel != rel_single:
            raise AssertionError(f"recon --pods 2 rel_err {rel!r} against "
                                 f"the single pod's {rel_single!r}")
        log(f"  recon.main --pods 2: rel_err {rel:.6f} equal to the single "
            f"pod's; {time.perf_counter() - t0:.1f} s with the data set; "
            f"one live scrape ({len(scrapes[0][1])} B), the Prometheus file "
            f"{len(text)} B with the calibration, SLO and memory-margin "
            "families")
    finally:
        obs.set_tracer(prev)
        for name in os.listdir(out_dir):
            if name != "recon.prom":
                shutil.rmtree(os.path.join(out_dir, name),
                              ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"  phase_fleet took {time.perf_counter() - t_phase:.1f} s; "
        f"launches {({k: v['launches'] for k, v in totals.items()})}")
    return totals


# --------------------------------------------------------------------------
# the LM serving path (gemma2-9b)
# --------------------------------------------------------------------------

def phase_flash_checks():
    """flash_attention against its plain version on the card: S 1000 (no
    tile divides it), head dims 64, 80, 128 and 256, Hq/Hkv 1, 2 and 8, at
    D 128 also llama-3.2-vision's 32/8 (a group of 4), and at zamba2's
    D 112 its 32/32 and 32/8, causal and not,
    windows 64 and 4096, soft-cap none and 50, float32 and bfloat16; repeat
    launches bit-identical.  At D 256, Hq/Hkv 8 in bfloat16, the plain
    version with the window, the causal mask or the cap dropped must fall
    outside the band."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain)
    s = 1000
    heads = ((4, 4), (8, 4), (16, 2))
    cases = [(d, hq, hkv) for d in FLASH_DIMS for hq, hkv in heads]
    cases += [(128, 32, 8), (112, 32, 32), (112, 32, 8)]
    masks = ((True, None, None), (False, None, None), (True, 64, 50.0),
             (False, 64, None), (True, 4096, 50.0), (False, 4096, 50.0))
    log(f"== flash_attention checks at S={s}, D 64/80/128/256, Hq/Hkv 1/2/8 "
        f"(and 32/8 at D 128, 32/32 and 32/8 at D 112), {len(masks)} mask "
        "and cap settings, float32 and bfloat16")
    from repro_torch import kernels
    gen = torch.Generator(device="cuda").manual_seed(4)
    worst = {}
    kernels.reset_counters()
    for dtype in (torch.float32, torch.bfloat16):
        rtol, atol = FLASH_TOL[str(dtype).split(".")[1]]
        for d, hq, hkv in cases:
            q, k, v = ((torch.randn((2, h, s, d), generator=gen,
                                    device="cuda") * c).to(dtype)
                       for h, c in ((hq, FLASH_Q_SCALE), (hkv, 1.0),
                                    (hkv, 1.0)))
            for causal, window, cap in masks:
                got = flash_attention_cuda(q, k, v, causal, window, cap)
                want = flash_attention_plain(q, k, v, causal, window, cap)
                err = (got.float() - want.float()).abs()
                tag = (f"{dtype} D={d} Hq/Hkv={hq}/{hkv} causal={causal} "
                       f"window={window} softcap={cap}")
                n_bad = outside_band(got, want, rtol, atol)
                if n_bad:
                    raise AssertionError(
                        f"flash_attention {tag}: {n_bad} elements "
                        f"outside rtol={rtol} atol={atol} (max |err| "
                        f"{float(err.max()):.3g})")
                if dtype == torch.bfloat16 and d == 256 and hq == 16:
                    for what, wrong in _dropped(causal, window, cap, s):
                        check_separates(
                            f"flash_attention {tag}", want,
                            flash_attention_plain(q, k, v, *wrong),
                            rtol, atol, what)
                if not torch.equal(got, flash_attention_cuda(
                        q, k, v, causal, window, cap)):
                    raise AssertionError(f"flash_attention {tag}: repeat "
                                         "launch differs")
                worst[dtype] = max(worst.get(dtype, 0.0), float(err.max()))
                if hq == 32:
                    tag = f"{dtype} D {d} Hq/Hkv 32/{hkv}"
                    worst[tag] = max(worst.get(tag, 0.0), float(err.max()))
    torch.cuda.synchronize()
    n_cases = len(cases) * len(masks)
    paths = flash_paths()
    if paths != {"wgmma": 2 * n_cases, "simt": 2 * n_cases}:
        raise AssertionError(f"flash_attention paths {paths}: bfloat16 must "
                             "launch the tensor-core kernel, float32 the SIMT "
                             "one")
    log(f"  {2 * n_cases} cases within band; max |err| "
        + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
        + f"; repeat launches bit-identical; launches by path {paths}")
    phase_flash_backward_checks()


def _grad_band(want, dtype) -> tuple:
    """(rtol, atol) of the gradient band (FLASH_GRAD_TOL) around ``want``:
    in bfloat16 the atol is a share of the leaf's max |g|."""
    import torch
    rtol, atol = FLASH_GRAD_TOL[str(dtype).split(".")[1]]
    if dtype == torch.bfloat16:
        atol *= float(want.float().abs().max())
    return rtol, atol


def _plain_grads(q, k, v, d_out, causal, window, softcap):
    """dq, dk, dv of autograd of the plain version (the oracle)."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention_plain
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out = flash_attention_plain(*leaves, causal, window, softcap)
    return torch.autograd.grad(out, leaves, d_out)


def _kernel_grads(q, k, v, d_out, causal, window, softcap, repeat=False):
    """(out, (dq, dk, dv)) of flash_attention_cuda with gradients on (its
    autograd Function: the forward with lse, the backward kernels); with
    ``repeat`` the backward runs twice on one graph and must give the same
    bits."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out = flash_attention_cuda(*leaves, causal, window, softcap)
    grads = torch.autograd.grad(out, leaves, d_out, retain_graph=repeat)
    if repeat:
        again = torch.autograd.grad(out, leaves, d_out)
        if not all(torch.equal(a, b) for a, b in zip(grads, again)):
            raise AssertionError("flash_attention backward: repeat launch "
                                 "differs")
    return out.detach(), grads


def phase_flash_backward_checks():
    """The backward kernels (csrc/flash_attention_bwd.cu, through
    flash_attention_cuda's autograd Function) against autograd of the
    plain version on the card: every head dim of HEAD_DIMS, S 1000 and 77
    (77: under two tiles), Hq/Hkv 1, 2 and 4, causal and not, window 64,
    cap none and 50, float32 and bfloat16, at FLASH_GRAD_TOL; every
    bfloat16 backward on the tensor-core kernels (bwd_wgmma_launches) and
    every float32 one on the SIMT kernels; repeat backward launches
    bit-identical, and no atomic operation in the backward's source; the
    forward's out with lse asked for bit-equal to the out without, its lse
    against torch.logsumexp of the plain scores and its float32 out
    against the plain one.  At D 256, GQA 2, bfloat16, the plain version's
    gradients with the window, the causal mask or the cap dropped must
    fall outside the band.  Then the same checks at the train shapes of
    FLASH_BWD_TRAIN_SHAPES (``_flash_backward_train_shapes``)."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import (HEAD_DIMS,
                                                     flash_attention_cuda)
    heads = ((4, 4), (4, 2), (8, 2))
    masks = ((True, None, None), (False, None, None), (True, 64, 50.0),
             (False, 64, None))
    lengths = (1000, 77)
    dims = "/".join(map(str, HEAD_DIMS))
    log(f"== flash_attention backward checks: D {dims}"
        f", S {'/'.join(map(str, lengths))}, Hq/Hkv 1/2/4, {len(masks)} "
        f"mask and cap settings, float32 and bfloat16 (bands {FLASH_GRAD_TOL}"
        "; bf16 atol of the leaf's max |g|)")
    src = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc",
                       "flash_attention_bwd.cu")
    with open(src) as f:
        if "atomic" in f.read():
            raise AssertionError(f"{src} names an atomic operation")
    gen = torch.Generator(device="cuda").manual_seed(6)
    worst = {}
    n_cases = 0
    n_bf16 = 0
    kernels.reset_counters()
    t0 = time.perf_counter()
    for dtype in (torch.float32, torch.bfloat16):
        for d in HEAD_DIMS:
            for s in lengths:
                for hq, hkv in heads:
                    q, k, v, d_out = (
                        (torch.randn((2, h, s, d), generator=gen,
                                     device="cuda") * c).to(dtype)
                        for h, c in ((hq, FLASH_Q_SCALE), (hkv, 1.0),
                                     (hkv, 1.0), (hq, 1.0)))
                    for causal, window, cap in masks:
                        tag = (f"{dtype} D={d} S={s} Hq/Hkv={hq}/{hkv} "
                               f"causal={causal} window={window} "
                               f"softcap={cap}")
                        out, got = _kernel_grads(q, k, v, d_out, causal,
                                                 window, cap,
                                                 repeat=s == lengths[-1])
                        want = _plain_grads(q, k, v, d_out, causal, window,
                                            cap)
                        checks = [((str(dtype).split(".")[1], name), a, b,
                                   _grad_band(b, dtype))
                                  for name, a, b in zip(("dq", "dk", "dv"),
                                                        got, want)]
                        n_cases += 1
                        n_bf16 += (1 + (s == lengths[-1])) * (
                            dtype == torch.bfloat16)
                        if s == lengths[-1]:
                            checks += _forward_lse_checks(
                                q, k, v, out, causal, window, cap, tag)
                        for key, a, b, band in checks:
                            n_bad = outside_band(a, b, *band)
                            err = float((a.float() - b.float()).abs().max())
                            if n_bad or not bool(torch.isfinite(a).all()):
                                raise AssertionError(
                                    f"flash_attention {tag}: {key} {n_bad} of "
                                    f"{a.numel()} outside rtol, atol {band} "
                                    f"(max |err| {err:.3g})")
                            worst[key] = max(worst.get(key, 0.0), err)
                        if s == lengths[-1] and d == 256 and \
                                dtype == torch.bfloat16 and (hq, hkv) == (4, 2):
                            _backward_separates(q, k, v, d_out, want,
                                                causal, window, cap, s, tag)
    torch.cuda.synchronize()
    bwd = flash_attention_cuda.bwd_launches
    bwd_wgmma = flash_attention_cuda.bwd_wgmma_launches
    expect = n_cases + n_cases // len(lengths)   # the repeats at S 77
    if (bwd, bwd_wgmma) != (expect, n_bf16):
        raise AssertionError(f"flash_attention backward launches {bwd}, "
                             f"{bwd_wgmma} on the tensor cores; expected "
                             f"{expect}, {n_bf16} (every bfloat16 one)")
    log(f"  {n_cases} cases within band in {time.perf_counter() - t0:.1f} s; "
        "max |err| " + ", ".join(
            f"{'/'.join(k) if isinstance(k, tuple) else k} {v:.3g}"
            for k, v in worst.items())
        + f"; repeat backward launches bit-identical ({bwd} backward "
        f"launches, the {bwd_wgmma} bfloat16 ones on the tensor cores); out "
        "with lse bit-equal to out without")
    _flash_backward_train_shapes(gen)


#: the backward's train shapes that its cases above do not reach: (B, Hq,
#: Hkv, S, D) of one shard of llama-3.2-vision-11b and of zamba2-7b's
#: shared block on the (data 2, model 2) mesh (batch 4 x 4096 split over
#: the data axis, their 32 / 8 and 32 / 32 heads over the model axis;
#: causal, no window or cap)
FLASH_BWD_TRAIN_SHAPES = {"llama-3.2-vision-11b shard": (2, 16, 4, 4096,
                                                         128),
                          "zamba2-7b shard": (2, 16, 16, 4096, 112)}


def _flash_backward_train_shapes(gen) -> None:
    """The forward with lse and the backward kernels at each of
    FLASH_BWD_TRAIN_SHAPES, bfloat16, causal: dq, dk, dv against autograd
    of the plain version at FLASH_GRAD_TOL, the out with lse bit-equal to
    the out without, lse and the float32 out against the plain ones, and
    the backward launched once, on the tensor cores."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    dtype = torch.bfloat16
    for what, (b, hq, hkv, s, d) in FLASH_BWD_TRAIN_SHAPES.items():
        q, k, v, d_out = (
            (torch.randn((b, h, s, d), generator=gen, device="cuda")
             * c).to(dtype)
            for h, c in ((hq, FLASH_Q_SCALE), (hkv, 1.0), (hkv, 1.0),
                         (hq, 1.0)))
        tag = (f"{what} (B {b}, Hq/Hkv {hq}/{hkv}, S {s}, D {d}) bfloat16 "
               "causal")
        kernels.reset_counters()
        out, got = _kernel_grads(q, k, v, d_out, True, None, None)
        torch.cuda.synchronize()
        launches = (flash_attention_cuda.bwd_launches,
                    flash_attention_cuda.bwd_wgmma_launches)
        if launches != (1, 1):
            raise AssertionError(f"flash_attention {tag}: backward launches "
                                 f"{launches}, expected one, on the tensor "
                                 "cores")
        want = _plain_grads(q, k, v, d_out, True, None, None)
        checks = [(name, a, w, _grad_band(w, dtype))
                  for name, a, w in zip(("dq", "dk", "dv"), got, want)]
        del want
        checks += _forward_lse_checks(q, k, v, out, True, None, None, tag)
        errs = {}
        for key, a, w, band in checks:
            n_bad = outside_band(a, w, *band)
            errs[key] = float((a.float() - w.float()).abs().max())
            if n_bad or not bool(torch.isfinite(a).all()):
                raise AssertionError(
                    f"flash_attention {tag}: {key} {n_bad} of {a.numel()} "
                    f"outside rtol, atol {band} (max |err| {errs[key]:.3g})")
        log(f"  {tag}: dq, dk, dv within band, out with lse bit-equal to "
            "out without, lse and the float32 out within theirs; max |err| "
            + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
            + "; the backward on the tensor cores")
        del q, k, v, d_out, out, got, checks
        torch.cuda.empty_cache()


def _forward_lse_checks(q, k, v, out, causal, window, softcap, tag):
    """The forward with its row statistics: its out, and the out of the
    autograd Function (``out``), bit-equal to the out without them; the
    (key, got, want, band) checks of its lse against torch.logsumexp of
    the plain scores and of its float32 out against the plain one."""
    import torch
    from repro_torch.kernels.flash_attention import (
        _launch_fwd, flash_attention_cuda, flash_attention_plain_lse)
    with torch.no_grad():
        plain = flash_attention_cuda(q, k, v, causal, window, softcap)
        o2, lse, o32 = _launch_fwd(q, k, v, causal, window, softcap, True)
        _, lse_want, o32_want = flash_attention_plain_lse(
            q, k, v, causal, window, softcap)
    if not (torch.equal(o2, plain) and torch.equal(out, plain)):
        raise AssertionError(f"flash_attention {tag}: out with lse differs "
                             "from out without")
    return [("lse", lse, lse_want, (LSE_RTOL, LSE_ATOL)),
            ("out_f32", o32, o32_want, FLASH_TOL["float32"])]


def _backward_separates(q, k, v, d_out, want, causal, window, softcap, s,
                        tag) -> None:
    """The gradient band around ``want`` excludes the plain version's
    gradients with the window, the causal mask or the cap dropped: a
    backward kernel that dropped one would fail its check."""
    for what, wrong in _dropped(causal, window, softcap, s):
        bad = sum(outside_band(w, g, *_grad_band(g, q.dtype)) for w, g in
                  zip(_plain_grads(q, k, v, d_out, *wrong), want))
        log(f"  flash_attention backward {tag}: the plain version with {what}"
            f" puts {bad} gradient entries outside the band")
        if bad == 0:
            raise AssertionError(f"flash_attention backward {tag}: the band "
                                 f"does not tell {what} apart")


def _dropped(causal, window, softcap, s):
    """(what, arguments) of the plain version with one of the masks or the
    cap dropped, for each that changes the function at length ``s``."""
    out = []
    if window is not None and window < s:
        out.append(("the window dropped", (causal, None, softcap)))
    if causal:
        out.append(("the causal mask dropped", (False, window, softcap)))
    if softcap is not None:
        out.append(("the soft-cap dropped", (causal, window, None)))
    return out


def _lm_tokens(seed: int, batch: int, seq: int, vocab: int):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, vocab, (batch, seq)).astype(
        np.int32)).cuda()


def _lm_inputs(cfg, seed: int, batch: int, seq: int):
    """Seeded token ids, or seeded frame embeddings (an audio model's
    stub frontend, N(0, 1) in the model's type), on the card."""
    import torch
    if cfg.family == "audio":
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return torch.randn((batch, seq, cfg.d_model), generator=gen,
                           device="cuda").to(cfg.dtype)
    return _lm_tokens(seed, batch, seq, cfg.vocab)


def _lm_ctx(cfg, seed: int, batch: int):
    """A VLM's image context (the stub vision tower's patch embeddings):
    seeded N(0, 1) of (batch, n_ctx_tokens, d_model) in the model's type
    on the card; None for a model without cross-attention."""
    import torch
    if "xattn" not in cfg.layer_kinds:
        return None
    gen = torch.Generator(device="cuda").manual_seed(seed + 1000)
    return torch.randn((batch, cfg.n_ctx_tokens, cfg.d_model), generator=gen,
                       device="cuda").to(cfg.dtype)


#: the cross-attention gates' value in the LM runs: the reference
#: zero-initialises them, and tanh(0) = 0 would multiply every
#: cross-attention layer away
XATTN_GATE = 0.5


def phase_lm_build(name: str, seed: int, smi):
    """Config ``name`` at full width and depth, bf16, weights drawn on the
    card from ``seed``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM
    cfg = get_config(name)
    log(f"== {name} ({cfg.family}; card: {smi}): {cfg.n_layers} layers "
        f"{sorted(set(cfg.layer_kinds))}, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv} heads of {cfg.hd}, d_ff {cfg.d_ff}"
        + (f", {cfg.n_experts} experts top-{cfg.top_k} of {cfg.d_expert} "
           f"(+{cfg.n_shared} shared)" if cfg.n_experts else "")
        + (f", MLA q_lora {cfg.q_lora_rank} kv_lora {cfg.kv_lora_rank} "
           f"nope/rope/v {cfg.qk_nope_dim}/{cfg.qk_rope_dim}/"
           f"{cfg.v_head_dim}" if "mla" in cfg.layer_kinds else "")
        + (f", {cfg.layer_kinds.count('xattn')} cross-attention layers over "
           f"{cfg.n_ctx_tokens} patch embeddings"
           if "xattn" in cfg.layer_kinds else "")
        + (f", Mamba2 d_inner {cfg.mamba_cfg().d_inner} in "
           f"{cfg.mamba_cfg().n_heads} heads of {cfg.mamba_cfg().head_dim}, "
           f"state {cfg.mamba_cfg().d_state}, SSD chunk {cfg.ssd_chunk}; the "
           f"shared attention block called from "
           f"{cfg.layer_kinds.count('mamba_shared')} layers"
           if "mamba" in cfg.layer_kinds else "")
        + (f", {cfg.layer_kinds.count('mlstm')} mLSTM layers (d_inner "
           f"{cfg.xlstm_cfg().d_inner} in {cfg.n_heads} heads of "
           f"{cfg.xlstm_cfg().head_dim}) and {cfg.layer_kinds.count('slstm')} "
           f"sLSTM layers" if "mlstm" in cfg.layer_kinds else "")
        + f", vocab {cfg.vocab}, {cfg.dtype}")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    torch.cuda.reset_peak_memory_stats()
    ms, model = once_ms(lambda: LM(cfg, device="cuda", generator=gen))
    n = sum(p.numel() for p in model.parameters())
    gates = model.set_xattn_gates(XATTN_GATE)
    log(f"  {n / 1e9:.3f} B parameters, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card, drawn "
        f"in {ms / 1e3:.1f} s"
        + (f"; {gates} cross-attention gates set to {XATTN_GATE} (zero at "
           "init)" if gates else ""))
    return model


def phase_prefill(model, inputs, reps: int = 3, ctx=None):
    """The main path: build_prefill_step on B x S prompts (token ids, or
    an audio model's frame embeddings; a VLM's image context ``ctx``).  A
    warm-up forward (which also counts the MoE drops) and ``reps`` timed
    prefills, each ending in a sync, every one's logits the same bits;
    every GQA layer's and shared-block call's launch on the tensor-core
    kernel (MLA and cross-attention layers launch none), no plain call."""
    import torch
    from repro_torch import kernels
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models.lm import flash_layers
    cfg = model.cfg
    b, s = inputs.shape[:2]
    step = build_prefill_step(cfg, "prefill_32k", batch=b, seq=s,
                              model=model)
    want_spec = (tuple(inputs.shape), inputs.dtype if cfg.family == "audio"
                 else torch.int32)
    if step.in_specs["tokens"] != want_spec or step.in_specs.get("ctx") != (
            None if ctx is None else (tuple(ctx.shape), ctx.dtype)):
        raise AssertionError(f"input spec {step.in_specs} for {want_spec}")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counters()
    stats = {}
    with torch.inference_mode():
        warm_ms, hidden = once_ms(lambda: model(inputs, ctx,
                                                moe_stats=stats))
        first = model.logits(hidden[:, -1:])
        del hidden
    times = []
    for _ in range(reps):
        ms, logits = once_ms(lambda: step.fn(inputs, ctx))
        times.append(ms)
        if not torch.equal(logits, first):
            raise AssertionError(f"{cfg.name}: a repeat prefill differs")
    counts = kernels.counters()
    paths = flash_paths()
    med = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = flash_layers(cfg) * (reps + 1)
    if want:
        check_counts(counts, "prefill", f"{cfg.name} prefill")
    if counts["flash_attention"] != {"launches": want, "plain_calls": 0} or \
            paths != {"wgmma": want, "simt": 0}:
        raise AssertionError(f"{cfg.name}: {counts['flash_attention']}, by "
                             f"path {paths}; expected {want}, all on the "
                             "tensor-core path")
    if tuple(first.shape) != (b, 1, cfg.vocab) or not bool(
            torch.isfinite(first).all()):
        raise AssertionError(f"{cfg.name}: prefill logits "
                             f"{tuple(first.shape)}, finite "
                             f"{bool(torch.isfinite(first).all())}")
    drop = int(stats["dropped"]) / stats["assignments"] if stats else None
    log(f"  prefill {b} x {s} (prefill_32k cut to S {s}, batch {b}): wall ms "
        f"{[round(t, 1) for t in times]} (median {med:.1f}; warm-up forward "
        f"{warm_ms:.1f}), {b * s / med * 1e3:.0f} tokens/s, peak device "
        f"memory {peak:.2f} GiB; {reps + 1} prefills bit-identical, logits "
        f"finite; flash launches {want} ({want // (reps + 1)} a prefill) by "
        f"path {paths}"
        + ("" if drop is None else
           f"; MoE assignments dropped at capacity {int(stats['dropped'])} "
           f"of {stats['assignments']} ({100 * drop:.3f} %)"))
    return dict(prefill_ms=med, tokens_per_s=b * s / med * 1e3,
                peak_gib=peak, launches=want, drop_share=drop)


def _leaves(tree, prefix: str = ""):
    """(dotted name, leaf) of a layer's nested cache, or of its
    ``{name: (shape, dtype)}`` specs."""
    for name, val in tree.items():
        key = prefix + name
        if isinstance(val, dict):
            yield from _leaves(val, key + ".")
        else:
            yield key, val


def phase_decode(model, tokens, steps: int, slots: int, ctx=None):
    """build_serve_step on init_cache(B, slots): ``steps`` decode steps fed
    the prompts' first tokens at positions 0..steps-1 (a VLM's image
    context ``ctx`` at every step); no kernel and no plain version runs
    (decode attends in plain ops on the ring or latent cache)."""
    import torch
    from repro_torch import kernels
    from repro_torch.launch.steps import build_serve_step
    cfg = model.cfg
    b = tokens.shape[0]
    step = build_serve_step(cfg, "decode_32k", batch=b, seq=slots,
                            model=model)
    torch.cuda.reset_peak_memory_stats()
    caches = model.init_cache(b, slots)
    shapes = [c and {n: (tuple(t.shape), t.dtype) for n, t in _leaves(c)}
              for c in caches]
    if shapes != [c and dict(_leaves(c))
                  for c in step.in_specs["caches"]]:
        raise AssertionError("caches differ from the step's input specs")
    kernels.reset_counters()
    times = []
    for t in range(steps):
        ms, (logits, caches) = once_ms(
            lambda: step.fn(tokens[:, t:t + 1], t, caches, ctx))
        times.append(ms)
        if tuple(logits.shape) != (b, 1, cfg.vocab) or not bool(
                torch.isfinite(logits).all()):
            raise AssertionError(f"{cfg.name} step {t}: logits "
                                 f"{tuple(logits.shape)}")
    counts = kernels.counters()
    if any(c["launches"] or c["plain_calls"] for c in counts.values()):
        raise AssertionError(f"decode ran a kernel or plain version: {counts}")
    med = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() / 2**30
    cache_gib = sum(t.numel() * t.element_size() for c in caches if c
                    for _, t in _leaves(c)) / 2**30
    where = (f"on {slots} slots" if any(
        name.split(".")[-1] == "pos" for c in caches if c
        for name, _ in _leaves(c))
        else "on its O(1) recurrent state (no slots)")
    log(f"  decode: {steps} steps at batch {b} {where} (decode_32k "
        f"cut to batch {b}): median {med:.2f} ms a step (first "
        f"{times[0]:.2f}, last {times[-1]:.2f}), caches {cache_gib:.2f} GiB, "
        f"peak device memory {peak:.2f} GiB; logits finite; counters all 0")
    del caches
    torch.cuda.empty_cache()
    return dict(decode_ms=med, decode_peak_gib=peak, cache_gib=cache_gib)


def phase_lm_consistency(name: str, seed: int, layers: int = 4, n: int = 32,
                         at=(7, 15, 31), **overrides):
    """The reference's decode-equals-forward check (tests/test_models.py:74)
    at the config's full widths: ``layers`` layers (the MoE configs: the
    dense prelude and layers - 1 MoE layers; llama-vision: its 5-kind
    pattern once), float32, the ``overrides``, cross-attention gates at
    XATTN_GATE and a seeded image context.  Decoding n tokens one by one
    at batch 2 gives, at the positions ``at``, the logits that prefill of
    that prefix gives (through the kernel at each GQA layer; MLA's
    absorbed decode against its expanded prefill), within rtol 1e-3 /
    atol 1e-4.  At n <= 32 a pass holds at most 64 tokens, within the MoE
    capacity floor min(T, 64), so neither pass drops an assignment."""
    import dataclasses
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM, flash_layers
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("TF32 matmuls are on")
    cfg = dataclasses.replace(get_config(name), n_layers=layers,
                              dtype=torch.float32, **overrides)
    model = LM(cfg, device="cuda",
               generator=torch.Generator(device="cuda").manual_seed(seed))
    model.set_xattn_gates(XATTN_GATE)
    tokens = _lm_tokens(seed + 1, 2, n, cfg.vocab)
    ctx = _lm_ctx(cfg, seed, 2)
    worst = 0.0
    with torch.inference_mode():
        kernels.reset_counters()
        want = {p: model.prefill(tokens[:, :p + 1], ctx) for p in at}
        counts = kernels.counters()["flash_attention"]
        paths = flash_paths()
        caches = model.init_cache(2, n)
        for t in range(n):
            got, caches = model.decode_step(tokens[:, t:t + 1], t, caches,
                                            ctx)
            if t in want:
                err = (got - want[t]).abs()
                bad = err > LM_ATOL + LM_RTOL * want[t].abs()
                if bool(bad.any()):
                    raise AssertionError(
                        f"{name} position {t}: {int(bad.sum())} logits "
                        f"outside rtol={LM_RTOL} atol={LM_ATOL} (max |err| "
                        f"{float(err.max()):.3g})")
                worst = max(worst, float(err.max()))
    n_flash = flash_layers(cfg) * len(at)
    if counts != {"launches": n_flash, "plain_calls": 0} or \
            paths != {"wgmma": 0, "simt": n_flash}:
        raise AssertionError(f"{name}: prefills ran {counts}, by path {paths}")
    log(f"  {name} {list(cfg.layer_kinds)}{overrides or ''}, {n} tokens, "
        f"positions {list(at)}: max |err| {worst:.3g}; prefills {counts}, by "
        f"path {paths}")
    del model, caches, ctx
    torch.cuda.empty_cache()
    return worst


def _device_rows(prof):
    """(ms, launches, name) of each kernel in a torch.profiler window: the
    CUDA events' self time, summed (the operators that launch them are not
    counted again; a record_function range's span on the device, such as
    MLA_RANGE's or SSD_RANGE's, is no kernel and is left out)."""
    from torch.autograd import DeviceType
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or ev.key in RANGES or \
                getattr(ev, "is_user_annotation", False):
            continue
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = ev.self_cuda_time_total
        if t > 0:
            rows.append((t / 1e3, ev.count, ev.key))
    return rows


def _device_report(prof, wall_ms: float, what: str, top: int = 12) -> float:
    """Device time by kernel (``_device_rows``) and the device's busy and
    idle share of the window's wall time; returns the busy ms."""
    rows = _device_rows(prof)
    busy = sum(r[0] for r in rows)
    share = 100 * busy / wall_ms
    log(f"  {what}: wall {wall_ms:.1f} ms, device busy {busy:.1f} ms "
        f"({share:.1f} %), idle {100 - share:.1f} %; "
        f"{sum(r[1] for r in rows)} kernels")
    for ms, count, name in sorted(rows, reverse=True)[:top]:
        log(f"    {ms:9.2f} ms {100 * ms / busy:5.1f} % x{count:<5d} "
            f"{name[:110]}")
    return busy


def phase_lm_profile(model, inputs, slots: int, steps: int = 3, ctx=None,
                     top: int = 12):
    """torch.profiler over one prefill of ``inputs`` (with a VLM's
    ``ctx``) and ``steps`` decode steps on ``slots`` cache slots (after a
    warm-up of each): where the device time goes (the ``top`` kernels) and
    how much of the wall time the device idles."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    b, s = inputs.shape[:2]
    log(f"== profile: {model.cfg.name} prefill of {b} x {s} tokens and "
        f"{steps} decode steps from a {slots}-slot cache (torch.profiler, "
        "CPU + CUDA)")
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.inference_mode():
        model.prefill(inputs, ctx)
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            ms, _ = once_ms(lambda: model.prefill(inputs, ctx))
        _device_report(prof, ms, "prefill", top)
        caches = model.init_cache(b, slots)
        model.decode_step(inputs[:, :1], 0, caches, ctx)
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            ms, _ = once_ms(lambda: [
                model.decode_step(inputs[:, t:t + 1], t, caches, ctx)
                for t in range(1, steps + 1)])
        _device_report(prof, ms, f"{steps} decode steps", top)
    del caches
    torch.cuda.empty_cache()


def phase_ssd_share(model, inputs, prefill_ms: float):
    """A Mamba2 model's chunked SSD (``_ssd_chunked``: the float32 decays,
    the masked intra-chunk product, the chunk states and the inter-chunk
    loop) and its whole Mamba2 block, each timed alone (CUDA events,
    median of 3) on layer 0's prefill input; times the Mamba2 layer count,
    against the prefill's median wall time."""
    import torch
    from repro_torch.models import mamba2 as m2
    from repro_torch.models.lm import _apply_norm
    cfg = model.cfg
    mc = cfg.mamba_cfg()
    n_mamba = sum(k.startswith("mamba") for k in cfg.layer_kinds)
    p = model.layers[0]
    bsz, s = inputs.shape[:2]
    with torch.inference_mode():
        h = _apply_norm(p["ln1"], model._embed(inputs), cfg)
        mp = p["mamba"]
        x = m2._causal_conv(h @ mp["w_x"], mp["conv_x"], mp["conv_xb"])[0]
        B = m2._causal_conv(h @ mp["w_B"], mp["conv_B"], mp["conv_Bb"])[0]
        C = m2._causal_conv(h @ mp["w_C"], mp["conv_C"], mp["conv_Cb"])[0]
        dt = m2._softplus((h @ mp["w_dt"]).float() + mp["dt_bias"])
        a = -torch.exp(mp["a_log"])
        xh = x.reshape(bsz, s, mc.n_heads, mc.head_dim)
        B, C = B.float(), C.float()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ssd_ms = cuda_ms(lambda: m2._ssd_chunked(xh, dt, a, B, C, mc), reps=3)
        ssd_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
        block_ms = cuda_ms(lambda: m2.mamba2_fwd(mp, h, mc), reps=3)
    del h, x, B, C, dt, xh
    torch.cuda.empty_cache()
    log(f"  Mamba2 layer 0 at {bsz} x {s}: chunked SSD {ssd_ms:.2f} ms "
        f"(transient {ssd_gib:.2f} GiB), the whole block {block_ms:.2f} ms; "
        f"x {n_mamba} layers: SSD {n_mamba * ssd_ms:.1f} ms "
        f"({100 * n_mamba * ssd_ms / prefill_ms:.1f} % of the prefill's "
        f"{prefill_ms:.1f} ms), Mamba2 blocks {n_mamba * block_ms:.1f} ms "
        f"({100 * n_mamba * block_ms / prefill_ms:.1f} %)")
    return dict(ssd_ms=ssd_ms, mamba_block_ms=block_ms,
                ssd_share=n_mamba * ssd_ms / prefill_ms,
                mamba_share=n_mamba * block_ms / prefill_ms)


def phase_xlstm_share(model, inputs, prefill_ms: float):
    """An xLSTM model's layers timed alone (CUDA events around the call
    after a warm-up, median of 3 for the mLSTM, one call for the sLSTM:
    its host loop leaves the device idle between its launches, so this is
    its wall time too) on the prefill's input: mLSTM layer 0 and the first
    sLSTM layer, each block with its pre-norm; times their layer counts,
    against the prefill's median wall time."""
    import torch
    from repro_torch.models.lm import block_fwd
    cfg = model.cfg
    kinds = cfg.layer_kinds
    bsz, s = inputs.shape[:2]
    out = {}
    with torch.inference_mode():
        x = model._embed(inputs)
        for kind in ("mlstm", "slstm"):
            i = kinds.index(kind)
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            ms = cuda_ms(lambda: block_fwd(kind, model.layers[i], x, cfg),
                         reps=3 if kind == "mlstm" else 1)
            out[kind] = (ms, kinds.count(kind),
                         (torch.cuda.max_memory_allocated() - base) / 2**30)
    del x
    torch.cuda.empty_cache()
    log(f"  layers alone at {bsz} x {s}: " + "; ".join(
        f"{kind} {ms:.2f} ms (transient {gib:.2f} GiB) x {n} = "
        f"{n * ms:.1f} ms, {100 * n * ms / prefill_ms:.1f} % of the "
        f"prefill's {prefill_ms:.1f} ms" for kind, (ms, n, gib) in
        out.items()))
    return {f"{kind}_ms": ms for kind, (ms, _, _) in out.items()} | {
        f"{kind}_share": n * ms / prefill_ms
        for kind, (ms, n, _) in out.items()}


#: the configs of the zoo, run after gemma2-9b, one at a time: dense, MoE,
#: MLA (minicpm3), VLM (llama-vision), hybrid (zamba2) and xLSTM
ZOO = ("stablelm-1.6b", "codeqwen1.5-7b", "hubert-xlarge",
       "deepseek-moe-16b", "moonshot-v1-16b-a3b", "minicpm3-4b",
       "llama-3.2-vision-11b", "zamba2-7b", "xlstm-350m")
#: layers of each decoder's decode-vs-prefill check: 4, llama-vision's
#: whole 5-kind pattern (4 GQA layers and a cross-attention layer), and
#: zamba2's 3 prelude Mamba2 layers and one 6-layer repeat (5 Mamba2
#: layers and a mamba_shared call of the shared block)
ZOO_CHECK_LAYERS = {"llama-3.2-vision-11b": 5, "zamba2-7b": 9}
#: the check's other changes: zamba2's SSD in chunks of 8, so that the
#: prefixes of 8, 16 and 32 tokens run one, two and four chunks (at its
#: chunk of 256 every prefix would be one chunk, and the inter-chunk
#: recurrence would go unchecked)
ZOO_CHECK_OVERRIDES = {"zamba2-7b": dict(ssd_chunk=8)}
#: flash_attention timed at the first flash-launching layer of these
#: configs, under these tags on the kernels line: hubert's D 80
#: (non-causal), llama-vision's GQA 4 (Hq 32, Hkv 8) at D 128 and zamba2's
#: shared block (32 / 32 heads of D 112, causal) at its first call site
ZOO_FLASH_SHAPES = {"hubert-xlarge": "hubert_d80",
                    "llama-3.2-vision-11b": "llama_vision_gqa4_d128",
                    "zamba2-7b": "zamba2_d112"}
#: the prefill length of a config's profile where it is shorter than the
#: zoo's: xlstm-350m's 2 x 8192 prefill launches ~0.94 M kernels, whose
#: profiler bookkeeping took over four minutes of the card machine's host,
#: so its profile takes 2 x 512 tokens (~60 k kernels) and
#: phase_xlstm_share times its layers at the full shape
ZOO_PROFILE_SEQ = {"xlstm-350m": 512}
#: their cuts: prefill_32k at S 8192 (batch 2 of 32); decode_32k at batch 2
#: (of 128) on 8192 cache slots (of 32768: moonshot's 25.8 GB cache would
#: not fit beside its 50.7 GB of weights), 16 steps
ZOO_SEQ, ZOO_SLOTS, ZOO_STEPS = 8192, 8192, 16


def phase_lm_zoo(seed: int, smi, reps: int = 3):
    """The zoo's configs at full width and depth, bf16, weights seeded on
    the card (cross-attention gates at XATTN_GATE), one model resident at
    a time: prefill of 2 x 8192 tokens (hubert: seeded frame embeddings;
    llama-vision: a seeded image context of 1600 patch embeddings) through
    build_prefill_step, 16 decode steps of the decoders through
    build_serve_step, hubert's serve step refused; flash_attention timed
    at hubert's D 80 shape, llama-vision's GQA-4 D 128 shape and zamba2's
    D 112 shape; a profiled prefill and 3 decode steps of each MoE, MLA,
    VLM, hybrid and xLSTM config, and zamba2's SSD timed alone; then
    decode vs prefill at 4 layers of each decoder's widths (5 for
    llama-vision, 9 for zamba2; xlstm-350m's 4 are one pattern unit) in
    float32.  Returns (flash launches of the prefills,
    {tag: timing} of the flash shapes, the per-config numbers)."""
    import torch
    from repro_torch.launch.steps import build_serve_step
    t0 = time.perf_counter()
    log(f"== LM zoo: {', '.join(ZOO)}; cuts: prefill_32k at S {ZOO_SEQ} "
        f"and batch 2 (of 32768 x 32), decode_32k at batch 2 (of 128) on "
        f"{ZOO_SLOTS} cache slots (of 32768), {ZOO_STEPS} steps; profiles "
        f"at S {ZOO_PROFILE_SEQ} where shorter")
    results, shapes, launches = {}, {}, 0
    for name in ZOO:
        model = phase_lm_build(name, seed, smi)
        cfg = model.cfg
        inputs = _lm_inputs(cfg, seed + 1, 2, ZOO_SEQ)
        ctx = _lm_ctx(cfg, seed, 2)
        res = phase_prefill(model, inputs, reps, ctx=ctx)
        launches += res["launches"]
        if cfg.encoder_only:
            try:
                build_serve_step(cfg, batch=2, seq=ZOO_SLOTS, model=model)
            except ValueError as e:
                log(f"  decode: refused ({e})")
            else:
                raise AssertionError(f"{name}: an encoder got a serve step")
        else:
            res.update(phase_decode(model, inputs, ZOO_STEPS, ZOO_SLOTS,
                                    ctx=ctx))
        if name in ZOO_FLASH_SHAPES:
            layer = _first_flash_layer(cfg)
            q, k, v = _layer_qkv(model, inputs, layer)
            shapes[ZOO_FLASH_SHAPES[name]] = _flash_case(
                f"flash_attention {name} layer {layer}", q, k, v,
                cfg.attn_cfg(cfg.layer_kinds[layer]))
            del q, k, v
        if cfg.family in ("moe", "vlm", "hybrid", "ssm") or \
                "mla" in cfg.layer_kinds:
            phase_lm_profile(model, inputs[:, :ZOO_PROFILE_SEQ.get(
                name, ZOO_SEQ)], ZOO_SLOTS, ctx=ctx,
                top=20 if cfg.family in ("hybrid", "ssm") else 12)
        if "mamba" in cfg.layer_kinds:
            res.update(phase_ssd_share(model, inputs, res["prefill_ms"]))
        if "mlstm" in cfg.layer_kinds:
            res.update(phase_xlstm_share(model, inputs, res["prefill_ms"]))
        results[name] = res
        del model, inputs, ctx
        torch.cuda.empty_cache()
    log(f"== decode vs prefill at full widths, 4 layers (llama-vision 5, "
        f"zamba2 9 with SSD chunks of 8), float32 (rtol {LM_RTOL}, atol "
        f"{LM_ATOL})")
    for name in ZOO:
        if name != "hubert-xlarge":
            results[name]["consistency_err"] = phase_lm_consistency(
                name, seed, layers=ZOO_CHECK_LAYERS.get(name, 4),
                **ZOO_CHECK_OVERRIDES.get(name, {}))
    log(f"  LM zoo phase {time.perf_counter() - t0:.1f} s")
    return launches, shapes, results


#: the train phase's cut of train_4k (seq 4096, batch 256): batch 4 at lr
#: 3e-4 (the trainer's warmup of 10 steps)
TRAIN_SEQ, TRAIN_BATCH = 4096, 4
#: per trained config: (layers of its train_4k run, None for all; steps;
#: layers of the float32 card-vs-CPU and resume checks).  xlstm-350m: one
#: pattern unit (3 mlstm + slstm) of its 24 layers and one step: a step is
#: host-bound sLSTM loops (76-92 s cold at full depth, and with 3 steps
#: the script took 1094 s of its 1200 s), and the depth is what the other
#: checks of the phase do not need.  stablelm-1.6b: full depth, 2 steps
#: (cold, then warm).
TRAIN_RUNS = {"xlstm-350m": (4, 1, 4), "stablelm-1.6b": (None, 2, 1)}
#: the card-vs-CPU and resume checks: batch 2 of 64 tokens
TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ = 2, 64
#: losses and gradient norms, card vs CPU and resumed vs uninterrupted
#: (tests/test_fault_tolerance.py's resume band); parameters card vs CPU
TRAIN_RTOL, PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-3, 1e-5
#: losses and gradient norms, the mesh vs one device on the card
#: (tests/test_torch_sharded_train.py's float32 band)
SHARDED_RTOL = 1e-5


def _unit_model(cfg, seed: int, device: str):
    """A model of ``cfg`` drawn on the CPU from ``seed`` (the same weights
    for either device), moved to ``device``."""
    import torch
    from repro_torch.models.lm import LM
    model = LM(cfg, device="cpu",
               generator=torch.Generator().manual_seed(seed))
    return model.to(device)


def _check_train_counts(cfg, steps: int, what: str, shards: int = 1) -> dict:
    """The kernel launches since the counters were set to 0 are those
    ``steps`` train steps of ``cfg`` make on the card: each GQA layer's
    (and each ``mamba_shared`` layer's shared-block call's) forward twice a
    step (the pass and its remat recompute; once in a prelude, which is not
    recomputed), on the tensor-core forward in bf16, and its backward
    once, on the tensor-core backward in bf16, on each of ``shards``
    shards of a mesh; nothing else, and no plain version.  Returns the
    forward (``launches``), tensor-core forward (``wgmma``), backward
    (``bwd``) and tensor-core backward (``bwd_wgmma``) launches."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.models.lm import FLASH_KINDS, flash_layers
    n = flash_layers(cfg) * shards
    fwd = 2 * n - sum(k in FLASH_KINDS for k in cfg.prelude) * shards
    bf16 = cfg.dtype == torch.bfloat16
    want = {"launches": fwd * steps, "wgmma": fwd * steps * bf16,
            "bwd": n * steps, "bwd_wgmma": n * steps * bf16}
    counts = kernels.counters()
    got = {"launches": counts["flash_attention"]["launches"],
           "wgmma": flash_attention_cuda.wgmma_launches,
           "bwd": flash_attention_cuda.bwd_launches,
           "bwd_wgmma": flash_attention_cuda.bwd_wgmma_launches}
    others = {k: c for k, c in counts.items() if k != "flash_attention"}
    if got != want or any(c["plain_calls"] for c in counts.values()) or \
            any(c["launches"] for c in others.values()):
        raise AssertionError(f"{what}: launches {got}, expected {want}; "
                             f"counters {counts}")
    return got


def phase_train(name: str, seed: int, smi, profile: bool = False):
    """The training path (``launch/train.py``: the token pipeline,
    ``LM.loss`` with remat per pattern unit, the chunked cross-entropy,
    AdamW on the cosine schedule, the watchdog) of ``name`` at full width
    on the card, train_4k cut to batch 4 and TRAIN_RUNS' depth and steps:
    ms per step, tokens/s, peak memory, every loss and gradient norm finite
    and every norm > 0, and the launches of ``_check_train_counts``
    (attention's forward kernel and backward kernels; no plain version).
    With ``profile``, one more (warm) step of the trained model under
    torch.profiler: device time by kernel and the idle share.  Then at
    TRAIN_RUNS' check depth in float32 (attention on the float32
    SIMT forward and the float32 backward): 2 steps on the card against the
    same 2 on the CPU, and a run preempted after its 3rd of 4 steps and
    resumed from its checkpoint (``CheckpointManager``) against the
    uninterrupted run; each card run's launches are counted from 0 and
    checked.  Returns the timings and the flash forward (``fwd``) and
    backward (``bwd``) launches of the main run alone."""
    import dataclasses
    import math
    import shutil
    import torch
    from repro_torch import configs, kernels
    from repro_torch.checkpoint import PreemptionGuard
    from repro_torch.launch.train import train
    from repro_torch.models.lm import LM
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("TF32 matmuls are on")
    layers, steps, check_layers = TRAIN_RUNS[name]
    cfg = configs.get_config(name)
    depth = "full width and depth"
    if layers is not None:
        depth = (f"full width, {layers} of its {cfg.n_layers} layers (one "
                 "pattern unit)")
        cfg = dataclasses.replace(cfg, n_layers=layers)
    t_phase = time.perf_counter()
    log(f"== train: {name} at {depth} (card: {smi}); train_4k cut to seq "
        f"{TRAIN_SEQ}, batch {TRAIN_BATCH} (of 256), {steps} steps at lr "
        "3e-4; remat per pattern unit")
    model = LM(cfg, device="cuda",
               generator=torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counters()
    hist = []
    _, opt_state, losses = train(
        model=model, steps=steps, batch=TRAIN_BATCH, seq=TRAIN_SEQ, lr=3e-4,
        seed=seed, verbose=False, history=hist)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    got = _check_train_counts(cfg, steps, f"train {name}")
    norms = [h["grad_norm"] for h in hist]
    ms = [1e3 * h["seconds"] for h in hist]
    if len(losses) != steps or not all(
            math.isfinite(v) for v in losses + norms) or \
            not all(g > 0 for g in norms):
        raise AssertionError(f"train: losses {losses}, grad norms {norms}")
    n = sum(p.numel() for p in model.parameters())
    # the first step is cold (its warm-up included): tokens/s is read at a
    # warm step where the run has one
    rate = TRAIN_BATCH * TRAIN_SEQ / ms[-1] * 1e3
    log(f"  {n / 1e6:.1f} M parameters; ms per step "
        f"{[round(m, 1) for m in ms]} (the first cold: its warm-up "
        f"included), {rate:.0f} tokens/s at "
        + ("the last step" if len(ms) > 1 else "the cold step")
        + f", peak device memory {peak:.2f} GiB; losses "
        f"{[round(v, 4) for v in losses]}; grad norms "
        f"{[round(g, 4) for g in norms]}; launches {got} "
        "(forward, tensor-core forward, backward, tensor-core backward), no "
        "plain call")
    timings = {"ms": ms, "tokens_per_s": rate, "peak_gib": peak,
               "losses": losses, "grad_norms": norms,
               "fwd": got["launches"], "bwd": got["bwd"]}
    if profile:
        _profile_train_step(model, opt_state, steps, seed)
    del model, opt_state
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(configs.get_config(name),
                              name=f"{name}-unit", n_layers=check_layers,
                              dtype=torch.float32)
    kw = dict(batch=TRAIN_CHECK_BATCH,
              seq=TRAIN_CHECK_SEQ, seed=seed, verbose=False)
    runs = {}
    for dev in ("cpu", "cuda"):
        m = _unit_model(cfg, seed + 5, dev)
        hist = []
        kernels.reset_counters()
        _, _, unit_losses = train(steps=2, model=m, history=hist, **kw)
        if dev == "cuda":
            _check_train_counts(cfg, 2, f"train {cfg.name} on the card")
        runs[dev] = (m, unit_losses, [h["grad_norm"] for h in hist])
    rel = {}
    for i, what in ((1, "losses"), (2, "grad norms")):
        got, want = runs["cuda"][i], runs["cpu"][i]
        rel[what] = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        if rel[what] > TRAIN_RTOL:
            raise AssertionError(f"train on the card vs the CPU: {what} "
                                 f"{got} vs {want}")
    worst = 0.0
    for (pname, a), b in zip(runs["cpu"][0].named_parameters(),
                             runs["cuda"][0].parameters()):
        err = (b.detach().cpu() - a.detach()).abs()
        bad = err > PARAM_ATOL + PARAM_RTOL * a.detach().abs()
        if bool(bad.any()):
            raise AssertionError(f"train on the card vs the CPU: {pname}, "
                                 f"{int(bad.sum())} parameters outside "
                                 f"rtol {PARAM_RTOL} atol {PARAM_ATOL}")
        worst = max(worst, float(err.max()))
    log(f"  card vs CPU, {check_layers} float32 layers, batch "
        f"{TRAIN_CHECK_BATCH} x {TRAIN_CHECK_SEQ}, 2 steps: losses "
        f"{[round(v, 6) for v in runs['cuda'][1]]} (max rel err "
        f"{rel['losses']:.2e}), grad norms max rel err "
        f"{rel['grad norms']:.2e}, parameters max |err| {worst:.2e} (rtol "
        f"{PARAM_RTOL}, atol {PARAM_ATOL})")
    del runs

    class TriggerAt(PreemptionGuard):
        """Reports a preemption from its ``at + 1``-th poll on (one poll
        a step): the run stops after step ``at``."""

        def __init__(self, at):
            super().__init__(install_handler=False)
            self.at, self.count = at, 0

        @property
        def preempted(self):
            self.count += 1
            return self.count > self.at

    ckpt = os.path.join(ROOT, "build", "train_resume")
    shutil.rmtree(ckpt, ignore_errors=True)
    kw.update(steps=4)

    def counted(steps, what, **more):
        kernels.reset_counters()
        _, _, losses = train(**kw, **more)
        _check_train_counts(cfg, steps, f"train {cfg.name}: {what}")
        return losses

    try:
        whole = counted(4, "uninterrupted",
                        model=_unit_model(cfg, seed + 6, "cuda"))
        first = counted(3, "preempted", model=_unit_model(cfg, seed + 6,
                                                          "cuda"),
                        ckpt_dir=ckpt, ckpt_every=2, guard=TriggerAt(2))
        rest = counted(1, "resumed", model=_unit_model(cfg, seed + 7, "cuda"),
                       ckpt_dir=ckpt, ckpt_every=2)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    resumed = first + rest
    if len(first) != 3 or len(rest) != 1 or any(
            abs(a - b) > TRAIN_RTOL * abs(b) for a, b in zip(resumed, whole)):
        raise AssertionError(f"preempt and resume: {first} + {rest} vs "
                             f"{whole}")
    log(f"  preempted after step 3 of 4 and resumed from its checkpoint: "
        f"losses {[round(v, 6) for v in resumed]} vs uninterrupted "
        f"{[round(v, 6) for v in whole]} (rtol {TRAIN_RTOL}); bit-equal: "
        f"{resumed == whole}")
    torch.cuda.empty_cache()
    log(f"  train phase {time.perf_counter() - t_phase:.1f} s")
    return timings


#: the sharded train phase: a (data 2, model 2) mesh of one card, ZeRO-1
SHARDED_DATA, SHARDED_MODEL = 2, 2


def phase_train_sharded(seed: int, smi):
    """The sharded training path (``launch/train.py`` on a mesh:
    ``ShardedLM``, its collectives, ``adamw_update_mesh`` with ZeRO-1) of
    stablelm-1.6b at full width and depth on a (data 2, model 2) mesh of
    four ``cuda:0`` shards, train_4k cut to the global batch 4 x 4096 of
    ``phase_train``, 2 steps (cold, then warm): ms per step, tokens/s,
    peak memory, every loss and gradient norm finite, the bytes each
    collective moves per step, and the flash forward and backward
    launches of the 4 shards (``_check_train_counts``); a third (warm)
    step under torch.profiler: device time by kernel and the idle share.
    Then one layer in float32 (attention on the float32 SIMT kernels),
    batch 2 x 64: 2 steps on the mesh against 2 of the single-device
    trainer on the card from the same weights, each run's launches
    counted from 0 and checked;
    losses and gradient norms rtol 1e-5, parameters rtol 1e-3 atol 1e-5.
    Returns the timings and the flash forward (``fwd``) and backward
    (``bwd``) launches of the main run alone."""
    import dataclasses
    import math
    import torch
    from repro_torch import configs, kernels
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import train
    from repro_torch.models.lm import LM
    from repro_torch.models.sharded_lm import ShardedLM
    name, steps = "stablelm-1.6b", 2
    shards = SHARDED_DATA * SHARDED_MODEL
    mesh = make_host_mesh(SHARDED_MODEL, devices=["cuda:0"] * shards)
    cfg = configs.get_config(name)
    t_phase = time.perf_counter()
    log(f"== train on a mesh: {name} at full width and depth (card: {smi}); "
        f"(data {SHARDED_DATA}, model {SHARDED_MODEL}) of {shards} cuda:0 "
        f"shards, ZeRO-1; global batch {TRAIN_BATCH} x {TRAIN_SEQ}, {steps} "
        "steps at lr 3e-4; remat per layer")
    model = LM(cfg, device="cuda",
               generator=torch.Generator(device="cuda").manual_seed(seed))
    sharded = ShardedLM(model, mesh)
    del model
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counters()
    sharded.comm.reset_bytes()
    hist = []
    _, opt_state, losses = train(
        model=sharded, steps=steps, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        lr=3e-4, seed=seed, verbose=False, history=hist)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    got = _check_train_counts(cfg, steps, f"train {name} on the mesh",
                              shards)
    norms = [h["grad_norm"] for h in hist]
    ms = [1e3 * h["seconds"] for h in hist]
    if len(losses) != steps or not all(
            math.isfinite(v) for v in losses + norms) or \
            not all(g > 0 for g in norms):
        raise AssertionError(f"train on the mesh: losses {losses}, grad "
                             f"norms {norms}")
    per_step = {k: v // steps for k, v in sorted(sharded.comm.bytes.items())}
    rate = TRAIN_BATCH * TRAIN_SEQ / ms[-1] * 1e3
    log(f"  ms per step {[round(m, 1) for m in ms]} (the first cold), "
        f"{rate:.0f} tokens/s at the last step, peak device memory "
        f"{peak:.2f} GiB; losses {[round(v, 4) for v in losses]}; grad norms "
        f"{[round(g, 4) for g in norms]}; launches {got} (forward, "
        "tensor-core forward, backward, tensor-core backward; 4 shards), no "
        "plain call")
    log(f"  bytes between shards per step, by collective: {per_step} "
        f"({sum(per_step.values()) / 2**30:.2f} GiB in all)")
    timings = {"ms": ms, "tokens_per_s": rate, "peak_gib": peak,
               "losses": losses, "grad_norms": norms, "bytes": per_step,
               "fwd": got["launches"], "bwd": got["bwd"]}
    _profile_train_step(sharded, opt_state, steps, seed)
    del sharded, opt_state
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(cfg, name=f"{name}-layer", n_layers=1,
                              dtype=torch.float32)
    _mesh_vs_one_device(cfg, mesh,
                        lambda: _unit_model(cfg, seed + 8, "cuda"), seed,
                        "1 float32 layer")
    torch.cuda.empty_cache()
    log(f"  sharded train phase {time.perf_counter() - t_phase:.1f} s")
    return timings


def _mesh_vs_one_device(cfg, mesh, make, seed: int, what: str) -> dict:
    """2 float32 train steps (``launch/train.py``, batch TRAIN_CHECK_BATCH x
    TRAIN_CHECK_SEQ) of a ``ShardedLM`` on ``mesh`` against 2 of the
    single-device trainer on the card, each from a model ``make()`` gives
    (the same weights each call), each run's launches counted from 0 and
    checked (``_check_train_counts``): losses and gradient norms rtol
    SHARDED_RTOL, parameters rtol PARAM_RTOL atol PARAM_ATOL.  Returns the
    worst relative errors and the parameters' max |err|."""
    import torch
    from repro_torch import kernels
    from repro_torch.launch.train import train
    from repro_torch.models.sharded_lm import ShardedLM
    shards = len(mesh.devices.flat)
    kw = dict(steps=2, batch=TRAIN_CHECK_BATCH, seq=TRAIN_CHECK_SEQ,
              seed=seed, verbose=False)
    t0 = time.perf_counter()
    runs = {}
    for where in ("one device", "mesh"):
        m = make()
        if where == "mesh":
            m = ShardedLM(m, mesh)
        hist = []
        kernels.reset_counters()
        _, _, unit_losses = train(model=m, history=hist, **kw)
        _check_train_counts(cfg, 2, f"train {cfg.name} on {where}",
                            shards if where == "mesh" else 1)
        # compared on the card: llama-vision's unit is 1.6 B parameters
        params = m.gather(m.device) if where == "mesh" else \
            {n: p.detach().clone() for n, p in m.named_parameters()}
        runs[where] = (params, unit_losses, [h["grad_norm"] for h in hist])
        del m
        torch.cuda.empty_cache()
    if not all(g > 0 for g in runs["mesh"][2]):
        raise AssertionError(f"train {cfg.name} on the mesh: grad norms "
                             f"{runs['mesh'][2]}")
    rel = {}
    for i, key in ((1, "losses"), (2, "grad norms")):
        got, want = runs["mesh"][i], runs["one device"][i]
        rel[key] = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        if rel[key] > SHARDED_RTOL:
            raise AssertionError(f"train {cfg.name} on the mesh vs one "
                                 f"device: {key} {got} vs {want}")
    worst = 0.0
    for pname, a in runs["one device"][0].items():
        b = runs["mesh"][0][pname]
        err = (b - a).abs()
        bad = err > PARAM_ATOL + PARAM_RTOL * a.abs()
        if bool(bad.any()):
            raise AssertionError(f"train {cfg.name} on the mesh vs one "
                                 f"device: {pname}, {int(bad.sum())} "
                                 f"parameters outside rtol {PARAM_RTOL} "
                                 f"atol {PARAM_ATOL}")
        worst = max(worst, float(err.max()))
    log(f"  mesh vs one device on the card, {what}, batch "
        f"{TRAIN_CHECK_BATCH} x {TRAIN_CHECK_SEQ}, 2 steps: losses "
        f"{[round(v, 6) for v in runs['mesh'][1]]} (max rel err "
        f"{rel['losses']:.2e}), grad norms max rel err "
        f"{rel['grad norms']:.2e} (rtol {SHARDED_RTOL}), parameters max "
        f"|err| {worst:.2e} (rtol {PARAM_RTOL}, atol {PARAM_ATOL}); "
        f"{time.perf_counter() - t0:.1f} s")
    return {"losses_rel": rel["losses"], "norms_rel": rel["grad norms"],
            "param_err": worst}


#: the MLA / cross-attention configs on the (data 2, model 2) mesh: (layers
#: of the bf16 run at full width, layers of the float32 mesh-vs-one-device
#: check).  minicpm3-4b: 16 of its 62 layers (1.20 B parameters, its state
#: at full depth does not fit the card with four shards' copies);
#: llama-3.2-vision-11b: one pattern unit (4 attn + 1 xattn, 1.62 B
#: parameters, most of them the 128256-row embedding)
SHARDED_MLA_XATTN_RUNS = {"minicpm3-4b": (16, 1),
                          "llama-3.2-vision-11b": (5, 5)}


#: the record_function ranges around MLA's attention core
#: (``_mla_attend``) in minicpm3-4b's profiled mesh step and around the
#: chunked SSD (``_ssd_chunked``) in zamba2-7b's
MLA_RANGE, SSD_RANGE = "mla_attend", "ssd_chunked"
RANGES = (MLA_RANGE, SSD_RANGE)


def _range_device_ms(prof, name: str) -> tuple:
    """Device time of the kernels a torch.profiler window ran for the
    record_function range ``name``: those launched inside the range (its
    forward passes, remat's recompute included), and those of the autograd
    nodes that the ops inside it made (their backward), each node matched
    to the op by the forward thread and sequence number the profiler
    records.  Each kernel counts once, for the range or backward node
    nearest around its launch.  Returns (forward ms, backward ms, the
    backward nodes' names)."""
    from torch.autograd import DeviceType
    node = "autograd::engine::evaluate_function: "
    roots = [e for e in prof.events()
             if e.device_type == DeviceType.CPU and e.cpu_parent is None]

    def walk():
        # (event, its nearest mark: "range", a backward node event, None)
        todo = [(e, None) for e in roots]
        while todo:
            e, mark = todo.pop()
            if e.name == name:
                mark = "range"
            elif e.name.startswith(node):
                mark = e
            yield e, mark
            todo.extend((c, mark) for c in e.cpu_children)
    made = set()
    spent = []
    for e, mark in walk():
        if mark == "range" and e.sequence_nr >= 0:
            made.add((e.thread, e.sequence_nr))
        if e.kernels and mark is not None:
            spent.append((sum(k.duration for k in e.kernels), mark))
    fwd = bwd = 0.0
    names = set()
    for us, mark in spent:
        if mark == "range":
            fwd += us
        elif (mark.fwd_thread, mark.sequence_nr) in made:
            bwd += us
            names.add(mark.name[len(node):])
    return fwd / 1e3, bwd / 1e3, sorted(names)


def _profile_range_share(sharded, opt_state, steps: int, seed: int,
                         warm_ms: float, module, attr: str, rng: str,
                         what: str, key: str) -> dict:
    """The profiled warm step (``_profile_train_step``) with each call of
    ``module.attr`` inside a ``rng`` range: the device ms of its kernels,
    forward and backward (``_range_device_ms``), and their share of the
    step's device busy time, of its wall time and of the unprofiled warm
    step's ``warm_ms``; the numbers under ``key``."""
    import torch
    fn = getattr(module, attr)

    def marked(*args, **kw):
        with torch.profiler.record_function(rng):
            return fn(*args, **kw)
    setattr(module, attr, marked)
    try:
        prof, wall, busy = _profile_train_step(sharded, opt_state, steps,
                                               seed)
    finally:
        setattr(module, attr, fn)
    t0 = time.perf_counter()
    fwd, bwd, names = _range_device_ms(prof, rng)
    read_s = time.perf_counter() - t0
    if not (fwd > 0 and bwd > 0):
        log(f"  {what}'s share: not measured (the profile gave {fwd:.1f} "
            f"ms forward, {bwd:.1f} ms backward)")
        return {}
    log(f"  {what} (``{attr}``) in the profiled step: forward and remat "
        f"recompute {fwd:.1f} ms, backward {bwd:.1f} ms "
        f"({', '.join(names)}); {fwd + bwd:.1f} ms, "
        f"{100 * (fwd + bwd) / busy:.1f} % of the device's busy "
        f"{busy:.1f} ms, {100 * (fwd + bwd) / wall:.1f} % of the step's "
        f"wall {wall:.1f} ms, {100 * (fwd + bwd) / warm_ms:.1f} % of the "
        f"unprofiled warm step's {warm_ms:.1f} ms (read from the profile "
        f"in {read_s:.1f} s)")
    return {f"{key}_ms": fwd + bwd, f"{key}_fwd_ms": fwd,
            f"{key}_bwd_ms": bwd, "busy_ms": busy, "profiled_wall_ms": wall,
            f"{key}_share": (fwd + bwd) / busy}


def _train_sharded_cut(name: str, layers: int, check_layers: int,
                       seed: int, smi, share=None) -> dict:
    """``name`` at full width and ``layers`` layers, bf16, trained on the
    (data 2, model 2) mesh of four ``cuda:0`` shards, ZeRO-1, train_4k
    cut to the global batch 4 x 4096, 2 steps (cold, then warm), any
    cross-attention gates opened to XATTN_GATE before the split: ms per
    step, tokens/s, peak memory, the bytes each collective moves per
    step, every loss and gradient norm finite and every norm > 0, and the
    flash launches of the 4 shards (``_check_train_counts``).  With
    ``share`` (module, function name, range, what, key), a third (warm)
    step under torch.profiler and the device time of that function's
    kernels in it (``_profile_range_share``).  Then ``check_layers``
    layers in float32: 2 steps on the mesh against 2 of the single-device
    trainer from the same weights (``_mesh_vs_one_device``).  Returns the
    timings and the flash forward (``fwd``) and backward (``bwd``)
    launches of the bf16 run."""
    import dataclasses
    import math
    import torch
    from repro_torch import configs, kernels
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import train
    from repro_torch.models.lm import LM
    from repro_torch.models.sharded_lm import ShardedLM
    steps = 2
    shards = SHARDED_DATA * SHARDED_MODEL
    mesh = make_host_mesh(SHARDED_MODEL, devices=["cuda:0"] * shards)
    t0 = time.perf_counter()
    full = configs.get_config(name)
    cfg = dataclasses.replace(full, n_layers=layers)
    log(f"== train on a mesh: {name} at full width, {layers} of its "
        f"{full.n_layers} layers (card: {smi}); (data {SHARDED_DATA}, "
        f"model {SHARDED_MODEL}) of {shards} cuda:0 shards, ZeRO-1; "
        f"global batch {TRAIN_BATCH} x {TRAIN_SEQ}, {steps} steps at lr "
        "3e-4; remat per pattern unit")
    model = LM(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(seed))
    gates = model.set_xattn_gates(XATTN_GATE)
    n = sum(p.numel() for p in model.parameters())
    sharded = ShardedLM(model, mesh)
    del model
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counters()
    sharded.comm.reset_bytes()
    hist = []
    _, opt_state, losses = train(
        model=sharded, steps=steps, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        lr=3e-4, seed=seed, verbose=False, history=hist)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    got = _check_train_counts(cfg, steps, f"train {name} on the mesh",
                              shards)
    norms = [h["grad_norm"] for h in hist]
    ms = [1e3 * h["seconds"] for h in hist]
    if len(losses) != steps or not all(
            math.isfinite(v) for v in losses + norms) or \
            not all(g > 0 for g in norms):
        raise AssertionError(f"train {name} on the mesh: losses "
                             f"{losses}, grad norms {norms}")
    per_step = {k: v // steps
                for k, v in sorted(sharded.comm.bytes.items())}
    rate = TRAIN_BATCH * TRAIN_SEQ / ms[-1] * 1e3
    log(f"  {n / 1e9:.3f} B parameters"
        + (f", {gates} cross-attention gates at {XATTN_GATE}" if gates
           else "")
        + f"; ms per step {[round(m, 1) for m in ms]} (the first cold), "
        f"{rate:.0f} tokens/s at the last step, peak device memory "
        f"{peak:.2f} GiB; losses {[round(v, 4) for v in losses]}; grad "
        f"norms {[round(g, 4) for g in norms]}; launches {got} (forward, "
        "tensor-core forward, backward, tensor-core backward; 4 shards), "
        "no plain call")
    log(f"  bytes between shards per step, by collective: {per_step} "
        f"({sum(per_step.values()) / 2**30:.2f} GiB in all)")
    res = {"ms": ms, "tokens_per_s": rate, "peak_gib": peak,
           "losses": losses, "grad_norms": norms, "bytes": per_step,
           "fwd": got["launches"], "bwd": got["bwd"]}
    if share is not None:
        res.update(_profile_range_share(sharded, opt_state, steps, seed,
                                        ms[-1], *share))
    del sharded, opt_state
    torch.cuda.empty_cache()
    ccfg = dataclasses.replace(full, name=f"{name}-check",
                               n_layers=check_layers, dtype=torch.float32)

    def make():
        m = LM(ccfg, device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(seed + 8))
        m.set_xattn_gates(XATTN_GATE)
        return m
    res.update(_mesh_vs_one_device(
        ccfg, mesh, make, seed, f"{check_layers} float32 layer"
        + ("s" if check_layers > 1 else "")))
    torch.cuda.empty_cache()
    log(f"  {name} on the mesh: {time.perf_counter() - t0:.1f} s")
    return res


def phase_train_sharded_mla_xattn(seed: int, smi):
    """The sharded training path of the MLA and cross-attention kinds
    (``ShardedLM``'s head-parallel ``mla_fwd_mesh`` and ``cross_fwd_mesh``,
    the image context split with the batch) for minicpm3-4b and
    llama-3.2-vision-11b at full width and SHARDED_MLA_XATTN_RUNS' depth
    (``_train_sharded_cut``; llama-vision's 1600 seeded patch embeddings
    a step from the trainer): the flash launches are none for MLA, two
    forward and one backward per GQA layer and shard a step, on the
    tensor cores; no plain call.  minicpm3's third (warm) step under
    torch.profiler (device time by kernel, idle share), and the device
    time of its float32 MLA attention core's kernels in that step, forward
    and backward, and their share of the step.  Returns per config
    ``_train_sharded_cut``'s timings."""
    from repro_torch.models import attention as attn_mod
    out = {}
    for name, (layers, check_layers) in SHARDED_MLA_XATTN_RUNS.items():
        share = ((attn_mod, "_mla_attend", MLA_RANGE,
                  "MLA attention core (float32)", "mla_attention")
                 if name == "minicpm3-4b" else None)
        out[name] = _train_sharded_cut(name, layers, check_layers, seed,
                                       smi, share)
    return out


#: zamba2-7b on the (data 2, model 2) mesh: (layers of the bf16 run at full
#: width, layers of the float32 mesh-vs-one-device check).  15 of 81: the
#: 3-layer prelude and two pattern units of 5 mamba and one mamba_shared
#: layer (1.49 B parameters; the shared block called at two sites, so its
#: gradient sums both); the check: the prelude and one unit
SHARDED_ZAMBA2_RUN = (15, 9)


def phase_train_sharded_zamba2(seed: int, smi):
    """The sharded training path of Mamba2 and zamba2's shared attention
    block (``ShardedLM``'s head-parallel ``mamba2_fwd_mesh``, the gated
    norm's sums of squares and the ``out_proj`` partials all-reduced; the
    shared block's GQA and FFN split as a dense block's, on each shard's
    slices) for zamba2-7b at full width and SHARDED_ZAMBA2_RUN's depth
    (``_train_sharded_cut``): two forward and one backward flash launch per
    shared-block call and shard a step (16 and 8 at D 112), on the tensor
    cores, no plain call; the third (warm) step under torch.profiler
    (device time by kernel, idle share), and the device time of the
    chunked SSD's kernels (``_ssd_chunked``, forward, remat recompute and
    backward) in that step and their share of it.  Then the prelude and
    one unit in float32, the mesh against one device.  Returns
    ``_train_sharded_cut``'s timings."""
    from repro_torch.models import mamba2 as mamba_mod
    layers, check_layers = SHARDED_ZAMBA2_RUN
    return _train_sharded_cut(
        "zamba2-7b", layers, check_layers, seed, smi,
        (mamba_mod, "_ssd_chunked", SSD_RANGE, "chunked SSD", "ssd"))


def _profile_train_step(model, opt_state, steps: int, seed: int) -> tuple:
    """One more train step of ``model`` (an ``LM`` or a ``ShardedLM``, whose
    step takes the global batch) from ``opt_state`` (warm: the kernels are
    built and the allocator's pools filled by the steps before) on the
    next batch of the run's token pipeline, under torch.profiler: where
    the step's device time goes, by kernel, and the idle share.  Returns
    the profile, the step's wall ms and the device's busy ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data import TokenPipeline, TokenPipelineConfig
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamWConfig
    cfg = model.cfg
    pipe = TokenPipeline(TokenPipelineConfig(
        vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
        seed=seed))
    step_fn = make_train_step(model, AdamWConfig(lr=3e-4), 10, steps + 1)
    toks, labels = pipe.batch(steps)
    tokens = torch.from_numpy(toks).to(model.device)
    labels = torch.from_numpy(labels).to(model.device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ms, _ = once_ms(lambda: step_fn(opt_state, tokens, labels))
    busy = _device_report(prof, ms, f"{cfg.name} train step {steps + 1} "
                          "(warm, under torch.profiler)", top=12)
    return prof, ms, busy


def phase_flash_bwd_times(launches: int):
    """The backward kernels at stablelm-1.6b's train shape (B 4, H 32, S
    4096, D 64, causal, bf16; seeded q, k, v, d_out): CUDA-event median of
    5 of one backward launch, and of the forward with lse (a train step's)
    and without; the plain version once (autograd of
    flash_attention_plain: its backward pass, after an untimed forward);
    the library yardstick, torch's scaled_dot_product_attention forward +
    backward minus its forward (causal, no cap; never on the path); the
    bound, 10 D operations per unmasked pair and head at the bf16
    tensor-core peak against the bytes (q, k, v, d_out, the float32 out
    and lse read once, dq, dk, dv written once).  The kernel's gradients
    are held against the plain ones at the band, and three launches run
    under torch.profiler for the device time of each of its kernels.
    Returns the kernels line's row."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (_launch_bwd,
                                                     _launch_fwd,
                                                     flash_attention_plain)
    b, h, s, d = 4, 32, TRAIN_SEQ, 64
    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v, d_out = (torch.randn((b, h, s, d), generator=gen,
                                  device="cuda").to(torch.bfloat16)
                      for _ in range(4))
    with torch.no_grad():
        _, lse, o32 = _launch_fwd(q, k, v, True, None, None, True)
        # the forward as a train step launches it (with lse and the float32
        # out), and as prefill does (without)
        fwd_ms = {lse_: cuda_ms(lambda: _launch_fwd(q, k, v, True, None, None,
                                                    lse_), reps=5)
                  for lse_ in (True, False)}
    run = lambda: _launch_bwd(q, k, v, o32, lse, d_out, True, None, None)
    ms = cuda_ms(run, reps=5)
    split = _kernel_split(run, 3)
    got = run()
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = flash_attention_plain(*leaves, True, None, None)
    plain_ms, want = once_ms(lambda: torch.autograd.grad(out, leaves, d_out))
    del out, leaves
    err = 0.0
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        n_bad = outside_band(a, w, *_grad_band(w, torch.bfloat16))
        err = max(err, float((a.float() - w.float()).abs().max()))
        if n_bad:
            raise AssertionError(f"flash_attention backward at the train "
                                 f"shape: {name} {n_bad} outside the band")
    del got, want
    torch.cuda.empty_cache()
    lib_ms = None
    try:
        ql, kl, vl = (t.clone().requires_grad_(True) for t in (q, k, v))

        def sdpa_fwd():
            return F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa_fwd(), (ql, kl, vl), d_out)

        with torch.no_grad():
            sdpa_ms = cuda_ms(sdpa_fwd, reps=5)
        lib_ms = cuda_ms(sdpa_fwd_bwd, reps=5) - sdpa_ms
        lib_note = (f"scaled_dot_product_attention backward {lib_ms:.3f} ms"
                    f" (its forward {sdpa_ms:.3f} ms)")
    except Exception as e:   # the yardstick only: the port never calls it
        sdpa_ms = None
        lib_note = f"scaled_dot_product_attention none: {type(e).__name__}"
    pairs = _unmasked_pairs(s, True, None)
    t_ops = 10 * d * pairs * b * h / PEAK_BF16
    t_bytes = (q.numel() * 2 * 7 + o32.numel() * 4 + lse.numel() * 4) \
        / PEAK_BYTES
    row = _row("flash_attention_bwd",
               "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
               "src/repro/kernels/flash_attention.py:34", launches, err, ms,
               plain_ms, t_ops, t_bytes)
    row["library_ms"] = lib_ms
    row["bound_share"] = row["bound_ms"] / ms
    row["tflops"] = 10 * d * pairs * b * h / ms / 1e9
    row["fwd_lse_ms"] = fwd_ms[True]
    row["sdpa_fwd_ms"] = sdpa_ms
    row["split_ms"] = split
    log(f"  flash_attention forward at that shape: {fwd_ms[True]:.3f} ms "
        f"with lse and the float32 out (a train step's), {fwd_ms[False]:.3f}"
        " ms without (prefill's); median of 5")
    log(f"  flash_attention backward (B {b}, H {h}, S {s}, D {d}, bf16, "
        f"causal): {ms:.3f} ms (median of 5), plain {plain_ms:.1f} ms, "
        f"bound {row['bound_ms']:.3f} ms ({row['bound_by']}; "
        f"{row['tflops']:.1f} TFLOP/s of the 10 D count, "
        f"{100 * row['bound_share']:.1f} % of the bound); {lib_note}; "
        f"max |err| vs the plain gradients {err:.3g}; {launches} backward "
        "launches on the main paths")
    log("  its kernels (device ms a launch, torch.profiler): " + (", ".join(
        f"{name} {t:.3f}" for name, t in split.items()) or "not measured "
        "(the profiler recorded no kernel)"))
    return row


def _kernel_split(fn, n: int) -> dict:
    """Device ms of each kernel ``fn()`` launches, averaged over ``n``
    calls under torch.profiler, by the kernel's name up to its template
    arguments."""
    import re
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    split = {}
    for ms, _, key in _device_rows(prof):
        found = re.search(r"(\w+)[<(]", key)
        name = found.group(1) if found else key[:40]
        split[name] = split.get(name, 0.0) + ms / n
    return split


def _unmasked_pairs(s: int, causal: bool, window):
    """(query, key) pairs the masks keep, per batch and head."""
    if not causal:
        return s * s if window is None else sum(
            s - max(0, q - window + 1) for q in range(s))
    w = s if window is None else window
    return sum(min(q + 1, w) for q in range(s))


def _first_flash_layer(cfg) -> int:
    """The first layer that launches flash_attention in prefill."""
    from repro_torch.models.lm import FLASH_KINDS
    return next(i for i, kind in enumerate(cfg.layer_kinds)
                if kind in FLASH_KINDS)


def _layer_qkv(model, tokens, layer: int):
    """The q, k, v that layer ``layer``'s attention sees in prefill (a
    ``mamba_shared`` layer's: the shared block's, after the layer's Mamba2
    part)."""
    import torch
    from repro_torch.models.attention import _project
    from repro_torch.models.lm import _apply_norm, block_fwd
    from repro_torch.models.mamba2 import mamba2_fwd
    cfg = model.cfg
    kinds = cfg.layer_kinds
    with torch.inference_mode():
        x = model._embed(tokens)
        pos = torch.arange(x.shape[1], device=x.device)
        for i in range(layer):
            x = block_fwd(kinds[i], model.layers[i], x, cfg, positions=pos,
                          shared=model.shared_attn)[0]
        p = model.layers[layer]
        if kinds[layer] == "mamba_shared":
            x = x + mamba2_fwd(p["mamba"], _apply_norm(p["ln1"], x, cfg),
                               cfg.mamba_cfg())[0]
            p = model.shared_attn
        h = _apply_norm(p["ln1"], x, cfg)
        q, k, v = _project(p["attn"], h, cfg.attn_cfg(kinds[layer]), pos)
    # clones outside inference mode: flex_attention is compiled on them
    return tuple(t.clone(memory_format=torch.contiguous_format)
                 for t in (q, k, v))


def _flex_ms(q, k, v, causal, window, softcap):
    """(ms, max |diff| vs out) of torch's flex_attention (compiled), the
    one PyTorch call with the same masks and soft-cap; the yardstick only."""
    import torch
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    s = q.shape[2]

    def mask_mod(b, h, qi, ki):
        keep = ki <= qi if causal else ki >= 0
        return keep & (ki > qi - window) if window is not None else keep

    def capped(sc, b, h, qi, ki):
        return softcap * torch.tanh(sc / softcap)

    block_mask = create_block_mask(mask_mod, None, None, s, s, device="cuda")
    fn = torch.compile(flex_attention)
    call = lambda: fn(q, k, v, score_mod=capped if softcap else None,
                      block_mask=block_mask, enable_gqa=True)
    with torch.no_grad():
        return cuda_ms(call, reps=5), call()


def _flash_case(name, q, k, v, acfg):
    """One attention shape of the main path: CUDA-event median of 5, the
    plain version once, flex_attention (compiled) median of 5, and the
    bound (4 D operations per unmasked pair and head at the bf16
    tensor-core peak, against the bytes of q, k, v and out).  The band
    must exclude the plain version with the layer's mask changed (the
    window dropped on a local layer, the causal mask dropped on a causal
    one, a causal mask added on an encoder's), and the kernel's float32
    instantiation on the same q, k, v widened is held at the float32
    band."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain)
    b, hq, s, d = q.shape
    args = (acfg.causal, acfg.window, acfg.softcap)
    rtol, atol = FLASH_TOL[str(q.dtype).split(".")[1]]
    ms = cuda_ms(lambda: flash_attention_cuda(q, k, v, *args), reps=5)
    plain_ms, want = once_ms(lambda: flash_attention_plain(q, k, v, *args))
    got = flash_attention_cuda(q, k, v, *args)
    err = check_close(f"{name} at main shapes", got, want, rtol, atol)
    if not torch.equal(got, flash_attention_cuda(q, k, v, *args)):
        raise AssertionError(f"{name}: repeat launch differs")
    log(f"  {name}: median |out| {float(want.float().abs().median()):.3g}"
        f", max |out| {float(want.float().abs().max()):.3g}")
    if acfg.window is not None:
        wrong = ("the window dropped", (acfg.causal, None, acfg.softcap))
    elif acfg.causal:
        wrong = ("the causal mask dropped", (False, None, acfg.softcap))
    else:
        wrong = ("a causal mask added", (True, None, acfg.softcap))
    check_separates(name, want, flash_attention_plain(q, k, v, *wrong[1]),
                    rtol, atol, wrong[0])
    del got, want
    q32, k32, v32 = (t.float() for t in (q, k, v))
    check_close(f"{name} float32 on the same inputs widened",
                flash_attention_cuda(q32, k32, v32, *args),
                flash_attention_plain(q32, k32, v32, *args),
                *FLASH_TOL["float32"])
    del q32, k32, v32
    torch.cuda.empty_cache()
    pairs = _unmasked_pairs(s, acfg.causal, acfg.window)
    flop = 4 * d * pairs * b * hq
    t_ops = flop / PEAK_BF16
    t_bytes = (2 * q.numel() + 2 * k.numel()) * q.element_size() / PEAK_BYTES
    try:
        lib_ms, lib_out = _flex_ms(q, k, v, *args)
        lib_err = float((lib_out.float() - flash_attention_cuda(
            q, k, v, *args).float()).abs().max())
        lib_note = f"flex_attention {lib_ms:.3f} ms (max |diff| vs the " \
            f"kernel {lib_err:.3g})"
    except Exception as e:   # the yardstick only: the port never calls it
        lib_ms = None
        lib_note = f"flex_attention none: {type(e).__name__}: " \
            f"{str(e).splitlines()[0][:300] if str(e) else ''}"
    out = dict(ms=ms, plain_ms=plain_ms, err=err, t_ops=t_ops,
               t_bytes=t_bytes, lib_ms=lib_ms, tflops=flop / ms / 1e9,
               share=max(t_ops, t_bytes) * 1e3 / ms)
    log(f"  {name} (B {b}, Hq {hq}, Hkv {k.shape[1]}, S {s}, D {d}, "
        f"{q.dtype}, causal {acfg.causal}, window {acfg.window}, softcap "
        f"{acfg.softcap}): {ms:.3f} ms, plain {plain_ms:.1f} ms, bound "
        f"{max(t_ops, t_bytes) * 1e3:.3f} ms "
        f"({'operations' if t_ops >= t_bytes else 'bytes'}; "
        f"{flop / 1e12:.3f} TFLOP, {flop / ms / 1e9:.1f} TFLOP/s, "
        f"{100 * out['share']:.1f} % of the bound); {lib_note}")
    return out


def phase_flash_times(model, tokens, launches: int):
    """flash_attention at the main path's shape, on the q, k, v of layer 0
    (local) and layer 1 (global) of the prefill prompts (``_flash_case``).
    The row gives the mean of one local and one global launch: a prefill
    runs as many of each."""
    import torch
    cfg = model.cfg
    per = {}
    for layer in (0, 1):
        kind = cfg.layer_kinds[layer]
        q, k, v = _layer_qkv(model, tokens, layer)
        per[kind] = _flash_case(f"flash_attention {kind}", q, k, v,
                                cfg.attn_cfg(kind))
        del q, k, v
        torch.cuda.empty_cache()
    mean = lambda key: sum(p[key] for p in per.values()) / len(per)
    libs = [p["lib_ms"] for p in per.values()]
    row = _row("flash_attention",
               "src/repro_torch/kernels/csrc/flash_attention.cu",
               "src/repro/kernels/flash_attention.py:34", launches,
               max(p["err"] for p in per.values()), mean("ms"),
               mean("plain_ms"), mean("t_ops"), mean("t_bytes"))
    row["library_ms"] = None if None in libs else sum(libs) / len(libs)
    row["tflops"] = mean("tflops")
    row["bound_share"] = row["bound_ms"] / row["ms"]
    for kind, p in per.items():
        _add_flash_shape(row, kind, p)
    return row


def _add_flash_shape(row, tag: str, p) -> None:
    """One timed shape's numbers on the flash row, under ``*_<tag>``."""
    row[f"ms_{tag}"] = p["ms"]
    row[f"bound_ms_{tag}"] = max(p["t_ops"], p["t_bytes"]) * 1e3
    row[f"library_ms_{tag}"] = p["lib_ms"]
    row[f"tflops_{tag}"] = p["tflops"]
    row[f"bound_share_{tag}"] = p["share"]


# --------------------------------------------------------------------------
# the tile autotuner (repro_torch.kernels.autotune)
# --------------------------------------------------------------------------

def tile_cases(n: int):
    """(tag, geometry, angles) of the tile checks: nice(n), a prime shape
    (N=61, a 67 x 71 detector, 13 angles) and OVERFLOW_GEO (bp_voxel's
    global-read path beside its staged one)."""
    from repro_torch.core.geometry import ConeGeometry, circular_angles
    return ((f"N={n}", ConeGeometry.nice(n), circular_angles(48)),
            ("N=61 prime", ConeGeometry.nice(61, n_detector=(67, 71)),
             circular_angles(13)),
            ("overflow", ConeGeometry(**OVERFLOW_GEO), circular_angles(40)))


def phase_tile_checks(n: int):
    """Every compiled tile configuration of fp_ray, bp_matched and bp_voxel
    against configuration 0 bit for bit, and against the plain version at
    the kernel band: x- and y-dominant angles (the backend's rotation),
    the whole volume and a z0 > 0 slab, each bp_voxel weight."""
    import torch
    from repro_torch.core.geometry import dominant_axis_mask
    from repro_torch.core.projector import _rotate_vol_90
    from repro_torch.kernels import autotune, build
    from repro_torch.kernels.bp_matched import (bp_matched_cuda,
                                                bp_matched_plain)
    from repro_torch.kernels.bp_voxel import bp_voxel_cuda, bp_voxel_plain
    from repro_torch.kernels.fp_ray import fp_ray_cuda, fp_ray_plain
    cfgs = {k: build.configs(k) for k in autotune.KERNELS.values()}
    log("== tile configurations held against configuration 0 and the "
        "plain version: " + "; ".join(
            f"{k}: " + ", ".join(f"{i} {c}" for i, c in enumerate(v))
            for k, v in cfgs.items()))
    gen = torch.Generator(device="cuda").manual_seed(11)
    n_checked = 0
    for tag, geo, ang in tile_cases(n):
        nz = geo.n_voxel[0]
        vol = torch.randn(geo.n_voxel, generator=gen, device="cuda")
        mask = dominant_axis_mask(ang)
        calls = []
        for dom, sub in (("x", ang[mask]), ("y", ang[~mask])):
            if not sub.size:
                continue
            a = torch.from_numpy(sub).cuda()
            v = vol
            if dom == "y":
                if geo.n_voxel[1] != geo.n_voxel[2]:
                    continue          # the rotation needs a square xy grid
                v = _rotate_vol_90(vol).contiguous()
                a = a - torch.pi / 2
            y = torch.randn((a.numel(),) + geo.n_detector, generator=gen,
                            device="cuda")
            for part, z0, z1 in (("full", 0, nz),
                                 ("slab", nz // 3, 2 * nz // 3 + 1)):
                slab = v[z0:z1].contiguous()
                t = f"{tag} {dom}-dominant {part}"
                calls.append((
                    "fp_ray", t,
                    lambda c, s=slab, a=a, z0=z0: fp_ray_cuda(s, geo, a, z0,
                                                              c),
                    lambda s=slab, a=a, z0=z0: fp_ray_plain(s, geo, a, z0)))
                calls.append((
                    "bp_matched", t,
                    lambda c, y=y, a=a, z0=z0, p=z1 - z0: bp_matched_cuda(
                        y, geo, a, z0, p, config=c),
                    lambda y=y, a=a, z0=z0, p=z1 - z0: bp_matched_plain(
                        y, geo, a, z0, p)))
        a = torch.from_numpy(ang).cuda()
        y = torch.randn((a.numel(),) + geo.n_detector, generator=gen,
                        device="cuda")
        for weight in ("fdk", "pmatched", "none"):
            for part, z0, p in (("full", 0, nz), ("slab", nz // 3,
                                                  nz // 3 + 1)):
                calls.append((
                    "bp_voxel", f"{tag} {weight} {part}",
                    lambda c, w=weight, z0=z0, p=p: bp_voxel_cuda(
                        y, geo, a, w, z0, p, c),
                    lambda w=weight, z0=z0, p=p: bp_voxel_plain(
                        y, geo, a, w, z0, p)))
        for name, t, kern, plain in calls:
            want = plain()
            ref = kern(0)
            errs = []
            for i in range(len(cfgs[name])):
                got = kern(i)
                if not torch.equal(got, ref):
                    raise AssertionError(
                        f"{name} {t}: configuration {i} {cfgs[name][i]} "
                        f"differs from configuration 0 in "
                        f"{int((got != ref).sum())} elements")
                err = (got - want).abs()
                bad = int((err > ATOL + RTOL * want.abs()).sum())
                if bad:
                    raise AssertionError(
                        f"{name} {t}: configuration {i}: {bad} elements "
                        f"outside rtol={RTOL} atol={ATOL} of the plain "
                        "version")
                errs.append(float(err.max()))
                n_checked += 1
            log(f"  {name} {t}: {len(errs)} configurations bit-equal to "
                f"configuration 0, max |err| vs plain {max(errs):.3g}")
        del vol
    torch.cuda.synchronize()
    log(f"  {n_checked} (configuration, case) pairs checked")


def _count_measures(autotune):
    """Wrap ``autotune._measure`` with a call counter (a list)."""
    calls = []
    inner = autotune._measure

    def counted(*args, **kw):
        calls.append(args[:2])
        return inner(*args, **kw)
    autotune._measure = counted
    return calls, inner


def phase_autotune(n: int, n_angles: int, ds, x2_plain, x_sart_plain,
                   device_bytes, smi):
    """The measured tile autotuner at the main path's sizes: tune fp,
    bp_matched and bp for nice(n) (the whole volume and the streamed slab
    height) and nice(n // 2), print each candidate's ms, bit check and the
    winner; time the default and the winner at the main path's shapes;
    save the table under chiprun_out/, reload it in a cleared tuner with
    no measurement; run CGLS and OS-SART (2 iterations) with tuning on,
    under the tuned table and under a table forcing each kernel's last
    configuration, bit-equal to the untuned runs; ``recon.main
    --autotune`` twice at n // 2 with REPRO_AUTOTUNE_CACHE set, the second
    run measuring nothing.  Returns the winners at N=n by kernel."""
    import torch
    from repro_torch.core.geometry import (ConeGeometry, circular_angles,
                                           dominant_axis_mask)
    from repro_torch.core.plan import plan
    from repro_torch.core.splitting import MemoryModel
    from repro_torch.kernels import autotune, build
    from repro_torch.kernels.bp_matched import bp_matched_cuda
    from repro_torch.kernels.bp_voxel import bp_voxel_cuda
    from repro_torch.kernels.fp_ray import fp_ray_cuda
    from repro_torch.launch import recon
    t_phase = time.perf_counter()
    log(f"== tile autotuner (card: {smi})")
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    geo = ConeGeometry.nice(n)
    half = ConeGeometry.nice(n // 2)
    slab = plan(geo, n_angles, 1, MemoryModel(device_bytes=device_bytes)
                ).backward.slab_ranges[0]
    slab_planes = slab[1] - slab[0]
    autotune.clear()
    autotune.enable(True)
    measures, inner = _count_measures(autotune)
    winners = {}
    tuned = {}
    try:
        for g, planes in ((geo, None), (geo, slab_planes), (half, None)):
            for kind in ("fp", "bp_matched", "bp"):
                pl = g.n_voxel[0] if kind == "bp" and planes is None \
                    else planes
                t0 = time.perf_counter()
                rep = autotune.tune(kind, g, planes=pl, repeats=3)
                log(f"  {rep.key}: " + "; ".join(
                    f"{c['config']} "
                    + ("refused (bit check)" if not c["bit_equal"] else
                       f"{c['seconds'] * 1e3:.3f} ms")
                    for c in rep.candidates)
                    + f" -> configuration {rep.winner} "
                    f"{rep.candidates[rep.winner]} "
                    f"({time.perf_counter() - t0:.2f} s)")
                if rep.refused:
                    raise AssertionError(f"{rep.key}: configurations "
                                         f"{rep.refused} failed the bit check")
                tuned[(kind, g.n_voxel[0], pl)] = rep
                if planes is None:
                    winners[(autotune.KERNELS[kind], g.n_voxel[0])] = \
                        rep.winner

        # default and winner at the main path's shapes (seeded inputs)
        log("  default vs tuned at the main path's shapes (median of 5):")
        times = {}
        for g in (geo, half):
            nn = g.n_voxel[0]
            gen = torch.Generator(device="cuda").manual_seed(7)
            ang = circular_angles(nn)
            a_x = torch.from_numpy(ang[dominant_axis_mask(ang)]).cuda()
            a_all = torch.from_numpy(ang).cuda()
            vol = torch.randn(g.n_voxel, generator=gen, device="cuda")
            y = torch.randn((a_x.numel(),) + g.n_detector, generator=gen,
                            device="cuda")
            p_all = torch.randn((a_all.numel(),) + g.n_detector,
                                generator=gen, device="cuda")
            kern = {"fp_ray": lambda c: fp_ray_cuda(vol, g, a_x, 0, c),
                    "bp_matched": lambda c: bp_matched_cuda(y, g, a_x,
                                                            config=c),
                    "bp_voxel": lambda c: bp_voxel_cuda(p_all, g, a_all,
                                                        "pmatched", config=c)}
            for name, k in kern.items():
                w = winners[(name, nn)]
                ms0 = cuda_ms(lambda: k(0), reps=5)
                msw = ms0 if w == 0 else cuda_ms(lambda: k(w), reps=5)
                times[(name, nn)] = (w, ms0, msw)
                log(f"    {name} N={nn}: configuration 0 {ms0:.3f} ms, "
                    f"tuned configuration {w} {msw:.3f} ms "
                    f"({build.configs(name)[w]})")
            del vol, y, p_all
            torch.cuda.empty_cache()

        # the table round trip: a cleared tuner reloads every winner
        path = os.path.join(out_dir, "autotune_table.json")
        autotune.save(path)
        before = autotune.table()
        autotune.clear()
        n_before = len(measures)
        if autotune.load(path) != len(before) or autotune.table() != before:
            raise AssertionError("the table did not round-trip")
        for (kind, nn, pl), rep in tuned.items():
            g = geo if nn == n else half
            got = autotune.get_blocks(kind, g, planes=pl)
            if got != rep.blocks:
                raise AssertionError(f"{rep.key}: reloaded {got}, tuned "
                                     f"{rep.blocks}")
        if len(measures) != n_before:
            raise AssertionError("the reloaded table measured again")
        log(f"  table saved ({len(before)} entries, {path}), reloaded in a "
            "cleared tuner: the same winners, no measurement")

        # tuned iterates are the untuned ones, bit for bit
        def iterate(alg, want, what):
            res = recon.reconstruct(alg, n=n, n_angles=n_angles, iters=2,
                                    mode="plain", device="cuda", dataset=ds,
                                    verbose=False, autotune=True)
            got = res.rec.cpu()
            if not torch.equal(got, want):
                raise AssertionError(
                    f"{alg} {what}: {int((got != want).sum())} voxels "
                    "differ from the untuned run")
            log(f"  {alg} N={n}, 2 iterations, {what}: bit-equal to the "
                f"untuned run ({[round(s, 3) for s in res.seconds]} s per "
                "iteration)")
        forced = {}
        for cfg in ("tuned table", "last configurations"):
            if cfg == "last configurations":
                with autotune._LOCK:
                    for key in list(autotune._TABLE):
                        kind = key[0]
                        last = len(autotune.configs(kind)) - 1
                        autotune._TABLE[key] = dict(
                            autotune.configs(kind)[last], config=last)
                        forced[kind] = last
                    autotune._FINGERPRINT += 1
                if autotune.get_blocks("fp", geo)["config"] == 0:
                    raise AssertionError("the forced table was not applied")
            n_before = len(measures)
            iterate("cgls", x2_plain, f"{cfg} {forced or ''}".strip())
            iterate("ossart", x_sart_plain, cfg)
            if len(measures) != n_before:
                raise AssertionError("the tuned runs measured again")

        # recon --autotune twice with the JSON cache: the second measures
        # nothing
        cache = os.path.join(out_dir, "recon_autotune.json")
        if os.path.exists(cache):
            os.remove(cache)
        old_env = os.environ.get("REPRO_AUTOTUNE_CACHE")
        os.environ["REPRO_AUTOTUNE_CACHE"] = cache
        try:
            rels, counts = [], []
            for run_i in range(2):
                autotune.clear()        # a new process: only the file is kept
                autotune.enable(None)
                n_before = len(measures)
                t0 = time.perf_counter()
                _, rel = recon.main(["--alg", "cgls", "--n", str(n // 2),
                                     "--angles", str(n // 2), "--iters", "2",
                                     "--autotune"])
                counts.append(len(measures) - n_before)
                rels.append(rel)
                log(f"  recon.main --autotune N={n // 2} run {run_i + 1}: "
                    f"rel_err {rel:.6f}, {counts[-1]} measurements, "
                    f"{time.perf_counter() - t0:.1f} s")
        finally:
            if old_env is None:
                os.environ.pop("REPRO_AUTOTUNE_CACHE", None)
            else:
                os.environ["REPRO_AUTOTUNE_CACHE"] = old_env
        if counts[0] == 0 or counts[1] != 0:
            raise AssertionError(f"recon --autotune measurements {counts}: "
                                 "the first run must measure, the second "
                                 "none")
        if rels[0] != rels[1]:
            raise AssertionError(f"recon --autotune rel_err {rels}")
    finally:
        autotune._measure = inner
        autotune.enable(None)
        autotune.clear()
    log(f"  phase_autotune took {time.perf_counter() - t_phase:.1f} s")
    return {name: times[(name, n)] for name in autotune.KERNELS.values()}, \
        {name: times[(name, n // 2)] for name in autotune.KERNELS.values()}


def _row(name, source, replaces, launches, err, ms, plain_ms, t_ops,
         t_bytes, tuned=(None, None)):
    """One kernel's entry of the ``kernels`` line; ``tuned``: the tile
    configuration the autotuner picked at the main path's size and its ms
    (None, None for a kernel without tiles)."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None, "tuned_config": tuned[0],
            "tuned_ms": tuned[1]}


def _time_kernel(name, kern, plain, rtol=RTOL, atol=ATOL, config=None):
    """(CUDA-event median of 5, plain ms once, max |err|, tuned) of one
    kernel; with a tuned ``config``, ``kern(config)`` is timed too and
    must give configuration 0's bits: tuned = (config, its ms)."""
    import torch
    run = kern if config is None else (lambda: kern(0))
    ms = cuda_ms(run, reps=5)
    plain_ms, want = once_ms(plain)
    got = run()
    err = check_close(f"{name} at main shapes", got, want, rtol, atol)
    tuned = (None, None)
    if config is not None:
        tuned = (config, ms if config == 0 else
                 cuda_ms(lambda: kern(config), reps=5))
        if not torch.equal(kern(config), got):
            raise AssertionError(f"{name}: tuned configuration {config} "
                                 "differs from configuration 0")
    del want, got
    torch.cuda.empty_cache()
    return ms, plain_ms, err, tuned


def phase_times(n: int, n_angles: int, ds, launches, per_iter, smi,
                tuned):
    """Each kernel at its main path's shapes: CUDA-event median, the plain
    version once, the error between them, and the bound; for the three
    tuned kernels also the autotuner's configuration at N=n (``tuned``:
    {kernel: config}) and its median.  The Joseph pair
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
            ("fp_ray", lambda c: fp_ray_cuda(vol, geo, a, 0, c),
             lambda: fp_ray_plain(vol, geo, a),
             "src/repro_torch/kernels/csrc/fp_ray.cu",
             "src/repro/kernels/fp_ray.py:62"),
            ("bp_matched", lambda c: bp_matched_cuda(y, geo, a, config=c),
             lambda: bp_matched_plain(y, geo, a),
             "src/repro_torch/kernels/csrc/bp_matched.cu",
             "src/repro/kernels/bp_matched.py:43")):
        ms, plain_ms, err, tun = _time_kernel(name, kern, plain,
                                              config=tuned[name])
        rows.append(_row(name, src, replaces, launches[name], err, ms,
                         plain_ms, t_ops, t_bytes, tun))
    # bp_voxel at FDK's shape: every angle, the whole volume
    a_all = torch.from_numpy(angles).cuda()
    p_all = proj.contiguous()
    pairs = nz * ny * nx * a_all.numel()
    v_ops = OPS_PER_PAIR_VOXEL * pairs / PEAK_FP32
    v_bytes = (vol_bytes + a_all.numel() * (nv * nu * 4 + 32)) / PEAK_BYTES
    ms, plain_ms, err, tun = _time_kernel(
        "bp_voxel",
        lambda c: bp_voxel_cuda(p_all, geo, a_all, "pmatched", config=c),
        lambda: bp_voxel_plain(p_all, geo, a_all, "pmatched"),
        config=tuned["bp_voxel"])
    rows.append(_row("bp_voxel", "src/repro_torch/kernels/csrc/bp_voxel.cu",
                     "src/repro/kernels/bp_voxel.py:32", launches["bp_voxel"],
                     err, ms, plain_ms, v_ops, v_bytes, tun))
    del p_all
    torch.cuda.empty_cache()
    # tv_grad over the whole volume: each voxel read once, written once
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(geo.n_voxel, generator=gen, device="cuda")
    ms, plain_ms, err, _ = _time_kernel(
        "tv_grad", lambda: tv_grad_cuda(x), lambda: tv_grad_plain(x),
        TV_RTOL, TV_ATOL)
    rows.append(_row("tv_grad", "src/repro_torch/kernels/csrc/tv_grad.cu",
                     "src/repro/kernels/tv_grad.py:35", launches["tv_grad"],
                     err, ms, plain_ms,
                     OPS_PER_VOXEL_TV * x.numel() / PEAK_FP32,
                     2 * vol_bytes / PEAK_BYTES))
    del x
    torch.cuda.empty_cache()
    log("  library: none for any of the four CT kernels. No single PyTorch "
        "call projects along rays or transposes that gather; for bp_voxel, "
        "grid_sample would need an A*Nz*Ny*Nx intermediate "
        f"({pairs * 4 / 1e9:.0f} GB here); the TV gradient's closed form "
        "has no single call (autograd of tv_value is many ops)")
    for row in rows:
        tun = ("" if row["tuned_config"] is None else
               f", tuned configuration {row['tuned_config']} "
               f"{row['tuned_ms']:.3f} ms")
        log(f"  {row['name']}: {row['ms']:.3f} ms (median of 5){tun}, plain "
            f"{row['plain_ms']:.1f} ms, bound {row['bound_ms']:.3f} ms "
            f"({row['bound_by']}), launches per iteration "
            + ", ".join(f"{path} {per[row['name']]}"
                        for path, per in per_iter.items()
                        if per[row['name']])
            + f", {row['launches']} on the main paths")
    return rows


PHASE_SECONDS = {}


def timed(name: str, fn, *args, **kw):
    """``fn(*args, **kw)``, its seconds logged and kept in PHASE_SECONDS
    (a phase run twice adds up)."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    dt = time.perf_counter() - t0
    PHASE_SECONDS[name] = PHASE_SECONDS.get(name, 0.0) + dt
    log(f"[{name}: {dt:.1f} s]")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="build and check the kernels only (CT at N=64)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the LM's weights and prompts")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    smi = timed("environment", phase_environment)
    timed("build", phase_build)
    if args.quick:
        timed("kernel_checks", phase_kernel_checks, 64, 48)
        timed("bp_voxel_checks", phase_bp_voxel_checks, 64, 48)
        timed("overflow_checks", phase_overflow_checks)
        timed("tile_checks", phase_tile_checks, 64)
        timed("tv_grad_checks", phase_tv_grad_checks, 64)
        timed("flash_checks", phase_flash_checks)
        log(f"quick run passed in {time.perf_counter() - t_start:.0f}s")
        return 0
    timed("kernel_checks", phase_kernel_checks, 128, 96)
    timed("bp_voxel_checks", phase_bp_voxel_checks, 128, 96)
    timed("overflow_checks", phase_overflow_checks)
    timed("tile_checks", phase_tile_checks, 64)
    timed("tv_grad_checks", phase_tv_grad_checks, 128)
    timed("flash_checks", phase_flash_checks)
    n, n_angles = 512, 512
    mib256 = 256 << 20
    ds, x2, c_cgls, per_cgls, x3 = timed("main_plain", phase_main_plain, n,
                                         n_angles, iters=3)
    # kept for phase_dist and phase_stream_devices, in host memory so that
    # the phases between hold what they held before
    x2, x3 = x2.cpu(), x3.cpu()
    c_cgls_stream, x_stream = timed("main_stream", phase_main_stream, n,
                                    n_angles, ds, x2, device_bytes=mib256)
    c_fdk = timed("fdk", phase_fdk, n, n_angles, ds)
    x_sart, c_sart, per_sart = timed("ossart_plain", phase_ossart_plain, n,
                                     n_angles, ds, iters=2)
    c_sart_stream = timed("ossart_stream", phase_ossart_stream, n, n_angles,
                          ds, x_sart, device_bytes=mib256)
    # kept for phase_autotune's tuned OS-SART, in host memory
    x_sart = x_sart.cpu()
    torch.cuda.empty_cache()
    first, c_asd, per_asd = timed("asd_pocs_plain", phase_asd_pocs_plain, n,
                                  n_angles, ds, iters=2)
    torch.cuda.empty_cache()
    c_asd_stream = timed("asd_pocs_stream", phase_asd_pocs_stream, n,
                         n_angles, ds, first, device_bytes=mib256)
    del first
    torch.cuda.empty_cache()
    c_fista, per_fista = timed("fista_plain", phase_fista_plain, n, n_angles,
                               ds, iters=2)
    torch.cuda.empty_cache()
    c_dist = timed("dist", phase_dist, n, n_angles, ds, x3, smi)
    del x3
    torch.cuda.empty_cache()
    c_dist_tv = timed("dist_tv", phase_dist_tv, n, smi)
    torch.cuda.empty_cache()
    c_stream_dev = timed("stream_devices", phase_stream_devices, n, n_angles,
                         ds, x2, device_bytes=mib256, smi=smi)
    torch.cuda.empty_cache()
    c_serve, solos = timed("serve", phase_serve, n, ds, x_stream,
                           device_bytes=mib256, smi=smi)
    del x_stream
    c_serve_durable, solo_durable, rel_single = timed(
        "serve_durable", phase_serve_durable, n // 2, smi)
    solos.update(solo_durable)
    c_fleet = timed("fleet", phase_fleet, n, ds, solos, rel_single, smi)
    del solos
    tuned, _ = timed("autotune", phase_autotune, n, n_angles, ds, x2, x_sart,
                     mib256, smi)
    del x2, x_sart
    torch.cuda.empty_cache()
    runs = (c_cgls, c_cgls_stream, c_fdk, c_sart, c_sart_stream, c_asd,
            c_asd_stream, c_fista, c_dist, c_dist_tv, c_stream_dev,
            c_serve, c_serve_durable, c_fleet)
    ct_kernels = ("fp_ray", "bp_matched", "bp_voxel", "tv_grad")
    launches = {k: sum(c[k]["launches"] for c in runs) for k in ct_kernels}
    rows = timed("times", phase_times, n, n_angles, ds, launches,
                 {"CGLS": per_cgls, "OS-SART": per_sart,
                  "ASD-POCS": per_asd, "FISTA": per_fista}, smi,
                 {name: t[0] for name, t in tuned.items()})
    del ds
    torch.cuda.empty_cache()
    log(f"  CT phases done at {time.perf_counter() - t_start:.0f}s; device "
        f"memory freed to {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    model = timed("lm_build", phase_lm_build, "gemma2-9b", args.seed, smi)
    prompts = _lm_tokens(args.seed, 2, 8192, model.cfg.vocab)
    gemma_launches = timed("prefill", phase_prefill, model,
                           prompts)["launches"]
    timed("decode", phase_decode, model, prompts, steps=32, slots=32768)
    log(f"== flash_attention times at the main path's shape (card: {smi})")
    flash_row = timed("flash_times", phase_flash_times, model, prompts,
                      gemma_launches)
    rows.append(flash_row)
    timed("lm_profile", phase_lm_profile, model, prompts, slots=32768)
    del model, prompts
    torch.cuda.empty_cache()
    log(f"== decode vs prefill at gemma2-9b's widths, 4 layers, float32, "
        f"window 32 (rtol {LM_RTOL}, atol {LM_ATOL})")
    timed("lm_consistency", phase_lm_consistency, "gemma2-9b", args.seed,
          n=96, at=(31, 32, 63, 95), window=32)
    zoo_launches, zoo_shapes, _ = timed("lm_zoo", phase_lm_zoo, args.seed,
                                        smi)
    train_xlstm = timed("train xlstm-350m", phase_train, "xlstm-350m",
                        args.seed, smi)
    train_lm = timed("train stablelm-1.6b", phase_train, "stablelm-1.6b",
                     args.seed, smi, profile=True)
    train_mesh = timed("train_sharded", phase_train_sharded, args.seed, smi)
    train_mx = timed("train_sharded_mla_xattn",
                     phase_train_sharded_mla_xattn, args.seed, smi)
    train_z = timed("train_sharded_zamba2", phase_train_sharded_zamba2,
                    args.seed, smi)
    trains = [train_xlstm, train_lm, train_mesh, train_z] + \
        list(train_mx.values())
    log(f"== flash_attention backward times at stablelm-1.6b's train shape "
        f"(card: {smi})")
    rows.append(timed("flash_bwd_times", phase_flash_bwd_times,
                      sum(t["bwd"] for t in trains)))
    train_fwd = sum(t["fwd"] for t in trains)
    flash_row["launches"] += zoo_launches + train_fwd
    for tag, timing in zoo_shapes.items():
        _add_flash_shape(flash_row, tag, timing)
    log(f"  flash_attention launches on the main paths: "
        f"{flash_row['launches']} (gemma2-9b {gemma_launches}, the zoo "
        f"{zoo_launches}, training {train_fwd}); backward launches "
        f"{rows[-1]['launches']}")
    log("phase seconds: " + ", ".join(f"{k} {v:.1f}"
                                      for k, v in PHASE_SECONDS.items()))
    log(f"total {time.perf_counter() - t_start:.0f}s")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
