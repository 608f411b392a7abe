"""Partition planner: the paper's "Check GPU memory / split" logic (Alg 1-2).

Given a problem (geometry + angle count), a device count, and a per-device
memory budget, the planner decides

* how angles are partitioned across devices (forward projection,
  paper SS2.1: "each GPU will compute a set of independent projections"),
* how many volumetric axial slabs the image must be split into so that
  ``slab + projection double-buffers (+ accumulation buffer)`` fits in the
  budget (paper: "the image is partitioned into same size volumetric axial
  slices stacks, as big as possible"),
* the angle chunk size ``N_angles`` per kernel launch.

The plan is pure Python / numpy (static).  This module is the port's own
copy of ``repro.core.splitting``; ``tests/test_torch_core.py`` holds its
plans equal to the reference's over a sweep of geometries and budgets.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import numpy as np

from .geometry import ConeGeometry

F32 = 4  # bytes


def even_splits(n: int, k: int) -> List[Tuple[int, int]]:
    """Split range(n) into k contiguous, maximally-even (start, stop) pieces."""
    if k <= 0:
        raise ValueError("k must be positive")
    base, extra = divmod(n, k)
    out, s = [], 0
    for i in range(k):
        e = s + base + (1 if i < extra else 0)
        out.append((s, e))
        s = e
    return out


@dataclasses.dataclass(frozen=True)
class MemoryModel:
    """Per-device memory budget in bytes (11 GiB = paper's GTX 1080 Ti)."""
    device_bytes: int = 11 * (1 << 30)
    # fraction usable for our buffers (leave headroom for code/fragmentation)
    usable_fraction: float = 0.95

    @property
    def usable(self) -> int:
        return int(self.device_bytes * self.usable_fraction)


@dataclasses.dataclass(frozen=True)
class ForwardPlan:
    """Execution plan for the forward projection (paper Alg 1 / Fig 3)."""
    n_devices: int
    angle_ranges: List[Tuple[int, int]]     # per device
    angle_chunk: int                        # N_angles per kernel launch
    n_slabs: int                            # image splits N_sp
    slab_ranges: List[Tuple[int, int]]      # z-plane ranges
    bytes_image_slab: int
    bytes_proj_buffers: int

    @property
    def needs_accumulation(self) -> bool:
        return self.n_slabs > 1


@dataclasses.dataclass(frozen=True)
class BackwardPlan:
    """Execution plan for the backprojection (paper Alg 2 / Fig 5)."""
    n_devices: int
    slab_ranges: List[Tuple[int, int]]      # all slabs, round-robin over devices
    device_of_slab: List[int]
    angle_chunk: int
    bytes_image_slab: int
    bytes_proj_buffers: int

    @property
    def n_slabs(self) -> int:
        return len(self.slab_ranges)


def _proj_bytes(geo: ConeGeometry, n_angles: int) -> int:
    nv, nu = geo.n_detector
    return n_angles * nv * nu * F32


def _slab_bytes(geo: ConeGeometry, planes: int) -> int:
    _, ny, nx = geo.n_voxel
    return planes * ny * nx * F32


def plan_forward(geo: ConeGeometry, n_angles: int, n_devices: int = 1,
                 memory: MemoryModel = MemoryModel(),
                 angle_chunk: int = 16) -> ForwardPlan:
    """Plan FP: angles across devices; z-slabs sized to the memory budget.

    Budget per device (paper SS2.1): image slab + 2 x angle_chunk projection
    double-buffer + (if split) 1 x angle_chunk accumulation buffer.  The
    chunk auto-shrinks (halving) when the buffers alone exceed the budget
    -- tiny simulated devices stay runnable.
    """
    nz = geo.n_voxel[0]
    angle_ranges = even_splits(n_angles, n_devices)
    max_chunk = max(1, math.ceil(n_angles / n_devices))
    angle_chunk = min(angle_chunk, max_chunk)

    # First try: whole volume resident (fast path, no accumulation buffer).
    buf2 = 2 * _proj_bytes(geo, angle_chunk)
    if _slab_bytes(geo, nz) + buf2 <= memory.usable:
        return ForwardPlan(n_devices, angle_ranges, angle_chunk, 1,
                           [(0, nz)], _slab_bytes(geo, nz), buf2)

    # Split: need a third (accumulation) buffer; maximise slab planes.
    while angle_chunk > 1 and \
            3 * _proj_bytes(geo, angle_chunk) >= memory.usable:
        angle_chunk //= 2
    buf3 = 3 * _proj_bytes(geo, angle_chunk)
    avail = memory.usable - buf3
    if avail < _slab_bytes(geo, 1):
        raise MemoryError(
            f"cannot fit projection buffers ({buf3/2**30:.3f} GiB) plus one "
            f"image plane in the device budget")
    planes = max(1, avail // _slab_bytes(geo, 1))
    n_slabs = math.ceil(nz / planes)
    slab_ranges = even_splits(nz, n_slabs)  # paper: same-size slabs
    return ForwardPlan(n_devices, angle_ranges, angle_chunk, n_slabs,
                       slab_ranges, _slab_bytes(geo, slab_ranges[0][1]
                                                - slab_ranges[0][0]), buf3)


def plan_backward(geo: ConeGeometry, n_angles: int, n_devices: int = 1,
                  memory: MemoryModel = MemoryModel(),
                  angle_chunk: int = 32) -> BackwardPlan:
    """Plan BP: image slabs across (and, if needed, queued within) devices.

    Paper SS2.2: the image is split into equal slabs allocated among GPUs; if
    ``total image + buffers`` exceeds the pooled GPU RAM, each device owns a
    queue of more than one slab.  Every device consumes the entire projection
    set through a 2 x angle_chunk double buffer.
    """
    nz = geo.n_voxel[0]
    angle_chunk = min(angle_chunk, n_angles)
    while angle_chunk > 1 and \
            2 * _proj_bytes(geo, angle_chunk) >= memory.usable:
        angle_chunk //= 2
    buf2 = 2 * _proj_bytes(geo, angle_chunk)
    avail = memory.usable - buf2
    if avail < _slab_bytes(geo, 1):
        raise MemoryError(
            f"cannot fit projection buffers ({buf2/2**30:.3f} GiB) plus one "
            f"image plane in the device budget")
    max_planes_per_device = max(1, avail // _slab_bytes(geo, 1))

    # Fewest equal slabs such that each device's largest slab fits.
    n_slabs = n_devices * max(1, math.ceil(
        math.ceil(nz / n_devices) / max_planes_per_device))
    n_slabs = min(n_slabs, nz)
    slab_ranges = even_splits(nz, n_slabs)
    device_of_slab = [i % n_devices for i in range(n_slabs)]
    return BackwardPlan(n_devices, slab_ranges, device_of_slab, angle_chunk,
                        _slab_bytes(geo, slab_ranges[0][1] - slab_ranges[0][0]),
                        buf2)


def paper_size_limits(memory: MemoryModel = MemoryModel(),
                      angle_chunk_fp: int = 16, angle_chunk_bp: int = 32,
                      min_slab_planes: int = 1) -> dict:
    """Reproduce the paper's SS4 napkin numbers: the largest N (N^3 volume,
    N^2 detector, N angles) each operator can handle under the budget."""
    out = {}
    for name, chunk, nbuf in (("forward", angle_chunk_fp, 3),
                              ("backward", angle_chunk_bp, 2)):
        n = 1024
        while True:
            proj = nbuf * chunk * n * n * F32
            slab = min_slab_planes * n * n * F32
            if proj + slab > memory.usable:
                break
            n += 1024
        out[name] = n - 1024
    return out
