"""Device meshes of one process.

Port of ``repro/launch/mesh.py``'s host meshes.  A :class:`Mesh` is a grid
of ``torch.device``s with named axes, ``("data", "model")`` or ``("pod",
"data", "model")``, as ``jax.sharding.Mesh`` is a grid of JAX devices: the
paper's and TIGRE's setting of one node, one host process and several
GPUs.  The distributed operators (:mod:`repro_torch.core.distributed`) run
each shard's work on a CUDA stream of its own and move data between
shards by explicit copies, so one device may appear several times: a mesh
of four ``cuda:0`` shards runs every exchange and reduction of a 2 x 2
mesh on one card, and a mesh of ``cpu`` shards runs them on the CPU.

The 16 x 16 production mesh of the reference (``make_production_mesh``,
a TPU v5e pod) belongs to its dry-run tools and has no counterpart here.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.device import DeviceLike


class Mesh:
    """A grid of ``torch.device``s with named axes.

    ``devices`` is a numpy object array of ``torch.device`` whose
    dimensions are named by ``axis_names``; ``shape`` maps each name to its
    size (as ``jax.sharding.Mesh.shape`` does) and ``size`` is the number
    of shards."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device grid for axes "
                             f"{tuple(axis_names)}")
        self.devices = devices
        self.axis_names: Tuple[str, ...] = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self):
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def _device_list(devices: Optional[Sequence[DeviceLike]]) -> List[torch.device]:
    """``devices`` as ``torch.device``s; None means every GPU present, and
    raises without one (a mesh never lands on the CPU unless asked)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass devices="
                               "['cpu', ...] to build a mesh on the CPU")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    out = [torch.device(d) for d in devices]
    if not out:
        raise ValueError("a mesh needs at least one device")
    return out


def _grid(devs: List[torch.device], shape: Tuple[int, ...]) -> np.ndarray:
    grid = np.empty(len(devs), dtype=object)
    grid[:] = devs
    return grid.reshape(shape)


def make_host_mesh(model_axis: int = 1,
                   devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """A ``(data, model)`` mesh over ``devices`` (default: every GPU
    present), ``model_axis`` shards along ``model``."""
    devs = _device_list(devices)
    n = len(devs)
    if model_axis < 1 or n % model_axis:
        raise ValueError(f"make_host_mesh: {n} devices do not split into a "
                         f"model axis of {model_axis}")
    return Mesh(_grid(devs, (n // model_axis, model_axis)),
                ("data", "model"))


def make_pod_mesh(pods: int, model_axis: int = 1,
                  devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """A mesh with a leading "pod" axis: ``pods`` equal groups of
    ``devices`` (default: every GPU present), each a (data, model) grid.
    :func:`pod_device_groups` splits it back into per-pod groups."""
    devs = _device_list(devices)
    n = len(devs)
    if pods < 1 or n % pods != 0:
        raise ValueError(f"make_pod_mesh: {n} local devices do not split "
                         f"into {pods} equal pods")
    per = n // pods
    if per % model_axis != 0:
        raise ValueError(f"make_pod_mesh: per-pod device count {per} is "
                         f"not divisible by model_axis={model_axis}")
    return Mesh(_grid(devs, (pods, per // model_axis, model_axis)),
                ("pod", "data", "model"))


def pod_device_groups(mesh: Mesh, pod_axis: str = "pod") -> List[list]:
    """Split a mesh's devices into per-pod groups (one group per index
    along ``pod_axis``); a mesh without a pod axis is a single pod."""
    if pod_axis not in mesh.axis_names:
        return [list(np.ravel(mesh.devices))]
    axis = mesh.axis_names.index(pod_axis)
    moved = np.moveaxis(mesh.devices, axis, 0)
    return [list(np.ravel(moved[p])) for p in range(moved.shape[0])]
