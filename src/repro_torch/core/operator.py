"""Unified CT operator: one object, execution modes, any kernel backend.

Port of ``repro/core/operator.py``.  The paper's point is that the *same*
algorithms run regardless of how the operators are executed ("TIGRE's
architecture is modular, thus all of the GPU code is independent from the
algorithm that uses it").  ``CTOperator`` exposes ``A`` (forward) and
``At`` (the exact adjoint, or a voxel-driven backprojection) and hides the
execution:

* ``mode="plain"``  -- the volume and projections live on the device;
* ``mode="stream"`` -- the paper's out-of-core executor: they live in host
  memory and each device of ``devices`` holds only what the plan stages
  (:mod:`repro_torch.core.streaming`);
* ``mode="dist"``   -- sharded over a device mesh, angles over ``data`` and
  z slabs over ``model`` (:mod:`repro_torch.core.distributed`); the volume
  and projections live on ``mesh.devices.flat[0]``.

Every mode is built from one memoized
:class:`~repro_torch.core.plan.ExecutionPlan` (``self.plan``) and draws its
kernels from the backend registry (:mod:`repro_torch.core.backend`).  The
operator runs on the card unless the caller passes ``device="cpu"`` (or a
mesh or devices on the CPU).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .backend import get_backend, resolve as resolve_backend
from .device import DeviceLike, as_f32, norm, resolve_device
from .geometry import ConeGeometry, dominant_axis_mask
from .plan import ExecutionPlan, plan as plan_execution
from .splitting import MemoryModel
from ..kernels.bp_matched import seg_chunk_for


class CTOperator:
    """``A`` / ``At`` with selectable execution mode and kernel backend.

    Parameters
    ----------
    geo, angles : geometry and the (static, numpy) gantry angles.
    mode : "plain" | "stream" | "dist".
    bp_weight : default backprojection weighting: "matched" (the exact
        adjoint of ``A``) or a voxel-driven weight, "fdk", "pmatched" or
        "none".
    mesh : a :class:`~repro_torch.launch.mesh.Mesh` with ("data",
        "model") axes, required for mode="dist".
    memory : memory model of the device (defaults to an 11 GiB device);
        ``mode="stream"`` splits the volume to fit it.
    devices : the devices a streamed run spreads over (mode="stream"; the
        plan is made for their count).
    backend : kernel backend name ("ref" | "cuda" | "auto"/None).
    plan : pre-computed :class:`~repro_torch.core.plan.ExecutionPlan`;
        derived (memoized) from the other arguments when omitted.
    device : where the kernels run; None means the card (and raises when
        there is none), ``"cpu"`` runs the plain versions on the CPU.  In
        dist mode the mesh's first device, in stream mode with ``devices``
        the first of them.
    """

    def __init__(self, geo: ConeGeometry, angles, mode: str = "plain",
                 bp_weight: str = "matched", mesh=None,
                 memory: Optional[MemoryModel] = None,
                 devices: Optional[Sequence[DeviceLike]] = None,
                 backend: Optional[str] = None,
                 plan: Optional[ExecutionPlan] = None,
                 device: DeviceLike = None):
        if mode not in ("plain", "stream", "dist"):
            raise ValueError(f"unknown mode {mode!r}")
        if mode == "dist" and mesh is None:
            raise ValueError("mode='dist' needs a mesh")
        self.geo = geo
        self.angles_np = np.asarray(angles, np.float32)
        self.mode = mode
        self.bp_weight = bp_weight
        self.mesh = mesh
        self.devices = (None if devices is None or mode != "stream"
                        else [resolve_device(d) for d in devices])
        if mode == "dist":
            device = mesh.devices.flat[0]
        elif self.devices:
            device = self.devices[0]
        self.device = resolve_device(device)
        self.backend_name = resolve_backend(backend, self.device)
        self._backend = get_backend(self.backend_name)
        self.angles = torch.from_numpy(self.angles_np).to(self.device)
        self.memory = memory or MemoryModel()
        # bp_matched's scratch goes in the headroom the memory model leaves
        self._seg_chunk = seg_chunk_for(geo, self.memory)
        self._xdom = dominant_axis_mask(self.angles_np)
        # one plan drives every mode: dist mode reads its reduction and
        # dominance-split decisions (n_devices = the mesh's model axis)
        if mode == "dist":
            from .distributed import (_grid, dist_backproject,
                                      dist_backproject_matched,
                                      dist_forward_project)
            self._data_axis_size, n_dev = _grid(mesh).shape
        elif self.devices:
            n_dev = len(self.devices)
        else:
            n_dev = 1
        self.plan = plan if plan is not None else \
            plan_execution(geo, len(self.angles_np), n_dev, self.memory)
        if mode == "dist":
            comm, name = self.plan.comm, self.backend_name
            self._a = dist_forward_project(mesh, geo, backend=name,
                                           comm=comm)
            self._at = {w: dist_backproject(mesh, geo, weight=w,
                                            backend=name)
                        for w in ("fdk", "pmatched", "none")}
            self._at["matched"] = dist_backproject_matched(
                mesh, geo, backend=name, seg_chunk=self._seg_chunk)

    @property
    def data_device(self) -> torch.device:
        """Where ``A``'s and ``At``'s inputs and outputs live: the device
        in plain mode, the mesh's first device in dist mode, host memory
        in stream mode (the volume need not fit on the device)."""
        return (torch.device("cpu") if self.mode == "stream"
                else self.device)

    def _angles(self, angles):
        """(numpy angles, dominance mask, device tensor) of a call."""
        if angles is None:
            return self.angles_np, self._xdom, self.angles
        a = np.asarray(torch.as_tensor(angles, dtype=torch.float32).cpu())
        return a, dominant_axis_mask(a), torch.from_numpy(a).to(self.device)

    def warmup(self, weight: Optional[str] = None) -> None:
        """Materialise this operator's dispatch entries, and build and load
        the CUDA kernels, ahead of first use."""
        weight = weight or self.bp_weight
        nz = self.geo.n_voxel[0]
        present = [xd for xd, any_ in ((True, self._xdom.any()),
                                       (False, (~self._xdom).any())) if any_]
        if self.mode == "plain":
            self._backend.fp_mixed(self.geo, self._xdom, self.device)
            if weight == "matched":
                self._backend.at_matched_mixed(self.geo, self._xdom,
                                               self._seg_chunk, self.device)
            else:
                self._backend.bp(self.geo, planes=nz, weight=weight,
                                 device=self.device)
        else:
            for xd in present:
                self._backend.fp(self.geo, xdom=xd, device=self.device)
            slabs = (self.plan.backward.slab_ranges if self.mode == "stream"
                     else [(0, nz // self.mesh.shape["model"])])
            for z0, z1 in slabs:
                if weight != "matched":
                    self._backend.bp(self.geo, planes=z1 - z0,
                                     weight=weight, device=self.device)
                    continue
                for xd in present:
                    self._backend.bp_matched(self.geo, planes=z1 - z0,
                                             xdom=xd,
                                             seg_chunk=self._seg_chunk,
                                             device=self.device)
        if self.backend_name == "cuda" and self.device.type == "cuda":
            from ..kernels import build
            build.build()
            for name in build.SOURCES:
                build.entry(name)

    def kernel_config(self) -> dict:
        """The backend's tile configurations for this geometry on this
        operator's device (``bp`` at a model shard's slab in dist mode)."""
        planes = self.geo.n_voxel[0]
        if self.mode == "dist":
            planes //= self.mesh.shape["model"]
        return self._backend.kernel_config(self.geo, planes=planes,
                                           device=self.device)

    # ---- forward ----------------------------------------------------------
    def A(self, vol, angles=None) -> torch.Tensor:
        a_np, mask, a_dev = self._angles(angles)
        if self.mode == "stream":
            from .streaming import stream_forward
            return stream_forward(vol, self.geo, a_np, self.plan,
                                  devices=self.devices or [self.device],
                                  backend=self.backend_name)
        if self.mode == "dist":
            from .distributed import pad_angles
            # the data axis takes a multiple of its size: pad with
            # duplicates and drop their (suffix) rows afterwards
            padded, valid = pad_angles(a_np, self._data_axis_size)
            out = self._a(vol, padded)
            return out if valid.all() else out[:len(a_np)]
        fp = self._backend.fp_mixed(self.geo, mask, self.device)
        return fp(as_f32(vol, self.device), a_dev)

    # ---- backward ---------------------------------------------------------
    def At(self, proj, angles=None,
           weight: Optional[str] = None) -> torch.Tensor:
        weight = weight or self.bp_weight
        a_np, mask, a_dev = self._angles(angles)
        if self.mode == "stream":
            from .streaming import stream_backward
            return stream_backward(proj, self.geo, a_np, self.plan,
                                   weight=weight,
                                   devices=self.devices or [self.device],
                                   backend=self.backend_name)
        if self.mode == "dist":
            from .distributed import pad_angles
            padded, valid = pad_angles(a_np, self._data_axis_size)
            proj = as_f32(proj, self.device)
            if not valid.all():
                # zero rows for the padded duplicates: BP is linear in the
                # projections, so they add nothing to the sums
                proj = torch.cat([proj, proj.new_zeros(
                    (len(padded) - len(a_np),) + tuple(self.geo.n_detector))])
            return self._at[weight](proj, padded)
        if weight != "matched":
            bp = self._backend.bp(self.geo, planes=self.geo.n_voxel[0],
                                  weight=weight, device=self.device)
            return bp(as_f32(proj, self.device), a_dev, 0)
        at = self._backend.at_matched_mixed(self.geo, mask, self._seg_chunk,
                                            self.device)
        return at(as_f32(proj, self.device), a_dev)

    # ---- spectral norm estimate (power iterations) -------------------------
    def norm_squared_est(self, n_iter: int = 8, seed: int = 0) -> float:
        """Estimate ||A||_2^2 with power iteration on A^T A (matched
        pair), from a start vector drawn by a seeded ``torch.Generator``."""
        dev = self.data_device
        gen = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randn(self.geo.n_voxel, generator=gen, device=dev)
        x = x / norm(x)
        lam = 1.0
        for _ in range(n_iter):
            y = self.At(self.A(x), weight="matched")
            lam = float(norm(y))
            x = y / (lam + 1e-30)
        return lam

    def subset_indices(self, subset_size: int):
        """Contiguous angle subsets for OS methods (paper SS3.2 OS-SART)."""
        n = len(self.angles_np)
        return [np.arange(s, min(s + subset_size, n))
                for s in range(0, n, subset_size)]
