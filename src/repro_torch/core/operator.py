"""Unified CT operator: one object, execution modes, any kernel backend.

Port of ``repro/core/operator.py``.  The paper's point is that the *same*
algorithms run regardless of how the operators are executed ("TIGRE's
architecture is modular, thus all of the GPU code is independent from the
algorithm that uses it").  ``CTOperator`` exposes ``A`` (forward) and
``At`` (exact adjoint) and hides the execution:

* ``mode="plain"``  -- the volume and projections live on the device;
* ``mode="stream"`` -- the paper's out-of-core executor: they live in host
  memory and the device holds only what the plan stages
  (:mod:`repro_torch.core.streaming`).

``mode="dist"`` arrives with the distributed slice.  Both modes are built
from one memoized :class:`~repro_torch.core.plan.ExecutionPlan`
(``self.plan``) and draw their kernels from the backend registry
(:mod:`repro_torch.core.backend`).  The operator runs on the card unless
the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .backend import get_backend, resolve as resolve_backend
from .device import DeviceLike, as_f32, resolve_device
from .geometry import ConeGeometry, dominant_axis_mask
from .plan import ExecutionPlan, plan as plan_execution
from .splitting import MemoryModel


class CTOperator:
    """``A`` / ``At`` with selectable execution mode and kernel backend.

    Parameters
    ----------
    geo, angles : geometry and the (static, numpy) gantry angles.
    mode : "plain" | "stream".
    bp_weight : default backprojection weighting; only "matched" (the
        exact adjoint) is ported.
    memory : memory model of the device (defaults to an 11 GiB device);
        ``mode="stream"`` splits the volume to fit it.
    backend : kernel backend name ("ref" | "cuda" | "auto"/None).
    plan : pre-computed :class:`~repro_torch.core.plan.ExecutionPlan`;
        derived (memoized) from the other arguments when omitted.
    device : where the kernels run; None means the card (and raises when
        there is none), ``"cpu"`` runs the plain versions on the CPU.
    """

    def __init__(self, geo: ConeGeometry, angles, mode: str = "plain",
                 bp_weight: str = "matched",
                 memory: Optional[MemoryModel] = None,
                 backend: Optional[str] = None,
                 plan: Optional[ExecutionPlan] = None,
                 device: DeviceLike = None):
        if mode == "dist":
            raise NotImplementedError(
                "mode='dist' arrives with the distributed slice "
                "(ROADMAP Queue A 10)")
        if mode not in ("plain", "stream"):
            raise ValueError(f"unknown mode {mode!r}")
        self.geo = geo
        self.angles_np = np.asarray(angles, np.float32)
        self.mode = mode
        self.bp_weight = bp_weight
        self.device = resolve_device(device)
        self.backend_name = resolve_backend(backend, self.device)
        self._backend = get_backend(self.backend_name)
        self.angles = torch.from_numpy(self.angles_np).to(self.device)
        self.memory = memory or MemoryModel()
        self._xdom = dominant_axis_mask(self.angles_np)
        self.plan = plan if plan is not None else \
            plan_execution(geo, len(self.angles_np), 1, self.memory)

    @property
    def data_device(self) -> torch.device:
        """Where ``A``'s and ``At``'s inputs and outputs live: the device
        in plain mode, host memory in stream mode (the volume need not fit
        on the device)."""
        return self.device if self.mode == "plain" else torch.device("cpu")

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
        if weight != "matched":
            self._backend.bp(self.geo, planes=nz, weight=weight)   # raises
        if self.mode == "plain":
            self._backend.fp_mixed(self.geo, self._xdom)
            self._backend.at_matched_mixed(self.geo, self._xdom)
        else:
            for xd in present:
                self._backend.fp(self.geo, xdom=xd)
                for z0, z1 in self.plan.backward.slab_ranges:
                    self._backend.bp_matched(self.geo, planes=z1 - z0,
                                             xdom=xd)
        if self.backend_name == "cuda" and self.device.type == "cuda":
            from ..kernels import build
            from ..kernels.fp_ray import launch_entry
            build.build()
            for name in build.SOURCES:
                launch_entry(name)

    def kernel_config(self) -> dict:
        """The backend's tunable block-size config for this geometry."""
        return self._backend.kernel_config(self.geo,
                                           planes=self.geo.n_voxel[0])

    # ---- forward ----------------------------------------------------------
    def A(self, vol, angles=None) -> torch.Tensor:
        a_np, mask, a_dev = self._angles(angles)
        if self.mode == "stream":
            from .streaming import stream_forward
            return stream_forward(vol, self.geo, a_np, self.plan,
                                  device=self.device,
                                  backend=self.backend_name)
        fp = self._backend.fp_mixed(self.geo, mask)
        return fp(as_f32(vol, self.device), a_dev)

    # ---- backward ---------------------------------------------------------
    def At(self, proj, angles=None,
           weight: Optional[str] = None) -> torch.Tensor:
        weight = weight or self.bp_weight
        a_np, mask, a_dev = self._angles(angles)
        if self.mode == "stream":
            from .streaming import stream_backward
            return stream_backward(proj, self.geo, a_np, self.plan,
                                   weight=weight, device=self.device,
                                   backend=self.backend_name)
        if weight != "matched":
            bp = self._backend.bp(self.geo, planes=self.geo.n_voxel[0],
                                  weight=weight)                   # raises
            return bp(as_f32(proj, self.device), a_dev, 0)
        at = self._backend.at_matched_mixed(self.geo, mask)
        return at(as_f32(proj, self.device), a_dev)

    # ---- spectral norm estimate (power iterations) -------------------------
    def norm_squared_est(self, n_iter: int = 8, seed: int = 0) -> float:
        """Estimate ||A||_2^2 with power iteration on A^T A (matched
        pair), from a start vector drawn by a seeded ``torch.Generator``."""
        dev = self.data_device
        gen = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randn(self.geo.n_voxel, generator=gen, device=dev)
        x = x / torch.linalg.norm(x)
        lam = 1.0
        for _ in range(n_iter):
            y = self.At(self.A(x), weight="matched")
            lam = float(torch.linalg.norm(y))
            x = y / (lam + 1e-30)
        return lam

    def subset_indices(self, subset_size: int):
        """Contiguous angle subsets for OS methods (paper SS3.2 OS-SART)."""
        n = len(self.angles_np)
        return [np.arange(s, min(s + subset_size, n))
                for s in range(0, n, subset_size)]
