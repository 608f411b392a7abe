"""Kernel-backend registry: named projector implementations, one dispatch.

Port of ``repro/core/backend.py``.  The splitting plans
(:mod:`repro_torch.core.plan`) are independent of the algorithms *and* of
the kernels that execute them; this module is the kernel half of that
contract — a registry of named backends, each providing the same small
slab-operator surface:

* ``"ref"``  — the plain-PyTorch projectors in
  :mod:`repro_torch.core.projector` (runs everywhere; the parity oracle);
* ``"cuda"`` — the hand-written kernels in :mod:`repro_torch.kernels`
  (``fp_ray``, ``bp_matched``, ``bp_voxel``).  On a CPU tensor each kernel
  wrapper runs its plain version, so the backend's plumbing (rotation,
  adjoint pairing, dispatch) is exercised by the CPU tests too;
* ``"auto"`` — resolves from the device: ``"cuda"`` on a CUDA device,
  ``"ref"`` on the CPU.

Every executor (``CTOperator`` plain mode, the out-of-core streaming loops)
obtains its kernels from here.  Callables come from a process-wide dispatch
table keyed by (backend, kind, geometry, static args), with hit/miss
counters (:func:`dispatch_cache_info`, :func:`dispatch_cache_keys`).  The
cuda backend's static args include the tile configuration of each kernel
(:mod:`repro_torch.kernels.autotune`: configuration 0 unless tuning is on
and measured another on the ``device`` a backend method is given), so a
retuned table materialises new entries; every configuration gives the
same bits.

Exact-adjoint ("matched") operators follow the selected backend: the cuda
backend pairs the ray-driven FP with the matched kernel through a
``torch.autograd.Function`` (the counterpart of the reference's
``jax.custom_vjp``), while the ref backend takes ``torch.func.vjp`` of its
projector.
"""

from __future__ import annotations

import math
import threading
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .. import obs
from . import projector as proj_mod
from .device import DeviceLike, resolve_device
from .geometry import ConeGeometry

# --------------------------------------------------------------------------
# dispatch table
# --------------------------------------------------------------------------

class _DispatchTable:
    """Process-wide (key -> callable) map with hit/miss stats.

    Builders run outside the lock; a racing double-build keeps the first
    entry, so callers always share one callable per key.
    """

    def __init__(self):
        self._fns: Dict[tuple, Callable] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key: tuple, build: Callable[[], Callable]) -> Callable:
        with self._lock:
            fn = self._fns.get(key)
            if fn is not None:
                self.hits += 1
                obs.incr("dispatch_hits")
                return fn
            self.misses += 1
        obs.incr("dispatch_misses")
        with obs.span("compile", "compile", key=str(key[:2])):
            fn = build()
        with self._lock:
            return self._fns.setdefault(key, fn)

    def info(self) -> Dict[str, int]:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "currsize": len(self._fns)}

    def keys(self) -> tuple:
        with self._lock:
            return tuple(self._fns)

    def clear(self) -> None:
        with self._lock:
            self._fns.clear()
            self.hits = self.misses = 0


_TABLE = _DispatchTable()


def dispatch_cache_info() -> Dict[str, int]:
    """Hit/miss/size counters of the shared dispatch table."""
    return _TABLE.info()


def dispatch_cache_keys() -> tuple:
    """The dispatch table's current ``(backend, kind, geometry, ...)``
    keys: tests assert on *which* operators materialised."""
    return _TABLE.keys()


def clear_dispatch_cache() -> None:
    _TABLE.clear()


def _index_on(idx: np.ndarray, cache: dict, device: torch.device):
    """``idx`` as an index tensor on ``device``, uploaded once."""
    t = cache.get(device)
    if t is None:
        t = cache[device] = torch.as_tensor(idx, device=device)
    return t


# --------------------------------------------------------------------------
# backend interface + implementations
# --------------------------------------------------------------------------

class KernelBackend:
    """One named kernel implementation.

    The contract is three slab operators, shared through the dispatch
    table:

    * ``fp(geo, xdom=...)``               -> ``f(slab, angles, z0) -> proj``
      partial forward projection of the z planes ``[z0, z0+len(slab))``
      for a single-dominance angle set;
    * ``bp(geo, planes=..., weight=...)`` -> ``f(proj, angles, z0) ->
      slab`` — the voxel-driven backprojection (weight fdk / pmatched /
      none) of any angle set into the z planes ``[z0, z0+planes)``;
    * ``bp_matched(geo, planes=..., xdom=...)`` -> ``f(proj, angles, z0)
      -> slab`` — the *exact* adjoint of the slab forward projection.

    plus two full-volume conveniences for mixed-dominance angle sets
    (``fp_mixed`` / ``at_matched_mixed``), built on the slab operators.
    ``angles`` is always a float32 tensor on the data's device.
    """

    name = "?"

    def kernel_config(self, geo: ConeGeometry, *,
                      planes: Optional[int] = None,
                      device: DeviceLike = None) -> Dict[str, int]:
        """Tunable tile configurations this backend would run ``geo`` with
        on ``device`` (empty: the plain versions have no tiles)."""
        return {}

    def fp(self, geo: ConeGeometry, *, xdom: bool,
           device: DeviceLike = None) -> Callable:
        raise NotImplementedError

    def bp(self, geo: ConeGeometry, *, planes: int,
           weight: str, device: DeviceLike = None) -> Callable:
        raise NotImplementedError

    def bp_matched(self, geo: ConeGeometry, *, planes: int, xdom: bool,
                   seg_chunk: Optional[int] = None,
                   device: DeviceLike = None) -> Callable:
        """Exact slab adjoint: vjp of the ref slab FP (no scratch, so
        ``seg_chunk`` is not used)."""
        def build():
            def f(proj_chunk, angles, z0):
                zeros = torch.zeros((planes,) + tuple(geo.n_voxel[1:]),
                                    dtype=torch.float32,
                                    device=proj_chunk.device)
                _, vjp = torch.func.vjp(
                    lambda s: proj_mod.forward_project_joseph(
                        s, geo, angles, xdom=xdom, z0=z0), zeros)
                return vjp(proj_chunk)[0]
            return f
        return _TABLE.get(("ref", "bp_matched", geo, planes, xdom), build)

    def fp_mixed(self, geo: ConeGeometry, mask: np.ndarray,
                 device: DeviceLike = None) -> Callable:
        """Full forward projection ``f(vol, angles) -> proj`` for a static
        dominance ``mask`` (x-dominant entries True): each dominance subset
        runs the specialised slab FP and the results scatter back."""
        mask = np.asarray(mask, bool)
        key = (self.name, "fp_mixed", geo, mask.tobytes(),
               self._tiles(geo, device))

        def build():
            groups = [(self.fp(geo, xdom=xd, device=device), idx, {})
                      for xd, idx in ((True, np.nonzero(mask)[0]),
                                      (False, np.nonzero(~mask)[0]))
                      if idx.size]
            nv, nu = geo.n_detector

            def f(vol, angles):
                if len(groups) == 1:
                    return groups[0][0](vol, angles, 0)
                out = torch.zeros((len(mask), nv, nu), dtype=torch.float32,
                                  device=vol.device)
                for fp, idx, cache in groups:
                    ii = _index_on(idx, cache, vol.device)
                    out = out.index_copy(0, ii, fp(vol, angles[ii], 0))
                return out
            return f
        return _TABLE.get(key, build)

    def _tiles(self, geo: ConeGeometry, device: DeviceLike) -> tuple:
        """The tile configurations a dispatch key holds (none: the plain
        versions have no tiles)."""
        return ()

    def at_matched_mixed(self, geo: ConeGeometry, mask: np.ndarray,
                         seg_chunk: Optional[int] = None,
                         device: DeviceLike = None) -> Callable:
        """Exact adjoint ``f(proj, angles) -> vol`` of the mixed-dominance
        full FP (vjp of the ref FP here; the cuda backend sums its
        per-dominance matched kernels, with ``seg_chunk`` angles of
        scratch)."""
        mask = np.asarray(mask, bool)
        key = ("ref", "at_matched_mixed", geo, mask.tobytes())

        def build():
            ref_fp = get_backend("ref").fp_mixed(geo, mask)

            def f(proj, angles):
                zeros = torch.zeros(geo.n_voxel, dtype=torch.float32,
                                    device=proj.device)
                _, vjp = torch.func.vjp(lambda v: ref_fp(v, angles), zeros)
                return vjp(proj)[0]
            return f
        return _TABLE.get(key, build)


class RefBackend(KernelBackend):
    """Plain-PyTorch projectors (:mod:`repro_torch.core.projector`)."""

    name = "ref"

    def fp(self, geo: ConeGeometry, *, xdom: bool,
           device: DeviceLike = None) -> Callable:
        def build():
            if not xdom:
                proj_mod.check_rotation_trick(geo)

            def f(slab, angles, z0):
                return proj_mod.forward_project_joseph(
                    slab, geo, angles, xdom=xdom, z0=z0)
            return f
        return _TABLE.get(("ref", "fp", geo, xdom), build)

    def bp(self, geo: ConeGeometry, *, planes: int,
           weight: str, device: DeviceLike = None) -> Callable:
        def build():
            def f(proj, angles, z0):
                return proj_mod.backproject_voxel(
                    proj, geo, angles, weight=weight, z_start=z0,
                    z_planes=planes)
            return f
        return _TABLE.get(("ref", "bp", geo, planes, weight), build)


class _JosephFP(torch.autograd.Function):
    """The kernel pair as one differentiable op: forward launches
    ``fp_ray``, backward the matched ``bp_matched`` kernel — both replay
    identical fp32 tap weights, so anything that differentiates through
    this FP gets the exact adjoint.  ``tiles``: the two kernels' tile
    configurations, (fp_ray's, bp_matched's)."""

    @staticmethod
    def forward(ctx, slab, geo, angles, z0, tiles):
        from ..kernels.fp_ray import fp_ray
        ctx.geo, ctx.angles, ctx.z0, ctx.tiles = geo, angles, z0, tiles
        ctx.planes = slab.shape[0]
        return fp_ray(slab, geo, angles, z0, config=tiles[0])

    @staticmethod
    def backward(ctx, g):
        from ..kernels.bp_matched import bp_matched
        slab_bar = bp_matched(g.contiguous(), ctx.geo, ctx.angles, ctx.z0,
                              ctx.planes, config=ctx.tiles[1])
        return slab_bar, None, None, None, None


class CudaBackend(KernelBackend):
    """The hand-written CUDA kernels (:mod:`repro_torch.kernels.fp_ray`,
    :mod:`repro_torch.kernels.bp_matched`,
    :mod:`repro_torch.kernels.bp_voxel`).

    The matched weighting is native: ``fp`` is the autograd pair above,
    and ``bp_matched`` / ``at_matched_mixed`` hand out the matched kernel
    directly — no ref operator anywhere on the matched path.  The -90 deg
    rotation of the y-dominant angles stays outside the autograd pair
    (autograd transposes it), and the matched adjoint applies the inverse
    rotation after the kernel.
    """

    name = "cuda"

    def _blocks(self, kind: str, geo: ConeGeometry,
                planes: Optional[int] = None,
                device: DeviceLike = None) -> int:
        """Kernel ``kind``'s tile configuration for ``geo`` on ``device``
        (:func:`repro_torch.kernels.autotune.get_blocks`): 0 unless tuning
        is on and the device a card."""
        from ..kernels import autotune
        return autotune.get_blocks(kind, geo, planes=planes,
                                   device=device)["config"]

    def _tiles(self, geo: ConeGeometry, device: DeviceLike) -> tuple:
        """(fp_ray's, bp_matched's) configurations: the pair ``fp``'s
        autograd op launches (as the reference keys both blocks of its
        custom_vjp pair); ``bp_matched``'s is tuned at the whole volume."""
        return (self._blocks("fp", geo, None, device),
                self._blocks("bp_matched", geo, None, device))

    def kernel_config(self, geo: ConeGeometry, *,
                      planes: Optional[int] = None,
                      device: DeviceLike = None) -> Dict[str, int]:
        """The tile configuration of each kernel on ``geo`` (``bp`` at a
        slab of ``planes``) on ``device``, with the configuration's knob
        values on a card, and whether tuning is on."""
        from ..kernels import autotune
        chosen = {"fp": self._blocks("fp", geo, None, device),
                  "bp_matched": self._blocks("bp_matched", geo, None,
                                             device),
                  "bp": self._blocks("bp", geo, planes, device)}
        cfg = {f"{kind}.config": i for kind, i in chosen.items()}
        if device is not None and resolve_device(device).type == "cuda":
            for kind, i in chosen.items():
                for knob, v in autotune.configs(kind)[i].items():
                    cfg[f"{kind}.{knob}"] = v
        cfg["autotuned"] = bool(autotune.enabled())
        return cfg

    def fp(self, geo: ConeGeometry, *, xdom: bool,
           device: DeviceLike = None) -> Callable:
        tiles = self._tiles(geo, device)

        def build():
            if not xdom:
                proj_mod.check_rotation_trick(geo)

            def f(slab, angles, z0):
                if not xdom:
                    slab = proj_mod._rotate_vol_90(slab)
                    angles = angles - math.pi / 2.0
                return _JosephFP.apply(slab, geo, angles, z0, tiles)
            return f
        return _TABLE.get(("cuda", "fp", geo, xdom, tiles), build)

    def bp(self, geo: ConeGeometry, *, planes: int,
           weight: str, device: DeviceLike = None) -> Callable:
        """The voxel-driven kernel: one launch over all the angles passed,
        whatever their dominance."""
        config = self._blocks("bp", geo, planes, device)

        def build():
            from ..kernels.bp_voxel import bp_voxel

            def f(proj, angles, z0):
                return bp_voxel(proj, geo, angles, weight, z0, planes,
                                config)
            return f
        return _TABLE.get(("cuda", "bp", geo, planes, weight, config), build)

    def bp_matched(self, geo: ConeGeometry, *, planes: int, xdom: bool,
                   seg_chunk: Optional[int] = None,
                   device: DeviceLike = None) -> Callable:
        """Native exact slab adjoint: the matched kernel replaying the ray
        kernel's fp32 weights (no ref vjp involved), with ``seg_chunk``
        angles of scratch (see :func:`~repro_torch.kernels.bp_matched.
        seg_chunk_for`)."""
        config = self._blocks("bp_matched", geo, None, device)

        def build():
            from ..kernels.bp_matched import bp_matched
            if not xdom:
                proj_mod.check_rotation_trick(geo)

            def f(proj_chunk, angles, z0):
                ang = angles if xdom else angles - math.pi / 2.0
                slab = bp_matched(proj_chunk, geo, ang, z0, planes,
                                  seg_chunk, config)
                if not xdom:
                    # adjoint (= inverse) of the -90 deg scene rotation
                    slab = proj_mod._unrotate_vol_90(slab).contiguous()
                return slab
            return f
        return _TABLE.get(("cuda", "bp_matched", geo, planes, xdom,
                           seg_chunk, config), build)

    def at_matched_mixed(self, geo: ConeGeometry, mask: np.ndarray,
                         seg_chunk: Optional[int] = None,
                         device: DeviceLike = None) -> Callable:
        """Exact adjoint of the mixed-dominance FP from the per-dominance
        matched kernels: the dominance groups partition the angle rows,
        so summing each group's slab adjoint is the full A^T."""
        mask = np.asarray(mask, bool)
        config = self._blocks("bp_matched", geo, None, device)
        key = ("cuda", "at_matched_mixed", geo, mask.tobytes(), seg_chunk,
               config)

        def build():
            nz = geo.n_voxel[0]
            groups = [(self.bp_matched(geo, planes=nz, xdom=xd,
                                       seg_chunk=seg_chunk, device=device),
                       idx, {})
                      for xd, idx in ((True, np.nonzero(mask)[0]),
                                      (False, np.nonzero(~mask)[0]))
                      if idx.size]

            def f(proj, angles):
                if len(groups) == 1:
                    return groups[0][0](proj, angles, 0)
                out = None
                for bm, idx, cache in groups:
                    ii = _index_on(idx, cache, proj.device)
                    part = bm(proj.index_select(0, ii), angles[ii], 0)
                    out = part if out is None else out + part
                return out
            return f
        return _TABLE.get(key, build)


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------

_REGISTRY: Dict[str, KernelBackend] = {}


def register_backend(backend: KernelBackend) -> KernelBackend:
    """Add a named backend (replacing any previous holder of the name)."""
    _REGISTRY[backend.name] = backend
    return backend


register_backend(RefBackend())
register_backend(CudaBackend())


def available_backends() -> tuple:
    """Registered backend names plus the ``"auto"`` alias."""
    return tuple(sorted(_REGISTRY)) + ("auto",)


def resolve(name: Optional[str], device: DeviceLike = None) -> str:
    """Canonical backend name: ``None`` / ``"auto"`` pick from the device
    (``"cuda"`` on a CUDA device, ``"ref"`` on the CPU; no device means
    the card, and raises without one); unknown names raise."""
    name = name or "auto"
    if name == "auto":
        return "cuda" if resolve_device(device).type == "cuda" else "ref"
    if name not in _REGISTRY:
        raise ValueError(f"unknown kernel backend {name!r} "
                         f"(have {available_backends()})")
    return name


def get_backend(name: Optional[str] = None,
                device: DeviceLike = None) -> KernelBackend:
    """Backend instance for ``name`` (default: resolve from ``device``)."""
    return _REGISTRY[resolve(name, device)]
