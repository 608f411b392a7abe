"""Measured tile autotuner for the CUDA projector kernels.

Port of ``repro/kernels/autotune.py``.  The reference tunes Pallas block
sizes (``fp_ray``'s and ``bp_matched``'s ``slab_planes``, ``bp_voxel``'s
``z_block`` / ``angle_chunk``): they set grid steps and VMEM windows,
which this card has neither of.  The port's counterparts are the tiles of
its CUDA kernels, each compiled in a small fixed set of configurations from
the repository's sources (:func:`configs`; configuration 0, the kernel's
default, is the tile each kernel had before it could be chosen):

* ``fp`` -> ``fp_ray``: rows a thread owns, warps a block;
* ``bp_matched`` -> ``bp_matched``: slab planes of a block, angles staged
  at a time (its ``seg_chunk`` is the budget's, not a tile);
* ``bp`` -> ``bp_voxel``: planes a thread sums, columns in y of a block.

This module times the configurations per

    (kind, card, geometry shape class)

on first use, memoises the winner in a process-wide table, and optionally
persists it as JSON so that later processes skip the measurement, as the
reference does:

* ``REPRO_AUTOTUNE=1`` (or :func:`enable`) turns tuning on; when off,
  :func:`get_blocks` returns configuration 0 and measures nothing.
* ``REPRO_AUTOTUNE_CACHE=/path/table.json`` loads the table on first use
  and rewrites it after every new measurement (``recon --autotune`` and
  ``tools/torch_autotune.py`` pre-bake it).  The file is the reference's
  (schema 1, ``kind|platform|nvox|ndet|planes`` keys); the platform is the
  card's name (``torch.cuda.get_device_name``), so an entry tuned on
  another card, or written by the reference for ``cpu`` / ``tpu``, is
  kept and written back untouched, never applied here.
* The floor is configuration 0: it is always a candidate, and another
  replaces it only when faster by :data:`MARGIN`.  A loaded entry that
  names a configuration this library does not have (or other knob values
  under its index) is refused, logged, and configuration 0 is used: the
  same kernel, as the reference clamps a stale entry to its heuristic.
* Tuning never changes a bit.  Before timing, :func:`tune` runs every
  candidate once on seeded inputs and compares its output with
  configuration 0's by ``torch.equal``; a candidate that differs in one
  bit is refused and reported, never entered in the table.  Jobs stolen,
  migrated or restored between pods with different tables stay bit-equal
  to their solo runs.

On a CPU device there is nothing to tune (the plain versions have no
tiles): :func:`get_blocks` returns configuration 0 and :func:`tune` raises.
The reference's ``pick_block`` / ``heuristic_blocks`` exist for Pallas's
divisor constraint, which the CUDA kernels do not have; the port has no
counterpart.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import logging
import os
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.device import DeviceLike, resolve_device

_SCHEMA = 1
_KINDS = ("fp", "bp", "bp_matched")
#: kind -> the kernel whose tile it picks
KERNELS = {"fp": "fp_ray", "bp": "bp_voxel", "bp_matched": "bp_matched"}
#: a candidate replaces configuration 0 only when at least this much faster
MARGIN = 0.03
#: angles of a measurement: the reference's x-dominant set
#: (``np.linspace(-0.3, 0.3, 16)``)
N_ANGLES = 16

_LOCK = threading.RLock()
_TABLE: Dict[Tuple, Dict[str, int]] = {}
_LOADED: set = set()          # cache paths already merged into _TABLE
_REFUSED: set = set()         # keys whose stale entry was logged
_ENABLED: Optional[bool] = None   # None -> consult REPRO_AUTOTUNE
_FINGERPRINT = 0              # bumped on any table/state mutation

log = logging.getLogger(__name__)


# --------------------------------------------------------------------------
# state

def enabled() -> bool:
    """True when measured tuning is active (env or :func:`enable`)."""
    if _ENABLED is not None:
        return _ENABLED
    return os.environ.get("REPRO_AUTOTUNE", "") not in ("", "0", "false")


def enable(on: Optional[bool]) -> None:
    """Force tuning on/off for this process (``None`` -> env-driven)."""
    global _ENABLED, _FINGERPRINT
    with _LOCK:
        _ENABLED = on
        _FINGERPRINT += 1


def cache_path() -> str:
    return os.environ.get("REPRO_AUTOTUNE_CACHE", "")


def fingerprint() -> int:
    """Monotone counter over table mutations.

    Folded into cache keys that must distinguish "same geometry, different
    tuned tiles" (the serving layer's operator cache)."""
    return _FINGERPRINT


def clear() -> None:
    global _FINGERPRINT
    with _LOCK:
        _TABLE.clear()
        _LOADED.clear()
        _REFUSED.clear()
        _FINGERPRINT += 1


def table() -> Dict[str, Dict[str, int]]:
    """Copy of the current table, JSON-keyed (for inspection/tests)."""
    with _LOCK:
        return {_key_str(k): dict(v) for k, v in _TABLE.items()}


# --------------------------------------------------------------------------
# configurations, keys + persistence

def configs(kind: str) -> Tuple[Dict[str, int], ...]:
    """Kind ``kind``'s tile configurations, as its kernel's library
    reports them (``{knob: value}`` each, index 0 the default).  Builds
    and loads the library: on the card only."""
    from . import build
    return build.configs(KERNELS[kind])


def _check_kind(kind: str) -> None:
    if kind not in _KINDS:
        raise ValueError(f"unknown autotune kind: {kind!r}")


def _platform(device: torch.device) -> str:
    """The table's platform: the card's name, or ``cpu``."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def shape_class(kind: str, geo, planes: Optional[int],
                device: DeviceLike = None) -> Tuple:
    """The memo key: geometry *shape*, not its physical scale, on the
    card ``device`` (default: the current one).

    Tiles are about blocks, threads and shared-memory windows, so only the
    integer shapes matter; two geometries with the same voxel/detector
    counts share a tuned entry."""
    return (kind, _platform(resolve_device(device)), tuple(geo.n_voxel),
            tuple(geo.n_detector),
            int(planes) if planes is not None else None)


def _key_str(key: Tuple) -> str:
    kind, plat, nvox, ndet, planes = key
    return "|".join([kind, plat,
                     ",".join(map(str, nvox)), ",".join(map(str, ndet)),
                     str(planes)])


def _key_parse(s: str) -> Optional[Tuple]:
    parts = s.split("|")
    if len(parts) != 5:
        return None
    kind, plat, nvox, ndet, planes = parts
    try:
        return (kind, plat, tuple(int(x) for x in nvox.split(",")),
                tuple(int(x) for x in ndet.split(",")),
                None if planes == "None" else int(planes))
    except ValueError:
        return None


def save(path: str) -> None:
    with _LOCK:
        doc = {"version": _SCHEMA, "entries": table()}
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
    os.replace(tmp, path)


def load(path: str) -> int:
    """Merge a persisted table; returns the number of entries taken.
    Entries of every platform are taken as they are (and written back by
    :func:`save`); only this card's are ever applied."""
    global _FINGERPRINT
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError):
        return 0
    if not isinstance(doc, dict) or doc.get("version") != _SCHEMA:
        return 0
    n = 0
    with _LOCK:
        for ks, cfg in (doc.get("entries") or {}).items():
            key = _key_parse(ks)
            if key is None or not isinstance(cfg, dict):
                continue
            _TABLE[key] = {k: int(v) for k, v in cfg.items()}
            n += 1
        if n:
            _FINGERPRINT += 1
    return n


def _maybe_load() -> None:
    p = cache_path()
    if p and p not in _LOADED:
        _LOADED.add(p)
        if os.path.exists(p):
            load(p)


def _checked(kind: str, key: Tuple, entry: Dict[str, int]) -> int:
    """The configuration a table entry names, or 0 when this library does
    not have it (an index out of range, other knob values under it, or no
    index at all): the entry is then refused, and logged once."""
    cfgs = configs(kind)
    i = entry.get("config")
    knobs = {k: v for k, v in entry.items() if k != "config"}
    if (i is not None and 0 <= i < len(cfgs)
            and all(cfgs[i].get(k) == v for k, v in knobs.items())):
        return i
    with _LOCK:
        first = key not in _REFUSED
        _REFUSED.add(key)
    if first:
        log.warning("autotune: refused %s -> %s: this %s library has no "
                    "such configuration (it has %s); using configuration 0",
                    _key_str(key), entry, KERNELS[kind], list(cfgs))
    return 0


# --------------------------------------------------------------------------
# measurement

@functools.lru_cache(maxsize=1)
def _launcher(kind: str, geo, planes: Optional[int], device: torch.device):
    """``f(config) -> output``: kind's kernel in tile configuration
    ``config`` on inputs seeded on ``device`` (a volume of ``planes``
    planes, or projections at :data:`N_ANGLES` x-dominant angles), made
    once for every candidate of a :func:`tune`."""
    from .bp_matched import bp_matched_cuda
    from .bp_voxel import bp_voxel_cuda
    from .fp_ray import fp_ray_cuda
    nz, ny, nx = geo.n_voxel
    p = nz if planes is None else int(planes)
    angles = torch.from_numpy(
        np.linspace(-0.3, 0.3, N_ANGLES).astype(np.float32)).to(device)
    gen = torch.Generator(device=device).manual_seed(0)
    if kind == "fp":
        vol = torch.randn((p, ny, nx), generator=gen, device=device)
        return lambda c: fp_ray_cuda(vol, geo, angles, 0, c)
    proj = torch.randn((N_ANGLES,) + tuple(geo.n_detector), generator=gen,
                       device=device)
    if kind == "bp_matched":
        return lambda c: bp_matched_cuda(proj, geo, angles, 0, p, config=c)
    return lambda c: bp_voxel_cuda(proj, geo, angles, "fdk", 0, p, c)


def _run(kind: str, geo, planes: Optional[int], cfg: Dict[str, int],
         device: torch.device) -> torch.Tensor:
    """The output of one call under ``cfg`` (for the bit check)."""
    return _launcher(kind, geo, planes, device)(cfg["config"])


def _measure(kind: str, geo, planes: Optional[int], cfg: Dict[str, int],
             device: torch.device, repeats: int) -> float:
    """Median seconds of one kernel call under ``cfg``, by CUDA events on
    the device's current stream, after one warm-up call."""
    call = _launcher(kind, geo, planes, device)
    stream = torch.cuda.current_stream(device)
    call(cfg["config"])
    times = []
    for _ in range(max(1, repeats)):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record(stream)
        call(cfg["config"])
        b.record(stream)
        b.synchronize()
        times.append(a.elapsed_time(b) / 1e3)
    return float(np.median(times))


@dataclasses.dataclass
class TuneReport:
    """What one :func:`tune` found: every candidate (its knobs,
    ``bit_equal`` to configuration 0, ``seconds`` when timed, None when
    refused) and the winner's index."""
    kind: str
    key: str
    winner: int
    candidates: List[Dict]

    @property
    def blocks(self) -> Dict[str, int]:
        return {"config": self.winner}

    @property
    def refused(self) -> List[int]:
        return [c["config"] for c in self.candidates if not c["bit_equal"]]


def tune(kind: str, geo, *, planes: Optional[int] = None,
         device: DeviceLike = None, repeats: int = 3) -> TuneReport:
    """Bit-check and time every configuration of ``kind`` on the card,
    memoise the winner (configuration 0 unless another is faster by
    :data:`MARGIN`) and return the report.  Raises on a CPU device."""
    global _FINGERPRINT
    _check_kind(kind)
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"nothing to tune on {dev}: the plain versions "
                         "have no tiles")
    key = shape_class(kind, geo, planes, dev)
    cands = [{"config": i, **k} for i, k in enumerate(configs(kind))]
    try:
        ref = _run(kind, geo, planes, cands[0], dev).clone()
        rows = [dict(cands[0], bit_equal=True)]
        for c in cands[1:]:
            same = bool(torch.equal(_run(kind, geo, planes, c, dev), ref))
            rows.append(dict(c, bit_equal=same))
        del ref
        for row, c in zip(rows, cands):
            row["seconds"] = (_measure(kind, geo, planes, c, dev, repeats)
                              if row["bit_equal"] else None)
    finally:
        _launcher.cache_clear()
    t0 = rows[0]["seconds"]
    best = min((r for r in rows if r["seconds"] is not None),
               key=lambda r: r["seconds"])
    winner = best["config"] if best["seconds"] < t0 * (1 - MARGIN) else 0
    for r in rows:
        if not r["bit_equal"]:
            log.warning("autotune: %s configuration %s refused: its output "
                        "differs from configuration 0's", _key_str(key),
                        r["config"])
    with _LOCK:
        _TABLE[key] = dict(cands[winner])
        _FINGERPRINT += 1
    p = cache_path()
    if p:
        try:
            save(p)
        except OSError:
            pass
    return TuneReport(kind, _key_str(key), winner, rows)


def get_blocks(kind: str, geo, *, planes: Optional[int] = None,
               device: DeviceLike = None,
               repeats: int = 3) -> Dict[str, int]:
    """``{"config": i}``, the tile configuration for a kernel ``kind`` on
    ``geo`` on ``device``.

    Configuration 0 when tuning is disabled or the device is the CPU;
    otherwise the memoised measured winner, measuring on first miss.
    Thread-safe; measurement happens outside the table lock (concurrent
    first-misses may both measure -- idempotent, last writer wins)."""
    _check_kind(kind)
    if not enabled():
        return {"config": 0}
    dev = resolve_device(device)
    if dev.type != "cuda":
        return {"config": 0}
    key = shape_class(kind, geo, planes, dev)
    with _LOCK:
        _maybe_load()
        hit = _TABLE.get(key)
    if hit is not None:
        return {"config": _checked(kind, key, hit)}
    return tune(kind, geo, planes=planes, device=dev,
                repeats=repeats).blocks


def warm(geo, *, planes: Optional[int] = None, kinds=_KINDS,
         device: DeviceLike = None,
         repeats: int = 3) -> Dict[str, Dict[str, int]]:
    """Pre-bake tuned entries for every ``kind`` on ``geo``."""
    return {k: get_blocks(k, geo, planes=planes, device=device,
                          repeats=repeats)
            for k in kinds}
