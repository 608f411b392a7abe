"""Build the port's CUDA kernels at first use and load them with ctypes.

Each source under ``csrc/`` becomes one shared library with a plain C
interface, compiled by ``nvcc`` for Hopper::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o lib<name>-<digest>.so csrc/<name>.cu

(no ``--use_fast_math``: the kernels' arithmetic must stay IEEE fp32).
The libraries go to ``build/repro_torch_kernels/`` at the root of the
checkout, found from this file's location, never from the current
directory.  The file name carries a digest of the sources and flags, so a
changed source is rebuilt and an unchanged one is loaded as it is.  All
missing libraries are compiled in parallel, one ``nvcc`` each.

Nothing here runs at import: the CPU test rig has no ``nvcc``, and the
kernel modules import this one.  A missing ``nvcc`` or a failed build
raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
#: kernel name -> its source under csrc/
SOURCES = {"fp_ray": "fp_ray.cu", "bp_matched": "bp_matched.cu",
           "bp_voxel": "bp_voxel.cu", "tv_grad": "tv_grad.cu",
           "flash_attention": "flash_attention.cu",
           "flash_attention_bwd": "flash_attention_bwd.cu"}
#: kernel name -> the headers under csrc/ its source includes
HEADERS = {"fp_ray": ("joseph_common.cuh", "tile_configs.cuh"),
           "bp_matched": ("joseph_common.cuh", "tile_configs.cuh"),
           "bp_voxel": ("tile_configs.cuh",), "tv_grad": (),
           "flash_attention": ("hopper_common.cuh",),
           "flash_attention_bwd": ("hopper_common.cuh",)}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}
_ENTRIES: Dict[str, Callable[..., int]] = {}
_LOCK = threading.Lock()


def build_dir() -> Path:
    """``<checkout>/build/repro_torch_kernels`` (``build/`` is git-ignored)."""
    return CSRC.parents[3] / "build" / "repro_torch_kernels"


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found (neither on PATH nor at "
                       f"{default}): the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """Where ``name``'s library lives; the digest covers every input."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fname in (SOURCES[name],) + HEADERS[name]:
        h.update((CSRC / fname).read_bytes())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None,
          verbose: bool = False) -> Dict[str, float]:
    """Compile the missing libraries of ``names`` (default: all), one
    ``nvcc`` per source, all started together.  Returns the seconds each
    build took (0.0 for a library that was already there).  ``verbose``
    adds ``-Xptxas -v`` and prints the compiler's report (registers,
    shared memory, spills)."""
    names = list(SOURCES if names is None else names)
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    seconds = {}
    for name in names:
        dest = library_path(name)
        if dest.exists():
            seconds[name] = 0.0
            continue
        tmp = dest.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS]
        if verbose:
            cmd += ["-Xptxas", "-v"]
        cmd += ["-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, dest, time.monotonic())
    failed = []
    for name, (proc, tmp, dest, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.monotonic() - t0
        if verbose and log:
            print(f"[build] {name}:\n{log.rstrip()}")
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, dest)       # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if missing."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            lib = _LIBS[name] = ctypes.CDLL(str(path))
        return lib


#: the arguments both entries of the Joseph pair take after their own:
#: n_angles, nz, ny, nx, nz_slab, nv, nu, ten floats (dz dy dx dv du offz
#: offy offv offu z0), device, stream
JOSEPH_TAIL = ([ctypes.c_int] * 7 + [ctypes.c_float] * 10
               + [ctypes.c_int, ctypes.c_void_p])
#: csrc/fp_ray.cu's entry: vol, consts, xc, out, the tile config, then the
#: Joseph tail
FP_RAY_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] + JOSEPH_TAIL
#: csrc/bp_matched.cu's entry: proj, consts, xc, out, the gs scratch and
#: its angle count seg_chunk, the tile config, then the Joseph tail
BP_MATCHED_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                       + JOSEPH_TAIL)
#: ctypes signature of csrc/bp_voxel.cu's entry: proj, consts, out;
#: n_angles nz ny nx planes nv nu; fourteen floats (dz dy dx dv du offz
#: offy offx offv/dv offu DSO DSD DSO/DSD z_start); weight, the tile
#: config, device, stream
VOXEL_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
                  + [ctypes.c_float] * 14
                  + [ctypes.c_int] * 3 + [ctypes.c_void_p])
#: ctypes signature of csrc/tv_grad.cu's entry: vol, out; nz ny nx;
#: eps^2; device, stream
TV_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_float]
               + [ctypes.c_int, ctypes.c_void_p])
#: the arguments both flash entries take after their pointers: b hq hkv s d
#: dtype; scale; causal window; softcap; device, stream
FLASH_TAIL = ([ctypes.c_int] * 6 + [ctypes.c_float] + [ctypes.c_int] * 2
              + [ctypes.c_float] + [ctypes.c_int, ctypes.c_void_p])
#: ctypes signature of csrc/flash_attention.cu's entry: q, k, v, out, lse
#: and out_f32 (each null: not written), then the flash tail
FLASH_ARGTYPES = [ctypes.c_void_p] * 6 + FLASH_TAIL
#: csrc/flash_attention_bwd.cu's entry: q, k, v, out (float32), lse, d_out,
#: dq, dk, dv, the Di scratch, then the flash tail
FLASH_BWD_ARGTYPES = [ctypes.c_void_p] * 10 + FLASH_TAIL
ARGTYPES = {"fp_ray": FP_RAY_ARGTYPES, "bp_matched": BP_MATCHED_ARGTYPES,
            "bp_voxel": VOXEL_ARGTYPES, "tv_grad": TV_ARGTYPES,
            "flash_attention": FLASH_ARGTYPES,
            "flash_attention_bwd": FLASH_BWD_ARGTYPES}


def entry(name: str):
    """The C entry ``<name>_launch`` of kernel ``name``, typed with its
    own signature (every entry returns ``cudaGetLastError()``)."""
    fn = _ENTRIES.get(name)
    if fn is None:
        fn = getattr(load(name), f"{name}_launch")
        fn.argtypes = ARGTYPES[name]
        fn.restype = ctypes.c_int
        _ENTRIES[name] = fn
    return fn


_CONFIGS: Dict[str, Tuple[Dict[str, int], ...]] = {}


def configs(name: str) -> Tuple[Dict[str, int], ...]:
    """The tile configurations compiled into kernel ``name``'s library, in
    the order of their index (0: the default), each ``{knob: value}``, as
    its C query ``<name>_configs`` / ``<name>_config_knobs`` reports them
    (the library is built and loaded first); a kernel without the query
    has one tile and raises."""
    got = _CONFIGS.get(name)
    if got is None:
        lib = load(name)
        knobs_fn = getattr(lib, f"{name}_config_knobs", None)
        if knobs_fn is None:
            raise ValueError(f"{name} has no tile configurations")
        knobs_fn.restype = ctypes.c_char_p
        knobs = knobs_fn().decode().split()
        query = getattr(lib, f"{name}_configs")
        query.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        query.restype = ctypes.c_int
        n = query(None, 0)
        values = (ctypes.c_int * (n * len(knobs)))()
        query(values, n)
        got = _CONFIGS[name] = tuple(
            dict(zip(knobs, values[i * len(knobs):(i + 1) * len(knobs)]))
            for i in range(n))
    return got


def launch(name: str, device: torch.device, *args) -> None:
    """Call kernel ``name``'s C entry with ``args`` (its tensors and
    counts, then the device index and the stream), leaving the caller's
    current device as it was: the entries select their device with
    ``cudaSetDevice`` and do not put the previous one back.  Raise on a
    nonzero ``cudaGetLastError()``."""
    if device.index is None or device.index == torch.cuda.current_device():
        rc = entry(name)(*args)
    else:
        with torch.cuda.device(device):
            rc = entry(name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
