"""Build the port's CUDA kernels at first use and load them with ctypes.

Each source under ``csrc/`` becomes one shared library with a plain C
interface, compiled by ``nvcc`` for Hopper::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o lib<name>-<digest>.so csrc/<name>.cu

(no ``--use_fast_math``: the kernels' tap arithmetic must stay IEEE fp32).
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
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
#: kernel name -> its source under csrc/ (each includes joseph_common.cuh)
SOURCES = {"fp_ray": "fp_ray.cu", "bp_matched": "bp_matched.cu"}
HEADERS = ("joseph_common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}
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
    for fname in (SOURCES[name],) + HEADERS:
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


#: ctypes signature shared by both C entries (see csrc/*.cu):
#: four pointers, n_angles, nz, ny, nx, nz_slab, nv, nu, ten floats
#: (dz dy dx dv du offz offy offv offu z0), device, stream
LAUNCH_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_float] * 10 + [ctypes.c_int, ctypes.c_void_p])
