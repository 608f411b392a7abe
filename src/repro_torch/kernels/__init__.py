"""Hand-written CUDA kernels of the port, each beside its plain version.

* :mod:`.fp_ray` — the Joseph forward projector A (``csrc/fp_ray.cu``);
* :mod:`.bp_matched` — its exact adjoint A^T (``csrc/bp_matched.cu``);
* :mod:`.build` — ``nvcc`` at first use, ``ctypes`` loading.

Importing this package builds and loads nothing.
"""

from __future__ import annotations

from typing import Dict

from .bp_matched import bp_matched_cuda, bp_matched_plain
from .fp_ray import fp_ray_cuda, fp_ray_plain

_LAUNCHES = {"fp_ray": fp_ray_cuda, "bp_matched": bp_matched_cuda}
_PLAIN = {"fp_ray": fp_ray_plain, "bp_matched": bp_matched_plain}


def reset_counters() -> None:
    """Set every kernel's launch count and plain-call count to 0."""
    for fn in _LAUNCHES.values():
        fn.launches = 0
    for fn in _PLAIN.values():
        fn.calls = 0


def counters() -> Dict[str, Dict[str, int]]:
    """``{kernel: {"launches": n, "plain_calls": m}}`` since the last
    :func:`reset_counters`."""
    return {name: {"launches": _LAUNCHES[name].launches,
                   "plain_calls": _PLAIN[name].calls}
            for name in _LAUNCHES}
