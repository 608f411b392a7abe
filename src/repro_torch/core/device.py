"""Where the port runs: the card unless the caller asks for the CPU."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the current CUDA device, and raises when there is none:
    an entry point never carries on quietly on the CPU.  ``"cpu"`` (or any
    explicit device) is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def as_f32(x, device: Optional[torch.device] = None) -> torch.Tensor:
    """``x`` (tensor, numpy array or sequence) as a float32 tensor on
    ``device`` (its own device when None); no copy when it already is."""
    t = torch.as_tensor(x, dtype=torch.float32)
    return t if device is None else t.to(device)


#: elements per float64 partial sum of :func:`norm` on the CPU (32 MB)
_NORM_CHUNK = 1 << 22


def norm(x: torch.Tensor) -> torch.Tensor:
    """Euclidean norm of all of ``x``: a float32 0-d tensor on its device.

    On the card, ``torch.linalg.vector_norm`` (a tree reduction, accurate
    to fp32 rounding).  On the CPU, float64 sums over chunks: there both
    ``torch.linalg.norm`` and ``torch.dot`` of a float32 tensor accumulate
    in float32, and over a 512^3 volume (which stream mode keeps in host
    memory) they are off by 0.96 % and 2.2e-5 (torch 2.13 CPU, uniform
    values); on the host of an H100 machine (torch 2.11) the dot product
    put a streamed ASD-POCS step's dp 1.3e-4 away from the card's."""
    v = x.reshape(-1)
    if v.device.type != "cpu":
        return torch.linalg.vector_norm(v)
    sq = torch.zeros((), dtype=torch.float64)
    for c in v.split(_NORM_CHUNK):
        c = c.double()
        sq += torch.dot(c, c)
    return torch.sqrt(sq).to(v.dtype)
