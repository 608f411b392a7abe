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
