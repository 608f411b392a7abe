"""Learning-rate schedules (pure functions of the step).

Port of ``repro/optim/schedules.py``.  ``step`` is an int or an integer
tensor (the optimizer state's int32 step); the value is a float32 0-d
tensor on the step's device, computed in float32 as the reference's jnp
computes it from an int32 step."""

from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.int32)


def linear_warmup(step, warmup_steps: int, peak: float) -> torch.Tensor:
    step = _step(step)
    return peak * torch.clamp((step + 1) / max(warmup_steps, 1), max=1.0)


def cosine_schedule(step, warmup_steps: int, total_steps: int, peak: float,
                    floor: float = 0.1) -> torch.Tensor:
    """Linear warmup then cosine decay to ``floor * peak``."""
    step = _step(step)
    warm = linear_warmup(step, warmup_steps, peak)
    t = torch.clip((step - warmup_steps)
                   / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(step < warmup_steps, warm, peak * cos)
