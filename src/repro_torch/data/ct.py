"""CT projection-data generation (benchmarks / examples).

Port of ``repro/data/ct.py``: (volume, angles, projections) from the
analytic phantoms, so every reconstruction has a ground truth without
shipping measured data.  The projections come from :class:`CTOperator` on
the chosen device, so on the card they run the forward-projection kernel.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core import phantoms
from ..core.device import DeviceLike
from ..core.geometry import ConeGeometry, circular_angles
from ..core.operator import CTOperator


def make_ct_dataset(geo: ConeGeometry, n_angles: int,
                    phantom: str = "shepp", noise_rel: float = 0.0,
                    seed: int = 0, device: DeviceLike = None,
                    backend: Optional[str] = None):
    """Returns ``(vol, angles, proj)``: the phantom and its projections as
    float32 tensors on ``device`` (the card unless ``device="cpu"``), the
    angles as numpy.  ``noise_rel`` adds Gaussian noise of that relative
    magnitude, drawn by numpy from ``seed`` as the reference draws it."""
    angles = circular_angles(n_angles)
    if phantom == "shepp":
        vol_np = phantoms.shepp_logan(geo)
    elif phantom == "sphere":
        vol_np = phantoms.sphere(geo)
    else:
        raise ValueError(f"unknown phantom {phantom!r}")
    op = CTOperator(geo, angles, device=device, backend=backend)
    vol = torch.from_numpy(vol_np).to(op.device)
    proj = op.A(vol)
    if noise_rel > 0:
        rng = np.random.default_rng(seed)
        noise = rng.standard_normal(tuple(proj.shape)).astype(np.float32)
        proj = proj + (noise_rel * proj.std()) * torch.from_numpy(noise).to(
            proj.device)
    return vol, angles, proj
