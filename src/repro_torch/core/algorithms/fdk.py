"""Feldkamp-Davis-Kress filtered backprojection.

Port of ``repro/core/algorithms/fdk.py``: cosine weighting, Ram-Lak (ramp)
filtering along the detector u axis with ``torch.fft``, and the
depth-weighted voxel backprojection (``weight="fdk"``).  The u axis is
rescaled to the virtual detector through the rotation axis (factor
DSO/DSD), as in TIGRE.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import DeviceLike, as_f32
from ..geometry import ConeGeometry
from ..operator import CTOperator


def _ramp_freq_response(pad: int, d: float) -> np.ndarray:
    """|freq| response of the discrete Ram-Lak kernel with spacing ``d``
    (a copy of the reference's, fdk.py:17-30).

    Built from the exact band-limited spatial kernel (Kak & Slaney eq. 61):
    h[0] = 1/(4 d^2), h[k odd] = -1/(pi k d)^2, h[k even] = 0, laid out
    circularly, then transformed.
    """
    k = np.fft.fftfreq(pad) * pad  # 0, 1, ..., -1 circular indices
    h = np.zeros(pad, np.float64)
    h[0] = 1.0 / (4.0 * d * d)
    ki = k.astype(np.int64)
    odd = np.abs(ki) % 2 == 1
    h[odd] = -1.0 / (np.pi * ki[odd] * d) ** 2
    return np.maximum(np.real(np.fft.fft(h)), 0.0)


def filter_projections(proj: torch.Tensor, geo: ConeGeometry,
                       angles=None) -> torch.Tensor:
    """Cosine-weight and ramp-filter projections (per angle, along u), on
    ``proj``'s device."""
    nv, nu = geo.n_detector
    dv, du = geo.d_detector
    offv, offu = geo.off_detector
    dev = proj.device
    us = (torch.arange(nu, dtype=torch.float32, device=dev)
          - (nu - 1) / 2.0) * du + offu
    vs = (torch.arange(nv, dtype=torch.float32, device=dev)
          - (nv - 1) / 2.0) * dv + offv
    # cosine weights on the *real* detector
    cosw = geo.DSD / torch.sqrt(geo.DSD ** 2 + us[None, :] ** 2
                                + vs[:, None] ** 2)
    # ramp on the virtual detector through the origin
    du_virt = du * geo.DSO / geo.DSD
    pad = 1 << int(np.ceil(np.log2(2 * nu)))
    H = torch.from_numpy(_ramp_freq_response(pad, du_virt)[: pad // 2 + 1]
                         .astype(np.float32)).to(dev)
    P = torch.fft.rfft(proj * cosw, n=pad, dim=-1)
    out = torch.fft.irfft(P * H, n=pad, dim=-1)[..., :nu]
    return out.float() * du_virt


def fdk(proj, geo: ConeGeometry, angles, op: Optional[CTOperator] = None,
        device: DeviceLike = None) -> torch.Tensor:
    """FDK reconstruction.  ``op`` supplies the backprojection (plain or
    streamed); by default a plain operator on the card, or on the CPU with
    ``device="cpu"``.

    Scale: f = (d_theta / 2) * sum_theta (DSO/(DSO-p))^2 * g_filtered, the
    discrete Feldkamp integral.
    """
    angles = np.asarray(angles, np.float32)
    if op is None:
        op = CTOperator(geo, angles, mode="plain", device=device)
    fp = filter_projections(as_f32(proj, op.data_device), geo, angles)
    d_theta = 2.0 * np.pi / len(angles)
    return op.At(fp, weight="fdk") * (d_theta / 2.0)
