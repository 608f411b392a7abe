"""Cone-beam CT geometry (TIGRE parameterisation).

Conventions
-----------
* The volume is a ``(Nz, Ny, Nx)`` array indexed ``vol[k, j, i]``; voxel
  ``(k, j, i)`` has world-space centre

      x = (i - (Nx-1)/2) * dx + off_x
      y = (j - (Ny-1)/2) * dy + off_y
      z = (k - (Nz-1)/2) * dz + off_z

* The source rotates in the xy-plane.  At gantry angle ``theta``:

      S(theta) = ( DSO * cos(theta),  DSO * sin(theta), 0 )

  The flat detector is perpendicular to the central ray at distance
  ``DSD - DSO`` behind the origin; pixel ``(iv, iu)`` has world position

      C(theta) + (iu - (Nu-1)/2 + off_u/du) * du * e_u + (iv - ...) * dv * e_v

  with ``e_u = (-sin, cos, 0)``, ``e_v = (0, 0, 1)`` and
  ``C = -(DSD - DSO) * (cos, sin, 0)``.

* Projections are ``(n_angles, Nv, Nu)`` arrays.

The class is a plain frozen dataclass of Python/numpy scalars: hashable, so
it keys the dispatch table and the plan memo, while ``angles`` stays a
tensor argument.

This module is the port's own copy of ``repro.core.geometry`` (numpy only);
``tests/test_torch_core.py`` guards it against drift from the reference.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np

Vec3 = Tuple[float, float, float]
Vec2 = Tuple[float, float]


@dataclasses.dataclass(frozen=True)
class ConeGeometry:
    """Circular cone-beam geometry.

    Distances are in mm (any consistent unit works).  The defaults model a
    standard micro-CT bench.
    """

    DSD: float = 1536.0          # source -> detector
    DSO: float = 1000.0          # source -> rotation axis
    n_voxel: Tuple[int, int, int] = (256, 256, 256)       # (Nz, Ny, Nx)
    s_voxel: Tuple[float, float, float] = (256.0, 256.0, 256.0)  # physical size
    n_detector: Tuple[int, int] = (256, 256)              # (Nv, Nu)
    s_detector: Tuple[float, float] = (409.6, 409.6)      # physical size
    off_origin: Vec3 = (0.0, 0.0, 0.0)                    # (z, y, x) offsets
    off_detector: Vec2 = (0.0, 0.0)                       # (v, u) offsets

    # ---- derived quantities ------------------------------------------------
    @property
    def d_voxel(self) -> Tuple[float, float, float]:
        return tuple(s / n for s, n in zip(self.s_voxel, self.n_voxel))

    @property
    def d_detector(self) -> Tuple[float, float]:
        return tuple(s / n for s, n in zip(self.s_detector, self.n_detector))

    @property
    def magnification(self) -> float:
        return self.DSD / self.DSO

    @property
    def fan_half_angle(self) -> float:
        """Maximum in-plane angle between a ray and the central ray (rad)."""
        half_u = 0.5 * self.s_detector[1] + abs(self.off_detector[1])
        return math.atan2(half_u, self.DSD)

    @property
    def cone_half_angle(self) -> float:
        half_v = 0.5 * self.s_detector[0] + abs(self.off_detector[0])
        return math.atan2(half_v, self.DSD)

    def __post_init__(self):
        if self.DSD <= self.DSO:
            raise ValueError("DSD must exceed DSO")
        # Joseph's method with a per-angle dominant axis requires every ray of
        # an angle to share that axis; cap the fan angle safely below 45 deg.
        if self.fan_half_angle > math.radians(40.0):
            raise ValueError(
                f"fan half-angle {math.degrees(self.fan_half_angle):.1f} deg "
                "too large for the per-angle dominant-axis Joseph projector "
                "(limit 40 deg); reduce detector width or increase DSD"
            )

    # ---- factory helpers ---------------------------------------------------
    @staticmethod
    def nice(n: int, n_detector: Tuple[int, int] | None = None) -> "ConeGeometry":
        """A well-conditioned N^3 volume / N^2 detector geometry (paper Fig 7)."""
        if n_detector is None:
            n_detector = (n, n)
        return ConeGeometry(
            DSD=1536.0,
            DSO=1000.0,
            n_voxel=(n, n, n),
            s_voxel=(256.0, 256.0, 256.0),
            n_detector=n_detector,
            s_detector=(409.6 * n_detector[0] / max(n_detector), 409.6),
        )

    def with_voxels(self, n_voxel: Tuple[int, int, int]) -> "ConeGeometry":
        return dataclasses.replace(self, n_voxel=n_voxel)

    # ---- world-space helpers (numpy; used to set up kernel constants) ------
    def voxel_centers_1d(self, axis: int) -> np.ndarray:
        """World coordinates of voxel centres along axis (0=z,1=y,2=x)."""
        n = self.n_voxel[axis]
        d = self.d_voxel[axis]
        off = self.off_origin[axis]
        return (np.arange(n) - (n - 1) / 2.0) * d + off

    def detector_coords_1d(self, axis: int) -> np.ndarray:
        """World (detector-plane) coordinates of pixel centres (0=v,1=u)."""
        n = self.n_detector[axis]
        d = self.d_detector[axis]
        off = self.off_detector[axis]
        return (np.arange(n) - (n - 1) / 2.0) * d + off


def circular_angles(n_angles: int, total: float = 2.0 * math.pi) -> np.ndarray:
    """Equally spaced gantry angles over ``total`` radians (endpoint excl.)."""
    return np.linspace(0.0, total, n_angles, endpoint=False).astype(np.float32)


def source_positions(geo: ConeGeometry, angles: np.ndarray) -> np.ndarray:
    """(n_angles, 3) source positions in world (x, y, z) order."""
    c, s = np.cos(angles), np.sin(angles)
    return np.stack([geo.DSO * c, geo.DSO * s, np.zeros_like(c)], axis=-1)


def dominant_axis_mask(angles: np.ndarray) -> np.ndarray:
    """True where the *central ray* of the angle is x-dominant.

    The central ray direction is -(cos, sin, 0); x-dominant iff
    |cos| >= |sin|.  Rays within the fan deviate by < fan_half_angle
    (asserted < 40 deg in the geometry), so with the 45 deg decision
    boundary every ray of an x-dominant angle has |d_x| within
    tan(5 deg) of dominance — Joseph quadrature remains well conditioned.
    """
    return np.abs(np.cos(angles)) >= np.abs(np.sin(angles))
