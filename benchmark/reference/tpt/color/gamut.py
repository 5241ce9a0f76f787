"""Color gamuts: chromaticity-derived RGB<->XYZ 3x3 matrices.

Copy of ``tpu_pathtracer/color/gamut.py`` (numpy only).  Matrices are
derived from the primaries + white point: columns are the primaries' XYZ
scaled so that the white point maps to RGB = (1,1,1).  They stay float64
numpy; consumers take their entries as python floats.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np

__all__ = [
    "Gamut", "SRGB", "DISPLAY_P3", "P3_D65", "ADOBE_RGB", "REC709",
    "REC2020", "ACES_CG", "ACES_2065_1", "GAMUTS", "by_name",
]


def _xy_to_xyz(xy) -> np.ndarray:
    """xy chromaticity -> XYZ with Y=1 (ref: color/src/gamut.rs:15-27)."""
    x, y = float(xy[0]), float(xy[1])
    if y == 0.0:
        return np.zeros(3)
    return np.array([x / y, 1.0, (1.0 - x - y) / y])


def _rgb_to_xyz_matrix(r_xy, g_xy, b_xy, w_xy) -> np.ndarray:
    """Derive the RGB->XYZ matrix from primaries (ref: color/src/gamut.rs:29-40)."""
    m = np.stack([_xy_to_xyz(r_xy), _xy_to_xyz(g_xy), _xy_to_xyz(b_xy)], axis=1)
    w = _xy_to_xyz(w_xy)
    scale = np.linalg.solve(m, w)
    return m * scale[None, :]


@dataclasses.dataclass(frozen=True)
class Gamut:
    """A color gamut: primaries + white point with derived matrices."""
    name: str
    r_xy: tuple
    g_xy: tuple
    b_xy: tuple
    w_xy: tuple

    @property
    def rgb_to_xyz(self) -> np.ndarray:
        return _cached_matrices(self)[0]

    @property
    def xyz_to_rgb(self) -> np.ndarray:
        return _cached_matrices(self)[1]


@lru_cache(maxsize=None)
def _cached_matrices(g: Gamut):
    m = _rgb_to_xyz_matrix(g.r_xy, g.g_xy, g.b_xy, g.w_xy)
    return m, np.linalg.inv(m)


# Primaries/white points match the reference exactly
# (color/src/gamut.rs:50-53, 80-83, 110-113, 140-143, 171-174, 202-205).
SRGB = Gamut("srgb", (0.64, 0.33), (0.30, 0.60), (0.15, 0.06), (0.3127, 0.3290))
DISPLAY_P3 = Gamut("display_p3", (0.680, 0.320), (0.265, 0.690), (0.150, 0.060), (0.3127, 0.3290))
P3_D65 = DISPLAY_P3  # the reference's ColorP3D65 shares the DisplayP3 gamut
ADOBE_RGB = Gamut("adobe_rgb", (0.64, 0.33), (0.21, 0.71), (0.15, 0.06), (0.3127, 0.3290))
REC709 = Gamut("rec709", (0.64, 0.33), (0.30, 0.60), (0.15, 0.06), (0.3127, 0.3290))
REC2020 = Gamut("rec2020", (0.708, 0.292), (0.170, 0.797), (0.131, 0.046), (0.3127, 0.3290))
ACES_CG = Gamut("aces_cg", (0.713, 0.293), (0.165, 0.830), (0.128, 0.044), (0.32168, 0.33767))
ACES_2065_1 = Gamut("aces_2065_1", (0.7347, 0.2653), (0.0, 1.0), (0.0001, -0.0770), (0.32168, 0.33767))

GAMUTS = {
    g.name: g
    for g in (SRGB, DISPLAY_P3, ADOBE_RGB, REC709, REC2020, ACES_CG, ACES_2065_1)
}


def by_name(name: str) -> Gamut:
    return GAMUTS[name]
