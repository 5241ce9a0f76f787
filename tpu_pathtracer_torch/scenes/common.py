"""Shared scene-building pieces (counterpart of ``tpu_pathtracer/scenes/common.py``).

A [-2,2]x[0,4]x[-2,2] Cornell box (red left wall, green right wall, D65
area light in the ceiling), with the standard camera at (0, 3.5, 6)
looking (0,-1,-3).
"""
from __future__ import annotations

import numpy as np

from ..scene import mesh
from ..scene.builder import Emissive, Lambert, SceneBuilder
from ..spectrum.cie import illum_d6500

BOX_HALF = 2.0
BOX_HEIGHT = 4.0

CAMERA_POS = (0.0, 3.5, 6.0)
CAMERA_DIR = (0.0, -1.0, -3.0)


def translate(x, y, z) -> np.ndarray:
    m = np.eye(4)
    m[:3, 3] = (x, y, z)
    return m


def scale_translate(s, x, y, z) -> np.ndarray:
    m = np.eye(4) * s
    m[3, 3] = 1.0
    m[:3, 3] = (x, y, z)
    return m


def add_cornell_box(sb: SceneBuilder, white=(0.8, 0.8, 0.8),
                    left=(0.9, 0.0, 0.0), right=(0.0, 0.9, 0.0),
                    light_intensity: float = 10.0,
                    with_light: bool = True) -> None:
    """Box walls + ceiling area light."""
    s, h = BOX_HALF, BOX_HEIGHT
    m_white = sb.add_material(Lambert(albedo=white))
    m_left = sb.add_material(Lambert(albedo=left))
    m_right = sb.add_material(Lambert(albedo=right))

    def quad(p00, p10, p11, p01, mat):
        sb.add_mesh(mesh.quad(p00, p10, p11, p01), mat)

    quad([-s, 0, s], [s, 0, s], [s, 0, -s], [-s, 0, -s], m_white)      # floor
    quad([-s, h, -s], [s, h, -s], [s, h, s], [-s, h, s], m_white)      # ceiling
    quad([-s, 0, -s], [s, 0, -s], [s, h, -s], [-s, h, -s], m_white)    # back
    quad([-s, 0, -s], [-s, 0, s], [-s, h, s], [-s, h, -s], m_left)     # left
    quad([s, 0, s], [s, 0, -s], [s, h, -s], [s, h, s], m_right)        # right

    if with_light:
        m_light = sb.add_material(
            Emissive(spectrum=illum_d6500(), intensity=light_intensity))
        e = 0.7
        y = h - 0.02
        quad([-e, y, e], [e, y, e], [e, y, -e], [-e, y, -e], m_light)


def bunny_on_floor(scale: float = 1.6):
    """Procedural bunny resting on the floor at the box centre."""
    m = mesh.bunny()
    lo = m.positions.min(0)
    t = translate(0.0, -lo[1] * scale, 0.0) @ scale_translate(scale, 0, 0, 0)
    return m, t


def dragon_on_floor(scale: float = 1.4):
    m = mesh.dragon()
    lo = m.positions.min(0)
    t = translate(0.0, -lo[1] * scale, 0.0) @ scale_translate(scale, 0, 0, 0)
    return m, t
