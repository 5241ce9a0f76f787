"""Pinhole camera: batched ray generation in render space.

Counterpart of ``tpu_pathtracer/render/camera.py``.  Render space is world
translated so the camera sits at the origin; the scene builder bakes the
same translation into the geometry, so rays originate at 0.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Camera:
    """fov: vertical field of view in degrees."""
    position: tuple
    direction: tuple
    up: tuple
    fov: float
    width: int
    height: int

    def look_to(self, position, direction, up=(0.0, 1.0, 0.0)) -> "Camera":
        d = np.asarray(direction, np.float64)
        d = d / np.linalg.norm(d)
        u = np.asarray(up, np.float64)
        u = u / np.linalg.norm(u)
        return dataclasses.replace(self, position=tuple(np.asarray(position, np.float64)),
                                   direction=tuple(d), up=tuple(u))

    @property
    def rotation(self) -> np.ndarray:
        """camera-space -> render-space rotation (columns = right, up, -fwd)."""
        f = np.asarray(self.direction, np.float64)
        r = np.cross(f, np.asarray(self.up, np.float64))
        r = r / np.linalg.norm(r)
        u = np.cross(r, f)
        return np.stack([r, u, -f], axis=1)

    def generate_rays(self, pixel_xy, filter_uv):
        """pixel_xy: (R, 2) integer pixel coords; filter_uv: V2 of (R,) in
        [0, 1).  Box-filter jitter: the sample point is px + uv.
        Returns (origin V3, direction V3, weight (R,))."""
        from ..utils.vec import V3, normalize3

        x = pixel_xy[:, 0].to(torch.float32) + filter_uv.x
        y = pixel_xy[:, 1].to(torch.float32) + filter_uv.y
        aspect = self.width / self.height
        scale = float(np.tan(np.radians(self.fov) / 2.0))
        dx = (2.0 * x / self.width - 1.0) * aspect * scale
        dy = (1.0 - 2.0 * y / self.height) * scale
        d_cam = normalize3(V3(dx, dy, -torch.ones_like(dx)))
        m = [[float(v) for v in row]
             for row in np.asarray(self.rotation, np.float32)]
        d = normalize3(V3(
            m[0][0] * d_cam.x + m[0][1] * d_cam.y + m[0][2] * d_cam.z,
            m[1][0] * d_cam.x + m[1][1] * d_cam.y + m[1][2] * d_cam.z,
            m[2][0] * d_cam.x + m[2][1] * d_cam.y + m[2][2] * d_cam.z))
        z = torch.zeros_like(x)
        return V3(z, z, z), d, torch.ones_like(x)


def default_camera(width: int, height: int, fov: float = 45.0) -> Camera:
    return Camera(position=(0.0, 0.0, 0.0), direction=(0.0, 0.0, -1.0),
                  up=(0.0, 1.0, 0.0), fov=fov, width=width, height=height)
