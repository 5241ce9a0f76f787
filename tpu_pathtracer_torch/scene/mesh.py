"""Triangle meshes for the ported scenes (host-side numpy).

Counterpart of the parts of ``tpu_pathtracer/scene/mesh.py`` that the
ported scenes need: ``Mesh``, ``quad``, ``uv_sphere``, the procedural
``bunny`` and ``dragon``, and the tangent generation.  The JAX package also loads scanned OBJ assets when they are
present on disk; the port builds the procedural stand-ins only.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Mesh", "quad", "uv_sphere", "bunny", "dragon"]


@dataclasses.dataclass
class Mesh:
    """positions: (V, 3) f32; normals: (V, 3); uvs: (V, 2);
    indices: (T, 3) i32; tangents: (T, 3) per-triangle UV tangents."""
    positions: np.ndarray
    normals: np.ndarray
    uvs: np.ndarray
    indices: np.ndarray
    tangents: np.ndarray

    def transformed(self, matrix: np.ndarray) -> "Mesh":
        """Apply a 4x4 transform (normals via inverse transpose)."""
        m = np.asarray(matrix, np.float64)
        p = self.positions @ m[:3, :3].T + m[:3, 3]
        n_mat = np.linalg.inv(m[:3, :3]).T
        n = self.normals @ n_mat.T
        n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
        t = self.tangents @ m[:3, :3].T
        t /= np.maximum(np.linalg.norm(t, axis=-1, keepdims=True), 1e-20)
        return Mesh(p.astype(np.float32), n.astype(np.float32), self.uvs,
                    self.indices, t.astype(np.float32))


def _generate_tangents(positions, uvs, indices) -> np.ndarray:
    """Per-triangle tangents from UV derivatives; where |det| < 1e-6 or the
    result is not finite, a tangent of the geometric normal instead."""
    p0, p1, p2 = (positions[indices[:, k]] for k in range(3))
    e1, e2 = p1 - p0, p2 - p0
    if len(uvs):
        uv0, uv1, uv2 = (uvs[indices[:, k]] for k in range(3))
        d1, d2 = uv1 - uv0, uv2 - uv0
        det = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]
        safe_det = np.where(np.abs(det) < 1e-6, 1.0, det)
        t = (e1 * d2[:, 1:2] - e2 * d1[:, 1:2]) / safe_det[:, None]
        bad = (np.abs(det) < 1e-6) | ~np.isfinite(t).all(-1) | \
            (np.linalg.norm(t, axis=-1) < 1e-12)
    else:
        t = np.zeros_like(e1)
        bad = np.ones(len(e1), dtype=bool)

    gn = np.cross(e1, e2)
    gn_len = np.linalg.norm(gn, axis=-1, keepdims=True)
    gn = np.where(gn_len < 1e-12, np.array([0.0, 0.0, 1.0]), gn / np.maximum(gn_len, 1e-20))
    sign = np.where(gn[:, 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + gn[:, 2])
    b = gn[:, 0] * gn[:, 1] * a
    fb = np.stack([1.0 + sign * gn[:, 0] ** 2 * a, sign * b, -sign * gn[:, 0]], -1)

    t = np.where(bad[:, None], fb, t)
    t /= np.maximum(np.linalg.norm(t, axis=-1, keepdims=True), 1e-20)
    return t.astype(np.float32)


def _finalize(positions, normals, uvs, indices) -> Mesh:
    positions = np.asarray(positions, np.float32)
    indices = np.asarray(indices, np.int32).reshape(-1, 3)
    uvs = np.asarray(uvs, np.float32).reshape(-1, 2) if len(uvs) else np.zeros((len(positions), 2), np.float32)
    if normals is None or not len(normals):
        # area-weighted vertex normals
        p0, p1, p2 = (positions[indices[:, k]] for k in range(3))
        fn = np.cross(p1 - p0, p2 - p0)
        normals = np.zeros_like(positions)
        for k in range(3):
            np.add.at(normals, indices[:, k], fn)
        normals /= np.maximum(np.linalg.norm(normals, axis=-1, keepdims=True), 1e-20)
    normals = np.asarray(normals, np.float32)
    tangents = _generate_tangents(positions, uvs, indices)
    return Mesh(positions, normals, uvs, indices, tangents)


def quad(p00, p10, p11, p01, uv_scale: float = 1.0) -> Mesh:
    """Two-triangle quad with planar UVs; vertices counter-clockwise."""
    p = np.asarray([p00, p10, p11, p01], np.float32)
    n = np.cross(p[1] - p[0], p[3] - p[0])
    n = n / np.maximum(np.linalg.norm(n), 1e-20)
    normals = np.tile(n, (4, 1))
    uvs = np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32) * uv_scale
    indices = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    return _finalize(p, normals, uvs, indices)


def uv_sphere(radius: float = 1.0, n_theta: int = 32, n_phi: int = 64,
              center=(0.0, 0.0, 0.0)) -> Mesh:
    """Lat-long sphere with spherical UVs and exact normals."""
    th = np.linspace(0.0, np.pi, n_theta + 1)
    ph = np.linspace(0.0, 2.0 * np.pi, n_phi + 1)
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    x = np.sin(tt) * np.cos(pp)
    y = np.cos(tt)
    z = np.sin(tt) * np.sin(pp)
    pos = np.stack([x, y, z], -1).reshape(-1, 3)
    normals = pos.copy()
    pos = pos * radius + np.asarray(center)
    uvs = np.stack([pp / (2 * np.pi), 1.0 - tt / np.pi], -1).reshape(-1, 2)

    cols = n_phi + 1
    a = np.arange(n_theta)[:, None] * cols + np.arange(n_phi)[None, :]
    b, c, dd = a + 1, a + cols, a + cols + 1
    # per cell (i, j): triangles (a, c, b) then (b, c, d), in (i, j) order
    idx = np.stack([np.stack([a, c, b], -1), np.stack([b, c, dd], -1)],
                   axis=2).reshape(-1, 3)
    return _finalize(pos, normals, uvs, idx)


def _smooth_mesh(pos, indices, iters: int = 2):
    """Simple Laplacian smoothing used by the procedural bunny."""
    for _ in range(iters):
        acc = np.zeros_like(pos)
        cnt = np.zeros(len(pos))
        for a, b in ((0, 1), (1, 2), (2, 0)):
            np.add.at(acc, indices[:, a], pos[indices[:, b]])
            np.add.at(cnt, indices[:, a], 1.0)
            np.add.at(acc, indices[:, b], pos[indices[:, a]])
            np.add.at(cnt, indices[:, b], 1.0)
        pos = 0.5 * pos + 0.5 * acc / np.maximum(cnt[:, None], 1.0)
    return pos


def bunny(scale: float = 1.0, subdiv: int = 48) -> Mesh:
    """Procedural 'bunny': a unit sphere displaced by a few fixed
    low-frequency bumps (head, ears, tail), 4 * subdiv^2 triangles."""
    m = uv_sphere(1.0, subdiv, subdiv * 2)
    p = m.positions.copy()
    n = m.normals

    def bump(center, sharp, amp):
        c = np.asarray(center, np.float32)
        c = c / np.linalg.norm(c)
        d = (n @ c).clip(-1, 1)
        return amp * np.exp(sharp * (d - 1.0))

    disp = (0.25 * bump([0.0, 0.8, 0.6], 6.0, 1.0)       # head
            + 0.45 * bump([0.25, 1.0, 0.35], 40.0, 1.0)  # ear 1
            + 0.45 * bump([-0.25, 1.0, 0.35], 40.0, 1.0) # ear 2
            + 0.18 * bump([0.0, -0.2, -1.0], 3.0, 1.0)   # tail-ish
            - 0.10 * bump([0.0, -1.0, 0.0], 2.0, 1.0))   # flatten base
    p = p * (1.0 + disp[:, None])
    p[:, 1] *= 1.05
    p = _smooth_mesh(p, m.indices, 1) * (0.55 * scale)
    return _finalize(p, None, m.uvs, m.indices)


def dragon(scale: float = 1.0, n_u: int = 256, n_v: int = 24) -> Mesh:
    """Procedural 'dragon': a (2,3) torus knot swept with a varying-radius
    tube, 2 * n_u * n_v triangles."""
    u = np.linspace(0.0, 2.0 * np.pi, n_u, endpoint=False)
    cx = np.cos(2 * u) * (2.0 + np.cos(3 * u))
    cy = np.sin(3 * u) * 0.6
    cz = np.sin(2 * u) * (2.0 + np.cos(3 * u))
    c = np.stack([cx, cy, cz], -1) * 0.28

    # Frenet-ish frames along the curve
    t = np.roll(c, -1, 0) - np.roll(c, 1, 0)
    t /= np.maximum(np.linalg.norm(t, axis=-1, keepdims=True), 1e-12)
    ref = np.array([0.0, 1.0, 0.0])
    b = np.cross(t, ref)
    b /= np.maximum(np.linalg.norm(b, axis=-1, keepdims=True), 1e-12)
    nrm = np.cross(b, t)

    radius = 0.09 * (1.0 + 0.35 * np.cos(5 * u))[:, None]
    v = np.linspace(0.0, 2.0 * np.pi, n_v, endpoint=False)
    circ = np.stack([np.cos(v), np.sin(v)], -1)  # (n_v, 2)

    pos = (c[:, None, :]
           + radius[:, :, None] * (circ[None, :, 0:1] * nrm[:, None, :]
                                   + circ[None, :, 1:2] * b[:, None, :]))
    pos = pos.reshape(-1, 3) * scale

    uvs = np.stack(np.meshgrid(u / (2 * np.pi), v / (2 * np.pi), indexing="ij"),
                   -1).reshape(-1, 2)
    i = np.arange(n_u)[:, None]
    j = np.arange(n_v)[None, :]
    a = i * n_v + j
    bq = i * n_v + (j + 1) % n_v
    cq = ((i + 1) % n_u) * n_v + j
    dq = ((i + 1) % n_u) * n_v + (j + 1) % n_v
    # per quad (i, j): triangles (a, c, b) then (b, c, d), in (i, j) order
    idx = np.stack([np.stack([a, cq, bq], -1), np.stack([bq, cq, dq], -1)],
                   axis=2).reshape(-1, 3)
    return _finalize(pos, None, uvs, idx)
