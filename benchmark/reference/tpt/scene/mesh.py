"""Triangle meshes (host-side numpy): OBJ loading, procedural meshes,
tangent generation.

A frozen copy of ``tpu_pathtracer_torch/scene/mesh.py`` without the
bunny.  ``dragon()`` loads the scanned asset ``ASSET_DIR/dragon.min.obj``
(or ``dragon.obj``) when it is a real OBJ file, not a Git LFS pointer
stub, and otherwise builds the procedural stand-in (a swept torus knot).
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np

__all__ = ["Mesh", "load_obj", "quad", "uv_sphere", "dragon",
           "try_load_asset"]

# Real scanned assets are loaded from here when present (and not LFS
# pointer stubs): TPT_ASSET_DIR, as for the JAX package, else the
# checkout's assets/ directory (gitignored)
ASSET_DIR = os.environ.get("TPT_ASSET_DIR", os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "assets"))


def _is_lfs_stub(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            return f.read(32).startswith(b"version https://git-lfs")
    except OSError:
        return True


def try_load_asset(name: str, fit_height: float | None = None):
    """Load ``ASSET_DIR/name`` if it is a real OBJ (not an LFS stub).

    Returns the Mesh or None.  When ``fit_height`` is given the mesh is
    uniformly rescaled so its Y extent equals it, recentred in XZ with its
    base at y=0, the convention of the procedural stand-ins, so that a real
    scan drops into the same scene transforms."""
    path = os.path.join(ASSET_DIR, name)
    if not os.path.isfile(path) or _is_lfs_stub(path):
        return None
    m = load_obj(path)
    if fit_height is not None and len(m.positions):
        p = m.positions
        lo, hi = p.min(0), p.max(0)
        s = fit_height / max(hi[1] - lo[1], 1e-9)
        center = (lo + hi) * 0.5
        p = (p - [center[0], lo[1], center[2]]) * s
        m = dataclasses.replace(m, positions=p.astype(np.float32))
    return m


@dataclasses.dataclass
class Mesh:
    """positions: (V, 3) f32; normals: (V, 3); uvs: (V, 2);
    indices: (T, 3) i32; tangents: (T, 3) per-triangle UV tangents."""
    positions: np.ndarray
    normals: np.ndarray
    uvs: np.ndarray
    indices: np.ndarray
    tangents: np.ndarray

    @property
    def n_triangles(self) -> int:
        return len(self.indices)

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


def load_obj(path: str) -> Mesh:
    """Minimal OBJ parser: v/vt/vn and polygonal f, fan-triangulated;
    every distinct vertex token (``v``, ``v/vt``, ``v//vn``, ``v/vt/vn``,
    negative indices relative) becomes one vertex.  Without normals in the
    file the vertex normals are area-weighted."""
    vs, vts, vns = [], [], []
    out_pos, out_uv, out_nrm, out_idx = [], [], [], []
    cache: dict = {}

    def vertex(token: str) -> int:
        if token in cache:
            return cache[token]
        parts = token.split("/")
        vi = int(parts[0])
        vi = vi - 1 if vi > 0 else len(vs) + vi
        out_pos.append(vs[vi])
        if len(parts) > 1 and parts[1]:
            ti = int(parts[1])
            out_uv.append(vts[ti - 1 if ti > 0 else len(vts) + ti])
        else:
            out_uv.append((0.0, 0.0))
        if len(parts) > 2 and parts[2]:
            ni = int(parts[2])
            out_nrm.append(vns[ni - 1 if ni > 0 else len(vns) + ni])
        else:
            out_nrm.append((0.0, 0.0, 0.0))
        idx = len(out_pos) - 1
        cache[token] = idx
        return idx

    with open(path) as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            if t[0] == "v":
                vs.append(tuple(map(float, t[1:4])))
            elif t[0] == "vt":
                vts.append(tuple(map(float, t[1:3])))
            elif t[0] == "vn":
                vns.append(tuple(map(float, t[1:4])))
            elif t[0] == "f":
                ids = [vertex(tok) for tok in t[1:]]
                for k in range(1, len(ids) - 1):     # fan triangulation
                    out_idx.append((ids[0], ids[k], ids[k + 1]))

    normals = np.asarray(out_nrm, np.float32)
    if not len(normals) or float(np.abs(normals).sum()) == 0.0:
        normals = None
    return _finalize(out_pos, normals, out_uv, out_idx)


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


def dragon(scale: float = 1.0, n_u: int = 256, n_v: int = 24) -> Mesh:
    """'Dragon' hero mesh: the scan ``ASSET_DIR/dragon.min.obj``, else
    ``dragon.obj``, fitted to a height of 0.9 * scale when it is there,
    else procedural: a (2,3) torus knot swept with a varying-radius tube,
    2 * n_u * n_v triangles."""
    for name in ("dragon.min.obj", "dragon.obj"):
        real = try_load_asset(name, fit_height=0.9 * scale)
        if real is not None:
            return real
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
