"""Ray traversal front end: closest hit and occlusion for (R,) ray lanes.

Counterpart of ``tpu_pathtracer/ops/trace.py`` for the main triangle soup.
On a CUDA device the queries run the hand-written kernels of
``ops/cuda_trace.py`` (a one-ray-per-thread walk of the flat BVH); on the
CPU they run those kernels' plain PyTorch versions.  The JAX package's
TPU-only machinery (block culling, coherence sort, chunking past
MAX_DENSE_TRIS, the custom-vjp detachment) has no counterpart here.

Only the fast (unit-triangle transform) hit test is ported; ``precise``
is threaded explicitly and ``precise=True`` raises.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from . import cuda_trace

BIG_T = 3.0e38


@dataclasses.dataclass(frozen=True)
class BVHArrays:
    """Flat BVH + triangle rows in BVH leaf order.

    nodes_f: (N, 12) f32 -- [c0.min, c0.max, c1.min, c1.max] per internal node
    nodes_i: (N, 2) i32  -- child refs; >= 0 internal node id, < 0 leaf with
                            payload v = -(ref+1): start = v >> 3, count = v & 7
    tri9:    (T, 9) f32  -- triangle vertices [p0 p1 p2]
    tri_m12: (T, 12) f32 -- unit-triangle affine rows [Mu bu Mv bv Mw bw]:
                            the ray in triangle coordinates gives the plane hit
                            t = -o_w / d_w and barycentrics (u, v) of (p1, p2)
    stack_depth: traversal stack slots the tree needs (depth + 2)
    """
    nodes_f: torch.Tensor
    nodes_i: torch.Tensor
    tri9: torch.Tensor
    tri_m12: torch.Tensor
    stack_depth: int

    def to(self, device) -> "BVHArrays":
        return dataclasses.replace(
            self, nodes_f=self.nodes_f.to(device),
            nodes_i=self.nodes_i.to(device), tri9=self.tri9.to(device),
            tri_m12=self.tri_m12.to(device))


def _leaf_ref(start: int, count: int) -> int:
    return -(start * 8 + count) - 1


def pack_bvh(fb, P: np.ndarray) -> BVHArrays:
    """Pack a host FlatBVH + reordered triangle vertices (T, 3, 3).

    The numpy half of the JAX package's ``pack_bvh``: node rows, triangle
    rows and the unit-triangle transforms, without the TPU block layout."""
    n = fb.n_nodes
    count = np.asarray(fb.count)
    left = np.asarray(fb.left)
    right = np.asarray(fb.right)
    bmin = np.asarray(fb.bounds_min, np.float32)
    bmax = np.asarray(fb.bounds_max, np.float32)

    if count.max(initial=0) > 7:
        raise ValueError("leaf count must fit the 3-bit payload")
    refs = np.where(count > 0, -(left * 8 + count) - 1,
                    np.arange(n, dtype=np.int64)).astype(np.int32)

    nodes_f = np.zeros((max(n, 1), 12), np.float32)
    nodes_i = np.full((max(n, 1), 2), _leaf_ref(0, 0), np.int32)
    if count[0] > 0:
        # root is a leaf: pseudo-root whose second child is an empty box
        nodes_f[0, 0:3] = bmin[0]
        nodes_f[0, 3:6] = bmax[0]
        nodes_f[0, 6:9] = np.inf
        nodes_f[0, 9:12] = -np.inf
        nodes_i[0, 0] = _leaf_ref(int(left[0]), int(count[0]))
    else:
        internal = count == 0
        l, r = left[internal], right[internal]
        rows = np.nonzero(internal)[0]
        nodes_f[rows, 0:3] = bmin[l]
        nodes_f[rows, 3:6] = bmax[l]
        nodes_f[rows, 6:9] = bmin[r]
        nodes_f[rows, 9:12] = bmax[r]
        nodes_i[rows, 0] = refs[l]
        nodes_i[rows, 1] = refs[r]

    P = np.asarray(P, np.float32)
    t = len(P)
    depth = int(getattr(fb, "depth", 32))

    # unit-triangle affine transforms (f64 host precompute): M = A^-1 with
    # A's columns (p1-p0, p2-p0, e1 x e2); degenerate rows stay all-zero,
    # which gives t = NaN and never a hit
    V = P.astype(np.float64)
    e1 = V[:, 1] - V[:, 0]
    e2 = V[:, 2] - V[:, 0]
    nrm = np.cross(e1, e2)
    A = np.stack([e1, e2, nrm], axis=-1)
    ok = np.abs(np.linalg.det(A)) > 1e-30
    Minv = np.zeros((t, 3, 3))
    if ok.any():
        Minv[ok] = np.linalg.inv(A[ok])
    boff = -np.einsum("tij,tj->ti", Minv, V[:, 0])
    M4 = np.concatenate([Minv, boff[:, :, None]], axis=2)
    tri_m12 = M4.astype(np.float32).reshape(t, 12)

    return BVHArrays(
        nodes_f=torch.from_numpy(nodes_f),
        nodes_i=torch.from_numpy(nodes_i),
        tri9=torch.from_numpy(np.ascontiguousarray(P.reshape(t, 9))),
        tri_m12=torch.from_numpy(np.ascontiguousarray(tri_m12)),
        stack_depth=depth + 2,
    )


class Hit(NamedTuple):
    t: torch.Tensor        # (R,) hit distance (BIG_T if miss)
    tri: torch.Tensor      # (R,) i32 triangle id in leaf order (-1 if miss)
    b1: torch.Tensor       # (R,) barycentric of p1
    b2: torch.Tensor       # (R,) barycentric of p2
    hit: torch.Tensor      # (R,) bool


def pack_rays(ray_o, ray_d, t_max, active=None):
    """(7, R) float32 [ox oy oz dx dy dz t_max]; inactive rays get
    t_max = -1 so the kernels treat them as dead."""
    r = ray_o.x.shape[0]
    t0 = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32,
                                            device=ray_o.x.device), (r,))
    if active is not None:
        t0 = torch.where(active, t0, -1.0)
    return torch.stack([ray_o.x, ray_o.y, ray_o.z,
                        ray_d.x, ray_d.y, ray_d.z, t0]).to(torch.float32)


def _check_fast(precise: bool) -> None:
    if precise:
        raise NotImplementedError(
            "precise (watertight shear) traversal is not ported yet; "
            "use precise=False")


def intersect(bvh: BVHArrays, ray_o, ray_d, t_max=BIG_T, active=None,
              precise: bool = False) -> Hit:
    """Closest-hit query; ray_o/ray_d are V3 of (R,).  Inactive rays report
    a miss."""
    _check_fast(precise)
    t, tri, b1, b2, hit = cuda_trace.closest_hit(
        bvh.nodes_f, bvh.nodes_i, bvh.tri_m12, bvh.stack_depth,
        pack_rays(ray_o, ray_d, t_max, active))
    return Hit(t=t, tri=tri, b1=b1, b2=b2, hit=hit)


def intersect_p(bvh: BVHArrays, ray_o, ray_d, t_max, active=None,
                precise: bool = False):
    """Occlusion (any hit in (1e-6, t_max)) query; returns (R,) bool."""
    _check_fast(precise)
    return cuda_trace.any_hit(bvh.nodes_f, bvh.nodes_i, bvh.tri_m12,
                              bvh.stack_depth,
                              pack_rays(ray_o, ray_d, t_max, active))


def intersect_scene(scene, ray_o, ray_d, t_max=BIG_T, active=None,
                    precise: bool = False) -> Hit:
    """Closest hit against the scene's main soup (the port has no
    instanced groups)."""
    return intersect(scene.bvh, ray_o, ray_d, t_max, active=active,
                     precise=precise)


def intersect_p_scene(scene, ray_o, ray_d, t_max, active=None,
                      precise: bool = False):
    """Occlusion against the scene's main soup."""
    return intersect_p(scene.bvh, ray_o, ray_d, t_max, active=active,
                       precise=precise)
