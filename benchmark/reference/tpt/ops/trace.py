"""Ray traversal of the reference: closest hit and occlusion for (R,)
ray lanes, in plain PyTorch.

A frozen copy of ``tpu_pathtracer_torch/ops/trace.py``'s scene queries
(``intersect_scene``, ``intersect_p_scene``) and of the triangle rows that
``pack_bvh`` derives, over a tree the reference builds itself
(``bvh_ref.build_bvh``, a Morton-ordered median split) and walks itself
(``bvh_ref.walk``): no CUDA kernel, no 4-wide rows.  The hit test is the
program's arithmetic (``bvh_ref.fast_test``, ``bvh_ref.precise_test``),
so a hit's t and barycentrics are those of the program's kernels; which of
two triangles at exactly the same t wins may differ, since the trees
differ.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..utils.vec import V3
from . import bvh_ref

BIG_T = 3.0e38


@dataclasses.dataclass(frozen=True)
class BVHArrays:
    """Flat binary BVH + triangle rows in BVH leaf order.

    nodes_f: (N, 12) f32 -- [c0.min, c0.max, c1.min, c1.max] per internal node
    nodes_i: (N, 2) i32  -- child refs; >= 0 internal node id, < 0 leaf with
                            payload v = -(ref+1): start = v >> 3, count = v & 7
    tri9:    (T, 9) f32  -- triangle vertices [p0 p1 p2]
    tri_m12: (T, 12) f32 -- unit-triangle affine rows [Mu bu Mv bv Mw bw]
    stack_depth: traversal stack slots the tree needs (depth + 2)
    n_big:   the first n_big triangle rows are outside the tree (tested by
             brute force)
    """
    nodes_f: torch.Tensor
    nodes_i: torch.Tensor
    tri9: torch.Tensor
    tri_m12: torch.Tensor
    stack_depth: int
    n_big: int = 0

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
        nodes_f=torch.from_numpy(nodes_f), nodes_i=torch.from_numpy(nodes_i),
        tri9=torch.from_numpy(np.ascontiguousarray(P.reshape(t, 9))),
        tri_m12=torch.from_numpy(np.ascontiguousarray(tri_m12)),
        stack_depth=depth + 2, n_big=int(getattr(fb, "n_big", 0)))


class Hit(NamedTuple):
    t: torch.Tensor        # (R,) hit distance (BIG_T if miss)
    tri: torch.Tensor      # (R,) i32 triangle id in leaf order (-1 if miss)
    b1: torch.Tensor       # (R,) barycentric of p1
    b2: torch.Tensor       # (R,) barycentric of p2
    hit: torch.Tensor      # (R,) bool


def _t_max_lanes(t_max, like):
    """t_max, a python float or a tensor, as float32 lanes of ``like``'s
    (R,) shape on its device; a float is filled in on the device (no host
    copy, so a CUDA graph can capture the query)."""
    if isinstance(t_max, torch.Tensor):
        return torch.broadcast_to(
            t_max.to(device=like.device, dtype=torch.float32), like.shape)
    return torch.full(like.shape, t_max, dtype=torch.float32,
                      device=like.device)


def pack_rays(ray_o, ray_d, t_max, active=None):
    """(7, R) float32 [ox oy oz dx dy dz t_max]; inactive rays get
    t_max = -1 so the kernels treat them as dead."""
    t0 = _t_max_lanes(t_max, ray_o.x)
    if active is not None:
        t0 = torch.where(active, t0, -1.0)
    return torch.stack([ray_o.x, ray_o.y, ray_o.z,
                        ray_d.x, ray_d.y, ray_d.z, t0]).to(torch.float32)


class _Detached(torch.autograd.Function):
    """A traversal kernel on the packed rays, cut out of autograd: its
    outputs carry no gradient and its backward returns none, so no
    gradient reaches the rays through a hit and the backward launches no
    kernel.  Counterpart of the JAX package's zero-cotangent custom VJPs
    (hits are fixed sample decisions); on the CPU it also keeps the plain
    versions' in-place writes out of the graph."""

    @staticmethod
    def forward(ctx, kernel, bvh, rays):
        out = kernel(bvh, rays)
        ctx.mark_non_differentiable(*(out if isinstance(out, tuple)
                                      else (out,)))
        return out

    @staticmethod
    def backward(ctx, *grads):
        return None, None, None


def intersect(bvh: BVHArrays, ray_o, ray_d, t_max=BIG_T, active=None,
              precise: bool = False) -> Hit:
    """Closest-hit query; ray_o/ray_d are V3 of (R,).  Inactive rays report
    a miss.  Detached: no gradient flows through it."""
    rays = pack_rays(ray_o, ray_d, t_max, active)
    return Hit(*_Detached.apply(bvh_ref.closest_hit_precise if precise
                                else bvh_ref.closest_hit, bvh, rays))


def intersect_p(bvh: BVHArrays, ray_o, ray_d, t_max, active=None,
                precise: bool = False):
    """Occlusion (any hit in (1e-6, t_max)) query; returns (R,) bool.
    Detached, as ``intersect``."""
    rays = pack_rays(ray_o, ray_d, t_max, active)
    return _Detached.apply(bvh_ref.any_hit_precise if precise
                           else bvh_ref.any_hit, bvh, rays)


def _inst_rays(group, o3: V3, d3: V3):
    """The rays in every instance's object space, stacked instance by
    instance -> (V3, V3) of (I*R,).  Directions stay unnormalized, so the
    ray parameter t is the same in object and render space."""
    m = group.inv

    def lin(v, c, off=None):
        out = (m[:, c:c + 1] * v.x + m[:, c + 1:c + 2] * v.y
               + m[:, c + 2:c + 3] * v.z)
        return out if off is None else out + m[:, off:off + 1]
    o = V3(lin(o3, 0, 9).reshape(-1), lin(o3, 3, 10).reshape(-1),
           lin(o3, 6, 11).reshape(-1))
    d = V3(lin(d3, 0).reshape(-1), lin(d3, 3).reshape(-1),
           lin(d3, 6).reshape(-1))
    return o, d


def _inst_active(group, o3: V3, d3: V3, t_bound, active):
    """Per-instance world-AABB cull of the render-space rays -> (I*R,)
    bool.  The slab arithmetic is the JAX package's: ``maximum`` and
    ``minimum`` propagate a NaN (0 * inf on an axis-parallel ray whose
    origin lies on a box plane), which then fails every compare."""
    n_inst = group.inv.shape[0]
    tn = torch.full((n_inst, o3.x.shape[0]), float("-inf"),
                    dtype=o3.x.dtype, device=o3.x.device)
    tf = torch.full_like(tn, float("inf"))
    for a, (oc, dc) in enumerate(((o3.x, d3.x), (o3.y, d3.y),
                                  (o3.z, d3.z))):
        inv = 1.0 / dc
        lo = (group.aabb_min[:, a:a + 1] - oc) * inv
        hi = (group.aabb_max[:, a:a + 1] - oc) * inv
        tn = torch.maximum(tn, torch.minimum(lo, hi))
        tf = torch.minimum(tf, torch.maximum(lo, hi))
    hit = (tn <= tf) & (tf > 0.0) & (tn < t_bound)
    if active is not None:
        hit = hit & active
    return hit.reshape(-1)


def intersect_scene(scene, ray_o, ray_d, t_max=BIG_T, active=None,
                    precise: bool = False) -> Hit:
    """Closest hit against the main soup and every instanced group.

    Each group is one launch over all its I x R lanes, bounded by the
    closest hit so far (never beyond ``t_max``), the lanes outside an
    instance's world AABB dead.  Instances are reduced in order with a
    strict ``<``; a group hit has the composite id ``base + i * Tc + tri``
    (``scene.types.InstancedGroup``)."""
    best = intersect(scene.bvh, ray_o, ray_d, t_max, active=active,
                     precise=precise)
    r = ray_o.x.shape[0]
    base = scene.bvh.tri9.shape[0]
    t0 = _t_max_lanes(t_max, ray_o.x)
    for g in scene.instanced:
        n_inst = g.inv.shape[0]
        tc = g.bvh.tri9.shape[0]
        # a miss carries t = BIG_T: the caller's bound caps it
        bound = torch.minimum(best.t, t0)
        o_all, d_all = _inst_rays(g, ray_o, ray_d)
        act = _inst_active(g, ray_o, ray_d, bound, active)
        h = intersect(g.bvh, o_all, d_all, bound.repeat(n_inst), active=act,
                      precise=precise)
        for i in range(n_inst):
            hi = Hit(*(x[i * r:(i + 1) * r] for x in h))
            better = hi.hit & (hi.t < best.t)
            best = Hit(t=torch.where(better, hi.t, best.t),
                       tri=torch.where(better, base + i * tc + hi.tri,
                                       best.tri),
                       b1=torch.where(better, hi.b1, best.b1),
                       b2=torch.where(better, hi.b2, best.b2),
                       hit=best.hit | better)
        base += n_inst * tc
    return best


def intersect_p_scene(scene, ray_o, ray_d, t_max, active=None,
                      precise: bool = False):
    """Occlusion against the main soup and every instanced group: one
    launch per group, even when none of its lanes is live; the lanes of
    rays already occluded go in inactive."""
    occ = intersect_p(scene.bvh, ray_o, ray_d, t_max, active=active,
                      precise=precise)
    t0 = _t_max_lanes(t_max, occ)
    for g in scene.instanced:
        n_inst = g.inv.shape[0]
        o_all, d_all = _inst_rays(g, ray_o, ray_d)
        act = _inst_active(g, ray_o, ray_d, t0, active) & ~occ.repeat(n_inst)
        o_i = intersect_p(g.bvh, o_all, d_all, t0.repeat(n_inst), active=act,
                          precise=precise)
        occ = occ | o_i.reshape(n_inst, -1).any(0)
    return occ
