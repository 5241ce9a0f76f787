"""Ray traversal front end: closest hit and occlusion for (R,) ray lanes.

Counterpart of ``tpu_pathtracer/ops/trace.py``: queries of one BVH, and the
scene queries over the main triangle soup and its instanced groups (each
group one launch over all its instances' lanes).  On a CUDA device the
queries run the hand-written kernels of
``ops/cuda_trace.py``: K1, K3 and K2p walk the 4-wide tree of
``widen_bvh``, a warp's lanes sharing the work of its rays (K2p ends a ray
for all its lanes at its first hit), K2 walks the binary tree, one thread
a ray; on the CPU they run those kernels' plain PyTorch versions.  The JAX package's
TPU-only machinery (block culling, coherence sort, chunking past
MAX_DENSE_TRIS) has no counterpart here; the custom-VJP detachment of a
hit is ``_Detached``.

``precise`` is an explicit argument of every query (there is no global
switch and no environment default): False runs the fast unit-triangle
transform test (K1, K2), True the watertight Dekker-compensated shear test
(K3, K2p), whose hits are those of the JAX package's CPU BVH walk.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..utils.math import intersect_triangle
from ..utils.vec import V3
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
    nodes_w: (N4, 32) f32 -- the same tree, 4 wide, one 128-byte row per
                            node (``widen_bvh``); read by K1, K3 and K2p
    tri9p:   (T, 12) f32 -- tri9's floats, one padded 16-byte group per
                            axis (``pad_tri9``); read by the precise
                            kernels
    wide_depth: levels of the 4-wide tree
    """
    nodes_f: torch.Tensor
    nodes_i: torch.Tensor
    tri9: torch.Tensor
    tri_m12: torch.Tensor
    stack_depth: int
    nodes_w: torch.Tensor
    tri9p: torch.Tensor
    wide_depth: int

    def to(self, device) -> "BVHArrays":
        return dataclasses.replace(
            self, nodes_f=self.nodes_f.to(device),
            nodes_i=self.nodes_i.to(device), tri9=self.tri9.to(device),
            tri_m12=self.tri_m12.to(device),
            nodes_w=self.nodes_w.to(device), tri9p=self.tri9p.to(device))

    @classmethod
    def from_binary(cls, nodes_f, nodes_i, tri9, tri_m12,
                    stack_depth: int) -> "BVHArrays":
        """From the numpy arrays of the binary tree; derives the wide rows
        and the padded vertex rows on the host."""
        nodes_w, wide_depth = widen_bvh(nodes_f, nodes_i)
        return cls(nodes_f=torch.from_numpy(nodes_f),
                   nodes_i=torch.from_numpy(nodes_i),
                   tri9=torch.from_numpy(tri9),
                   tri_m12=torch.from_numpy(tri_m12),
                   stack_depth=stack_depth,
                   nodes_w=torch.from_numpy(nodes_w),
                   tri9p=torch.from_numpy(pad_tri9(tri9)),
                   wide_depth=wide_depth)


def _leaf_ref(start: int, count: int) -> int:
    return -(start * 8 + count) - 1


WIDE = 4            # children of a wide node
WIDE_ROW = 32       # floats in a wide row: 128 bytes, one cache line


def widen_bvh(nodes_f: np.ndarray, nodes_i: np.ndarray):
    """Collapse the binary tree of ``pack_bvh`` into 4-wide nodes.

    Returns (nodes_w, wide_depth).  nodes_w is (N4, 32) float32, one row
    per wide node, in breadth-first order (a parent's row comes before its
    children's; row 0 is the root):

      [lo_x(4) lo_y(4) lo_z(4) hi_x(4) hi_y(4) hi_z(4) ref(4) pad(4)]

    with one column per child.  A child box holds the binary node's floats
    unchanged.  ref is an int32 stored bit for bit in the float row: >= 0
    the row of a wide node, < 0 a leaf with the payload of ``nodes_i``
    (v = -(ref+1): start = v >> 3, count = v & 7).  An unused slot is an
    inverted box (lo = +inf, hi = -inf, which no ray enters) with the ref
    of an empty leaf.  A wide node takes a binary node's two children and,
    while it has a free slot and an internal child, replaces the internal
    child of the largest surface area by that child's own two children, so
    a wide node stands for one to three binary nodes.  wide_depth is the
    number of levels of the wide tree (1 for a root with leaves only)."""
    nodes_f = np.asarray(nodes_f, np.float32)
    nodes_i = np.asarray(nodes_i, np.int32)

    def children(b):
        return [(nodes_f[b, 0:6], int(nodes_i[b, 0])),
                (nodes_f[b, 6:12], int(nodes_i[b, 1]))]

    def area(box):
        d = np.maximum(box[3:6].astype(np.float64) - box[0:3], 0.0)
        return d[0] * d[1] + d[1] * d[2] + d[2] * d[0]

    empty_box = np.asarray([np.inf] * 3 + [-np.inf] * 3, np.float32)
    boxes, refs = [], []
    queue = [(0, 1)]                  # (binary node id, level), row order
    wide_depth = 1
    head = 0
    while head < len(queue):
        b, level = queue[head]
        head += 1
        wide_depth = max(wide_depth, level)
        slots = children(b)
        while len(slots) < WIDE:
            internal = [k for k, (_, ref) in enumerate(slots) if ref >= 0]
            if not internal:
                break
            k = max(internal, key=lambda j: area(slots[j][0]))
            slots[k:k + 1] = children(slots[k][1])
        row_box = np.tile(empty_box, (WIDE, 1))
        row_ref = np.full(WIDE, _leaf_ref(0, 0), np.int32)
        for k, (box, ref) in enumerate(slots):
            row_box[k] = box
            if ref >= 0:
                row_ref[k] = len(queue)
                queue.append((ref, level + 1))
            else:
                row_ref[k] = ref
        boxes.append(row_box)
        refs.append(row_ref)

    n4 = len(boxes)
    nodes_w = np.zeros((n4, WIDE_ROW), np.float32)
    # (N4, child, 6) -> (N4, 6, child): one group of four floats per bound
    nodes_w[:, 0:24] = np.stack(boxes).transpose(0, 2, 1).reshape(n4, 24)
    nodes_w[:, 24:28] = np.stack(refs).view(np.float32)
    return nodes_w, wide_depth


def pad_tri9(tri9: np.ndarray) -> np.ndarray:
    """(T, 9) vertex rows [p0 p1 p2] -> (T, 12) rows
    [x0 x1 x2 0 | y0 y1 y2 0 | z0 z1 z2 0]: the same floats, one 16-byte
    group per axis, so that the precise kernel loads the three axes in its
    sheared order as three aligned vector loads."""
    tri9 = np.asarray(tri9, np.float32)
    t = len(tri9)
    out = np.zeros((t, 3, 4), np.float32)
    out[:, :, 0:3] = tri9.reshape(t, 3, 3).transpose(0, 2, 1)
    return out.reshape(t, 12)


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

    return BVHArrays.from_binary(
        nodes_f, nodes_i, np.ascontiguousarray(P.reshape(t, 9)),
        np.ascontiguousarray(tri_m12), stack_depth=depth + 2)


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
    kernel = cuda_trace.closest_hit_precise if precise \
        else cuda_trace.closest_hit
    return Hit(*_Detached.apply(kernel, bvh, rays))


def intersect_p(bvh: BVHArrays, ray_o, ray_d, t_max, active=None,
                precise: bool = False):
    """Occlusion (any hit in (1e-6, t_max)) query; returns (R,) bool.
    Detached, as ``intersect``."""
    rays = pack_rays(ray_o, ray_d, t_max, active)
    kernel = cuda_trace.any_hit_precise if precise else cuda_trace.any_hit
    return _Detached.apply(kernel, bvh, rays)


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


def intersect_brute(p0, p1, p2, ray_o, ray_d, t_max=BIG_T) -> Hit:
    """O(R*T) oracle for the traversal tests: ``intersect_triangle`` of
    every (R, 3) ray against every (T, 3) triangle, first-index argmin."""
    t, b1, b2, h = intersect_triangle(
        ray_o[:, None, :], ray_d[:, None, :], p0[None], p1[None], p2[None],
        torch.as_tensor(t_max, dtype=torch.float32))
    t = torch.where(h, t, BIG_T)
    i = torch.argmin(t, dim=1, keepdim=True)

    def pick(a):
        return a.gather(1, i)[:, 0]
    hi = pick(h)
    return Hit(t=pick(t), tri=torch.where(hi, i[:, 0], -1).to(torch.int32),
               b1=pick(b1), b2=pick(b2), hit=hi)
