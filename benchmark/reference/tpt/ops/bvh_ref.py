"""The reference's own BVH: a build in numpy and a walk in plain PyTorch.

``build_bvh`` sorts each range of triangles along the longest axis of
its box centres and splits it at its middle, level by level, until a range
holds at most ``LEAF_SIZE`` triangles: a balanced binary tree in the
layout of ``FlatBVH`` (the program's builder output), which the copied
``pack_bvh`` packs; the few triangles with very large boxes (walls, a
floor) stay out of the tree and are tested by brute force.  It is not the program's SAH tree; only the hits
matter, and those a tree does not change.

``walk`` visits the packed tree with every ray in lockstep (one node or
leaf a ray per round, a stack a ray) and tests a leaf's triangles with the
program's hit-test arithmetic (``fast_test``, ``precise_test``: copies of
the plain versions that its CUDA kernels are held to bit for bit).  Closest
hit: the smallest t below the ray's t_max, the lower triangle id on an
exact tie; occlusion: any hit in (1e-6, t_max).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.math import shear_test

LEAF_SIZE = 7
# a triangle whose box has over BIG_AREA x the median box's surface area
# (at most MAX_BIG of them) is left out of the tree and tested by brute force
BIG_AREA = 256.0
MAX_BIG = 64
BIG_T = 3.0e38
_DONE = -2 ** 31


@dataclasses.dataclass
class FlatBVH:
    bounds_min: np.ndarray
    bounds_max: np.ndarray
    left: np.ndarray
    right: np.ndarray
    count: np.ndarray
    order: np.ndarray
    depth: int
    n_big: int = 0

    @property
    def n_nodes(self) -> int:
        return len(self.count)


def build_bvh(tri_min: np.ndarray, tri_max: np.ndarray) -> FlatBVH:
    """The big triangles first (``n_big`` of them, tested by brute force:
    a wall's box would swell every box above it), then ``_median_tree``
    over the other (T, 3) triangle boxes."""
    tri_min = np.asarray(tri_min, np.float32)
    tri_max = np.asarray(tri_max, np.float32)
    ext = np.maximum(tri_max.astype(np.float64) - tri_min, 0.0)
    area = ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2] + ext[:, 2] * ext[:, 0]
    by_area = np.argsort(-area, kind="stable")[:MAX_BIG]
    big = np.sort(by_area[area[by_area] > BIG_AREA * np.median(area)])
    if len(big) == len(area):
        big = big[:0]
    rest = np.setdiff1d(np.arange(len(area)), big)
    fb = _median_tree(tri_min[rest], tri_max[rest])
    fb.order = np.concatenate([big, rest[fb.order]]).astype(np.int32)
    leaf = fb.count > 0
    fb.left = np.where(leaf, fb.left + len(big), fb.left).astype(np.int32)
    fb.n_big = len(big)
    return fb


def _median_tree(tri_min: np.ndarray, tri_max: np.ndarray) -> FlatBVH:
    """A tree built level by level: each range of more than ``LEAF_SIZE``
    triangles is sorted along the longest axis of its box centres and split
    at its middle."""
    t = len(tri_min)
    c = (tri_min.astype(np.float64) + tri_max) * 0.5
    order = np.arange(t)
    starts, lefts, rights, counts, levels = [], [], [], [], []
    level_s, level_e = np.asarray([0]), np.asarray([t])
    n = 0
    depth = 0
    while len(level_s):
        depth += 1
        ids = np.arange(n, n + len(level_s))
        n += len(level_s)
        size = level_e - level_s
        leaf = size <= LEAF_SIZE
        inner = ~leaf
        if inner.any():
            s_in, e_in = level_s[inner], level_e[inner]
            pos = _ranges(s_in, e_in)
            owner = np.repeat(np.arange(len(s_in)), e_in - s_in)
            cc = c[order[pos]]
            first = np.cumsum(np.r_[0, e_in - s_in])[:-1]
            lo = np.minimum.reduceat(cc, first, axis=0)
            hi = np.maximum.reduceat(cc, first, axis=0)
            axis = np.argmax(hi - lo, axis=1)
            key = cc[np.arange(len(pos)), axis[owner]]
            order[pos] = order[pos][np.lexsort((key, owner))]
        mid = (level_s + level_e) // 2
        k = np.cumsum(inner) - 1              # index among internal nodes
        starts.append(level_s)
        lefts.append(np.where(leaf, level_s, n + 2 * k))
        rights.append(np.where(leaf, -1, n + 2 * k + 1))
        counts.append(np.where(leaf, size, 0))
        levels.append(ids)
        level_s = np.stack([level_s[inner], mid[inner]], 1).reshape(-1)
        level_e = np.stack([mid[inner], level_e[inner]], 1).reshape(-1)
    start = np.concatenate(starts)
    count = np.concatenate(counts).astype(np.int32)
    left = np.concatenate(lefts).astype(np.int32)
    right = np.concatenate(rights).astype(np.int32)
    order = order.astype(np.int32)

    bmin = np.zeros((n, 3), np.float32)
    bmax = np.zeros((n, 3), np.float32)
    smin, smax = tri_min[order], tri_max[order]
    leaves = np.nonzero(count > 0)[0]
    by_start = leaves[np.argsort(start[leaves])]
    bmin[by_start] = np.minimum.reduceat(smin, start[by_start], axis=0)
    bmax[by_start] = np.maximum.reduceat(smax, start[by_start], axis=0)
    for ids in reversed(levels):
        inner = ids[count[ids] == 0]
        bmin[inner] = np.minimum(bmin[left[inner]], bmin[right[inner]])
        bmax[inner] = np.maximum(bmax[left[inner]], bmax[right[inner]])
    return FlatBVH(bounds_min=bmin, bounds_max=bmax, left=left, right=right,
                   count=count, order=order, depth=depth)


def _ranges(starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """The concatenation of arange(s, e) over the ranges."""
    sizes = ends - starts
    offs = np.repeat(starts - np.cumsum(np.r_[0, sizes])[:-1], sizes)
    return np.arange(sizes.sum()) + offs


def fast_test(m, ray):
    """The unit-triangle test on broadcastable tensors: m the 12 columns of
    tri_m12 rows, ray the 7 components of rays.  -> t, u, v, hit."""
    ox, oy, oz, dx, dy, dz, tmax = ray
    ou = ox * m[0] + oy * m[1] + oz * m[2] + m[3]
    ov = ox * m[4] + oy * m[5] + oz * m[6] + m[7]
    ow = ox * m[8] + oy * m[9] + oz * m[10] + m[11]
    du = dx * m[0] + dy * m[1] + dz * m[2]
    dv = dx * m[4] + dy * m[5] + dz * m[6]
    dw = dx * m[8] + dy * m[9] + dz * m[10]
    t = -ow / dw
    u = ou + t * du
    v = ov + t * dv
    hit = ((u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 1e-6)
           & (t < tmax))
    return t, u, v, hit


def precise_test(p, ray):
    """The watertight shear test on broadcastable tensors: p the 9 columns
    of tri9 rows, ray the 7 components of rays (x wins over z, y over x
    and z on ties of the axis choice).  -> t, b1, b2, hit."""
    ox, oy, oz, dx, dy, dz, tmax = ray
    adx, ady, adz = dx.abs(), dy.abs(), dz.abs()
    kz = torch.where(adx > ady, torch.where(adx >= adz, 0, 2),
                     torch.where(ady >= adz, 1, 2))
    verts = tuple(tuple(p[3 * v + c] for c in range(3)) for v in range(3))
    return shear_test(ox, oy, oz, dx, dy, dz, kz, verts, tmax)


def _leaf_best(t, tri, ok):
    """Per row, the hit of least t among the (m, L) candidates, the lowest
    triangle id on a tie -> (t, tri, column, any ok)."""
    tm = torch.where(ok, t, float("inf"))
    least = tm.min(dim=1, keepdim=True).values
    col = torch.argmax((ok & (tm == least)).to(torch.int8), dim=1,
                       keepdim=True)
    return (t.gather(1, col)[:, 0], tri.gather(1, col)[:, 0], col,
            ok.any(dim=1))


def walk(bvh, rays, precise: bool = False, any_hit: bool = False):
    """Closest hit (t, tri i32, b1, b2, hit) or, ``any_hit``, occlusion
    (R,) bool, of the (7, R) rays [ox oy oz dx dy dz t_max] against the
    packed triangles ``bvh`` (its first ``n_big`` by brute force, the rest
    through nodes_f and nodes_i; tri_m12, or tri9 when ``precise``).
    Closest hit: t_max <= 0 is a dead ray; any hit: t_max < 0 an inactive
    one.  The result is that of testing every triangle in id order with
    the kernels' rule for the better hit."""
    n, dev = rays.shape[1], rays.device
    nodes_f = bvh.nodes_f.view(-1, 2, 2, 3)          # node, child, lo/hi, axis
    nodes_i = bvh.nodes_i.to(torch.int64)
    tris = bvh.tri9 if precise else bvh.tri_m12
    test = precise_test if precise else fast_test
    n_tri, n_big = tris.shape[0], bvh.n_big
    tmax = rays[6]
    best_t = tmax.clone()
    best_tri = torch.full((n,), -1, dtype=torch.int64, device=dev)
    b1 = torch.zeros(n, dtype=torch.float32, device=dev)
    b2 = torch.zeros(n, dtype=torch.float32, device=dev)
    live = tmax >= 0.0 if any_hit else tmax > 0.0
    org = rays[0:3].T
    inv = 1.0 / rays[3:6].T

    def take(rows, t, tri, col, any_ok, u, v):
        """Keep each row's leaf best where it beats the best so far."""
        if any_hit:
            best_tri[rows[any_ok]] = tri[any_ok]
            return
        better = any_ok & ((t < best_t[rows])
                           | ((t == best_t[rows]) & (tri < best_tri[rows])))
        if precise:
            better = better | (any_ok & (best_tri[rows] < 0))
        r = rows[better]
        best_t[r], best_tri[r] = t[better], tri[better]
        b1[r] = u.gather(1, col)[:, 0][better]
        b2[r] = v.gather(1, col)[:, 0][better]

    def test_rows(rows, tri):
        """Test rows against (m, L) triangle ids (-1: none), or against
        the (1, L) ids that every row shares."""
        valid = tri >= 0
        cols = list(tris[tri.clamp(min=0)].unbind(2))
        ray = [c[rows, None] for c in rays.unbind(0)]
        t, u, v, ok = test(cols, ray)
        ok = ok & valid
        tri = tri.expand(ok.shape)
        t_b, tri_b, col, any_ok = _leaf_best(t, tri, ok)
        take(rows, t_b, tri_b, col, any_ok, u, v)

    rows = torch.nonzero(live)[:, 0]
    if n_big and rows.numel():
        test_rows(rows, torch.arange(n_big, device=dev)[None, :])

    stack = torch.full((n, bvh.stack_depth + 2), _DONE, dtype=torch.int64,
                       device=dev)
    sp = torch.ones(n, dtype=torch.int64, device=dev)
    cur = torch.where(live, 0, _DONE).to(torch.int64)
    if any_hit:
        cur = torch.where(best_tri >= 0, _DONE, cur)
    lane = torch.arange(LEAF_SIZE, device=dev)

    def pop(rows):
        sp[rows] -= 1
        return stack[rows, sp[rows]]

    while True:
        at_node = torch.nonzero(cur >= 0)[:, 0]
        at_leaf = torch.nonzero((cur < 0) & (cur != _DONE))[:, 0]
        if at_node.numel() == 0 and at_leaf.numel() == 0:
            break
        if at_node.numel():
            box = nodes_f[cur[at_node]]                     # (k, 2, 2, 3)
            o, iv = org[at_node, None, :], inv[at_node, None, :]
            t0 = (box[:, :, 0] - o) * iv
            t1 = (box[:, :, 1] - o) * iv
            tn = torch.fmin(t0, t1).amax(dim=2)              # (k, 2)
            tf = torch.fmax(t0, t1).amin(dim=2) * 1.0001 + 1e-6
            lim = best_t[at_node, None] * 1.001 + 1e-6
            h = (tn <= tf) & (tf > 0.0) & (tn <= lim)
            refs = nodes_i[cur[at_node]]
            first1 = h[:, 1] & (~h[:, 0] | (tn[:, 1] < tn[:, 0]))
            near = torch.where(first1, refs[:, 1], refs[:, 0])
            far = torch.where(first1, refs[:, 0], refs[:, 1])
            both = h[:, 0] & h[:, 1]
            r = at_node[both]
            stack[r, sp[r]] = far[both]
            sp[r] += 1
            any_child = h[:, 0] | h[:, 1]
            cur[at_node[any_child]] = near[any_child]
            none = at_node[~any_child]
            cur[none] = pop(none)
        if at_leaf.numel():
            payload = -(cur[at_leaf] + 1)
            start, count = payload >> 3, payload & 7
            count = torch.minimum(count, n_tri - start)
            tri = torch.where(lane < count[:, None], start[:, None] + lane, -1)
            test_rows(at_leaf, tri)
            cur[at_leaf] = pop(at_leaf)
            if any_hit:
                cur[at_leaf[best_tri[at_leaf] >= 0]] = _DONE
    found = best_tri >= 0
    if any_hit:
        return found
    return (torch.where(found, best_t, BIG_T), best_tri.to(torch.int32),
            torch.where(found, b1, 0.0), torch.where(found, b2, 0.0), found)


def closest_hit(bvh, rays):
    return walk(bvh, rays)


def closest_hit_precise(bvh, rays):
    return walk(bvh, rays, precise=True)


def any_hit(bvh, rays):
    return walk(bvh, rays, any_hit=True)


def any_hit_precise(bvh, rays):
    return walk(bvh, rays, precise=True, any_hit=True)
