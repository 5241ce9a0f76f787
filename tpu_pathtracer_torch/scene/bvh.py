"""Flat SAH BVH construction (host-side numpy).

Copy of the pure-numpy builder in ``tpu_pathtracer/scene/bvh.py`` (16-bin
binned SAH, leaves of at most MAX_LEAF_SIZE triangles), so that the port's
scene build needs neither JAX nor the native library.  Both packages give
the same tree for the same triangles.

Output is a set of flat numpy arrays (SoA):
  bounds_min/bounds_max: (N, 3) f32
  left:  (N,) i32  -- internal: left child index;  leaf: first triangle
  right: (N,) i32  -- internal: right child index; leaf: unused (-1)
  count: (N,) i32  -- 0 for internal nodes, leaf triangle count otherwise
  order: (T,) i32  -- triangle permutation (leaves reference contiguous runs)
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["FlatBVH", "build_bvh", "MAX_LEAF_SIZE"]

MAX_LEAF_SIZE = 4
N_BINS = 16
COST_NODE = 1.0
COST_LEAF_ITEM = 1.0


@dataclasses.dataclass
class FlatBVH:
    bounds_min: np.ndarray
    bounds_max: np.ndarray
    left: np.ndarray
    right: np.ndarray
    count: np.ndarray
    order: np.ndarray
    depth: int

    @property
    def n_nodes(self) -> int:
        return len(self.left)


def build_bvh(tri_min: np.ndarray, tri_max: np.ndarray) -> FlatBVH:
    """Build a flat binary BVH over triangle AABBs.

    tri_min/tri_max: (T, 3) per-triangle bounds.
    """
    n = len(tri_min)
    centroids = 0.5 * (tri_min + tri_max)

    bounds_min, bounds_max, left, right, count = [], [], [], [], []
    order = np.arange(n, dtype=np.int32)

    def new_node():
        bounds_min.append(None)
        bounds_max.append(None)
        left.append(-1)
        right.append(-1)
        count.append(0)
        return len(left) - 1

    max_depth = [0]

    # iterative build with explicit stack: (node_id, start, end, depth)
    root = new_node()
    stack = [(root, 0, n, 0)]
    while stack:
        node, start, end, depth = stack.pop()
        max_depth[0] = max(max_depth[0], depth)
        idx = order[start:end]
        bmin = tri_min[idx].min(0)
        bmax = tri_max[idx].max(0)
        bounds_min[node] = bmin
        bounds_max[node] = bmax
        n_items = end - start

        if n_items <= 1:
            left[node] = start
            count[node] = n_items
            continue

        # binned SAH over the centroid extent, all three axes
        c = centroids[idx]
        cmin, cmax = c.min(0), c.max(0)
        extent = cmax - cmin
        best = None  # (cost, axis, bin_index, assignment)
        area_parent = _half_area(bmin, bmax)
        for axis in range(3):
            if extent[axis] <= 1e-12:
                continue
            scale = N_BINS * (1.0 - 1e-6) / extent[axis]
            bins = np.clip(((c[:, axis] - cmin[axis]) * scale).astype(np.int32), 0, N_BINS - 1)
            # per-bin bounds + counts (vectorized)
            counts = np.bincount(bins, minlength=N_BINS)
            bb_min = np.full((N_BINS, 3), np.inf)
            bb_max = np.full((N_BINS, 3), -np.inf)
            np.minimum.at(bb_min, bins, tri_min[idx])
            np.maximum.at(bb_max, bins, tri_max[idx])
            # prefix/suffix sweeps
            lmin = np.minimum.accumulate(bb_min, 0)
            lmax = np.maximum.accumulate(bb_max, 0)
            rmin = np.minimum.accumulate(bb_min[::-1], 0)[::-1]
            rmax = np.maximum.accumulate(bb_max[::-1], 0)[::-1]
            lcnt = np.cumsum(counts)
            rcnt = n_items - lcnt
            for k in range(N_BINS - 1):
                if lcnt[k] == 0 or rcnt[k] == 0:
                    continue
                cost = COST_NODE + COST_LEAF_ITEM * (
                    _half_area(lmin[k], lmax[k]) / area_parent * lcnt[k]
                    + _half_area(rmin[k + 1], rmax[k + 1]) / area_parent * rcnt[k])
                if best is None or cost < best[0]:
                    best = (cost, axis, k, bins)

        leaf_cost = COST_LEAF_ITEM * n_items
        # a leaf is only allowed when it fits the traversal's leaf width;
        # degenerate clusters (all centroids identical, no SAH split
        # exists) above that size must median-split
        if n_items <= MAX_LEAF_SIZE and (best is None or best[0] >= leaf_cost):
            left[node] = start
            count[node] = n_items
            continue
        if best is None:
            # all centroids identical but too many items: median split
            mid = start + n_items // 2
        else:
            _, axis, k, bins = best
            mask = bins <= k
            sel = idx[mask]
            other = idx[~mask]
            order[start:start + len(sel)] = sel
            order[start + len(sel):end] = other
            mid = start + len(sel)
            if mid == start or mid == end:
                mid = start + n_items // 2

        l_id = new_node()
        r_id = new_node()
        left[node] = l_id
        right[node] = r_id
        count[node] = 0
        stack.append((l_id, start, mid, depth + 1))
        stack.append((r_id, mid, end, depth + 1))

    return FlatBVH(
        bounds_min=np.asarray(bounds_min, np.float32),
        bounds_max=np.asarray(bounds_max, np.float32),
        left=np.asarray(left, np.int32),
        right=np.asarray(right, np.int32),
        count=np.asarray(count, np.int32),
        order=order,
        depth=max_depth[0],
    )


def _half_area(bmin, bmax) -> float:
    d = np.maximum(bmax - bmin, 0.0)
    return float(d[0] * d[1] + d[1] * d[2] + d[2] * d[0])
