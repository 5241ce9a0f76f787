"""The 4-wide BVH layout the traversal kernels read (``widen_bvh``,
``pad_tri9``) and a plain walk of it.

(a) Structure of ``nodes_w`` against the binary tree it was collapsed from.
(b) ``walk_wide_plain`` (the kernels' walk as vectorised PyTorch: their cull
    rule with its padded far distance and slack, their child order, their
    rule for the better hit, or the any-hit kernels' first hit) against the
    brute-force plain versions on seeded numpy rays: hit, triangle id and
    t, b1, b2 bit for bit, or occlusion, because a conservative cull gives
    the brute-force answers whatever the visit order.
(c) The bridge gives a JAX-built scene the same wide rows as the port's own
    build.
"""
import dataclasses

import numpy as np
import pytest
import torch

from tpu_pathtracer.scenes import load_scene as jload
from tpu_pathtracer_torch.bridge import as_numpy_tree, scene_from_numpy
from tpu_pathtracer_torch.ops import cuda_trace
from tpu_pathtracer_torch.ops import trace as ttrace
from tpu_pathtracer_torch.scene import bvh as tbvh
from tpu_pathtracer_torch.scene import mesh as tmesh
from tpu_pathtracer_torch.scenes import load_scene as tload


def _pack(tri):
    tri = np.asarray(tri, np.float32)
    fb = tbvh.build_bvh(tri.min(1), tri.max(1))
    return ttrace.pack_bvh(fb, tri[fb.order])


def _mesh_tris(m):
    return m.positions[m.indices]


QUAD = _mesh_tris(tmesh.quad([-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]))
ONE = QUAD[:1]
MESHES = {
    "one_triangle": lambda: ONE,
    "quad_pair": lambda: QUAD,
    "uv_sphere": lambda: _mesh_tris(tmesh.uv_sphere(n_theta=10, n_phi=14)),
    "dragon": lambda: _mesh_tris(tmesh.dragon(n_u=32, n_v=8)),
}


def _binary_children(arrs):
    """{binary internal node: [(box (6,), ref), (box, ref)]}."""
    nf, ni = arrs.nodes_f.numpy(), arrs.nodes_i.numpy()
    return {b: [(nf[b, 0:6], int(ni[b, 0])), (nf[b, 6:12], int(ni[b, 1]))]
            for b in range(len(nf))}


def _wide_slots(arrs):
    """Per wide row: [(box (6,), ref)] of its four slots."""
    w = arrs.nodes_w.numpy()
    boxes = w[:, 0:24].reshape(-1, 6, 4).transpose(0, 2, 1)
    refs = w[:, 24:28].copy().view(np.int32)
    return [[(boxes[r, k], int(refs[r, k])) for k in range(4)]
            for r in range(len(w))]


def _reachable(children):
    """(internal node count, [(leaf ref, box bytes)]) of the binary tree."""
    leaves, todo, internal = [], [0], 0
    while todo:
        internal += 1
        for box, ref in children[todo.pop()]:
            if ref >= 0:
                todo.append(ref)
            else:
                leaves.append((ref, box.tobytes()))
    return internal, leaves


@pytest.mark.parametrize("name", list(MESHES))
def test_wide_rows_hold_the_binary_tree(name):
    arrs = _pack(MESHES[name]())
    w = arrs.nodes_w
    assert w.dtype == torch.float32 and w.dim() == 2 and w.shape[1] == 32
    assert w.is_contiguous()
    assert not w[:, 28:].any()                         # the padding
    slots = _wide_slots(arrs)
    n_tri = arrs.tri9.shape[0]

    # every triangle range of the binary leaves sits in exactly one wide
    # slot, with the binary node's box bit for bit
    want = sorted(l for l in _reachable(_binary_children(arrs))[1]
                  if (-(l[0] + 1)) & 7)
    got = sorted((ref, box.tobytes()) for row in slots for box, ref in row
                 if ref < 0 and (-(ref + 1)) & 7)
    assert got == want
    covered = np.zeros(n_tri, np.int32)
    for ref, _ in got:
        v = -(ref + 1)
        covered[(v >> 3):(v >> 3) + (v & 7)] += 1
    assert (covered == 1).all()

    # internal slots: parent row < child row, every row but the root has
    # exactly one parent, and the box is a binary node's child box
    binary_boxes = {box.tobytes() for pair in _binary_children(arrs).values()
                    for box, _ in pair}
    parents = np.zeros(len(slots), np.int32)
    for r, row in enumerate(slots):
        for box, ref in row:
            if ref >= 0:
                assert r < ref < len(slots)
                parents[ref] += 1
                assert box.tobytes() in binary_boxes
            elif (-(ref + 1)) & 7 == 0:
                # an unused slot: an inverted box no ray enters (a
                # one-leaf tree's pseudo-root brings its own)
                assert (box[0:3] > box[3:6]).all() or n_tri == 0
    assert parents[0] == 0 and (parents[1:] == 1).all()


def test_wide_depth_and_node_counts():
    """A wide node stands for one to three binary nodes; trees whose
    internal-node count is no multiple of three pack all the same."""
    counts = set()
    for n_u in (8, 9, 10, 11):
        arrs = _pack(_mesh_tris(tmesh.dragon(n_u=n_u, n_v=4)))
        internal = _reachable(_binary_children(arrs))[0]
        n4 = arrs.nodes_w.shape[0]
        assert n4 <= internal <= 3 * n4
        assert 1 <= arrs.wide_depth <= arrs.stack_depth - 2
        assert cuda_trace.wide_stack_slots(arrs.wide_depth) \
            <= cuda_trace.WIDE_MAX_STACK
        counts.add(internal % 3)
    assert len(counts) > 1


def test_one_leaf_and_two_triangle_trees():
    one = _pack(ONE)
    assert one.nodes_w.shape == (1, 32) and one.wide_depth == 1
    refs = one.nodes_w[0, 24:28].view(torch.int32).tolist()
    assert refs[0] == -(0 * 8 + 1) - 1 and refs[1:] == [-1, -1, -1]
    two = _pack(QUAD)
    assert two.nodes_w.shape == (1, 32) and two.wide_depth == 1
    counts = sorted((-(r + 1)) & 7
                    for r in two.nodes_w[0, 24:28].view(torch.int32).tolist())
    assert sum(counts) == 2


def test_pad_tri9_repeats_the_vertex_floats():
    arrs = _pack(MESHES["uv_sphere"]())
    p = arrs.tri9p.reshape(-1, 3, 4)
    assert arrs.tri9p.shape == (arrs.tri9.shape[0], 12)
    assert not p[:, :, 3].any()
    # group a holds axis a of p0, p1, p2
    assert torch.equal(p[:, :, 0:3].transpose(1, 2).reshape(-1, 9), arrs.tri9)


def _rays(tri, n, seed):
    """Rays from a sphere around the mesh towards points near it; a fifth
    dead or short."""
    rng = np.random.default_rng(seed)
    lo, hi = tri.reshape(-1, 3).min(0), tri.reshape(-1, 3).max(0)
    mid, rad = (lo + hi) / 2, np.linalg.norm(hi - lo) / 2
    o = rng.normal(size=(n, 3))
    o = mid + o / np.linalg.norm(o, axis=-1, keepdims=True) * rad * 2.5
    d = mid + rng.normal(size=(n, 3)) * rad * 0.4 - o
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = np.where(rng.uniform(size=n) < 0.8, 3e38,
                    rng.uniform(-1.0, 3.0 * rad, n))
    return torch.tensor(np.concatenate([o.T, d.T, tmax[None]]),
                        dtype=torch.float32)


@pytest.mark.parametrize("mode", ["closest", "any"])
@pytest.mark.parametrize("precise", [False, True], ids=["fast", "precise"])
@pytest.mark.parametrize("name", ["quad_pair", "uv_sphere", "dragon"])
def test_wide_walk_equals_brute_force(name, precise, mode):
    tri = MESHES[name]()
    arrs = _pack(tri)
    rays = _rays(tri, 3000, 21)
    got = cuda_trace.walk_wide_plain(arrs, rays, precise, mode == "any")
    if mode == "any":
        ref = (cuda_trace.any_hit_precise_plain(arrs.tri9, rays) if precise
               else cuda_trace.any_hit_plain(arrs.tri_m12, rays))
        # short rays: occlusion differs from a closest hit at t_max = BIG_T
        assert ((rays[6] > 0.0) & (rays[6] < 3e38) & ref).any()
        assert ref.any() and not ref.all() and not ref[rays[6] < 0.0].any()
        assert got.dtype == ref.dtype and torch.equal(got, ref)
        return
    ref = (cuda_trace.closest_hit_precise_plain(arrs.tri9, rays) if precise
           else cuda_trace.closest_hit_plain(arrs.tri_m12, rays))
    hit = ref[4]
    assert hit.any() and not hit.all()
    assert not hit[rays[6] <= 0.0].any()
    for g, r, what in zip(got, ref, ("t", "tri", "b1", "b2", "hit")):
        assert g.dtype == r.dtype and torch.equal(g, r), what


def test_wide_walk_axis_parallel_and_tie():
    """Axis-parallel rays (a zero direction component: 0 * inf in the slab
    test) and two coincident triangles (the lower id wins)."""
    tri = np.concatenate([QUAD, QUAD])
    arrs = _pack(tri)
    s = np.linspace(-0.99, 0.99, 64)
    o = np.stack([s, s[::-1] * 0.5, np.ones_like(s)])
    d = np.stack([np.zeros_like(s), np.zeros_like(s), -np.ones_like(s)])
    rays = torch.tensor(np.concatenate([o, d, np.full((1, 64), 3e38)]),
                        dtype=torch.float32)
    for precise in (False, True):
        got = cuda_trace.walk_wide_plain(arrs, rays, precise)
        ref = (cuda_trace.closest_hit_precise_plain(arrs.tri9, rays)
               if precise else cuda_trace.closest_hit_plain(arrs.tri_m12, rays))
        assert ref[4].all()
        for g, r in zip(got, ref):
            assert torch.equal(g, r)


def test_wrappers_take_the_bvh_and_check_the_wide_rows():
    """On the CPU all four wrappers and K2p's binary yardstick take the
    ``BVHArrays`` and run the plain versions; on another device they
    raise."""
    tri = MESHES["uv_sphere"]()
    arrs = _pack(tri)
    rays = _rays(tri, 256, 3)
    for g, r in zip(cuda_trace.closest_hit(arrs, rays),
                    cuda_trace.closest_hit_plain(arrs.tri_m12, rays)):
        assert torch.equal(g, r)
    for g, r in zip(cuda_trace.closest_hit_precise(arrs, rays),
                    cuda_trace.closest_hit_precise_plain(arrs.tri9, rays)):
        assert torch.equal(g, r)
    ref = cuda_trace.any_hit_plain(arrs.tri_m12, rays)
    assert ref.any() and not ref.all()
    assert torch.equal(cuda_trace.any_hit(arrs, rays), ref)
    ref = cuda_trace.any_hit_precise_plain(arrs.tri9, rays)
    assert torch.equal(cuda_trace.any_hit_precise(arrs, rays), ref)
    assert not hasattr(cuda_trace, "closest_hit_v1")
    assert not hasattr(cuda_trace, "any_hit_v1")
    deep = dataclasses.replace(arrs, wide_depth=cuda_trace.WIDE_MAX_STACK)
    assert cuda_trace.wide_stack_slots(deep.wide_depth) \
        > cuda_trace.WIDE_MAX_STACK
    meta = rays.to("meta")
    for fn in (cuda_trace.any_hit, cuda_trace.any_hit_precise):
        with pytest.raises(ValueError):      # neither CPU nor CUDA
            fn(arrs, meta)


def test_bridge_builds_the_same_wide_rows():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPT_NO_NATIVE", "1")
        js, jm, jc = jload(0, 32, 24, table_res=16)
        ts, _, _ = tload(0, 32, 24, table_res=16, device="cpu")
    bs, _, _ = scene_from_numpy(as_numpy_tree(js), jm._asdict(),
                                dataclasses.asdict(jc), device="cpu")
    assert torch.equal(bs.bvh.nodes_w.view(torch.int32),
                       ts.bvh.nodes_w.view(torch.int32))
    assert torch.equal(bs.bvh.tri9p, ts.bvh.tri9p)
    assert bs.bvh.wide_depth == ts.bvh.wide_depth
    assert bs.bvh.nodes_w.shape[0] > 64
