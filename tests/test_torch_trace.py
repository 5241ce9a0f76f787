"""Port vs JAX: BVH packing and the plain versions of the K1 / K2 kernels.

The port's closest-hit and any-hit run their plain PyTorch versions on
CPU tensors (brute force with the kernels' fast unit-triangle test).
They are held against the JAX package's Pallas traversal run in interpret
mode with the fast test (``precise=False``), and against its BVH walk
(the watertight test), with the statistical gate of tests/test_bvh.py:
>= 99.9 % identical hit/miss and t within 1e-4 relative on common hits;
occlusion >= 99.9 % equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pathtracer.ops import pallas_trace
from tpu_pathtracer.ops import trace as jtrace
from tpu_pathtracer.scene import bvh as jbvh
from tpu_pathtracer.scene import mesh as jmesh
from tpu_pathtracer_torch.ops import cuda_trace
from tpu_pathtracer_torch.ops import trace as ttrace
from tpu_pathtracer_torch.scene import bvh as tbvh
from tpu_pathtracer_torch.utils.vec import V3


@pytest.fixture(scope="module")
def dragon():
    """A small dragon packed by both packages from the same FlatBVH."""
    m = jmesh.dragon(n_u=48, n_v=10)
    p = m.positions[m.indices]
    fb = jbvh.build_bvh(p.min(1), p.max(1))
    jarrs = jtrace.pack_bvh(fb, p[fb.order])
    tarrs = ttrace.pack_bvh(fb, p[fb.order])
    return p, jarrs, tarrs


def _rays(n, seed, r_origin=3.0):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * r_origin
    d = rng.normal(size=(n, 3)) * 0.3 - o
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _v3(a):
    t = torch.from_numpy(a)
    return V3(t[:, 0], t[:, 1], t[:, 2])


def test_python_bvh_builder_matches():
    m = jmesh.dragon(n_u=32, n_v=8)
    p = m.positions[m.indices]
    a = jbvh.build_bvh(p.min(1), p.max(1))
    b = tbvh.build_bvh(p.min(1), p.max(1))
    for f in ("bounds_min", "bounds_max", "left", "right", "count", "order"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert a.depth == b.depth


def test_pack_bvh_matches(dragon):
    p, jarrs, tarrs = dragon
    t = len(p)
    assert np.array_equal(tarrs.nodes_f.numpy(), np.asarray(jarrs.nodes_f))
    assert np.array_equal(tarrs.nodes_i.numpy(), np.asarray(jarrs.nodes_i))
    assert np.array_equal(tarrs.tri9.numpy(), np.asarray(jarrs.tri9))
    assert np.array_equal(tarrs.tri_m12.numpy(),
                          np.asarray(jarrs.tri_m12)[:t])
    assert tarrs.stack_depth == jarrs.stack_hint.shape[0]


def test_closest_plain_vs_pallas_fast_and_bvh(dragon):
    _, jarrs, tarrs = dragon
    n = 2048
    o, d = _rays(n, 5)
    hp = pallas_trace.traverse(jarrs, jnp.asarray(o), jnp.asarray(d),
                               jnp.asarray(3e38), interpret=True,
                               precise=False)
    hb = jax.jit(lambda o, d: jtrace.intersect(jarrs, o, d, method="bvh"))(
        jnp.asarray(o), jnp.asarray(d))
    ht = ttrace.intersect(tarrs, _v3(o), _v3(d))
    for ref in (hp, hb):
        same = np.asarray(ref.hit) == ht.hit.numpy()
        assert same.mean() >= 0.999
        both = np.asarray(ref.hit) & ht.hit.numpy()
        tr, tt = np.asarray(ref.t)[both], ht.t.numpy()[both]
        assert np.abs(tr - tt).max() <= 1e-4 * np.abs(tr).max()
        assert (np.asarray(ref.tri)[both] == ht.tri.numpy()[both]).mean() >= 0.999
    assert ht.hit.any() and not ht.hit.all()
    miss = ~ht.hit.numpy()
    assert (ht.tri.numpy()[miss] == -1).all()
    assert (ht.t.numpy()[miss] == np.float32(3e38)).all()


def test_closest_plain_active_and_tmax(dragon):
    """Inactive rays and rays whose t_max ends short of the surface miss."""
    _, jarrs, tarrs = dragon
    n = 300
    o, d = _rays(n, 3)
    act = np.random.default_rng(4).uniform(size=n) < 0.7
    hb = jax.jit(lambda o, d: jtrace.intersect(
        jarrs, o, d, active=jnp.asarray(act), method="bvh"))(
        jnp.asarray(o), jnp.asarray(d))
    ht = ttrace.intersect(tarrs, _v3(o), _v3(d), active=torch.from_numpy(act))
    assert (np.asarray(hb.hit) == ht.hit.numpy()).mean() >= 0.999
    assert not ht.hit.numpy()[~act].any()
    short = ttrace.intersect(tarrs, _v3(o), _v3(d), t_max=0.5)
    assert not short.hit.any()


def test_anyhit_plain_vs_pallas_fast_and_bvh(dragon):
    _, jarrs, tarrs = dragon
    n = 1024
    o, d = _rays(n, 6)
    act = np.random.default_rng(7).uniform(size=n) < 0.7
    tmax = np.random.default_rng(8).uniform(1.5, 4.0, n).astype(np.float32)
    op = pallas_trace.traverse(jarrs, jnp.asarray(o), jnp.asarray(d),
                               jnp.asarray(tmax), active=jnp.asarray(act),
                               any_hit=True, interpret=True, precise=False)
    ob = jax.jit(lambda o, d: jtrace.intersect_p(
        jarrs, o, d, jnp.asarray(tmax), active=jnp.asarray(act),
        method="bvh"))(jnp.asarray(o), jnp.asarray(d))
    ot = ttrace.intersect_p(tarrs, _v3(o), _v3(d), torch.from_numpy(tmax),
                            active=torch.from_numpy(act)).numpy()
    for ref in (op, ob):
        assert (np.asarray(ref) == ot).mean() >= 0.999
    assert not ot[~act].any()
    assert ot.any() and not ot[act].all()


def test_anyhit_equals_closest_hit_within_tmax(dragon):
    """Occluded iff the closest hit lies below t_max (same hit test)."""
    _, _, tarrs = dragon
    o, d = _rays(512, 9)
    tmax = np.random.default_rng(10).uniform(1.0, 4.0, 512).astype(np.float32)
    h = ttrace.intersect(tarrs, _v3(o), _v3(d))
    occ = ttrace.intersect_p(tarrs, _v3(o), _v3(d), torch.from_numpy(tmax))
    assert torch.equal(occ, h.hit & (h.t < torch.from_numpy(tmax)))


def test_plain_tie_keeps_lower_triangle_id():
    """Two coincident triangles: the lower id wins, as in the kernel."""
    tri = np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]] * 2, np.float32)
    fb = tbvh.build_bvh(tri.min(1), tri.max(1))
    arrs = ttrace.pack_bvh(fb, tri[fb.order])
    o = np.array([[0.2, 0.2, 1.0]], np.float32)
    d = np.array([[0.0, 0.0, -1.0]], np.float32)
    h = ttrace.intersect(arrs, _v3(o), _v3(d))
    assert h.hit.item() and h.tri.item() == 0
    assert abs(h.t.item() - 1.0) < 1e-6
    assert abs(h.b1.item() - 0.2) < 1e-6 and abs(h.b2.item() - 0.2) < 1e-6


def test_precise_and_foreign_device_raise(dragon):
    """``precise=True`` runs (its results are held to the JAX package in
    tests/test_torch_trace_precise.py); a tensor on a device that is
    neither the CPU nor a GPU raises."""
    _, _, tarrs = dragon
    o, d = _rays(4, 11)
    h = ttrace.intersect(tarrs, _v3(o), _v3(d), precise=True)
    assert h.hit.shape == (4,) and h.hit.dtype == torch.bool
    occ = ttrace.intersect_p(tarrs, _v3(o), _v3(d), 1.0, precise=True)
    assert occ.shape == (4,) and not occ.any()
    rays = ttrace.pack_rays(_v3(o), _v3(d), 1.0).to("meta")
    with pytest.raises(ValueError):
        cuda_trace.closest_hit(tarrs, rays)
