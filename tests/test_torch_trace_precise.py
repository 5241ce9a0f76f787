"""Port vs JAX: the plain versions of the precise kernels (K3, K2p).

On CPU tensors ``intersect(..., precise=True)`` and ``intersect_p(...,
precise=True)`` run the kernels' plain PyTorch versions (brute force with
the watertight shear test).  They are held against the JAX package's BVH
walk (``method="bvh"``) and its Pallas traversal in interpret mode with
``precise=True``, on the inputs of tests/test_bvh.py: hit/miss and
triangle id identical on every ray; t, b1, b2 bit for bit against the
hit triangle's ``intersect_triangle`` evaluated op by op, and within
4e-6 of the jitted programs (XLA's compiled CPU code differs from its own
op-by-op evaluation in the last bits).
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
from tpu_pathtracer.utils import math as jmath
from tpu_pathtracer_torch.ops import cuda_trace
from tpu_pathtracer_torch.ops import trace as ttrace
from tpu_pathtracer_torch.scene import bvh as tbvh
from tpu_pathtracer_torch.scene import mesh as tmesh
from tpu_pathtracer_torch.utils.vec import V3

N = 300   # as tests/test_bvh.py: not a multiple of the 128-ray tile


@pytest.fixture(scope="module")
def dragon():
    m = jmesh.dragon(n_u=48, n_v=10)
    p = m.positions[m.indices]
    fb = jbvh.build_bvh(p.min(1), p.max(1))
    return jtrace.pack_bvh(fb, p[fb.order]), ttrace.pack_bvh(fb, p[fb.order])


def _rays(n, seed, r_origin=3.0):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * r_origin
    d = rng.normal(size=(n, 3)) * 0.3 - o
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _v3(a):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return V3(t[:, 0], t[:, 1], t[:, 2])


@pytest.fixture(scope="module")
def closest(dragon):
    jarrs, tarrs = dragon
    o, d = _rays(N, 3)
    act = np.random.default_rng(4).uniform(size=N) < 0.7
    hb = jax.jit(lambda o, d: jtrace.intersect(
        jarrs, o, d, active=jnp.asarray(act), method="bvh"))(
        jnp.asarray(o), jnp.asarray(d))
    ht = ttrace.intersect(tarrs, _v3(o), _v3(d), active=torch.from_numpy(act),
                          precise=True)
    return o, d, act, hb, ht


def test_closest_precise_plain_equals_bvh_walk(closest):
    o, d, act, hb, ht = closest
    hit = np.asarray(hb.hit)
    assert np.array_equal(ht.hit.numpy(), hit)
    assert np.array_equal(ht.tri.numpy(), np.asarray(hb.tri))
    assert hit.any() and not ht.hit.numpy()[~act].any()
    t = ht.t.numpy()
    np.testing.assert_allclose(t[hit], np.asarray(hb.t)[hit], rtol=1e-6)
    for k in ("b1", "b2"):
        np.testing.assert_allclose(getattr(ht, k).numpy()[hit],
                                   np.asarray(getattr(hb, k))[hit],
                                   rtol=0, atol=4e-6)
    assert (t[~hit] == np.float32(3e38)).all()
    assert (ht.tri.numpy()[~hit] == -1).all()


def test_closest_precise_plain_equals_pallas_interpret(dragon, closest):
    jarrs, _ = dragon
    o, d, act, _, ht = closest
    hp = pallas_trace.traverse(jarrs, jnp.asarray(o), jnp.asarray(d),
                               jnp.asarray(3e38), active=jnp.asarray(act),
                               interpret=True, precise=True)
    hit = np.asarray(hp.hit)
    assert np.array_equal(ht.hit.numpy(), hit)
    assert np.array_equal(ht.tri.numpy()[hit], np.asarray(hp.tri)[hit])
    np.testing.assert_allclose(ht.t.numpy()[hit], np.asarray(hp.t)[hit],
                               rtol=1e-6)


def test_closest_precise_plain_bit_exact_op_by_op(dragon, closest):
    """t, b1, b2 equal, bit for bit, the JAX ``intersect_triangle`` of the
    hit triangle evaluated op by op (not jitted)."""
    jarrs, _ = dragon
    o, d, _, _, ht = closest
    hit = ht.hit.numpy()
    row = np.asarray(jarrs.tri9)[ht.tri.numpy()[hit]]
    t, b1, b2, h = jmath.intersect_triangle(
        jnp.asarray(o[hit]), jnp.asarray(d[hit]), jnp.asarray(row[:, 0:3]),
        jnp.asarray(row[:, 3:6]), jnp.asarray(row[:, 6:9]), jnp.float32(3e38))
    assert np.asarray(h).all()
    for a, b in ((t, ht.t), (b1, ht.b1), (b2, ht.b2)):
        assert np.array_equal(np.asarray(a), b.numpy()[hit])


@pytest.mark.parametrize("t_max", [3e38, 2.5])
def test_anyhit_precise_plain_equals_bvh_and_pallas(dragon, t_max):
    jarrs, tarrs = dragon
    o, d = _rays(N, 6)
    act = np.random.default_rng(7).uniform(size=N) < 0.7
    tmax = np.full(N, t_max, np.float32)
    ob = jax.jit(lambda o, d: jtrace.intersect_p(
        jarrs, o, d, jnp.asarray(tmax), active=jnp.asarray(act),
        method="bvh"))(jnp.asarray(o), jnp.asarray(d))
    op = pallas_trace.traverse(jarrs, jnp.asarray(o), jnp.asarray(d),
                               jnp.asarray(tmax), active=jnp.asarray(act),
                               any_hit=True, interpret=True, precise=True)
    ot = ttrace.intersect_p(tarrs, _v3(o), _v3(d), torch.from_numpy(tmax),
                            active=torch.from_numpy(act), precise=True).numpy()
    assert np.array_equal(ot, np.asarray(ob))
    assert np.array_equal(ot, np.asarray(op))
    assert ot.any() and not ot[~act].any() and not ot[act].all()


def test_precise_anyhit_equals_closest_within_tmax(dragon):
    _, tarrs = dragon
    o, d = _rays(512, 9)
    tmax = np.random.default_rng(10).uniform(1.0, 4.0, 512).astype(np.float32)
    h = ttrace.intersect(tarrs, _v3(o), _v3(d), precise=True)
    occ = ttrace.intersect_p(tarrs, _v3(o), _v3(d), torch.from_numpy(tmax),
                             precise=True)
    agree = occ == (h.hit & (h.t < torch.from_numpy(tmax)))
    # the bound test runs on t_scaled before the divide: a hit whose t lies
    # within an ulp of t_max may fall on either side
    assert agree.float().mean() >= 0.998
    short = ttrace.intersect(tarrs, _v3(o), _v3(d), t_max=0.5, precise=True)
    assert not short.hit.any()


def test_precise_plain_equals_intersect_brute():
    """The precise plain version against the oracle built on
    ``intersect_triangle`` (first-index argmin), on a bunny."""
    m = tmesh.bunny(subdiv=12)
    p = m.positions[m.indices]
    fb = tbvh.build_bvh(p.min(1), p.max(1))
    arrs = ttrace.pack_bvh(fb, p[fb.order])
    o, d = _rays(256, 12)
    h = ttrace.intersect(arrs, _v3(o), _v3(d), precise=True)
    po = torch.from_numpy(p[fb.order])
    hb = ttrace.intersect_brute(po[:, 0], po[:, 1], po[:, 2],
                                torch.from_numpy(o), torch.from_numpy(d))
    assert torch.equal(h.hit, hb.hit) and h.hit.any() and not h.hit.all()
    assert torch.equal(h.tri[h.hit], hb.tri[h.hit])
    for k in ("t", "b1", "b2"):
        assert torch.equal(getattr(h, k)[h.hit], getattr(hb, k)[h.hit])


def _closed_box_diagonal_rays(n):
    """A closed box [-1, 1]^3 of 12 triangles, and axis-aligned rays from
    inside onto the shared diagonal of its z = -1 face."""
    box = [tmesh.quad(*q) for q in (
        ([-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1]),
        ([-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]),
        ([-1, -1, -1], [1, -1, -1], [1, -1, 1], [-1, -1, 1]),
        ([-1, 1, -1], [1, 1, -1], [1, 1, 1], [-1, 1, 1]),
        ([-1, -1, -1], [-1, 1, -1], [-1, 1, 1], [-1, -1, 1]),
        ([1, -1, -1], [1, 1, -1], [1, 1, 1], [1, -1, 1]))]
    p = np.concatenate([q.positions[q.indices] for q in box])
    fb = tbvh.build_bvh(p.min(1), p.max(1))
    arrs = ttrace.pack_bvh(fb, p[fb.order])
    s = np.linspace(-0.999, 0.999, n).astype(np.float32)
    # the quad's triangles (0,1,2) and (0,2,3) share the diagonal x = y
    o = np.stack([s, s, np.full(n, 0.25, np.float32)], -1)
    d = np.tile(np.asarray([[0.0, 0.0, -1.0]], np.float32), (n, 1))
    return arrs, o, d


def test_watertight_across_shared_diagonal():
    """Every axis-aligned ray onto a quad's shared diagonal hits with the
    precise test.  How many leak with the fast test is printed, not
    asserted."""
    arrs, o, d = _closed_box_diagonal_rays(2048)
    h = ttrace.intersect(arrs, _v3(o), _v3(d), precise=True)
    assert h.hit.all()
    np.testing.assert_allclose(h.t.numpy(), 1.25, rtol=1e-6)
    # oblique rays through the same diagonal points
    o2 = o + np.asarray([0.3, -0.2, 0.0], np.float32)
    d2 = (np.concatenate([o[:, :2], np.full((len(o), 1), -1.0)], -1)
          - o2).astype(np.float32)
    h2 = ttrace.intersect(arrs, _v3(o2), _v3(d2), precise=True)
    assert h2.hit.all()
    fast = ttrace.intersect(arrs, _v3(o2), _v3(d2), precise=False)
    print("fast test leaks on", int((~fast.hit).sum()), "of", len(o), "rays")


def test_precise_axis_tie_follows_ray_setup():
    """|dx| = |dy| > |dz|: the kernels and their plain versions take y as
    the shear axis (``_ray_setup``), ``intersect_triangle`` takes x; both
    hit the triangle at the same t."""
    tri = np.asarray([[[-1, -1, -2], [3, -1, -2.5], [-1, 3, -2.2]]], np.float32)
    fb = tbvh.build_bvh(tri.min(1), tri.max(1))
    arrs = ttrace.pack_bvh(fb, tri[fb.order])
    o = np.zeros((1, 3), np.float32)
    d = np.asarray([[0.1, 0.1, -1.0], [0.5, 0.5, -0.25]], np.float32)
    o = np.tile(o, (2, 1))
    d[1] = d[1] / np.linalg.norm(d[1])
    h = ttrace.intersect(arrs, _v3(o), _v3(d), precise=True)
    hb = ttrace.intersect_brute(*(torch.from_numpy(tri[:, k]) for k in range(3)),
                                torch.from_numpy(o), torch.from_numpy(d))
    assert torch.equal(h.hit, hb.hit)
    np.testing.assert_allclose(h.t.numpy(), hb.t.numpy(), rtol=1e-6)


def test_precise_wrappers_reject_foreign_device(dragon):
    _, tarrs = dragon
    o, d = _rays(4, 11)
    rays = ttrace.pack_rays(_v3(o), _v3(d), 1.0).to("meta")
    with pytest.raises(ValueError):
        cuda_trace.closest_hit_precise(tarrs, rays)
    with pytest.raises(ValueError):
        cuda_trace.any_hit_precise(tarrs.nodes_f, tarrs.nodes_i, tarrs.tri9,
                                   tarrs.stack_depth, rays)
