"""Port vs JAX: the watertight ray/triangle test, its Dekker-compensated
difference of products, and the slab test.

The port's functions run op by op in float32 exactly as the JAX functions
do when they are not jitted, so the two must agree bit for bit; the
edge-function signs are also held against float64.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pathtracer.utils import math as jmath
from tpu_pathtracer_torch.utils import math as tmath


def _tri_inputs(seed, n, near_edge):
    """Rays aimed at a point of their triangle: a random interior point,
    or a point on the edge p0-p1 (plus a few ulps of noise)."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)) * 2.0
    p = [rng.normal(size=(n, 3)) * 0.7 + [0.0, 0.0, -3.0] for _ in range(3)]
    if near_edge:
        s = rng.uniform(size=(n, 1))
        target = p[0] * (1 - s) + p[1] * s
    else:
        b = rng.dirichlet(np.ones(3), size=n)
        target = sum(p[k] * b[:, k:k + 1] for k in range(3))
        target = target + rng.normal(size=(n, 3)) * 0.4
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return [a.astype(np.float32) for a in (o, d, *p)]


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("near_edge", [False, True])
@pytest.mark.parametrize("t_max", [3e38, 4.0])
def test_intersect_triangle_bit_exact(near_edge, t_max):
    args = _tri_inputs(1 + near_edge, 4096, near_edge)
    jt = jmath.intersect_triangle(*map(jnp.asarray, args), jnp.float32(t_max))
    tt = tmath.intersect_triangle(*map(torch.from_numpy, args),
                                  torch.tensor(t_max))
    hit = np.asarray(jt[3])
    assert np.array_equal(tt[3].numpy(), hit)
    assert 0.05 < hit.mean() < 0.95
    for a, b in zip(jt[:3], tt[:3]):
        assert np.array_equal(_bits(a)[hit], _bits(b.numpy())[hit])


@pytest.mark.parametrize("scale", [1.0, 1e-3, 1e3])
def test_diff_of_products_sign_is_exact(scale):
    """Nearly cancelling products: the sign equals the float64 sign, and
    the value equals the JAX function's bit for bit."""
    rng = np.random.default_rng(3)
    a = (rng.normal(size=8192) * scale).astype(np.float32)
    b = rng.normal(size=8192).astype(np.float32)
    c = (a * (1 + rng.integers(-2, 3, 8192) * 2.0 ** -23)).astype(np.float32)
    d = (b * (1 + rng.integers(-2, 3, 8192) * 2.0 ** -23)).astype(np.float32)
    exact = a.astype(np.float64) * b - c.astype(np.float64) * d
    t = tmath._diff_of_products(*map(torch.from_numpy, (a, b, c, d))).numpy()
    j = jmath._diff_of_products(*map(jnp.asarray, (a, b, c, d)))
    assert np.array_equal(_bits(j), _bits(t))
    assert np.array_equal(np.sign(t), np.sign(exact))
    naive = a * b - c * d
    assert (np.sign(naive) != np.sign(exact)).any()   # the plain form fails


def test_intersect_aabb_matches():
    rng = np.random.default_rng(4)
    n = 2048
    o = rng.normal(size=(n, 3)).astype(np.float32) * 3
    lo = rng.uniform(-1, 0, (n, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.1, 2, (n, 3)).astype(np.float32)
    # aimed near the box centre, so that about half of the rays hit
    d = ((lo + hi) / 2 + rng.normal(size=(n, 3)) - o).astype(np.float32)
    d[::7, 0] = 0.0                       # flat rays: inv_d = inf
    with np.errstate(divide="ignore"):
        inv = (1.0 / d).astype(np.float32)
    jn, jh = jmath.intersect_aabb(*map(jnp.asarray, (o, inv, lo, hi)),
                                  jnp.float32(5.0))
    tn, th = tmath.intersect_aabb(*map(torch.from_numpy, (o, inv, lo, hi)),
                                  torch.tensor(5.0))
    assert np.array_equal(th.numpy(), np.asarray(jh))
    assert 0.05 < th.float().mean() < 0.95
    ok = np.isfinite(np.asarray(jn))
    assert np.array_equal(tn.numpy()[ok], np.asarray(jn)[ok])
