"""The port's native SAH builder (``tpu_pathtracer_torch/native.py``,
``csrc/bvh_builder.cpp``) against the JAX package's (``native.py``,
``native/bvh_builder.cpp``).

Port copies of tests/test_native.py's three cases (the walk of the
kernels over the native tree against brute force, the tree's size and
depth against the numpy build, degenerate boxes), and:

  * the port's ``FlatBVH`` equal to the JAX package's native build, bit
    for bit (the same source built with the same flags), on the bunny, the
    dragon, float64 boxes (an instanced group's) and degenerate inputs;
  * the scene builder's choice: the native build by default, the numpy
    build with one warning under ``TPT_NO_NATIVE`` or without a compiler.

Both packages build their library with the machine's g++; without one the
cases that need it skip (as tests/test_native.py does).
"""
import time
import warnings

import numpy as np
import pytest
import torch

from tpu_pathtracer import native as jnative
from tpu_pathtracer_torch import native as tnative
from tpu_pathtracer_torch.ops import cuda_trace
from tpu_pathtracer_torch.ops import trace as ttrace
from tpu_pathtracer_torch.scene import builder as tbuilder
from tpu_pathtracer_torch.scene import bvh as tbvh
from tpu_pathtracer_torch.scene import mesh as tmesh
from tpu_pathtracer_torch.utils.vec import V3

FIELDS = ("bounds_min", "bounds_max", "left", "right", "count", "order")


@pytest.fixture(scope="module")
def native_builds():
    """Skip without a C++ compiler; make sure the JAX package's library
    has loaded (its first load may race with another test process that is
    building it)."""
    if tnative.compiler() is None:
        pytest.skip("no C++ compiler")
    assert tnative.available()
    jax_native_ready()


def jax_native_ready(wait_s: float = 120.0):
    """The JAX package's native builder, loaded: ``make`` writes its
    library in place, so a process that opens it while another one is
    building it sees a partial file and gives up for good; retry until
    the build is done."""
    deadline = time.monotonic() + wait_s
    while not jnative.available():
        assert time.monotonic() < deadline, \
            "the JAX package's native builder failed to load"
        time.sleep(1.0)
        jnative._tried = False


def _tris(m):
    return m.positions[m.indices]


def _same_tree(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert a.depth == b.depth


CASES = {
    "bunny": lambda: _tris(tmesh.bunny()),
    "dragon": lambda: _tris(tmesh.dragon()),
    # an instanced group's boxes are float64 (the builder casts them)
    "bunny_float64": lambda: _tris(tmesh.bunny(subdiv=20)).astype(np.float64),
    "same_centroids": lambda: np.stack([np.zeros((37, 3)),
                                        np.ones((37, 3)),
                                        np.full((37, 3), 0.5)], 1),
    "one_triangle": lambda: _tris(tmesh.dragon(n_u=4, n_v=3))[:1],
    "flat_in_z": lambda: np.concatenate(
        [_tris(tmesh.uv_sphere(n_theta=6, n_phi=8))[..., :2],
         np.zeros((96, 3, 1))], -1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_flat_bvh_equals_jax_native(native_builds, case):
    p = CASES[case]()
    lo, hi = p.min(1), p.max(1)
    _same_tree(tnative.build_bvh_native(lo, hi),
               jnative.build_bvh_native(lo, hi))


# ---------------------------------------------------------------------------
# Port copies of tests/test_native.py
# ---------------------------------------------------------------------------

def _v3(a):
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return V3(t[:, 0], t[:, 1], t[:, 2])


@pytest.mark.parametrize("precise", [False, True])
def test_native_build_matches_brute_force(native_builds, precise):
    """The kernels' walk of the native tree (``walk_wide_plain``, closest
    and any hit) against the brute-force plain versions on every ray, bit
    for bit, fast and precise."""
    p = _tris(tmesh.bunny(subdiv=16))
    fb = tnative.build_bvh_native(p.min(1), p.max(1))
    arrs = ttrace.pack_bvh(fb, p[fb.order])
    rng = np.random.default_rng(0)
    o = rng.normal(size=(512, 3))
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * 3.0
    d = rng.normal(size=(512, 3)) * 0.3 - o
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    rays = ttrace.pack_rays(_v3(o), _v3(d), 3.0e38)
    walk = cuda_trace.walk_wide_plain(arrs, rays, precise=precise)
    ref = (cuda_trace.closest_hit_precise_plain(arrs.tri9, rays) if precise
           else cuda_trace.closest_hit_plain(arrs.tri_m12, rays))
    for x, y in zip(walk, ref):
        assert torch.equal(x, y)
    assert 0 < int(walk[4].sum()) < 512
    occ = cuda_trace.walk_wide_plain(arrs, rays, precise=precise,
                                     any_hit=True)
    assert torch.equal(occ, ref[4])


def test_native_tree_quality_matches_python(native_builds):
    m = tmesh.dragon(n_u=96, n_v=12)
    p = _tris(m)
    fb_c = tnative.build_bvh_native(p.min(1), p.max(1))
    fb_py = tbvh.build_bvh(p.min(1), p.max(1))
    assert fb_c.n_nodes == fb_py.n_nodes
    assert fb_c.depth == fb_py.depth
    assert np.sort(fb_c.order).tolist() == list(range(len(p)))
    leaf = fb_c.count > 0
    assert fb_c.count[leaf].max() <= tbvh.MAX_LEAF_SIZE


def test_degenerate_inputs(native_builds):
    # all centroids identical -> median splits, no infinite loop
    tmin = np.zeros((37, 3), np.float32)
    tmax = np.ones((37, 3), np.float32)
    fb = tnative.build_bvh_native(tmin, tmax)
    leaf = fb.count > 0
    assert fb.count[leaf].sum() == 37
    assert fb.count[leaf].max() <= tbvh.MAX_LEAF_SIZE
    with pytest.raises(ValueError):
        tnative.build_bvh_native(tmin[:, :2], tmax[:, :2])


# ---------------------------------------------------------------------------
# The scene builder's choice of builder
# ---------------------------------------------------------------------------

def test_scene_builder_prefers_native(native_builds, monkeypatch):
    p = _tris(tmesh.bunny(subdiv=12))
    lo, hi = p.min(1), p.max(1)
    monkeypatch.delenv("TPT_NO_NATIVE", raising=False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _same_tree(tbuilder.sah_bvh(lo, hi), tnative.build_bvh_native(lo, hi))
    monkeypatch.setenv("TPT_NO_NATIVE", "1")
    with pytest.warns(UserWarning, match="TPT_NO_NATIVE") as got:
        fb = tbuilder.sah_bvh(lo, hi)
    assert len(got) == 1
    _same_tree(fb, tbvh.build_bvh(lo, hi))


def test_scene_builder_without_compiler_uses_numpy(monkeypatch):
    """No C++ compiler: ``build_bvh_native`` gives None and the builder
    the numpy build, with one warning."""
    monkeypatch.delenv("TPT_NO_NATIVE", raising=False)
    monkeypatch.setattr(tnative, "compiler", lambda: None)
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_tried", False)
    p = _tris(tmesh.bunny(subdiv=12))
    lo, hi = p.min(1), p.max(1)
    assert tnative.build_bvh_native(lo, hi) is None
    with pytest.warns(UserWarning, match="no C\\+\\+ compiler") as got:
        fb = tbuilder.sah_bvh(lo, hi)
    assert len(got) == 1
    _same_tree(fb, tbvh.build_bvh(lo, hi))

