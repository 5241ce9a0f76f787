"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip where there is no GPU (a CUDA kernel has no CPU
mode).  Run them on a machine with an H100 and nvcc:
``python -m pytest tests/test_torch_cuda.py``.  chip_smoke.py holds the
same kernels against the plain versions at the main path's full size.
"""
import dataclasses

import numpy as np
import pytest
import torch

from tpu_pathtracer_torch.ops import cuda_trace
from tpu_pathtracer_torch.ops import trace as ttrace
from tpu_pathtracer_torch.scene import bvh as tbvh
from tpu_pathtracer_torch.scene import mesh as tmesh
from tpu_pathtracer_torch.utils.vec import V3

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def dragon(dev):
    m = tmesh.dragon(n_u=96, n_v=12)
    p = m.positions[m.indices]
    fb = tbvh.build_bvh(p.min(1), p.max(1))
    return ttrace.pack_bvh(fb, p[fb.order]).to(dev)


def _rays(n, seed, dev):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * 3.0
    d = rng.normal(size=(n, 3)) * 0.3 - o
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    act = rng.uniform(size=n) < 0.8
    tmax = rng.uniform(1.0, 5.0, n)

    def v3(a):
        t = torch.tensor(a, dtype=torch.float32, device=dev)
        return V3(t[:, 0], t[:, 1], t[:, 2])
    return (v3(o), v3(d), torch.tensor(act, device=dev),
            torch.tensor(tmax, dtype=torch.float32, device=dev))


def _assert_closest_equal(got, ref):
    """Every output of a closest-hit kernel equals the reference's on
    every ray, bit for bit."""
    for a, b, what in zip(got, ref, ("t", "tri", "b1", "b2", "hit")):
        assert torch.equal(a, b), what


def test_closest_hit_kernel_matches_plain(dragon, dev):
    o, d, act, _ = _rays(8192, 0, dev)
    rays = ttrace.pack_rays(o, d, ttrace.BIG_T, act)
    before = cuda_trace.LAUNCHES["closest_hit"]
    got = cuda_trace.closest_hit(dragon, rays)
    assert cuda_trace.LAUNCHES["closest_hit"] == before + 1
    ref = cuda_trace.closest_hit_plain(dragon.tri_m12, rays)
    torch.cuda.synchronize()
    _assert_closest_equal(got, ref)
    assert got[4].any() and not got[4][~act].any()


def test_any_hit_kernel_matches_plain_and_counts(dragon, dev):
    o, d, act, tmax = _rays(8192, 1, dev)
    rays = ttrace.pack_rays(o, d, tmax, act)
    counters = torch.zeros(2, dtype=torch.int64, device=dev)
    got = cuda_trace.any_hit(dragon.nodes_f, dragon.nodes_i, dragon.tri_m12,
                             dragon.stack_depth, rays, counters=counters)
    ref = cuda_trace.any_hit_plain(dragon.tri_m12, rays)
    torch.cuda.synchronize()
    assert (got == ref).float().mean().item() >= 0.9999
    assert not got[~act].any()
    visits, tests = counters.tolist()
    assert visits > 0 and tests > 0


def test_closest_hit_precise_kernel_matches_plain(dragon, dev):
    o, d, act, _ = _rays(8192, 3, dev)
    rays = ttrace.pack_rays(o, d, ttrace.BIG_T, act)
    before = cuda_trace.LAUNCHES["closest_hit_precise"]
    counters = torch.zeros(4, dtype=torch.int64, device=dev)
    got = cuda_trace.closest_hit_precise(dragon, rays, counters=counters)
    assert cuda_trace.LAUNCHES["closest_hit_precise"] == before + 1
    ref = cuda_trace.closest_hit_precise_plain(dragon.tri9, rays)
    torch.cuda.synchronize()
    _assert_closest_equal(got, ref)
    assert got[4].any() and not got[4][~act].any()
    assert min(counters.tolist()) > 0


@pytest.mark.parametrize("precise", [False, True], ids=["fast", "precise"])
def test_closest_hit_kernels_match_v1_and_count(dragon, dev, precise):
    """The wide kernels against the binary walk they replaced, with live,
    short and dead rays; the (4,) counters hold sums and per-ray maxima."""
    o, d, act, tmax = _rays(8192, 5, dev)
    tmax = torch.where(torch.arange(8192, device=dev) % 3 == 0, tmax,
                       torch.full_like(tmax, ttrace.BIG_T))
    rays = ttrace.pack_rays(o, d, tmax, act)
    suffix = "_precise" if precise else ""
    new = getattr(cuda_trace, "closest_hit" + suffix)
    old = getattr(cuda_trace, "closest_hit" + suffix + "_v1")
    c_new = torch.zeros(4, dtype=torch.int64, device=dev)
    c_old = torch.zeros(4, dtype=torch.int64, device=dev)
    before = cuda_trace.LAUNCHES["closest_hit" + suffix + "_v1"]
    got = new(dragon, rays, counters=c_new)
    ref = old(dragon, rays, counters=c_old)
    assert cuda_trace.LAUNCHES["closest_hit" + suffix + "_v1"] == before + 1
    torch.cuda.synchronize()
    _assert_closest_equal(got, ref)
    n_live = int((rays[6] > 0).sum())
    for visits, tests, max_visits, max_tests in (c_new.tolist(),
                                                 c_old.tolist()):
        assert 0 < max_visits <= visits <= max_visits * n_live
        assert 0 < max_tests <= tests <= max_tests * n_live
    # a wide visit stands for up to three binary ones
    assert c_new[0] < c_old[0]
    # at most one block a 128 rays, and no more than the card holds at once
    info = cuda_trace.closest_hit_launch_info(8192, precise)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert info["registers"] > 0 and info["blocks_per_sm"] >= 1
    assert info["grid"] == min(8192 // 128, sms * info["blocks_per_sm"])
    assert cuda_trace.closest_hit_launch_info(100, precise)["grid"] == 1


@pytest.mark.parametrize("precise", [False, True], ids=["fast", "precise"])
@pytest.mark.parametrize("n", [1, 31, 33, 129, 4097])
def test_closest_hit_kernels_small_and_sparse_launches(dragon, dev, precise, n):
    """Launches smaller than a warp or a block, and ones whose lanes are
    mostly dead, as late wavefront steps make them."""
    o, d, act, _ = _rays(n, 6 + n, dev)
    sparse = act & (torch.arange(n, device=dev) % 16 == 0)
    plain, table = ((cuda_trace.closest_hit_precise_plain, dragon.tri9)
                    if precise else
                    (cuda_trace.closest_hit_plain, dragon.tri_m12))
    kern = cuda_trace.closest_hit_precise if precise else cuda_trace.closest_hit
    for active in (torch.ones_like(act), sparse, torch.zeros_like(act)):
        rays = ttrace.pack_rays(o, d, ttrace.BIG_T, active)
        got = kern(dragon, rays)
        ref = plain(table, rays)
        torch.cuda.synchronize()
        _assert_closest_equal(got, ref)


def test_any_hit_precise_kernel_matches_plain(dragon, dev):
    o, d, act, tmax = _rays(8192, 4, dev)
    rays = ttrace.pack_rays(o, d, tmax, act)
    before = cuda_trace.LAUNCHES["any_hit_precise"]
    got = cuda_trace.any_hit_precise(dragon.nodes_f, dragon.nodes_i,
                                     dragon.tri9, dragon.stack_depth, rays)
    assert cuda_trace.LAUNCHES["any_hit_precise"] == before + 1
    ref = cuda_trace.any_hit_precise_plain(dragon.tri9, rays)
    torch.cuda.synchronize()
    assert (got == ref).float().mean().item() >= 0.9999
    assert got.any() and not got[~act].any()


def test_precise_watertight_on_shared_diagonal(dev):
    """Axis-aligned rays onto the shared diagonal of a quad: the precise
    kernel hits on every ray."""
    quad = tmesh.quad([-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0])
    p = quad.positions[quad.indices]
    fb = tbvh.build_bvh(p.min(1), p.max(1))
    arrs = ttrace.pack_bvh(fb, p[fb.order]).to(dev)
    s = torch.linspace(-0.999, 0.999, 4096, device=dev)
    o = V3(s, s, torch.ones_like(s))
    d = V3(torch.zeros_like(s), torch.zeros_like(s), -torch.ones_like(s))
    h = ttrace.intersect(arrs, o, d, precise=True)
    assert h.hit.all()


def test_wrapper_checks_inputs(dragon, dev):
    o, d, act, _ = _rays(64, 2, dev)
    rays = ttrace.pack_rays(o, d, 1.0, act)
    replace = dataclasses.replace
    for fn in (cuda_trace.closest_hit, cuda_trace.closest_hit_precise):
        with pytest.raises(ValueError):      # the wide rows on the CPU
            fn(replace(dragon, nodes_w=dragon.nodes_w.cpu()), rays)
        # contiguous and 16-byte aligned, but not on a 128-byte line
        flat = torch.zeros(dragon.nodes_w.numel() + 4, device=dev)
        shifted = flat[4:].view_as(dragon.nodes_w).copy_(dragon.nodes_w)
        assert shifted.is_contiguous() and shifted.data_ptr() % 128 == 16
        with pytest.raises(ValueError):
            fn(replace(dragon, nodes_w=shifted), rays)
        with pytest.raises(ValueError):      # more stack than compiled
            fn(replace(dragon, wide_depth=cuda_trace.WIDE_MAX_STACK), rays)
        with pytest.raises(ValueError):
            fn(dragon, rays[:, ::2])
        with pytest.raises(ValueError):      # counters are (4,)
            fn(dragon, rays,
               counters=torch.zeros(2, dtype=torch.int64, device=dev))
    with pytest.raises(ValueError):          # the precise kernel takes tri9p
        cuda_trace.closest_hit_precise(replace(dragon, tri9p=dragon.tri9),
                                       rays)
    with pytest.raises(ValueError):
        cuda_trace.closest_hit_v1(replace(dragon, nodes_f=dragon.nodes_f.cpu()),
                                  rays)
    with pytest.raises(ValueError):
        cuda_trace.any_hit(dragon.nodes_f, dragon.nodes_i, dragon.tri_m12,
                           cuda_trace.MAX_STACK + 1, rays)
    with pytest.raises(ValueError):
        cuda_trace.any_hit(dragon.nodes_f, dragon.nodes_i, dragon.tri_m12,
                           dragon.stack_depth, rays[:, ::2])
    with pytest.raises(ValueError):          # the precise kernels take tri9
        cuda_trace.any_hit_precise(dragon.nodes_f, dragon.nodes_i,
                                   dragon.tri_m12, dragon.stack_depth, rays)
