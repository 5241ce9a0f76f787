"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip where there is no GPU (a CUDA kernel has no CPU
mode).  Run them on a machine with an H100 and nvcc:
``python -m pytest tests/test_torch_cuda.py``.  chip_smoke.py holds the
same kernels against the plain versions at the main path's full size.
"""
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


def test_closest_hit_kernel_matches_plain(dragon, dev):
    o, d, act, _ = _rays(8192, 0, dev)
    rays = ttrace.pack_rays(o, d, ttrace.BIG_T, act)
    before = cuda_trace.LAUNCHES["closest_hit"]
    got = cuda_trace.closest_hit(dragon.nodes_f, dragon.nodes_i,
                                 dragon.tri_m12, dragon.stack_depth, rays)
    assert cuda_trace.LAUNCHES["closest_hit"] == before + 1
    ref = cuda_trace.closest_hit_plain(dragon.tri_m12, rays)
    torch.cuda.synchronize()
    t, tri, b1, b2, hit = got
    same = (hit == ref[4]) & (tri == ref[1])
    assert same.float().mean().item() >= 0.9999
    both = same & hit
    for a, b in ((t, ref[0]), (b1, ref[2]), (b2, ref[3])):
        assert torch.equal(a[both], b[both])
    assert not hit[~act].any()


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


def test_wrapper_checks_inputs(dragon, dev):
    o, d, act, _ = _rays(64, 2, dev)
    rays = ttrace.pack_rays(o, d, 1.0, act)
    with pytest.raises(ValueError):
        cuda_trace.closest_hit(dragon.nodes_f.cpu(), dragon.nodes_i,
                               dragon.tri_m12, dragon.stack_depth, rays)
    with pytest.raises(ValueError):
        cuda_trace.any_hit(dragon.nodes_f, dragon.nodes_i, dragon.tri_m12,
                           cuda_trace.MAX_STACK + 1, rays)
    with pytest.raises(ValueError):
        cuda_trace.any_hit(dragon.nodes_f, dragon.nodes_i, dragon.tri_m12,
                           dragon.stack_depth, rays[:, ::2])
