"""Port vs JAX: Z-Sobol draws (bit-exact) and camera rays.

The same (pixel, sample, dim) inputs, made with numpy from a seed, go
through ``tpu_pathtracer.render.sampler.ZSobolSampler`` and its port;
draws must match bit for bit, including per-lane sample and dim arrays
as the regenerative wavefront uses them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pathtracer.render import camera as jcam
from tpu_pathtracer.render import sampler as jsam
from tpu_pathtracer.utils.vec import V2 as JV2
from tpu_pathtracer_torch.render import camera as tcam
from tpu_pathtracer_torch.render import sampler as tsam
from tpu_pathtracer_torch.utils.vec import V2 as TV2


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _inputs(seed, n, res, max_sample, max_dim):
    rng = np.random.default_rng(seed)
    px = np.stack([rng.integers(0, res[0], n), rng.integers(0, res[1], n)],
                  -1).astype(np.int32)
    sample = rng.integers(0, max_sample, n).astype(np.int32)
    dim = rng.integers(0, max_dim, n).astype(np.int32)
    return px, sample, dim


@pytest.mark.parametrize("spp,res", [(4, (1024, 1024)), (2, (32, 24)),
                                     (1, (64, 48)), (64, (1024, 1024))])
def test_zsobol_per_lane_bit_exact(spp, res):
    """get_1d / get_2d with per-lane sample and dim arrays."""
    px, sample, dim = _inputs(spp, 4096, res, spp, 170)
    js = jsam.ZSobolSampler(seed=0, spp=spp, resolution=res)
    ts = tsam.ZSobolSampler(seed=0, spp=spp, resolution=res)
    jpx = jnp.asarray(px)
    tpx = torch.from_numpy(px)
    j1 = js.get_1d(jpx, jnp.asarray(sample), jnp.asarray(dim))
    t1 = ts.get_1d(tpx, torch.from_numpy(sample), torch.from_numpy(dim))
    assert np.array_equal(_bits(j1), _bits(t1.numpy()))
    j2 = js.get_2d(jpx, jnp.asarray(sample), jnp.asarray(dim))
    t2 = ts.get_2d(tpx, torch.from_numpy(sample), torch.from_numpy(dim))
    assert np.array_equal(_bits(j2.x), _bits(t2.x.numpy()))
    assert np.array_equal(_bits(j2.y), _bits(t2.y.numpy()))


@pytest.mark.parametrize("seed", [0, 7])
def test_zsobol_scalar_grid_bit_exact(seed):
    """Scalar (sample, dim) over a (pixel, sample, dim) grid, nonzero seed."""
    res = (32, 24)
    xs, ys = np.meshgrid(np.arange(res[0]), np.arange(res[1]))
    px = np.stack([xs.reshape(-1), ys.reshape(-1)], -1).astype(np.int32)
    js = jsam.ZSobolSampler(seed=seed, spp=8, resolution=res)
    ts = tsam.ZSobolSampler(seed=seed, spp=8, resolution=res)
    for sample in (0, 5):
        for dim in (0, 1, 3, 12, 59):
            j = js.get_1d(jnp.asarray(px), sample, dim)
            t = ts.get_1d(torch.from_numpy(px), sample, dim)
            assert np.array_equal(_bits(j), _bits(t.numpy())), (sample, dim)
            j2 = js.get_2d(jnp.asarray(px), sample, dim)
            t2 = ts.get_2d(torch.from_numpy(px), sample, dim)
            assert np.array_equal(_bits(j2.x), _bits(t2.x.numpy()))
            assert np.array_equal(_bits(j2.y), _bits(t2.y.numpy()))


def test_zsobol_negative_sample_index_matches():
    """Lanes that never regenerate carry sample -1 (uint32 0xFFFFFFFF)."""
    px, _, dim = _inputs(3, 256, (64, 64), 4, 40)
    sample = np.full(256, -1, np.int32)
    js = jsam.ZSobolSampler(seed=0, spp=4, resolution=(64, 64))
    ts = tsam.ZSobolSampler(seed=0, spp=4, resolution=(64, 64))
    j = js.get_1d(jnp.asarray(px), jnp.asarray(sample), jnp.asarray(dim))
    t = ts.get_1d(torch.from_numpy(px), torch.from_numpy(sample),
                  torch.from_numpy(dim))
    assert np.array_equal(_bits(j), _bits(t.numpy()))


def test_fmix32_and_owen_match():
    rng = np.random.default_rng(11)
    v = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    s = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    tv = torch.from_numpy(v.astype(np.int64))
    ts = torch.from_numpy(s.astype(np.int64))
    assert np.array_equal(np.asarray(jsam._fmix32(jnp.asarray(v))),
                          tsam._fmix32(tv).numpy().astype(np.uint32))
    assert np.array_equal(
        np.asarray(jsam._fast_owen(jnp.asarray(v), jnp.asarray(s))),
        tsam._fast_owen(tv, ts).numpy().astype(np.uint32))


@pytest.mark.parametrize("w,h", [(32, 24), (1024, 1024)])
def test_generate_rays_matches(w, h):
    rng = np.random.default_rng(w)
    n = 2048
    px = np.stack([rng.integers(0, w, n), rng.integers(0, h, n)],
                  -1).astype(np.int32)
    uv = rng.uniform(size=(2, n)).astype(np.float32)
    jc = jcam.default_camera(w, h).look_to((0.0, 3.5, 6.0), (0.0, -1.0, -3.0))
    tc = tcam.default_camera(w, h).look_to((0.0, 3.5, 6.0), (0.0, -1.0, -3.0))
    jo, jd, jw = jc.generate_rays(jnp.asarray(px),
                                  JV2(jnp.asarray(uv[0]), jnp.asarray(uv[1])))
    to, td, tw = tc.generate_rays(torch.from_numpy(px),
                                  TV2(torch.from_numpy(uv[0]),
                                      torch.from_numpy(uv[1])))
    for a, b in ((jd.x, td.x), (jd.y, td.y), (jd.z, td.z), (jo.x, to.x),
                 (jw, tw)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-6)
