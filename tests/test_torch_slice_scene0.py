"""The precise slice end to end on scene 0 (Lambert bunny): pt + random
and nee + sobol through the port's ``render_accum`` with ``precise=True``
and the JAX package's wavefront render, on the scene built by the JAX
package and carried over with the bridge; the lockstep ``trace_sample``
film against the wavefront film; the albedo and normal AOVs.

Both sides run the same watertight hit test and bit-exact draws, so the
gates are tight: display RMSE <= 0.002, linear mean within 1 %, traced
rays and ``count_rays_one_spp`` within 1 %; AOVs within 1e-5.
"""
import dataclasses

import numpy as np
import pytest
import torch

from tpu_pathtracer.render import film as jfilm
from tpu_pathtracer.render import integrator as jint
from tpu_pathtracer.scenes import load_scene as jload
from tpu_pathtracer_torch.bridge import as_numpy_tree, scene_from_numpy
from tpu_pathtracer_torch.render import film as tfilm
from tpu_pathtracer_torch.render import integrator as tint

W, H, SPP, DEPTH = 32, 24, 4, 6


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """The brute-force plain versions are memory-bound: two threads per
    test process do as well as eight and leave the other cores to the
    other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene0():
    js, jm, jc = jload(0, W, H, table_res=16)
    t = scene_from_numpy(as_numpy_tree(js), jm._asdict(),
                         dataclasses.asdict(jc), device="cpu")
    return (js, jm, jc), t


def _cfgs(strategy, sampler, precise=True, **kw):
    common = dict(width=W, height=H, spp=SPP, max_depth=DEPTH,
                  strategy=strategy, sampler=sampler)
    return (jint.RenderConfig(**common),
            tint.RenderConfig(**common, precise=precise, **kw))


def check_slice(j, t, strategy, sampler, precise=True):
    """Render through both packages and apply the slice gates; the port
    with the watertight hit test, or with the fast one."""
    (js, jm, jc), (ts, tm, tc) = j, t
    jcfg, tcfg = _cfgs(strategy, sampler, precise)
    jacc, jrays = jint.render_wavefront(js, jm, jc, jcfg, with_ray_count=True)
    jimg = np.asarray(jfilm.finalize(jacc, SPP, tone_map="reinhard",
                                     eotf="srgb"))
    tacc, stats = tint.render_accum(ts, tm, tc, tcfg, with_stats=True)
    timg = tfilm.finalize(tacc, SPP, tone_map="reinhard", eotf="srgb").numpy()
    assert np.isfinite(timg).all()
    rmse = float(np.sqrt(np.mean((timg - jimg) ** 2)))
    assert rmse <= 0.002, rmse
    j_mean = np.asarray(jacc).mean(0)
    assert (j_mean > 0).all()
    np.testing.assert_allclose(tacc.numpy().mean(0), j_mean, rtol=0.01)
    assert abs(stats.n_rays - jrays) <= 0.01 * jrays
    jcount = jint.count_rays_one_spp(js, jm, jc, jcfg)
    tcount = tint.count_rays_one_spp(ts, tm, tc, tcfg)
    assert abs(tcount - jcount) <= 0.01 * jcount
    assert tcount >= W * H
    return stats


@pytest.mark.parametrize("strategy,sampler", [("pt", "random"),
                                              ("nee", "sobol")])
def test_slice_scene0_precise(scene0, strategy, sampler):
    stats = check_slice(*scene0, strategy, sampler)
    assert stats.n_steps >= SPP


def test_wavefront_film_equals_trace_sample_film(scene0):
    """As tests/test_render.py gates the JAX package: the regenerative
    wavefront reproduces the lockstep film (nee + random, precise)."""
    _, (ts, tm, tc) = scene0
    _, cfg = _cfgs("nee", "random")
    cfg = dataclasses.replace(cfg, spp=2)
    sampler = tint.make_sampler(cfg.sampler, cfg.seed, cfg.spp, (W, H))
    px = tint._pixel_grid(W, H, "cpu")
    ref = tint._accum_chunk(ts, tm, tc, cfg, sampler, cfg.spp, px, 0,
                            torch.zeros((W * H, 3)))
    wf = tint.render_wavefront(ts, tm, tc, cfg)
    np.testing.assert_allclose(wf.numpy(), ref.numpy(), rtol=2e-5, atol=2e-6)
    assert float(ref.mean()) > 0


def test_count_rays_one_spp_is_tile_invariant(scene0):
    """Padded tiles (copies of pixel 0) are counted out."""
    _, (ts, tm, tc) = scene0
    _, cfg = _cfgs("mis", "sobol")
    whole = tint.count_rays_one_spp(ts, tm, tc, cfg)
    tiled = tint.count_rays_one_spp(
        ts, tm, tc, dataclasses.replace(cfg, tile_rays=500))
    assert whole == tiled and whole > W * H


def test_pt_traces_no_shadow_rays(scene0, monkeypatch):
    """With pt a step launches no any-hit query."""
    from tpu_pathtracer_torch.ops import trace as ttrace
    _, (ts, tm, tc) = scene0
    calls = []
    real = ttrace.intersect_p_scene
    monkeypatch.setattr(ttrace, "intersect_p_scene",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    cfg = tint.RenderConfig(width=8, height=6, spp=1, max_depth=3,
                            strategy="pt", sampler="random", precise=True)
    tint.render_accum(ts, tm, tc, cfg)
    assert not calls
    tint.render_accum(ts, tm, tc, dataclasses.replace(cfg, strategy="nee"))
    assert calls


@pytest.mark.parametrize("strategy", ["albedo", "normal"])
def test_aov_matches(scene0, strategy):
    (js, jm, jc), (ts, tm, tc) = scene0
    jcfg, tcfg = _cfgs(strategy, "sobol", tile_rays=500)   # two padded tiles
    jimg = np.asarray(jint.render(js, jm, jc, jcfg))
    timg = tint.render(ts, tm, tc, tcfg, device="cpu").numpy()
    assert timg.shape == (H, W, 3)
    np.testing.assert_allclose(timg, jimg, rtol=0, atol=1e-5)
    assert timg.std() > 0.05
    with pytest.raises(ValueError):
        tint.render_accum(ts, tm, tc, tcfg, with_stats=True)
