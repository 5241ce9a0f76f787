"""The slice end to end: scene 17, MIS + Z-Sobol, through the port's
``render`` and the JAX package's wavefront render, on the same scene
(built by the JAX package and carried over with the bridge).

Gates: display RMSE <= 0.01, linear mean within 1 %, ray count (camera +
continuation + NEE shadow rays) within 1 %.  The port traces with the
fast hit test and the JAX package on the CPU with its watertight BVH
walk; the draws are bit-exact, so the films differ only where those two
tests disagree and in the last bits of transcendentals.
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


@pytest.fixture(scope="module")
def renders():
    js, jm, jc = jload(17, W, H, table_res=16)
    jcfg = jint.RenderConfig(width=W, height=H, spp=SPP, max_depth=DEPTH,
                             strategy="mis", sampler="sobol")
    # the body of jint.render, keeping the ray count
    jacc, jrays = jint.render_wavefront(js, jm, jc, jcfg, with_ray_count=True)
    jimg = np.asarray(jfilm.finalize(jacc, SPP, tone_map="reinhard",
                                     eotf="srgb")).reshape(H, W, 3)
    ts, tm, tc = scene_from_numpy(as_numpy_tree(js), jm._asdict(),
                                  dataclasses.asdict(jc), device="cpu")
    tcfg = tint.RenderConfig(width=W, height=H, spp=SPP, max_depth=DEPTH)
    # the body of tint.render (test_render_is_finalized_accum holds the two
    # equal), keeping the linear film
    tacc, stats = tint.render_accum(ts, tm, tc, tcfg, with_stats=True)
    timg = tfilm.finalize(tacc, SPP, tone_map="reinhard",
                          eotf="srgb").reshape(H, W, 3)
    return dict(jimg=jimg, jacc=np.asarray(jacc), jrays=jrays,
                timg=timg.numpy(), tacc=tacc.numpy(), stats=stats,
                scene=(ts, tm, tc), tcfg=tcfg)


def test_slice_display_rmse(renders):
    timg, jimg = renders["timg"], renders["jimg"]
    assert timg.shape == (H, W, 3) and np.isfinite(timg).all()
    rmse = float(np.sqrt(np.mean((timg - jimg) ** 2)))
    assert rmse <= 0.01, rmse


def test_slice_linear_mean_and_ray_count(renders):
    t_mean = renders["tacc"].mean(0) / SPP
    j_mean = renders["jacc"].mean(0) / SPP
    assert (j_mean > 0).all()
    np.testing.assert_allclose(t_mean, j_mean, rtol=0.01)
    stats = renders["stats"]
    assert abs(stats.n_rays - renders["jrays"]) <= 0.01 * renders["jrays"]
    # every lane traces its camera ray per sample at least
    assert stats.n_rays >= W * H * SPP
    assert stats.n_steps >= SPP


def test_empty_sample_range_keeps_the_film(renders):
    ts, tm, tc = renders["scene"]
    init = torch.arange(W * H * 3, dtype=torch.float32).reshape(-1, 3)
    acc, stats = tint.render_accum(ts, tm, tc, renders["tcfg"], spp_start=2,
                                   spp_end=2, accum_init=init,
                                   with_stats=True)
    assert torch.equal(acc, init)
    assert stats.n_steps == 0 and stats.n_rays == 0


def test_render_is_finalized_accum(renders):
    """render() on the CPU = finalize(render_accum()), on an 8x6 film
    split into padded tiles of 20 lanes."""
    ts, tm, tc = renders["scene"]
    cfg = tint.RenderConfig(width=8, height=6, spp=1, max_depth=2,
                            tile_rays=20)
    img = tint.render(ts, tm, tc, cfg, device="cpu")
    acc = tint.render_accum(ts, tm, tc, cfg)
    ref = tfilm.finalize(acc, 1, tone_map="reinhard", eotf="srgb")
    assert img.shape == (6, 8, 3)
    assert torch.equal(img, ref.reshape(6, 8, 3))
