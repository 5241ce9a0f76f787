"""CPU tests of the reference: its BVH walk against brute force, and its
films and fit steps against the program's at a small size."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import yardstick
from benchmark.reference import fit as ref_fit
from benchmark.reference import render as ref_render
from benchmark.reference.tpt.ops import bvh_ref, trace

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def soup():
    pos, _, idx = yardstick.dragon_sweep(64, 8)
    wall = np.asarray([[[-3, -1, -3], [3, -1, -3], [3, -1, 3]],
                       [[-3, -1, -3], [3, -1, 3], [-3, -1, 3]]], np.float32)
    p = np.concatenate([pos[idx].astype(np.float32), wall])
    fb = bvh_ref.build_bvh(p.min(1), p.max(1))
    assert fb.n_big == 2
    g = torch.Generator().manual_seed(0)
    n = 3000
    o = torch.randn(n, 3, generator=g) * 1.5
    d = torch.randn(n, 3, generator=g)
    d = d / d.norm(dim=1, keepdim=True)
    tmax = torch.where(torch.rand(n, generator=g) < 0.1, -1.0, 3e38)
    rays = torch.cat([o.T, d.T, tmax[None]]).contiguous().float()
    return trace.pack_bvh(fb, p[fb.order]), rays


@pytest.mark.parametrize("precise", [False, True])
def test_walk_is_brute_force(soup, precise):
    from tpu_pathtracer_torch.ops import cuda_trace
    bvh, rays = soup
    got = bvh_ref.walk(bvh, rays, precise=precise)
    want = (cuda_trace.closest_hit_precise_plain(bvh.tri9, rays) if precise
            else cuda_trace.closest_hit_plain(bvh.tri_m12, rays))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    short = rays.clone()
    short[6] = torch.where(rays[6] > 0, got[0] * 0.999, rays[6])
    occ = bvh_ref.walk(bvh, short, precise=precise, any_hit=True)
    want = (cuda_trace.any_hit_precise_plain(bvh.tri9, short) if precise
            else cuda_trace.any_hit_plain(bvh.tri_m12, short))
    assert torch.equal(occ, want)


SMALL = dict(width=20, height=12, spp=8, max_depth=16)


@pytest.fixture(scope="module")
def scene17():
    from tpu_pathtracer_torch import scenes
    from benchmark.reference.tpt import scenes as rscenes
    w, h = SMALL["width"], SMALL["height"]
    return (scenes.load_scene(17, w, h, device="cpu"),
            rscenes.load_scene(17, w, h, device="cpu"))


@pytest.mark.parametrize("strategy,sampler", [("mis", "sobol"),
                                              ("pt", "random")])
def test_reference_films_are_the_programs(scene17, strategy, sampler):
    from tpu_pathtracer_torch.render import integrator as integ
    from benchmark.reference.tpt.render import integrator as rinteg
    (s, m, c), (rs, rm, rc) = scene17
    seed = 2 ** 33 + 7
    cfg = integ.RenderConfig(**SMALL, strategy=strategy, sampler=sampler,
                             seed=seed)
    acc = np.zeros((SMALL["width"] * SMALL["height"], 3), np.float32)
    films = []
    for k in range(2):
        acc = integ.render_accum(s, m, c, cfg, spp_start=4 * k,
                                 spp_end=4 * k + 4,
                                 accum_init=torch.from_numpy(acc)).numpy()
        films.append(acc)
    pix = torch.tensor([0, 7, 61, 100, 150, 239])
    ref = ref_render.pass_films(
        rs, rm, rc, rinteg.RenderConfig(**SMALL, strategy=strategy,
                                        sampler=sampler, seed=seed), pix, 4)
    for k in range(2):
        assert np.array_equal(films[k][pix.numpy()], ref[k].numpy())


def test_reference_fit_is_the_programs(scene17):
    from tpu_pathtracer_torch import parallel
    from tpu_pathtracer_torch.render import integrator as integ
    from benchmark.reference.tpt.render import integrator as rinteg
    (s, m, c), (rs, rm, rc) = scene17
    kw = dict(width=20, height=12, spp=2, max_depth=3, seed=5)
    target = ref_fit.make_target(5, 240, torch.device("cpu"))
    state = parallel.make_train_state(s, lr=0.05, device="cpu")
    state.params = ref_fit.start_params(parallel.extract_params(s))
    state, loss = parallel.train_step_adam(state, s, m, c,
                                           integ.RenderConfig(**kw), target,
                                           device="cpu")
    mus = [state.mu]
    state, loss2 = parallel.train_step_adam(state, s, m, c,
                                            integ.RenderConfig(**kw), target,
                                            device="cpu")
    mus.append(state.mu)
    ref = ref_fit.follow(rs, rm, rc, rinteg.RenderConfig(**kw), 5, 0.05, 2)
    assert float(loss) == ref["losses"][0]
    # the reference runs both samples in one call, so its backward adds in
    # another order: the rest agrees to rounding, not bit for bit
    assert abs(float(loss2) - ref["losses"][1]) <= 1e-5 * ref["losses"][1]
    for got, want in zip(ref_fit.gradients(mus), ref["grads"]):
        for k, g in want.items():
            assert torch.allclose(got[k], g, rtol=1e-5, atol=1e-6)
    for k, p in ref["params"][1].items():
        assert torch.allclose(state.params[k], p, rtol=1e-5, atol=1e-6)
