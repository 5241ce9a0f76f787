"""The reference films of a progressive render, at sampled pixels.

Every sampler draw is a pure function of (pixel, sample, dimension) and a
wavefront lane adds its pixel's samples to the film in sample order, so
the program's film after each pass is, pixel by pixel, the running sum of
that pixel's per-sample estimates.  ``pass_films`` works those out again
with the frozen copy: one lane per (pixel, sample), each running the
program's wavefront step (``_wavefront_step``) on exactly one sample, then
the sums in sample order.
"""
from __future__ import annotations

import torch

from .tpt.render import integrator as integ
from .tpt.render.sampler import make_sampler
from .tpt.scene.types import map_tensors

LOWER = {"float32": None, "bfloat16": torch.bfloat16}


def rounded(x, dtype):
    """x with every float32 tensor rounded to ``dtype`` and back (None:
    x itself): the control's arithmetic at the lower precision."""
    if dtype is None:
        return x

    def rnd(t):
        return t.to(dtype).to(t.dtype) if t.dtype == torch.float32 else t
    if isinstance(x, dict):
        return {k: rounded(v, dtype) for k, v in x.items()}
    return map_tensors(rnd, x)


def per_sample_rgb(scene, meta, camera, cfg, pixels, precision="float32"):
    """(K, spp, 3) linear RGB of each sample of the flat pixel ids
    ``pixels`` (K,), through the program's wavefront step.  Returns it
    with the steps run."""
    dev = scene.device
    lower = LOWER[precision]
    scene = rounded(scene, lower)
    k, spp = pixels.shape[0], cfg.spp
    pix = pixels.to(torch.int32).repeat_interleave(spp)
    px = torch.stack([pix % cfg.width, pix // cfg.width], -1).to(torch.int32)
    samples = torch.arange(spp, dtype=torch.int32,
                           device=dev).repeat(k)
    spp_end = samples + 1
    sampler = make_sampler(cfg.sampler, cfg.seed, cfg.spp,
                           (cfg.width, cfg.height))
    table = integ._spectral_table(scene)
    state = integ._wavefront_init(px.shape[0], 0,
                                  torch.zeros((px.shape[0], 3), device=dev))
    state["sample"] = samples - 1
    steps = 0
    with torch.no_grad():
        while True:
            for _ in range(integ.SYNC_EVERY):
                state = integ._wavefront_step(scene, meta, camera, cfg,
                                              sampler, px, spp_end, state,
                                              table)
                state = rounded(state, lower)
                steps += 1
            if integ._tile_done(state, spp_end):
                break
    a = state["accum"]
    return torch.stack([a.x, a.y, a.z], -1).reshape(k, spp, 3), steps


def pass_films(scene, meta, camera, cfg, pixels, chunk_spp,
               precision="float32"):
    """(n_passes, K, 3): the film of the pixels ``pixels`` after each pass
    of ``chunk_spp`` samples, each the running sum in sample order."""
    rgb, _ = per_sample_rgb(scene, meta, camera, cfg, pixels, precision)
    acc = torch.zeros_like(rgb[:, 0])
    out = []
    for s in range(cfg.spp):
        acc = acc + rgb[:, s]
        if (s + 1) % chunk_spp == 0 or s + 1 == cfg.spp:
            out.append(acc)
    return torch.stack(out, 0)
