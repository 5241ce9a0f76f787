"""The progressive-render driver: back-to-back 64 spp images of one
configuration through ``render_progressive``, a pass of ``chunk_spp``
samples at a time, on one card.

Set-up builds the scene (span ``scene.build``), then renders the first
``warm_spp`` samples twice through ``render_accum``: the first call
captures the kept step graph, the second replays it (``graphs.capture_s``
is the difference).  The graph is kept by configuration, not by sample
range, so the window's passes of ``chunk_spp`` samples replay it.
The window then renders images until the first pass boundary past
``seconds``; the ``on_chunk`` hook times each pass and keeps the film of
the sampled check pixels.  With ``trace`` the window's ``render_accum``
calls also return their ``RenderStats``, and after the window one more
pass runs under the profiler inside the benchmark's spans.  Once the
window has closed and the program's memory is freed, the reference works
the sampled pixels' films out again (``reference.render.pass_films``).
"""
from __future__ import annotations

import functools
import gc
import time

import numpy as np
import torch

from .. import yardstick
from ..harness import SPAN, WindowClosed, span, sync


def _config(integ, conf, traffic, seed):
    return integ.RenderConfig(
        width=conf["width"], height=conf["height"], spp=conf["spp"],
        max_depth=conf["max_depth"], strategy=traffic["strategy"],
        sampler=traffic["sampler"], seed=seed)


def check_pixels(conf, traffic, seed) -> np.ndarray:
    """The flat ids of the pixels the check compares, drawn from the seed."""
    n = conf["width"] * conf["height"]
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(n, size=min(traffic["check_pixels"], n),
                              replace=False))


def run(ctx) -> None:
    from tpu_pathtracer_torch.render import graphs
    from tpu_pathtracer_torch.render import integrator as integ
    from tpu_pathtracer_torch.render import progressive

    conf, traffic, dev = ctx.conf, ctx.traffic, ctx.device
    with span(ctx, "scene.build"):
        scene, meta, cam = ctx.config_module.build(
            "tpu_pathtracer_torch", conf, ctx.inputs, conf["width"],
            conf["height"], dev)
        sync(dev)
    cfg = _config(integ, conf, traffic, ctx.seed)
    chunk = traffic["chunk_spp"]
    scene = scene.to(dev)

    # set-up: the first call captures the step graph, the second replays it
    calls = []
    for _ in range(2):
        t0 = time.perf_counter()
        integ.render_accum(scene, meta, cam, cfg, spp_start=0,
                           spp_end=traffic["warm_spp"]).cpu()
        calls.append(time.perf_counter() - t0)
    ctx.layer["graphs.capture_s"] = calls[0] - calls[1]

    rows = check_pixels(conf, traffic, ctx.seed)
    films = []            # (spp done, film at the check pixels) per pass
    stats = []
    real_accum = progressive.render_accum
    if ctx.trace:
        def with_stats(*a, **kw):
            accum, st = real_accum(*a, with_stats=True, **kw)
            stats.append(st)
            return accum
        progressive.render_accum = with_stats

    passes = []
    state = {"t": 0.0}

    def on_chunk(fs):
        t = time.perf_counter()
        passes.append(t - state["t"])
        state["t"] = t
        films.append((fs.spp_done, fs.accum[rows].copy()))
        if t - t_window >= ctx.seconds:
            raise WindowClosed

    ctx.setup_done()
    t_window = state["t"] = time.perf_counter()
    try:
        while True:
            progressive.render_progressive(scene, meta, cam, cfg,
                                           chunk_spp=chunk,
                                           on_chunk=on_chunk, device=dev)
    except WindowClosed:
        pass
    finally:
        progressive.render_accum = real_accum
    window_s = state["t"] - t_window

    px = conf["width"] * conf["height"]
    ctx.attempted = len(passes)
    ctx.end_to_end["Msamples_per_s"] = (len(passes) * px * chunk
                                        / window_s / 1e6)
    ctx.layer["progressive.pass_s_p95"] = yardstick.percentile(passes, 95)
    if ctx.trace:
        ctx.layer["integrator.steps_per_pass"] = (
            sum(s.n_steps for s in stats) / len(stats))
        ctx.layer["integrator.Mrays_per_s"] = (
            sum(s.n_rays for s in stats) / sum(passes) / 1e6)
        ctx.counts["steps"] = _profile_pass(ctx, integ, progressive, scene,
                                            meta, cam, cfg, chunk)
        ctx.counts["traversal_lanes"] = integ.tile_lanes(cfg)

    ctx.read_memory()
    del scene
    graphs.release_graphs()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    _check(ctx, cfg, rows, films, chunk)


def _profile_pass(ctx, integ, progressive, scene, meta, cam, cfg, chunk):
    """Profile ``profiled_passes`` steady passes inside the benchmark's
    spans -> the wavefront steps they ran."""
    real = {"accum": progressive.render_accum,
            "chunk": integ._wavefront_chunk}
    steps = []

    def accum(*a, **kw):
        with torch.profiler.record_function(SPAN + "render_accum"):
            out, st = real["accum"](*a, with_stats=True, **kw)
        steps.append(st.n_steps)
        return out

    @functools.wraps(real["chunk"])
    def replays(graph):
        with torch.profiler.record_function(
                SPAN + "replays and all-done read"):
            return real["chunk"](graph)

    n = ctx.traffic["profiled_passes"]
    done = []

    def on_chunk(fs):
        done.append(fs.spp_done)
        if len(done) >= n:
            raise WindowClosed

    progressive.render_accum = accum
    integ._wavefront_chunk = replays
    try:
        ctx.trace_segment(lambda: _until_closed(
            lambda: progressive.render_progressive(
                scene, meta, cam, cfg, chunk_spp=chunk, on_chunk=on_chunk,
                device=ctx.device)), span_name="pass")
    finally:
        progressive.render_accum = real["accum"]
        integ._wavefront_chunk = real["chunk"]
    return sum(steps)


def _until_closed(fn):
    try:
        fn()
    except WindowClosed:
        pass


def _check(ctx, cfg, rows, films, chunk):
    """Hold the window's films at the check pixels to the reference's."""
    from ..reference import render as ref_render
    from ..reference.tpt.render import integrator as ref_integ
    t0 = time.perf_counter()
    ref_scene, ref_meta, ref_cam = ctx.config_module.build(
        "benchmark.reference.tpt", ctx.conf, ctx.inputs, cfg.width,
        cfg.height, ctx.device)
    ref_cfg = _config(ref_integ, ctx.conf, ctx.traffic, ctx.seed)
    pix = torch.as_tensor(rows, device=ctx.device)
    t1 = time.perf_counter()
    ref = ref_render.pass_films(ref_scene, ref_meta, ref_cam, ref_cfg, pix,
                                chunk).cpu().numpy()
    ctx.note(f"reference: scene {t1 - t0:.1f} s, films {time.perf_counter() - t1:.1f} s")
    ctx.compare_films(films, ref, chunk)
