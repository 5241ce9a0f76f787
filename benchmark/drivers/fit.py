"""The material-fitting driver: back-to-back ``train_step_adam`` calls of
one configuration against one target image, on one card.

Set-up builds the scene (span ``scene.build``), the target (from the seed,
on the card) and the train state, whose parameters start at 0.9 x the
scene's material columns + 0.05; it then drives that state through the
first ``checked_steps`` steps, the ones the reference follows.  The first
step captures the grad graph and returns its eager warm-up, the second
replays it (``graphs.capture_s`` is the difference); the gradients the
optimizer got at the first two, one eager and one replayed, are recovered
from its first moments for the check.  The window goes on from that
state, reading each step's loss as a fit that logs it would, and restarts
the fit from the start every ``restart_every`` steps, until the first
step past ``seconds``.  With ``trace`` two more steps run under the
profiler inside the benchmark's spans.  Once the window has closed and the
program's memory is freed, the reference (``reference.fit``) follows the
checked steps from the same start.
"""
from __future__ import annotations

import gc
import time

import torch

from ..harness import SPAN, span, sync
from ..reference import fit as ref_fit


def _config(integ, conf, traffic, seed):
    width, height = conf["resolution"]
    return integ.RenderConfig(
        width=width, height=height, spp=conf["spp"],
        max_depth=conf["max_depth"], strategy=traffic["strategy"],
        sampler=traffic["sampler"], seed=seed)


def run(ctx) -> None:
    from tpu_pathtracer_torch import parallel
    from tpu_pathtracer_torch.render import graphs
    from tpu_pathtracer_torch.render import integrator as integ

    tr, dev = ctx.traffic, ctx.device
    cfg = _config(integ, ctx.conf, tr, ctx.seed)
    with span(ctx, "scene.build"):
        scene, meta, cam = ctx.config_module.build(
            "tpu_pathtracer_torch", ctx.conf, ctx.inputs, cfg.width,
            cfg.height, dev)
        sync(dev)
    target = ref_fit.make_target(ctx.seed, cfg.width * cfg.height, dev)
    start = ref_fit.start_params(parallel.extract_params(scene))

    fresh, step = _stepper(parallel, scene, meta, cam, cfg, target, start,
                           tr["lr"], dev)
    # set-up: the checked steps; the first captures (and returns its eager
    # warm-up), the second replays
    state, checked, times = checked_steps(fresh, step, tr["checked_steps"])
    ctx.layer["graphs.capture_s"] = times[0] - times[1]

    ctx.setup_done()
    done = tr["checked_steps"]
    steps = 0
    t_window = time.perf_counter()
    while True:
        if done % tr["restart_every"] == 0:
            state = fresh()
        state, _ = step(state)
        done += 1
        steps += 1
        t = time.perf_counter()
        if t - t_window >= ctx.seconds:
            break
    ctx.attempted = steps
    ctx.end_to_end["train_step_s"] = (t - t_window) / steps

    if ctx.trace:
        real = {"lg": parallel.loss_and_grads, "adam": parallel._adam_update}

        def lg(*a, **kw):
            with torch.profiler.record_function(SPAN + "loss_and_grads"):
                return real["lg"](*a, **kw)

        def adam(*a, **kw):
            with torch.profiler.record_function(SPAN + "adam update"):
                return real["adam"](*a, **kw)

        def profiled():
            s = state
            for _ in range(tr["profiled_steps"]):
                s, _ = step(s)

        parallel.loss_and_grads, parallel._adam_update = lg, adam
        try:
            ctx.trace_segment(profiled, span_name="step")
        finally:
            parallel.loss_and_grads = real["lg"]
            parallel._adam_update = real["adam"]
        ctx.counts["steps"] = tr["profiled_steps"]
        ctx.counts["traversal_lanes"] = cfg.width * cfg.height

    ctx.read_memory()
    del scene, state
    graphs.release_graphs()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the reference follows the checked steps from the same start
    from ..reference.tpt.render import integrator as ref_integ
    t0 = time.perf_counter()
    ref_scene, ref_meta, ref_cam = ctx.config_module.build(
        "benchmark.reference.tpt", ctx.conf, ctx.inputs, cfg.width,
        cfg.height, dev)
    t1 = time.perf_counter()
    ref = ref_fit.follow(ref_scene, ref_meta, ref_cam,
                         _config(ref_integ, ctx.conf, tr, ctx.seed),
                         ctx.seed, tr["lr"], tr["checked_steps"])
    ctx.note(f"reference: scene {t1 - t0:.1f} s, {tr['checked_steps']} steps "
             f"{time.perf_counter() - t1:.1f} s")
    ctx.compare_fit(dict(checked, start=start), ref)


def _stepper(parallel, scene, meta, cam, cfg, target, start, lr, dev):
    """(fresh: a train state at ``start``, step: one Adam step -> (state,
    loss))."""
    def fresh():
        state = parallel.make_train_state(scene, lr=lr, device=dev)
        state.params = {k: v.clone() for k, v in start.items()}
        return state

    def step(state):
        state, loss = parallel.train_step_adam(state, scene, meta, cam, cfg,
                                               target, device=dev)
        return state, loss.item()
    return fresh, step


def checked_steps(fresh, step, n):
    """The first ``n`` steps from the start -> (state, dict(losses, grads
    of steps 1 and 2, params after each step), seconds of each step)."""
    state = fresh()
    losses, times, mus, params = [], [], [], []
    for _ in range(n):
        t0 = time.perf_counter()
        state, loss = step(state)
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        mus.append({k: v.detach().clone() for k, v in state.mu.items()})
        params.append({k: v.detach().clone() for k, v in
                       state.params.items()})
    return state, dict(losses=losses, grads=ref_fit.gradients(mus),
                       params=params), times


def program_steps(ctx, seed, n):
    """The program's first ``n`` steps of the cell's fit at ``seed``, in
    this process (the controls read the program's gaps on many seeds
    without a set-up each) -> dict as ``checked_steps`` with ``start``."""
    from tpu_pathtracer_torch import parallel
    from tpu_pathtracer_torch.render import integrator as integ
    cfg = _config(integ, ctx.conf, ctx.traffic, seed)
    if getattr(ctx, "program_scene", None) is None:
        ctx.program_scene = ctx.config_module.build(
            "tpu_pathtracer_torch", ctx.conf, ctx.inputs, cfg.width,
            cfg.height, ctx.device)
    scene, meta, cam = ctx.program_scene
    target = ref_fit.make_target(seed, cfg.width * cfg.height, ctx.device)
    start = ref_fit.start_params(parallel.extract_params(scene))
    fresh, step = _stepper(parallel, scene, meta, cam, cfg, target, start,
                           ctx.traffic["lr"], ctx.device)
    _, checked, _ = checked_steps(fresh, step, n)
    return dict(checked, start=start)
