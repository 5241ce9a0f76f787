"""Where a wavefront step's time goes on the GPU, eager and replayed from a
captured CUDA graph (run: python3 -m tpu_pathtracer_torch.profile_step
[--scene N] [--precise]).

Builds scene N (default 17) at 1024x1024 (table_res 64), MIS + Z-Sobol,
depth 16, 4 spp (``--precise``: with the watertight hit test), and runs
the first tile's wavefront: WARMUP eager steps, then from that state
STEPS steps each way: as eager ops, and (on a CUDA device) as replays of
the step captured as ``render_wavefront`` captures it.  Each way is timed
without the profiler, then profiled (CPU + CUDA).  The eager steps run
inside ``record_function`` ranges of the integrator's module functions,
wrapped here, so the package itself carries no instrumentation (a replay
runs no Python, so a graph has no ranges).  Prints one JSON line, with for
``eager`` and ``graph``:

  step_ms          host wall per step without the profiler (synchronised)
  profiled_step_ms the same under the profiler
  device_ms        summed CUDA kernel and copy time per step
  busy_share       device_ms / step_ms
  launches         device ops (kernels, copies) per step
  kernels          per step, the launches of each traversal kernel
  top_kernels      the 12 kernels with the most device time per step
  ranges_cpu_ms    (eager) inclusive host time per step of each range

and for the graph its ``capture_s`` (the first step run eagerly, the
capture and the instantiation) and ``recorded_launches`` (the wrappers'
launches counted while capturing, added to ``cuda_trace.LAUNCHES`` on each
replay).

``--grad`` profiles a step of the differentiable pass instead: one
``loss_and_grads`` call on bench.py's grad rung (scene N at 128x128, 2
spp, depth 8, MIS + Z-Sobol, an all-zero target), GRAD_STEPS calls each
way after a warm-up: ``eager`` (the eager program, forward and backward),
``forward`` (its forward alone with autograd recording, and the loss: the
rest of a step is the backward) and, on a CUDA device, ``graph`` (calls
replayed from the captured program, as ``loss_and_grads`` runs on a card,
with ``first_call_s``, the warm-up and capture).  ``backward_share`` is
1 - forward / eager of the step ms and of the device ms.
"""
from __future__ import annotations

import argparse
import functools
import json
import time

import torch

WARMUP = 6
STEPS = 4
GRAD_STEPS = 2
# bench.py's grad rung
GRAD_SIZE, GRAD_SPP, GRAD_DEPTH = 128, 2, 8
# the traversal kernels of csrc/trace_kernels.cu, by their names in a trace
TRAVERSAL_KERNELS = ("team_kernel", "binary_any_hit_kernel")


def _wrap(module, name, label):
    fn = getattr(module, name)

    @functools.wraps(fn)
    def wrapped(*a, **kw):
        with torch.profiler.record_function(label):
            return fn(*a, **kw)
    setattr(module, name, wrapped)
    return fn


def profile_steps(run_step, n: int, dev, ranges=()) -> dict:
    """Time ``n`` calls of ``run_step`` without the profiler (host wall,
    synchronised), then profile ``n`` more (CPU + CUDA activity); the
    caller resets the state between the two if it wants the same steps.
    Returns the per-step numbers of the module docstring; ``ranges`` are
    the labels of ``record_function`` ranges to report."""
    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    sync()
    t0 = time.perf_counter()
    for _ in range(n):
        run_step()
    sync()
    step_ms = (time.perf_counter() - t0) / n * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            run_step()
        sync()
        profiled_ms = (time.perf_counter() - t0) / n * 1e3
    events = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    # device-side events, without the GPU copies of the ranges
    device = [e for e in events if e.device_type == cuda
              and e.key not in ranges and e.device_time_total > 0]
    device_us = sum(e.device_time_total for e in device)
    top = sorted(device, key=lambda e: -e.device_time_total)[:12]
    return dict(
        step_ms=step_ms, profiled_step_ms=profiled_ms,
        device_ms=device_us / n / 1e3,
        busy_share=device_us / 1e3 / n / step_ms,
        launches=sum(e.count for e in device) / n,
        kernels={k: sum(e.count for e in device if k in e.key) / n
                 for k in TRAVERSAL_KERNELS},
        ranges_cpu_ms={e.key: e.cpu_time_total / n / 1e3 for e in events
                       if e.key in ranges and e.device_type != cuda},
        top_kernels=[dict(name=e.key[:80],
                          ms=e.device_time_total / n / 1e3,
                          calls=e.count / n) for e in top])


def profile_grad(scene_n: int, size: int, precise: bool, dev,
                 ranges) -> dict:
    """The ``--grad`` profile of the module docstring (``size``: the
    film's width and height)."""
    from . import parallel
    from .render import graphs
    from .render import integrator as integ
    from .scenes import load_scene

    scene, meta, cam = load_scene(scene_n, size, size, table_res=64,
                                  device=dev)
    cfg = integ.RenderConfig(width=size, height=size, spp=GRAD_SPP,
                             max_depth=GRAD_DEPTH, precise=precise,
                             early_exit=False)
    target = torch.zeros((size * size, 3), device=dev)
    params = parallel.extract_params(scene)
    px = integ._pixel_grid(size, size, dev)

    def eager():
        parallel._loss_and_grads(params, scene, meta, cam, cfg, target,
                                 None, dev, graphed=False)

    def forward():
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        with torch.enable_grad():
            rgb = parallel._accum_linear(parallel.merge_params(scene, p),
                                         meta, cam, cfg, px)
            ((rgb - target) ** 2).sum()

    out = dict(device=(torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
               scene=scene_n, grad=True, lanes=size * size, spp=GRAD_SPP,
               max_depth=GRAD_DEPTH, steps=GRAD_STEPS, precise=precise)
    for label, fn in (("eager", eager), ("forward", forward)):
        fn()
        out[label] = profile_steps(fn, GRAD_STEPS, dev, ranges=ranges)
    if dev.type == "cuda":
        def graph():
            parallel.loss_and_grads(params, scene, meta, cam, cfg, target)
        parallel.release_graphs()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        try:
            out["graph"] = dict(profile_steps(graph, GRAD_STEPS, dev),
                                first_call_s=first_s,
                                recorded_launches=dict(
                                    graphs.kept("grad").launches))
        finally:
            parallel.release_graphs()
    out["backward_share"] = {
        k: 1.0 - out["forward"][k] / out["eager"][k] if out["eager"][k]
        else None for k in ("step_ms", "device_ms")}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", type=int, default=17, help="scene number")
    ap.add_argument("--size", type=int, default=None,
                    help="film width = height (default 1024; with --grad "
                         f"{GRAD_SIZE})")
    ap.add_argument("--device", default=None,
                    help="default: the GPU; 'cpu' rehearses on the plain "
                         "versions")
    ap.add_argument("--precise", action="store_true",
                    help="profile the watertight path (K3 and K2p)")
    ap.add_argument("--grad", action="store_true",
                    help="profile a step of the differentiable pass "
                         "(bench.py's grad rung) instead")
    args = ap.parse_args()
    from .ops import trace
    from .render import bsdf, film, integrator as integ, lights, surface
    from .render import sampler as sampler_mod
    from .render.sampler import make_sampler
    from .device import resolve_device
    from .scenes import load_scene
    from .spectrum import grid

    dev = resolve_device(args.device)
    labels = {
        (trace, "intersect_scene"): "trace.intersect_scene (K1 / K3)",
        (trace, "intersect_p_scene"): "trace.intersect_p_scene (K2 / K2p)",
        (surface, "make_interaction"): "surface.make_interaction",
        (bsdf, "sample_material"): "bsdf.sample_material",
        (bsdf, "evaluate_material"): "bsdf.evaluate_material",
        (bsdf, "emitted_radiance"): "bsdf.emitted_radiance",
        (lights, "evaluate_nee"): "lights.evaluate_nee",
        (lights, "pdf_light_for_hit_pos"): "lights.pdf_light_for_hit_pos",
        (film, "spectral_to_rgb"): "film.spectral_to_rgb",
        (grid, "lambda_slice_bank"): "grid.lambda_slice_bank",
        (sampler_mod.ZSobolSampler, "get_1d"): "sampler.get_1d",
        (sampler_mod.ZSobolSampler, "get_2d"): "sampler.get_2d",
    }
    real = {key: _wrap(*key, label) for key, label in labels.items()}
    # the integrator and lights imported these names directly
    integ.make_interaction = surface.make_interaction
    if args.grad:
        print(json.dumps(profile_grad(args.scene, args.size or GRAD_SIZE,
                                      args.precise, dev,
                                      set(labels.values()))))
        return 0

    W = H = args.size or 1024
    scene, meta, cam = load_scene(args.scene, W, H, table_res=64, device=dev)
    cfg = integ.RenderConfig(width=W, height=H, spp=4, max_depth=16,
                             precise=args.precise)
    tile = integ.tile_lanes(cfg)
    px = integ._pixel_grid(W, H, dev)[:tile]
    sampler = make_sampler("sobol", cfg.seed, cfg.spp, (W, H))
    table = integ._spectral_table(scene)
    accum0 = torch.zeros((tile, 3), device=dev)
    state = integ._wavefront_init(tile, 0, accum0)
    for _ in range(WARMUP):
        state = integ._wavefront_step(scene, meta, cam, cfg, sampler, px,
                                      cfg.spp, state, table)
    steady = integ._state_leaves(state)
    box = dict(state=state)

    def eager_step():
        box["state"] = integ._wavefront_step(scene, meta, cam, cfg, sampler,
                                             px, cfg.spp, box["state"], table)

    out = dict(device=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"), scene=args.scene, lanes=tile,
               steps=STEPS, warmup_steps=WARMUP, precise=args.precise)
    out["eager"] = profile_steps(eager_step, STEPS, dev,
                                 ranges=set(labels.values()))
    if dev.type == "cuda":
        # the package's own functions again: a capture records no ranges
        for (mod, name), fn in real.items():
            setattr(mod, name, fn)
        integ.make_interaction = surface.make_interaction
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            graph = integ._StepGraph(scene, meta, cam, cfg, sampler, px, 0,
                                     cfg.spp, accum0, table)
            torch.cuda.synchronize()
            capture_s = time.perf_counter() - t0
            try:
                # the replays start from the eager windows' steady state
                for dst, src in zip(graph.leaves, steady):
                    dst.copy_(src)
                out["graph"] = dict(
                    profile_steps(graph.replay, STEPS, dev),
                    capture_s=capture_s,
                    recorded_launches=dict(graph.launches))
            finally:
                graph.release()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
