"""Where a wavefront step's time goes on the GPU (run: python3 -m
tpu_pathtracer_torch.profile_step).

Builds scene 17 at 1024x1024 (table_res 64), the MIS + Z-Sobol config of
chip_smoke.py, and runs the first tile's wavefront: WARMUP steps, then
STEPS steps under ``torch.profiler`` (CPU + CUDA).  The integrator's
module functions are wrapped in ``record_function`` ranges here, so the
package itself carries no instrumentation.  Prints one JSON line:

  step_ms          host wall per step without the profiler (synchronised)
  profiled_step_ms the same under the profiler
  device_ms        summed CUDA kernel and copy time per step
  busy_share       device_ms / step_ms
  launches         CUDA kernel launches per step
  ranges_cpu_ms    inclusive host time per step of each wrapped function
  top_kernels      the 12 kernels with the most device time per step
"""
from __future__ import annotations

import argparse
import functools
import json
import time

import torch

WARMUP = 6
STEPS = 4


def _wrap(module, name, label):
    fn = getattr(module, name)

    @functools.wraps(fn)
    def wrapped(*a, **kw):
        with torch.profiler.record_function(label):
            return fn(*a, **kw)
    setattr(module, name, wrapped)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=1024, help="film width = height")
    ap.add_argument("--device", default=None,
                    help="default: the GPU; 'cpu' rehearses on the plain versions")
    args = ap.parse_args()
    from .ops import trace
    from .render import bsdf, film, integrator as integ, lights, surface
    from .render import sampler as sampler_mod
    from .render.sampler import make_sampler
    from .device import resolve_device
    from .scenes import load_scene
    from .spectrum import grid

    dev = resolve_device(args.device)
    W = H = args.size
    scene, meta, cam = load_scene(17, W, H, table_res=64, device=dev)
    cfg = integ.RenderConfig(width=W, height=H, spp=4, max_depth=16)
    tile = integ.tile_lanes(cfg)
    px = integ._pixel_grid(W, H, dev)[:tile]

    labels = {
        (trace, "intersect_scene"): "trace.intersect_scene (K1)",
        (trace, "intersect_p_scene"): "trace.intersect_p_scene (K2)",
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
    for (mod, name), label in labels.items():
        _wrap(mod, name, label)
    # the integrator and lights imported these names directly
    integ.make_interaction = surface.make_interaction

    sampler = make_sampler("sobol", cfg.seed, cfg.spp, (W, H))
    table = integ._spectral_table(scene)
    state = integ._wavefront_init(tile, 0, torch.zeros((tile, 3), device=dev))
    for _ in range(WARMUP):
        state = integ._wavefront_step(scene, meta, cam, cfg, sampler, px,
                                      cfg.spp, state, table)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    # step wall without the profiler, then the same number of steps under it
    sync()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        state = integ._wavefront_step(scene, meta, cam, cfg, sampler, px,
                                      cfg.spp, state, table)
    sync()
    step_ms = (time.perf_counter() - t0) / STEPS * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            state = integ._wavefront_step(scene, meta, cam, cfg, sampler,
                                          px, cfg.spp, state, table)
        sync()
        profiled_ms = (time.perf_counter() - t0) / STEPS * 1e3
    events = prof.key_averages()
    names = set(labels.values())
    cuda = torch.autograd.DeviceType.CUDA
    # device-side events, without the GPU copies of the ranges above
    kernels = [e for e in events if e.device_type == cuda
               and e.key not in names and e.device_time_total > 0]
    device_us = sum(e.device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    ranges = {e.key: e.cpu_time_total / STEPS / 1e3 for e in events
              if e.key in names and e.device_type != cuda}
    top = sorted(kernels, key=lambda e: -e.device_time_total)[:12]
    print(json.dumps(dict(
        device=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu"), lanes=tile, steps=STEPS,
        step_ms=step_ms, profiled_step_ms=profiled_ms,
        device_ms=device_us / STEPS / 1e3,
        busy_share=device_us / 1e3 / STEPS / step_ms,
        launches=launches / STEPS, ranges_cpu_ms=ranges,
        top_kernels=[dict(name=e.key[:80],
                          ms=e.device_time_total / STEPS / 1e3,
                          calls=e.count / STEPS) for e in top])))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
