"""Smoke test of the PyTorch/CUDA port on one GPU (run: python3 chip_smoke.py).

Drives ``tpu_pathtracer_torch`` on the card in phases and prints one JSON
line per phase; any failed check raises and the script exits non-zero.

  env      the card (nvidia-smi name and power limit), torch and CUDA versions
  build    compiles the traversal kernels from csrc/ with nvcc (timed)
  kernels  scene 17 at 1024x1024 (table_res 64): the closest-hit (K1) and
           any-hit (K2) kernels against their plain PyTorch versions on the
           card, on camera rays of the first tile and on the continuation
           and NEE shadow rays of a wavefront step (262,144 lanes).
           Gates: hit/miss and triangle id identical on >= 99.99 % of the
           active rays; on agreeing hits t, b1, b2 within 1e-6 of the plain
           version relative to max(|value|, 1).  Times: CUDA events, median
           of 10 launches (plain version: median of 3).  The bound is the
           larger of the operations of one counted launch at the fp32 peak
           and its bytes (rays, results, one read of the tables) at the
           memory rate.
  render   the main path: render() of scene 17, MIS + Z-Sobol, 1024x1024,
           depth 16, table_res 64 -- a 1 spp warm-up, then a timed 4 spp
           render.  Checks: K1 and K2 launch counts equal the wavefront
           steps, no non-finite pixel, mean linear RGB > 0.
  parity   scene 17 at 64x48, 2 spp, depth 6 on the card and on the CPU
           (plain versions): display RMSE <= 0.01.

Before its last line it prints {"kernels": [...]} and the nvidia-smi line;
the last line is {"ok": true, "device": {...}}.  It exits non-zero, with
no result, when there is no CUDA device.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (dense, 700 W)
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# fp32 operations per unit of traversal work, counted in the kernel
# source: a node visit is two slab tests (6 sub, 6 mul, 12 min/max, 1 mul,
# 3 compares each) plus the near/far compare; a triangle test is 33 mul/add
# for the transform, a negate and a divide for t, 4 mul/add for u and v,
# 1 add and 5 compares
OPS_PER_NODE_VISIT = 53
OPS_PER_TRI_TEST = 45

GATE_AGREE = 0.9999
GATE_REL = 1e-6
GATE_RMSE = 0.01


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Median over ``reps`` launches of fn, in ms (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def rel_err(a, b):
    return (a - b).abs() / torch.clamp(b.abs(), min=1.0)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from tpu_pathtracer_torch.ops import cuda_trace, trace
    from tpu_pathtracer_torch.render import integrator as integ
    from tpu_pathtracer_torch.render.sampler import make_sampler
    from tpu_pathtracer_torch.scenes import load_scene
    from tpu_pathtracer_torch.color import eotf as eotf_mod
    from tpu_pathtracer_torch.color import tone_map as tm_mod

    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    emit("env", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())

    # ---- build ------------------------------------------------------------
    lib_path = cuda_trace.library_path()
    if os.path.exists(lib_path):
        os.remove(lib_path)           # build from this checkout's sources
    t0 = time.perf_counter()
    _, log = cuda_trace.build()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "stack frame" in ln]
    emit("build", seconds=build_s, ptxas=ptxas)

    # ---- kernels ------------------------------------------------------------
    W = H = 1024
    scene, meta, cam = load_scene(17, W, H, table_res=64, device=dev)
    bvh = scene.bvh
    cfg = integ.RenderConfig(width=W, height=H, spp=4, max_depth=16)
    tile = integ.tile_lanes(cfg)
    px = integ._pixel_grid(W, H, dev)[:tile]

    # record the rays the integrator hands the kernels in its first two
    # wavefront steps of tile 0
    recorded = {"closest_hit": [], "any_hit": []}
    real = {k: getattr(cuda_trace, k) for k in recorded}

    def recorder(name):
        def f(*args, **kw):
            recorded[name].append(args[4].clone())
            return real[name](*args, **kw)
        return f

    for k in recorded:
        setattr(cuda_trace, k, recorder(k))
    try:
        sampler = make_sampler("sobol", cfg.seed, cfg.spp, (W, H))
        table = integ._spectral_table(scene)
        state = integ._wavefront_init(tile, 0,
                                      torch.zeros((tile, 3), device=dev))
        for _ in range(2):
            state = integ._wavefront_step(scene, meta, cam, cfg, sampler, px,
                                          cfg.spp, state, table)
        torch.cuda.synchronize()
    finally:
        for k, fn in real.items():
            setattr(cuda_trace, k, fn)
    sets = {
        "closest_hit": {"camera": recorded["closest_hit"][0],
                        "step2": recorded["closest_hit"][1]},
        "any_hit": {"shadow_step1": recorded["any_hit"][0],
                    "shadow_step2": recorded["any_hit"][1]},
    }
    timed_set = {"closest_hit": "step2", "any_hit": "shadow_step2"}
    args = (bvh.nodes_f, bvh.nodes_i, bvh.tri_m12, bvh.stack_depth)
    table_bytes = (bvh.nodes_f.numel() * 4 + bvh.nodes_i.numel() * 4
                   + bvh.tri_m12.numel() * 4)
    out_bytes_per_ray = {"closest_hit": 4 + 4 + 4 + 4 + 1, "any_hit": 1}
    kernel_rows = {}
    for name, kernel_sets in sets.items():
        kern = getattr(cuda_trace, name)
        plain = getattr(cuda_trace, name + "_plain")
        max_abs = 0.0
        for set_name, rays in kernel_sets.items():
            active = rays[6] > 0.0 if name == "closest_hit" else rays[6] >= 0.0
            got = kern(*args, rays)
            ref = plain(bvh.tri_m12, rays)
            torch.cuda.synchronize()
            if name == "closest_hit":
                t, tri, b1, b2, hit = got
                rt, rtri, rb1, rb2, rhit = ref
                same = (hit == rhit) & (tri == rtri)
                agree = float(same[active].float().mean())
                both = same & hit
                errs = [float(rel_err(x, y)[both].max()) if both.any() else 0.0
                        for x, y in ((t, rt), (b1, rb1), (b2, rb2))]
                abs_err = max(float((x - y)[both].abs().max())
                              if both.any() else 0.0
                              for x, y in ((t, rt), (b1, rb1), (b2, rb2)))
                ok = agree >= GATE_AGREE and max(errs) <= GATE_REL
                detail = dict(agree=agree, rel_err_t_b1_b2=errs,
                              hits=int(hit.sum()),
                              hit_only_kernel=int((hit & ~rhit).sum()),
                              hit_only_plain=int((rhit & ~hit).sum()),
                              tri_differs=int((hit & rhit & (tri != rtri)).sum()))
            else:
                agree = float((got == ref)[active].float().mean())
                abs_err = float((got != ref).float().max())
                ok = agree >= GATE_AGREE
                detail = dict(agree=agree, occluded=int(got.sum()),
                              only_kernel=int((got & ~ref).sum()),
                              only_plain=int((ref & ~got).sum()))
            max_abs = max(max_abs, abs_err)
            emit("kernels", kernel=name, rays=set_name,
                 active=int(active.sum()), max_abs_err=abs_err, ok=ok,
                 **detail)
            if not ok:
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version on {set_name}")
        rays = kernel_sets[timed_set[name]]
        ms = cuda_ms(lambda: kern(*args, rays), 10)
        plain_ms = cuda_ms(lambda: plain(bvh.tri_m12, rays), 3)
        counters = torch.zeros(2, dtype=torch.int64, device=dev)
        kern(*args, rays, counters=counters)
        torch.cuda.synchronize()
        visits, tests = (int(v) for v in counters.tolist())
        n = rays.shape[1]
        ops = visits * OPS_PER_NODE_VISIT + tests * OPS_PER_TRI_TEST
        nbytes = n * (7 * 4 + out_bytes_per_ray[name]) + table_bytes
        ops_ms = ops / PEAK_FP32_FLOPS * 1e3
        bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        kernel_rows[name] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=max(ops_ms, bytes_ms),
            bound_by="operations" if ops_ms >= bytes_ms else "bytes",
            max_abs_err=max_abs)
        emit("kernels", kernel=name, timed_rays=timed_set[name], rays=n,
             node_visits=visits, tri_tests=tests, ops=ops, bytes=nbytes,
             **kernel_rows[name], library_ms=None)

    # ---- render: the main path ----------------------------------------------
    warm = integ.RenderConfig(width=W, height=H, spp=1, max_depth=16)
    img = integ.render(scene, meta, cam, warm)
    torch.cuda.synchronize()
    cuda_trace.reset_launch_counts()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    img, stats = integ.render(scene, meta, cam, cfg, with_stats=True)
    b.record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    render_ms = a.elapsed_time(b)
    launches = dict(cuda_trace.LAUNCHES)
    nonfinite = int((~torch.isfinite(img)).sum())
    linear = tm_mod.invert(eotf_mod.decode(img, cfg.eotf), cfg.tone_map)
    mean_rgb = [float(v) for v in linear.reshape(-1, 3).mean(0)]
    emit("render", width=W, height=H, spp=cfg.spp, max_depth=cfg.max_depth,
         ms=render_ms, wall_s=wall_s,
         mray_s=stats.n_rays / (render_ms * 1e-3) / 1e6,
         rays=stats.n_rays, rays_per_spp=stats.n_rays / cfg.spp,
         steps=stats.n_steps, launches=launches, nonfinite=nonfinite,
         mean_linear_rgb=mean_rgb)
    if launches.get("closest_hit") != stats.n_steps or \
            launches.get("any_hit") != stats.n_steps:
        raise AssertionError(f"kernel launches {launches} != wavefront "
                             f"steps {stats.n_steps}")
    if nonfinite or min(mean_rgb) <= 0.0:
        raise AssertionError("render produced non-finite or black output")

    # ---- parity: card vs CPU plain versions ---------------------------------
    pw, ph = 64, 48
    s_cpu, m_cpu, c_cpu = load_scene(17, pw, ph, table_res=64, device="cpu")
    pcfg = integ.RenderConfig(width=pw, height=ph, spp=2, max_depth=6)
    t0 = time.perf_counter()
    img_gpu = integ.render(s_cpu, m_cpu, c_cpu, pcfg, device=dev).cpu()
    img_cpu = integ.render(s_cpu, m_cpu, c_cpu, pcfg, device="cpu")
    rmse = float(((img_gpu - img_cpu) ** 2).mean().sqrt())
    emit("parity", width=pw, height=ph, spp=2, max_depth=6, rmse=rmse,
         seconds=time.perf_counter() - t0)
    if not rmse <= GATE_RMSE:
        raise AssertionError(f"card vs CPU display RMSE {rmse} > {GATE_RMSE}")

    replaces = {"closest_hit": "tpu_pathtracer/ops/pallas_trace.py:261",
                "any_hit": "tpu_pathtracer/ops/pallas_trace.py:388"}
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda",
             source="tpu_pathtracer_torch/csrc/trace_kernels.cu",
             replaces=replaces[name], launches=launches[name],
             max_abs_err=row["max_abs_err"], ms=row["ms"],
             plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
             bound_by=row["bound_by"], library_ms=None)
        for name, row in kernel_rows.items()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
