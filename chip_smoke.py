"""Smoke test of the PyTorch/CUDA port on one GPU (run: python3 chip_smoke.py).

Drives ``tpu_pathtracer_torch`` on the card in phases and prints one JSON
line per phase; any failed check raises and the script exits non-zero.

  env      the card (nvidia-smi name and power limit), torch and CUDA versions
  build    compiles the traversal kernels from csrc/ with nvcc (timed) and
           prints each kernel's registers and stack frame (ptxas -v)
  kernels  scene 17 at 1024x1024 (table_res 64): the closest-hit and any-hit
           kernels, fast (K1, K2) and precise (K3, K2p), against their plain
           PyTorch versions on the card, on camera rays of the first tile and
           on the continuation and NEE shadow rays of wavefront steps 2 and
           (closest hit only) 6 and 12, whose rays are incoherent, and 24
           and 32, where the tile runs out of samples and most lanes, then
           nearly all, are dead (262,144 lanes each), and on the first
           65,536 lanes of step 2 (the launch of a 256x256 film); the fast
           kernels on the rays of a fast step, the precise ones on the rays
           of a ``precise=True`` step.
           Gates, closest hit (K1, K3): hit/miss, triangle id, t, b1 and b2
           equal to the plain version's on every ray, bit for bit.  Any hit
           (K2, K2p): identical on >= 99.99 % of the active rays.
           Times: ``ms`` is device time (20 launches queued behind a spin
           kernel, CUDA events around the batch: no host time in it);
           ``call_ms`` is what the reports before this design called ms,
           CUDA events around one wrapper call (median of 10), most of
           which is the host getting to the launch; the plain version is
           the median of 3 calls.  ``prev_ms`` is the binary closest-hit
           walk the wide kernels replaced (``closest_hit_v1``,
           ``closest_hit_precise_v1``), device time taken in turns with the
           kernel's on every closest-hit ray set but the camera's; which is
           faster is printed, not gated.
           The bound is the larger of the operations of one counted launch
           at the fp32 peak and its bytes (rays, results, one read of the
           tables) at the memory rate.  The counters also give the largest
           node-visit and triangle-test count of any one ray.
  render   the fast main path: render() of scene 17, MIS + Z-Sobol,
           1024x1024, depth 16, table_res 64 -- a 1 spp warm-up, then a
           timed 4 spp render.  Checks: K1 and K2 launch counts equal the
           wavefront steps, the precise kernels are not launched, no
           non-finite pixel, mean linear RGB > 0.
  render_precise  the same render with ``precise=True``: K3 and K2p launch
           counts equal the wavefront steps, K1 and K2 are not launched, no
           non-finite pixel, mean > 0, display RMSE against the fast render
           <= 0.01.
  ladder   scene 6 (gold bunny), NEE + random sampler, 512x512, depth 16,
           precise, 4 spp: the same launch, non-finite and mean checks; and
           scene 0, PT + random, 256x256, 4 spp, where no any-hit kernel may
           be launched.
  parity   scene 17 at 64x48, 2 spp, depth 6 on the card and on the CPU
           (plain versions), fast and precise: display RMSE <= 0.01 each.

Before its last line it prints {"kernels": [...]} and the nvidia-smi line;
the last line is {"ok": true, "device": {...}}.  It exits non-zero, with
no result, when there is no CUDA device.
"""
from __future__ import annotations

import dataclasses
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
# source: a binary node visit is two slab tests (6 sub, 6 mul, 12 min/max,
# 1 mul, 3 compares each) plus the near/far compare, a wide one four slab
# tests, four clamps and the five compares of the sorting network; a fast
# triangle test is 33 mul/add for the transform, a negate and a divide for
# t, 4 mul/add for u and v, 1 add and 5 compares
OPS_PER_NODE_VISIT = 53
OPS_PER_WIDE_VISIT = 4 * 26 + 4 + 5
OPS_PER_TRI_TEST = 45
# a precise triangle test: translate, shear and scale three vertices (24),
# six Dekker splits (4 each) and six error-free products (9 each) combined
# into three edge functions (3 each) = 87, the side test (6 compares), det
# (2 adds, 1 compare), t_scaled (5), the bound (1 mul, 3 compares), one
# divide, three multiplies for t, b1, b2 and the t > 1e-6 compare
OPS_PER_PRECISE_TRI_TEST = 134
# the per-ray shear set-up: 3 abs, 3 compares, 3 divides, 2 negates
OPS_PER_PRECISE_RAY_SETUP = 11

GATE_AGREE = 0.9999
GATE_RMSE = 0.01

SOURCE = "tpu_pathtracer_torch/csrc/trace_kernels.cu"
# kernel -> (tables of BVHArrays it reads, the one its plain version takes,
# is closest hit, ops per triangle test, ops per ray, the TPU kernel it
# replaces)
KERNELS = {
    "closest_hit": (("nodes_w", "tri_m12"), "tri_m12", True,
                    OPS_PER_TRI_TEST, 0,
                    "tpu_pathtracer/ops/pallas_trace.py:261"),
    "any_hit": (("nodes_f", "nodes_i", "tri_m12"), "tri_m12", False,
                OPS_PER_TRI_TEST, 0,
                "tpu_pathtracer/ops/pallas_trace.py:388"),
    "closest_hit_precise": (("nodes_w", "tri9p"), "tri9", True,
                            OPS_PER_PRECISE_TRI_TEST,
                            OPS_PER_PRECISE_RAY_SETUP,
                            "tpu_pathtracer/ops/pallas_trace.py:311"),
    "any_hit_precise": (("nodes_f", "nodes_i", "tri9"), "tri9", False,
                        OPS_PER_PRECISE_TRI_TEST, OPS_PER_PRECISE_RAY_SETUP,
                        "tpu_pathtracer/ops/pallas_trace.py:411"),
}
FAST = ("closest_hit", "any_hit")
PRECISE = ("closest_hit_precise", "any_hit_precise")
# the binary closest-hit yardsticks: timed here, launched by no render
V1 = ("closest_hit_v1", "closest_hit_precise_v1")
# wavefront steps whose closest-hit rays are checked and timed: 2 coherent,
# 6 and 12 incoherent (dead lanes are regenerated while samples are left),
# 24 and 32 with the dead lanes of a tile that runs out of samples
CLOSEST_STEPS = (2, 6, 12, 24, 32)
SMALL_LAUNCH = 65536    # lanes of a 256x256 film's launch


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


def device_ms(fn, reps: int) -> float:
    """Device time of one ``fn()`` in ms: ``reps`` calls queued behind a
    spin kernel (``torch.cuda._sleep``, a private helper of torch), so that
    every launch is already waiting when the card gets to it, timed by CUDA
    events around the batch.  (Events around a single call measure the
    host: the card reaches the first event at once and then waits for
    Python to get to the launch.)"""
    fn()
    torch.cuda.synchronize()
    spin_cycles = 4_000_000
    while True:
        started = torch.cuda.Event()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin_cycles)
        started.record()
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        queued_in_time = not started.query()     # the spin still runs
        torch.cuda.synchronize()
        if queued_in_time:
            return a.elapsed_time(b) / reps
        spin_cycles *= 2


def record_step_rays(cuda_trace, integ, scene, meta, cam, cfg,
                     n_steps: int) -> dict:
    """The ray tensors the integrator hands each kernel wrapper in the first
    ``n_steps`` wavefront steps of the first tile:
    {wrapper name: [rays of step 1, step 2, ...]}."""
    from tpu_pathtracer_torch.render.sampler import make_sampler

    recorded = {k: [] for k in KERNELS}
    real = {k: getattr(cuda_trace, k) for k in KERNELS}

    def recorder(name):
        def f(*args, **kw):
            recorded[name].append(args[-1].clone())   # rays come last
            return real[name](*args, **kw)
        return f

    dev = scene.device
    tile = integ.tile_lanes(cfg)
    px = integ._pixel_grid(cfg.width, cfg.height, dev)[:tile]
    for k in KERNELS:
        setattr(cuda_trace, k, recorder(k))
    try:
        sampler = make_sampler(cfg.sampler, cfg.seed, cfg.spp,
                               (cfg.width, cfg.height))
        table = integ._spectral_table(scene)
        state = integ._wavefront_init(
            tile, 0, torch.zeros((tile, 3), device=dev))
        for _ in range(n_steps):
            state = integ._wavefront_step(scene, meta, cam, cfg, sampler, px,
                                          cfg.spp, state, table)
        torch.cuda.synchronize()
    finally:
        for k, fn in real.items():
            setattr(cuda_trace, k, fn)
    return recorded


def kernel_args(bvh, name):
    """What the wrapper ``name`` takes before the rays."""
    if KERNELS[name][2]:
        return (bvh,)
    return (bvh.nodes_f, bvh.nodes_i, getattr(bvh, KERNELS[name][1]),
            bvh.stack_depth)


def check_kernel(cuda_trace, bvh, name, ray_sets, timed_set, prev_sets=()):
    """Hold one kernel against its plain version on each ray set, then time
    both and compute the bound on ``timed_set``; on each of ``prev_sets``
    time the kernel and its binary predecessor in turns.  Returns the
    kernel's row of the final "kernels" line (without its launches)."""
    tables, plain_table, closest, ops_per_test, ops_per_ray, _ = KERNELS[name]
    tris = getattr(bvh, plain_table)
    args = kernel_args(bvh, name)
    kern = getattr(cuda_trace, name)
    plain = getattr(cuda_trace, name + "_plain")
    max_abs = 0.0
    for set_name, rays in ray_sets.items():
        active = rays[6] > 0.0 if closest else rays[6] >= 0.0
        got = kern(*args, rays)
        ref = plain(tris, rays)
        torch.cuda.synchronize()
        if closest:
            # a conservative cull gives the brute-force answers whatever the
            # visit order: every output equal on every ray, bit for bit
            t, tri, b1, b2, hit = got
            rt, rtri, rb1, rb2, rhit = ref
            same = (hit == rhit) & (tri == rtri)
            agree = float(same[active].float().mean())
            pairs = ((t, rt), (b1, rb1), (b2, rb2))
            abs_err = max(float((x - y)[same].abs().max())
                          if same.any() else 0.0 for x, y in pairs)
            detail = dict(
                agree=agree, hits=int(hit.sum()),
                hit_only_kernel=int((hit & ~rhit).sum()),
                hit_only_plain=int((rhit & ~hit).sum()),
                tri_differs=int((hit & rhit & (tri != rtri)).sum()),
                values_differ=int(sum((x != y).sum() for x, y in pairs)))
            ok = (agree == 1.0 and bool(same.all())
                  and detail["values_differ"] == 0)
        else:
            agree = float((got == ref)[active].float().mean())
            abs_err = float((got != ref).float().max())
            ok = agree >= GATE_AGREE
            detail = dict(agree=agree, occluded=int(got.sum()),
                          only_kernel=int((got & ~ref).sum()),
                          only_plain=int((ref & ~got).sum()))
        max_abs = max(max_abs, abs_err)
        emit("kernels", kernel=name, rays=set_name, active=int(active.sum()),
             max_abs_err=abs_err, ok=ok, **detail)
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"on {set_name}")
    rays = ray_sets[timed_set]
    ms = device_ms(lambda: kern(*args, rays), 20)
    call_ms = cuda_ms(lambda: kern(*args, rays), 10)
    plain_ms = cuda_ms(lambda: plain(tris, rays), 3)
    counters = torch.zeros(4 if closest else 2, dtype=torch.int64,
                           device=rays.device)
    kern(*args, rays, counters=counters)
    torch.cuda.synchronize()
    visits, tests, *maxima = (int(v) for v in counters.tolist())
    n = rays.shape[1]
    ops = (visits * (OPS_PER_WIDE_VISIT if closest else OPS_PER_NODE_VISIT)
           + tests * ops_per_test + n * ops_per_ray)
    table_bytes = 4 * sum(getattr(bvh, f).numel() for f in tables)
    out_bytes_per_ray = 4 + 4 + 4 + 4 + 1 if closest else 1
    nbytes = n * (7 * 4 + out_bytes_per_ray) + table_bytes
    ops_ms = ops / PEAK_FP32_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    row = dict(ms=ms, plain_ms=plain_ms, bound_ms=max(ops_ms, bytes_ms),
               bound_by="operations" if ops_ms >= bytes_ms else "bytes",
               max_abs_err=max_abs)
    emit("kernels", kernel=name, timed_rays=timed_set, rays=n,
         node_visits=visits, tri_tests=tests, ops=ops, bytes=nbytes, **row,
         call_ms=call_ms, library_ms=None)
    if closest:
        emit("kernels", kernel=name, timed_rays=timed_set,
             max_node_visits_of_a_ray=maxima[0],
             max_tri_tests_of_a_ray=maxima[1],
             **cuda_trace.closest_hit_launch_info(n, "precise" in name))
    prev = getattr(cuda_trace, name + "_v1", None)
    for set_name in prev_sets:
        rays = ray_sets[set_name]
        counters = torch.zeros(4, dtype=torch.int64, device=rays.device)
        got = prev(bvh, rays, counters=counters)
        ref = kern(*args, rays)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got, ref)):
            raise AssertionError(f"{name}_v1 differs from {name} on "
                                 f"{set_name}")
        times = {"prev": [], "new": []}
        for which in ("prev", "new", "new", "prev"):
            fn = prev if which == "prev" else kern
            a = (bvh,) if which == "prev" else args
            times[which].append(device_ms(lambda: fn(*a, rays), 20))
        pv, pt, pmv, pmt = (int(v) for v in counters.tolist())
        row_prev = dict(ms=statistics.mean(times["new"]),
                        prev_ms=statistics.mean(times["prev"]))
        emit("kernels", kernel=name, timed_rays=set_name, rays=rays.shape[1],
             live=int((rays[6] > 0.0).sum()), **row_prev,
             prev_over_new=row_prev["prev_ms"] / row_prev["ms"],
             prev_node_visits=pv, prev_tri_tests=pt,
             prev_max_node_visits_of_a_ray=pmv,
             prev_max_tri_tests_of_a_ray=pmt)
    return row


def timed_render(integ, cuda_trace, tm_mod, eotf_mod, phase, scene, meta, cam,
                 cfg, expect, forbid):
    """One main path: 1 spp warm-up, launch counts set to 0, the timed
    render, the counts read.  ``expect`` kernels must have been launched
    once per wavefront step, ``forbid`` kernels not at all.  Returns
    (image, launches)."""
    integ.render(scene, meta, cam, dataclasses.replace(cfg, spp=1))
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
    launches = {k: cuda_trace.LAUNCHES[k] for k in (*KERNELS, *V1)}
    render_ms = a.elapsed_time(b)
    nonfinite = int((~torch.isfinite(img)).sum())
    linear = tm_mod.invert(eotf_mod.decode(img, cfg.eotf), cfg.tone_map)
    mean_rgb = [float(v) for v in linear.reshape(-1, 3).mean(0)]
    emit(phase, width=cfg.width, height=cfg.height, spp=cfg.spp,
         max_depth=cfg.max_depth, strategy=cfg.strategy, sampler=cfg.sampler,
         precise=bool(cfg.precise), ms=render_ms, wall_s=wall_s,
         mray_s=stats.n_rays / (render_ms * 1e-3) / 1e6, rays=stats.n_rays,
         rays_per_spp=stats.n_rays / cfg.spp, steps=stats.n_steps,
         launches=launches, nonfinite=nonfinite, mean_linear_rgb=mean_rgb)
    for k in expect:
        if launches[k] != stats.n_steps:
            raise AssertionError(f"{phase}: {k} launched {launches[k]} times "
                                 f"in {stats.n_steps} wavefront steps")
    for k in (*forbid, *V1):
        if launches[k] != 0:
            raise AssertionError(f"{phase}: {k} launched {launches[k]} times, "
                                 "expected none")
    if nonfinite or min(mean_rgb) <= 0.0:
        raise AssertionError(f"{phase}: non-finite or black output")
    return img, launches


def display_rmse(a, b) -> float:
    return float(((a - b) ** 2).mean().sqrt())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from tpu_pathtracer_torch.ops import cuda_trace
    from tpu_pathtracer_torch.render import integrator as integ
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
             if "Compiling entry" in ln or "registers" in ln
             or "stack frame" in ln]
    emit("build", seconds=build_s, ptxas=ptxas)

    # ---- kernels ------------------------------------------------------------
    W = H = 1024
    scene, meta, cam = load_scene(17, W, H, table_res=64, device=dev)
    cfg = integ.RenderConfig(width=W, height=H, spp=4, max_depth=16)
    cfg_precise = dataclasses.replace(cfg, precise=True)
    n_recorded = max(CLOSEST_STEPS)
    rec_fast = record_step_rays(cuda_trace, integ, scene, meta, cam, cfg,
                                n_recorded)
    rec_precise = record_step_rays(cuda_trace, integ, scene, meta, cam,
                                   cfg_precise, n_recorded)
    for names, rec, other in ((FAST, rec_fast, PRECISE),
                              (PRECISE, rec_precise, FAST)):
        if (any(len(rec[k]) != n_recorded for k in names)
                or any(rec[k] for k in other)):
            raise AssertionError("a wavefront step did not launch exactly "
                                 f"its own kernels: "
                                 f"{ {k: len(v) for k, v in rec.items()} }")
    kernel_rows = {}
    for name, (_, _, closest, *_rest) in KERNELS.items():
        rec = rec_precise if name in PRECISE else rec_fast
        if closest:
            sets = {"camera": rec[name][0]}
            sets.update((f"step{k}", rec[name][k - 1]) for k in CLOSEST_STEPS)
            sets[f"step2_first_{SMALL_LAUNCH}"] = \
                rec[name][1][:, :SMALL_LAUNCH].contiguous()
            kernel_rows[name] = check_kernel(
                cuda_trace, scene.bvh, name, sets, "step2",
                prev_sets=[k for k in sets if k != "camera"])
        else:
            sets = {"shadow_step1": rec[name][0], "shadow_step2": rec[name][1]}
            kernel_rows[name] = check_kernel(cuda_trace, scene.bvh, name,
                                             sets, "shadow_step2")
    emit("kernels", precise_over_fast=dict(
        closest=kernel_rows["closest_hit_precise"]["ms"]
        / kernel_rows["closest_hit"]["ms"],
        any=kernel_rows["any_hit_precise"]["ms"]
        / kernel_rows["any_hit"]["ms"]))

    # ---- render: the fast and the precise main paths --------------------------
    helpers = (integ, cuda_trace, tm_mod, eotf_mod)
    img_fast, launches = timed_render(*helpers, "render", scene, meta, cam,
                                      cfg, expect=FAST, forbid=PRECISE)
    img_precise, launches_p = timed_render(
        *helpers, "render_precise", scene, meta, cam, cfg_precise,
        expect=PRECISE, forbid=FAST)
    for k in PRECISE:
        launches[k] = launches_p[k]
    rmse = display_rmse(img_precise, img_fast)
    emit("render_precise", rmse_vs_fast=rmse)
    if not rmse <= GATE_RMSE:
        raise AssertionError(f"precise vs fast display RMSE {rmse} > "
                             f"{GATE_RMSE}")
    del img_fast, img_precise, scene

    # ---- ladder: scene 6 NEE + random, scene 0 PT + random, both precise ------
    for n, size, strategy, expect, forbid in (
            (6, 512, "nee", PRECISE, FAST),
            (0, 256, "pt", PRECISE[:1], FAST + PRECISE[1:])):
        s_l, m_l, c_l = load_scene(n, size, size, table_res=64, device=dev)
        lcfg = integ.RenderConfig(width=size, height=size, spp=4,
                                  max_depth=16, strategy=strategy,
                                  sampler="random", precise=True)
        timed_render(*helpers, f"ladder_scene{n}", s_l, m_l, c_l, lcfg,
                     expect=expect, forbid=forbid)

    # ---- parity: card vs CPU plain versions, fast and precise -----------------
    pw, ph = 64, 48
    s_cpu, m_cpu, c_cpu = load_scene(17, pw, ph, table_res=64, device="cpu")
    for precise in (False, True):
        pcfg = integ.RenderConfig(width=pw, height=ph, spp=2, max_depth=6,
                                  precise=precise)
        t0 = time.perf_counter()
        img_gpu = integ.render(s_cpu, m_cpu, c_cpu, pcfg, device=dev).cpu()
        img_cpu = integ.render(s_cpu, m_cpu, c_cpu, pcfg, device="cpu")
        rmse = display_rmse(img_gpu, img_cpu)
        emit("parity", width=pw, height=ph, spp=2, max_depth=6,
             precise=precise, rmse=rmse, seconds=time.perf_counter() - t0)
        if not rmse <= GATE_RMSE:
            raise AssertionError(f"card vs CPU display RMSE {rmse} > "
                                 f"{GATE_RMSE} (precise={precise})")

    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=SOURCE,
             replaces=KERNELS[name][5], launches=launches[name],
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
