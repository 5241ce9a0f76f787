"""Smoke test of the PyTorch/CUDA port on one GPU (run: python3 chip_smoke.py).

Drives ``tpu_pathtracer_torch`` on the card in phases and prints one JSON
line per phase; any failed check raises and the script exits non-zero.

  env      the card (nvidia-smi name and power limit), torch and CUDA versions
  build    compiles the traversal kernels from csrc/ with nvcc (timed) and
           prints each kernel's registers and stack frame (ptxas -v)
  sampler  the Z-Sobol draw kernel (``csrc/sampler.cu``, built and timed
           here; ptxas's registers) against its plain version
           (``get_1d_plain`` / ``get_2d_plain``, int64 tensor ops) on the
           ten draw calls of a step (MIS: 1-D dim 0, 2-D dim 1, then at
           ``base`` = 3 + 10 depth the calls at base, base + 1 (2-D), + 3,
           + 4, + 5, + 6, + 7 (2-D), + 9): the render cells' wavefront
           step, the first 262,144 pixels of 800x600 at 64 spp, per-lane
           int32 samples (some -1) and depths 0-15; the fit's lockstep
           sample, 128x128 at 2 spp (odd log2_spp), 16,384 lanes, a python
           int sample and depth 0.  Gate: every draw equal bit for bit.
           Times, device ms of the ten calls (``device_ms``; the plain
           version one call at a time, ~500 launches each), beside the
           bound: the larger of the operands and draws (pixel 8 B, a
           per-lane sample and dim 4 B each, a draw 4 B) at 3.35 TB/s and
           the 32-bit integer operations counted in the source at 132 SMs
           x 64 a clock x 1.98 GHz; registers, local bytes and resident
           blocks an SM of each kernel.  Its row in the final "kernels"
           line gives these per launch.
  bsdf     the material kernels (``csrc/bsdf.cu``, built and timed here;
           ptxas's lines) on the recorded ``sample_material`` and
           ``evaluate_material`` inputs of step 2 of an eager MIS render
           at 800x600 (its first tile, 262,144 lanes): scene 17 (Lambert,
           clearcoat; the scan cell's kinds) and scene 19 under its sky
           (Lambert, PBR, clearcoat, plastic; the sky cell's).  Gate: each
           kernel's every output equal bit for bit to the torch ops it
           replaces (``_sample_material_ops``, ``_evaluate_material_ops``),
           one launch a call.  Times: each kernel's device ms
           (``device_ms``, 20 launches queued), and the torch ops' device
           ms and device ops for the same call (``profile_steps``), beside
           the byte bound (a lane's columns read once and its outputs
           written once at 3.35 TB/s; the material rows are cached);
           registers, local bytes and resident blocks an SM.  Its rows in
           the final "kernels" line give these per launch.
  kernels  scene 17 at 1024x1024 (table_res 64): the closest-hit and any-hit
           kernels, fast (K1, K2) and precise (K3, K2p), against their plain
           PyTorch versions on the card.  Closest hit: camera rays of the
           first tile and the continuation rays of wavefront steps 2, 6 and
           12 (incoherent: dead lanes are regenerated while samples are
           left) and 24 and 32, where the tile runs out of samples and most
           lanes, then nearly all, are dead (262,144 lanes each), and the
           first 65,536 lanes of step 2 (the launch of a 256x256 film).  Any
           hit: the NEE shadow rays of steps 1, 2, 6, 12, 24 and 32 and the
           first 65,536 lanes of step 2.  The fast kernels on the rays of a
           fast step, the precise ones on the rays of a ``precise=True``
           step.
           Gates, exact: closest hit (K1, K3) hit/miss, triangle id, t, b1
           and b2, any hit (K2, K2p) occlusion, equal to the plain version's
           on every ray, bit for bit.
           Times: ``ms`` is device time (20 launches queued behind a spin
           kernel, CUDA events around the batch: no host time in it);
           ``call_ms`` is CUDA events around one wrapper call (median of
           10), most of which is the host getting to the launch; the plain
           version is the median of 3 calls.  Each kernel is timed on its
           step-2 set.  (Every any-hit design stage against the binary
           walk: python3 any_hit_stages.py.)
           The bound is the larger of the operations of one counted launch
           at the fp32 peak and its bytes (the seven floats of a live ray,
           the t_max of a dead or inactive one, results, one read of the
           tables) at the memory rate.  The counters also give the largest
           node-visit and triangle-test count of any one ray (the longest
           chain), on every set.
           New traffic, each set held exact against the plain version and
           timed the same way, fast and precise: the step-2 continuation
           rays of scene 8 (SF11 glass bunny) at 512x512, inside and
           outside the glass; the camera rays of scene 19 (spheres under a
           sky, no box) at 512x512, many of which miss everything; and the
           step-2 shadow rays of scene 19, toward the environment light
           (t_max = 3e38).  Instanced traffic, at 512x512 (4 x 262,144
           lanes a launch): the step-2 launches on scene 7's group of K1
           and K2 (fast) and on scene 12's of K3 and K2p (precise), whose
           rays are in the instances' object space (directions not of unit
           length), bounded by the main soup's closest hit, the lanes
           outside an instance's box dead.
  graph    scene 17 at the main path's size, fast and precise:
           ``render_wavefront``'s tiles with their steps replayed from one
           captured CUDA graph against the eager step loop (its plain
           version), in turns (eager, graph, graph, eager); the first
           graph call starts from no kept graph, the second finds the
           first call's kept.  Gates: the films equal bit for bit, the same
           rays and steps, each kernel launched once a step both ways, one
           capture in the first graph call and none in the kept one, the
           memory in use back at its level before the first graph call
           after ``release_graphs()``, and in a profiled replay the
           traversal kernels of the trace equal the launches the capture
           recorded, which holds ten Z-Sobol draw launches (MIS: ten draw
           calls a step) and one of each material kernel.  Reports ms a step, Mray/s and peak device memory of
           each way, the capture's seconds, the memory allocated and
           reserved before, with the kept graph and after its release,
           and a steady step of each (device ms, busy share, device ops;
           ``profile_steps``).  Then ``kept_scene``: scene 17 at 256x256
           rendered twice with the graph kept, the second time with the
           dragon's coat tint moved and the scene a new object; its film
           must equal the eager film of the changed scene and differ from
           the first.  Every render below runs through the kept graph, as
           ``render`` does on a card.
  films    scene 17 at the main path's size (4 tiles of 262,144 lanes),
           fast and precise: the forward films other than ``render``,
           called as a user calls them.  The albedo and normal AOVs
           (``render_accum``, FILMS_AOV_SPP spp), eager on every device:
           timed, one closest-hit launch a tile and sample, no capture.
           ``count_rays_one_spp`` and ``parallel.render_sharded`` (no
           group, MIS + Z-Sobol, depth 16, FILMS_SHARDED_SPP spp; the same
           configuration, so the film replays the count's kept step)
           through the wavefront, each against its eager wavefront form
           (the private ``graphed=False`` form, the plain version), eager
           first; the count is called twice through the graph, the first
           time with no graph kept.  Gates: counts and films equal bit for
           bit; the count's first graph call captures the step once (the
           tile's lanes), every other call never; the same launches both
           ways.  Reports ms, Mray/s (the sharded film's rays are the
           count x spp), peak device memory and the capture's seconds.
  render   the fast main path: render() of scene 17, MIS + Z-Sobol,
           1024x1024, depth 16, table_res 64 -- a 1 spp warm-up, then a
           timed 4 spp render (a first call of its configuration: it
           captures its step once, gated) and a second timed call, which
           replays the kept graph (``kept_ms``): no capture, the image,
           rays, steps and launches of the first.  Checks: K1 and K2
           launch counts equal the wavefront steps, the precise kernels
           are not launched, no non-finite pixel, mean linear RGB > 0.
  render_precise  the same render (and kept call) with ``precise=True``:
           K3 and K2p launch
           counts equal the wavefront steps, K1 and K2 are not launched, no
           non-finite pixel, mean > 0, display RMSE against the fast render
           <= 0.01.
  ladder   scene 6 (gold bunny), NEE + random sampler, 512x512, depth 16,
           precise, 4 spp: the same launch, non-finite and mean checks; and
           scene 0, PT + random, 256x256, 4 spp, where no any-hit kernel may
           be launched.  Then bench.py's other rungs at its sizes, fast,
           depth 16, table_res 64, 4 spp after a 1 spp warm-up (bench.py
           runs 16 to 256): scene 3 PT + random 256x256 (textures, a normal
           map), scene 8 MIS + Sobol 512x512 (dispersive glass), scene 10
           MIS + Sobol 1024x1024 (thin plastic); scene 19 MIS + Sobol and
           scene 1 NEE + Sobol at 512x512 (environment light, PBR,
           clearcoat and plastic; two point lights); and scene 8 with
           ``precise=True``, display RMSE against its fast render <= 0.01.
           The instanced scenes, MIS + Sobol 512x512: scene 7 fast and
           scene 12 fast and precise (display RMSE of precise against fast
           <= 0.01); each kernel launched 1 + G times a step (G = 1 group).
  progressive  scene 7 at 256x256, 4 spp: ``render_progressive`` in chunks
           of 2, and resumed from the checkpoint of its first chunk, each
           against the one-shot ``render`` (atol 2e-5, rtol 1e-4), each
           run from no kept graph capturing its step once; then
           ``python -m tpu_pathtracer_torch.cli --scene 7`` at 128x96, 4 spp
           as a subprocess, which must exit 0 and write its PNG.
  parity   scene 17 at 64x48, 2 spp, depth 6 on the card and on the CPU
           (plain versions), fast and precise; scenes 8 and 19 the same,
           fast, and scene 7 fast and precise: display RMSE <= 0.01 each.
  consistency  the JAX package's independent checks of its integrators
           (``tpu_pathtracer_torch.consistency``, the counterparts of
           tests/test_consistency_matrix.py), at the reference's sizes,
           seeds and gates, table_res 32, depth 8: pt vs nee vs mis on
           scene 0 (Sobol and random) and scene 8 (Sobol, abs_floor 0.03)
           at 48x36, 48 spp -- each pair's median-filtered RMSE over the
           nee mean under 0.02 (0.03) + 2 x the noise of pt against pt
           with seed 101, and the nee and mis means within 0.02 + 2 x
           noise / 8; then the PT mean of the anchored scenes 3, 8 and
           17 (64x48, 128 spp, Sobol, seed 7) within 0.08 + 2 x the
           anchor's two-seed spread x sqrt(anchor spp / 128) of the
           anchor (the port's copy, ``tpu_pathtracer_torch/data/
           pt_mean_anchors.json``).  Each gate's value is printed beside
           its limit; any miss fails the phase.  (The slow tier, the
           ``cuda`` + ``slow`` tests of tests/test_torch_cuda.py: every
           anchored scene with both samplers at 64x48, 64 spp, and the
           anchors of scenes 6, 9 and 10.)
  train    the differentiable pass (``tpu_pathtracer_torch.parallel``).
           grad_step: bench.py's grad rung, ``loss_and_grads`` on scene
           17 at 128x128, 2 spp, depth 8, MIS + Z-Sobol against an
           all-zero target, fast and precise, in the order: the eager
           program (``_loss_and_grads(..., graphed=False)``, the plain
           version), the first graph call (the eager warm-up and the
           capture of forward and backward as one CUDA graph;
           ``first_call_extra_s`` is its time less a replay's), a replayed
           call (``step_s``), then the eager program and a replay with
           other values of every column.  Gates: each graph call's loss
           and gradients equal to the eager ones of its parameters bit for
           bit (the gathers' backward sums in a fixed order), the other
           parameters' loss different; every gradient value finite, at
           both sets of values; the
           launches of every call exact: K1 (K3 precise) 2 x (1 + 8) = 18
           times and K2 (K2p) 2 x 8 = 16 times, the other pair never; the
           forward alone (no autograd) launches the same, so the backward
           launches none; the gathers' backward kernel (G1,
           ``gather_rows_grad``) the same number of times every call and
           never in the forward alone; a profiled replay traces as many
           traversal kernels as the capture recorded, and the capture
           recorded G1's launches and one Z-Sobol draw launch for each of
           the 2 x (2 + 8 x 8) draw calls; ``release_graphs()`` brings the
           memory in use back to its level before the first call.
           Reports each call's seconds and peak device memory, the memory
           the kept graph holds between calls (allocated and reserved),
           and the replay's device ops, device ms and busy share.
           gather_grad: G1 on the inputs of every gather site of one eager
           fast grad step at that size (upstream gradient, row index and
           table rows recorded at the kernel's wrapper: 16,384 lanes each,
           5 rows) and on seeded sets of the largest shipped table (8
           rows) at 16,384 lanes and of the grid's cap of blocks (600,000
           lanes), C 1 and 3.  Gates: every result within 1e-6 of each
           row's sum of |g| against the plain version
           (``gather_rows_grad_plain``, ``index_add_``) in float64 on the
           same inputs, and the same bits on a second call; the float32
           plain version's and the masked sum's errors are read beside
           the kernel's.  Times, device ms of all the step's sites (queued
           8 sites at a time): the kernel, the plain version, torch's
           ``index_put_`` with accumulate (autograd's own backward of
           ``table[idx]``) and a masked per-row sum in plain PyTorch
           (``(g[:, None] * (idx[:, None] == arange(M))[..., None])
           .sum(0)``), beside the byte bound (each lane's index and
           gradient read once at 3.35 TB/s).  Its
           row in the final "kernels" line gives these per launch.
           adam: the target is scene 17's linear render (``render_accum``
           / spp) at the same size and spp, NEE at one bounce (where the
           gradient is exact); from the dragon's base and coat tint
           coefficients moved off, five ``train_step_adam`` steps (lr 0.02)
           and the loss at the end: the loss falls on at least four of the
           five steps and ends below the first; a checkpoint saved after
           step 3, loaded with ``TrainState.load`` and run to step 5, lands
           on the uninterrupted run's params within 1e-6 + 1e-5 relative
           (``bit_exact`` says whether it is exact).
           grad_parity: scene 17 at 32x24, 1 spp, depth 3, fast and
           precise, ``loss_and_grads`` on the card against the CPU's plain
           versions: loss within 1e-3 relative, every gradient value
           finite and each column within 1e-2 of its largest magnitude.  Adam and grad_parity run
           through the captured graph (one capture per configuration).
  files    file-backed inputs, written to a temporary directory that
           becomes the port's ``mesh.ASSET_DIR``: ``dragon.obj``, the
           procedural dragon at 2304 x 192 (884,736 triangles, about the
           scanned dragon's 871k; v/vt/vn/f lines, ``%.9g``), an LFS-stub
           ``bunny.obj``, scene 19's sky as a FLOAT EXR, a ZIP/HALF EXR and
           an 8-bit PNG texture.  Checks: each file read back by the port
           equal to what was written (the OBJ's triangles and normals bit
           for bit, the stub skipped for the procedural 9,216-triangle
           bunny); times ``load_obj`` and the native SAH build of the
           dragon, and the bunny under the numpy and the native builder in
           turns (numpy, native, native, numpy); the native builder must
           be available and no numpy build may run in the scene build.
           Scene 17 through ``try_load_asset``: the kernels on the step-2
           rays of its first tile (K1, K3) and their shadow rays (K2,
           K2p), 262,144 lanes, exact against the plain versions (brute
           force) on every 16th lane and against the kernels' walk in
           PyTorch (``walk_wide_plain``) on every lane, timed and bounded
           as in the kernels phase (the tables' bytes now dominate); then
           the render gates of the main path at its size (1024x1024, MIS
           + Z-Sobol, depth 16, table_res 64, 4 spp after a 1 spp warm-up),
           fast and precise (launches = steps, finite, precise vs fast
           display RMSE <= 0.01).  Scene 19 with its sky read from the EXR
           at 512x512, 4 spp: the film equal bit for bit to the in-memory
           sky's.  Neither PIL nor cv2 may have been imported.
  fit      ``fit_table(srgb, 64)`` on the card, timed; on the 7^3 sweep of
           tests/test_spectrum.py's production-res gate, the round trip's
           p99 delta E < 1.0 and p99 delta E <= 0.1 between its spectra
           and the committed ``srgb_64_v2.npz``'s.  Then the CLI with
           ``--gamut rec2020 --table-res 24`` (sRGB at res 24 is not
           committed; ``--gamut`` is the output gamut) as a subprocess,
           which must fit the table, cache it and write its PNG.

Before its last line it prints {"kernels": [...]} and the nvidia-smi line;
the last line is {"ok": true, "device": {...}}.  It exits non-zero, with
no result, when there is no CUDA device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
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
    "any_hit_precise": (("nodes_w", "tri9p"), "tri9", False,
                        OPS_PER_PRECISE_TRI_TEST, OPS_PER_PRECISE_RAY_SETUP,
                        "tpu_pathtracer/ops/pallas_trace.py:411"),
}
FAST = ("closest_hit", "any_hit")
PRECISE = ("closest_hit_precise", "any_hit_precise")
# wavefront steps whose rays are checked and timed: 1 and 2 coherent, 6
# and 12 incoherent (dead lanes are regenerated while samples are left),
# 24 and 32 with the dead lanes of a tile that runs out of samples; the
# closest-hit kernels also on the camera rays (step 1)
STEPS = (2, 6, 12, 24, 32)
SHADOW_STEPS = (1, *STEPS)
SMALL_LAUNCH = 65536    # lanes of a 256x256 film's launch


_T0 = time.perf_counter()


def emit(phase: str, **fields):
    """One JSON line of results; ``t_s`` is the seconds since the script
    started."""
    print(json.dumps({"phase": phase, **fields,
                      "t_s": time.perf_counter() - _T0}), flush=True)


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
        if spin_cycles >= 1 << 34:       # ~10 s of spin: fn waits for the card
            raise RuntimeError("device_ms: fn synchronises with the host")
        spin_cycles *= 2


def record_tile_rays(cuda_trace, integ, scene, meta, cam, cfg,
                     max_steps=None) -> dict:
    """The launches the integrator makes of each kernel wrapper in every
    wavefront step of the first tile, its steps run as the eager step loop
    runs them (until the all-done flag, read every ``SYNC_EVERY`` steps, or
    after ``max_steps`` steps; a graph replay runs no wrapper, and replays
    the same steps): {wrapper name: [(BVH, rays), ...]} in
    launch order; an instanced scene launches each kernel on the main
    soup's BVH, then on each group's.  ``launches_on`` picks one BVH's."""
    from tpu_pathtracer_torch.render.sampler import make_sampler

    recorded = {k: [] for k in KERNELS}
    real = {k: getattr(cuda_trace, k) for k in KERNELS}

    def recorder(name):
        def f(*args, **kw):
            # the BVH comes first, the rays last
            recorded[name].append((args[0], args[-1].clone()))
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
        steps = 0
        while max_steps is None or steps < max_steps:
            for _ in range(integ.SYNC_EVERY if max_steps is None
                           else max_steps):
                state = integ._wavefront_step(scene, meta, cam, cfg, sampler,
                                              px, cfg.spp, state, table)
                steps += 1
            if integ._tile_done(state, cfg.spp):
                break
        torch.cuda.synchronize()
    finally:
        for k, fn in real.items():
            setattr(cuda_trace, k, fn)
    return recorded


def launches_on(rec: dict, bvh) -> dict:
    """{wrapper name: [rays of step 1, step 2, ...]} of the launches on
    ``bvh`` in a ``record_tile_rays`` record."""
    return {k: [r for b, r in v if b is bvh] for k, v in rec.items()}


def check_kernel(cuda_trace, bvh, name, ray_sets, timed_set,
                 plain_stride=1):
    """Hold one kernel against its plain version on each ray set, then time
    both and compute the bound on ``timed_set``; on each set read the
    counters.  With ``plain_stride`` > 1 the plain
    version (brute force: rays x triangles) runs on every
    ``plain_stride``-th lane only, timed by that one call, and the
    kernels' walk in PyTorch (``walk_wide_plain``) is held against the
    kernel on every lane.  Returns the kernel's row of the final "kernels"
    line (without its launches)."""
    tables, plain_table, closest, ops_per_test, ops_per_ray, _ = KERNELS[name]
    tris = getattr(bvh, plain_table)
    kern = getattr(cuda_trace, name)
    plain = getattr(cuda_trace, name + "_plain")
    lanes = slice(None, None, plain_stride)
    max_abs = 0.0
    plain_call_ms = {}
    for set_name, rays in ray_sets.items():
        active = rays[6] > 0.0 if closest else rays[6] >= 0.0
        got = got_all = kern(bvh, rays)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        ref = plain(tris, rays[:, lanes].contiguous())
        b.record()
        torch.cuda.synchronize()
        plain_call_ms[set_name] = a.elapsed_time(b)
        walk_differs = None
        if plain_stride > 1:
            walk = cuda_trace.walk_wide_plain(bvh, rays,
                                              precise=name in PRECISE,
                                              any_hit=not closest)
            walk_differs = int(sum((x != y).sum() for x, y in zip(
                walk if closest else (walk,),
                got_all if closest else (got_all,))))
            got = tuple(x[lanes] for x in got) if closest else got[lanes]
            active = active[lanes]
        # a conservative cull gives the brute-force answers whatever the
        # visit order: every output equal on every ray, bit for bit
        if closest:
            t, tri, b1, b2, hit = got
            rt, rtri, rb1, rb2, rhit = ref
            same = (hit == rhit) & (tri == rtri)
            pairs = ((t, rt), (b1, rb1), (b2, rb2))
            abs_err = max(float((x - y)[same].abs().max())
                          if same.any() else 0.0 for x, y in pairs)
            detail = dict(
                hits=int(hit.sum()),
                hit_only_kernel=int((hit & ~rhit).sum()),
                hit_only_plain=int((rhit & ~hit).sum()),
                tri_differs=int((hit & rhit & (tri != rtri)).sum()),
                values_differ=int(sum((x != y).sum() for x, y in pairs)))
            ok = bool(same.all()) and detail["values_differ"] == 0
        else:
            same = got == ref
            abs_err = float((~same).float().max())
            detail = dict(occluded=int(got.sum()),
                          only_kernel=int((got & ~ref).sum()),
                          only_plain=int((ref & ~got).sum()))
            ok = bool(same.all())
        if walk_differs is not None:
            detail.update(plain_lanes=len(range(rays.shape[1])[lanes]),
                          walk_values_differ=walk_differs)
            ok = ok and walk_differs == 0
        max_abs = max(max_abs, abs_err)
        counters = torch.zeros(4, dtype=torch.int64, device=rays.device)
        kern(bvh, rays, counters=counters)
        torch.cuda.synchronize()
        visits, tests, max_visits, max_tests = counters.tolist()
        emit("kernels", kernel=name, rays=set_name, active=int(active.sum()),
             agree=float(same[active].float().mean()) if active.any() else 1.0,
             max_abs_err=abs_err, ok=ok, **detail, node_visits=visits,
             tri_tests=tests, max_node_visits_of_a_ray=max_visits,
             max_tri_tests_of_a_ray=max_tests)
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"on {set_name}")
    rays = ray_sets[timed_set]
    live = int((rays[6] > 0.0 if closest else rays[6] >= 0.0).sum())
    ms = device_ms(lambda: kern(bvh, rays), 20)
    call_ms = cuda_ms(lambda: kern(bvh, rays), 10)
    plain_ms = (cuda_ms(lambda: plain(tris, rays), 3) if plain_stride == 1
                else plain_call_ms[timed_set])
    counters = torch.zeros(4, dtype=torch.int64, device=rays.device)
    kern(bvh, rays, counters=counters)
    torch.cuda.synchronize()
    visits, tests, _, _ = counters.tolist()
    n = rays.shape[1]
    ops_per_visit = (OPS_PER_WIDE_VISIT if "nodes_w" in tables
                     else OPS_PER_NODE_VISIT)
    ops = visits * ops_per_visit + tests * ops_per_test + live * ops_per_ray
    table_bytes = 4 * sum(getattr(bvh, f).numel() for f in tables)
    out_bytes_per_ray = 4 + 4 + 4 + 4 + 1 if closest else 1
    # a live ray reads its seven floats, a dead or inactive one only its
    # t_max; every ray writes its result
    nbytes = (live * 7 * 4 + (n - live) * 4 + n * out_bytes_per_ray
              + table_bytes)
    ops_ms = ops / PEAK_FP32_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    row = dict(ms=ms, plain_ms=plain_ms, bound_ms=max(ops_ms, bytes_ms),
               bound_by="operations" if ops_ms >= bytes_ms else "bytes",
               max_abs_err=max_abs)
    emit("kernels", kernel=name, timed_rays=timed_set, rays=n, live=live,
         node_visits=visits, tri_tests=tests, ops=ops, bytes=nbytes, **row,
         call_ms=call_ms, plain_lanes=len(range(n)[lanes]), library_ms=None,
         **cuda_trace.launch_info(name, n))
    return row


# the traversal kernels of csrc/trace_kernels.cu, by their names in a trace
TRAVERSAL_KERNELS = ("team_kernel", "binary_any_hit_kernel")


def profile_steps(run_step, n: int, dev) -> dict:
    """Time ``n`` calls of ``run_step`` without the profiler (host wall,
    synchronised), then profile ``n`` more (CPU + CUDA activity) -> per
    step: ``step_ms`` and ``profiled_step_ms`` (host wall), ``device_ms``
    (summed device time), ``busy_share`` (device_ms / step_ms),
    ``launches`` (device ops), ``kernels`` (launches of each traversal
    kernel) and ``top_kernels`` (the 12 with the most device time)."""
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
    cuda = torch.autograd.DeviceType.CUDA
    device = [e for e in prof.key_averages() if e.device_type == cuda
              and e.device_time_total > 0]
    device_us = sum(e.device_time_total for e in device)
    top = sorted(device, key=lambda e: -e.device_time_total)[:12]
    return dict(
        step_ms=step_ms, profiled_step_ms=profiled_ms,
        device_ms=device_us / n / 1e3,
        busy_share=device_us / 1e3 / n / step_ms,
        launches=sum(e.count for e in device) / n,
        kernels={k: sum(e.count for e in device if k in e.key) / n
                 for k in TRAVERSAL_KERNELS},
        top_kernels=[dict(name=e.key[:80],
                          ms=e.device_time_total / n / 1e3,
                          calls=e.count / n) for e in top])


@contextlib.contextmanager
def captures_of(graph_cls):
    """Within: every ``graph_cls`` built (``integrator._StepGraph``: one
    capture each) appends (its lanes, the seconds of
    its build: the eager warm-up and the capture) to the yielded list."""
    built = []
    real_init = graph_cls.__init__

    def timed_init(self, scene, meta, camera, cfg, sampler, px, *rest):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real_init(self, scene, meta, camera, cfg, sampler, px, *rest)
        torch.cuda.synchronize()
        built.append((px.shape[0], time.perf_counter() - t0))

    graph_cls.__init__ = timed_init
    try:
        yield built
    finally:
        graph_cls.__init__ = real_init


def timed_render(integ, cuda_trace, tm_mod, eotf_mod, phase, scene, meta, cam,
                 cfg, expect, forbid, kept=False):
    """One main path: 1 spp warm-up, launch counts set to 0, the timed
    render, the counts read.  ``expect`` kernels must have been launched
    1 + G times per wavefront step (once on the main soup, once on each of
    the scene's G instanced groups), ``forbid`` kernels not at all; a
    replay of the captured step counts the launches its capture recorded.
    The warm-up's configuration is another (spp is part of a kept graph's
    key), so the timed render is a first call: it captures its step.  With
    ``kept`` a second call of the same configuration follows, which must
    capture nothing and give the first call's image, rays, steps and
    launches.  Returns (image, launches)."""
    integ.render(scene, meta, cam, dataclasses.replace(cfg, spp=1))
    calls = []
    with captures_of(integ._StepGraph) as caps:
        for _ in range(2 if kept else 1):
            torch.cuda.synchronize()
            cuda_trace.reset_launch_counts()
            caps.clear()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            a.record()
            img, stats = integ.render(scene, meta, cam, cfg, with_stats=True)
            b.record()
            torch.cuda.synchronize()
            calls.append(dict(
                img=img, stats=stats, wall_s=time.perf_counter() - t0,
                ms=a.elapsed_time(b), captures=len(caps),
                launches={k: cuda_trace.LAUNCHES[k] for k in KERNELS}))
    img, stats = calls[0]["img"], calls[0]["stats"]
    wall_s, render_ms = calls[0]["wall_s"], calls[0]["ms"]
    launches, captures = calls[0]["launches"], calls[0]["captures"]
    kept_fields = {}
    if kept:
        again = calls[1]
        kept_fields = dict(
            kept_ms=again["ms"], kept_wall_s=again["wall_s"],
            kept_mray_s=again["stats"].n_rays / (again["ms"] * 1e-3) / 1e6,
            kept_captures=again["captures"],
            kept_equal=torch.equal(again["img"], img))
        if again["captures"] or not kept_fields["kept_equal"] \
                or again["stats"] != stats or again["launches"] != launches:
            raise AssertionError(f"{phase}: the kept call captured "
                                 f"{again['captures']} times or differs from "
                                 f"the first: {kept_fields}, "
                                 f"{again['launches']} vs {launches}")
    del calls
    nonfinite = int((~torch.isfinite(img)).sum())
    linear = tm_mod.invert(eotf_mod.decode(img, cfg.eotf), cfg.tone_map)
    mean_rgb = [float(v) for v in linear.reshape(-1, 3).mean(0)]
    emit(phase, width=cfg.width, height=cfg.height, spp=cfg.spp,
         max_depth=cfg.max_depth, strategy=cfg.strategy, sampler=cfg.sampler,
         precise=bool(cfg.precise), ms=render_ms, wall_s=wall_s,
         mray_s=stats.n_rays / (render_ms * 1e-3) / 1e6, rays=stats.n_rays,
         rays_per_spp=stats.n_rays / cfg.spp, steps=stats.n_steps,
         launches=launches, groups=len(scene.instanced), nonfinite=nonfinite,
         mean_linear_rgb=mean_rgb, captures=captures, **kept_fields)
    if captures != 1:
        raise AssertionError(f"{phase}: the first call captured {captures} "
                             "step graphs, expected 1")
    per_step = 1 + len(scene.instanced)
    for k in expect:
        if launches[k] != stats.n_steps * per_step:
            raise AssertionError(f"{phase}: {k} launched {launches[k]} times "
                                 f"in {stats.n_steps} wavefront steps of "
                                 f"{per_step} launches")
    for k in forbid:
        if launches[k] != 0:
            raise AssertionError(f"{phase}: {k} launched {launches[k]} times, "
                                 "expected none")
    if nonfinite or min(mean_rgb) <= 0.0:
        raise AssertionError(f"{phase}: non-finite or black output")
    return img, launches


def graph_vs_eager(integ, cuda_trace, scene, meta, cam, cfg, expect):
    """``render_wavefront``'s tile loop with each tile's steps replayed
    from the kept captured step, against the eager step loop (its plain
    version), in turns (eager, graph, graph, eager): the first graph call
    starts from no kept graph and captures the step, the second finds it
    kept.  Gates: the films equal bit for bit (each way also equal to its
    own repeat), the same rays and steps, the ``expect`` kernels launched
    1 + G times a step both ways (G instanced groups) and no other; one
    capture in the first graph call, none in the kept one or the eager
    loop; after ``release_graphs()`` the memory in use is back at its
    level before the first graph call.  Returns each way's seconds (the
    graph's: first call, kept call), ms a step, Mray/s, peak device memory
    and captures, and the memory the kept graph holds."""
    from tpu_pathtracer_torch.render import film as film_mod
    from tpu_pathtracer_torch.render import graphs

    graphs.release_graphs()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
    films, ways = {}, {False: [], True: []}
    with captures_of(integ._StepGraph) as caps:
        for graphed in (False, True, True, False):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            cuda_trace.reset_launch_counts()
            caps.clear()
            t0 = time.perf_counter()
            film, stats = integ._wavefront_film(scene, meta, cam, cfg, 0,
                                                None, None, graphed=graphed)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            ways[graphed].append(dict(
                s=wall, stats=stats, peak=torch.cuda.max_memory_allocated(),
                captures=[t for _, t in caps],
                launches={k: cuda_trace.LAUNCHES[k]
                          for k in KERNELS}))
            if graphed not in films:
                films[graphed] = film
            elif not torch.equal(film, films[graphed]):
                raise AssertionError(f"graph: two "
                                     f"{('eager', 'graph')[graphed]} renders "
                                     f"differ ({cfg})")
            del film
    equal = torch.equal(films[True], films[False])
    rmse = display_rmse(*(film_mod.finalize(films[g], cfg.spp,
                                            tone_map=cfg.tone_map,
                                            eotf=cfg.eotf)
                          for g in (True, False)))
    del films
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
    graphs.release_graphs()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    after = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
    out = dict(film_equal=equal, display_rmse=rmse, memory_bytes=dict(
        before=dict(allocated=base[0], reserved=base[1]),
        kept=dict(allocated=held[0], reserved=held[1]),
        after_release=dict(allocated=after[0], reserved=after[1])))
    for graphed, runs in ways.items():
        st = runs[0]["stats"]
        secs = [r["s"] for r in runs]
        out["graph" if graphed else "eager"] = dict(
            seconds=secs, steps=st.n_steps, rays=st.n_rays,
            ms_per_step=[x * 1e3 / st.n_steps for x in secs],
            mray_s=[st.n_rays / x / 1e6 for x in secs],
            peak_mem_bytes=[r["peak"] for r in runs],
            captures=[len(r["captures"]) for r in runs],
            capture_s=[t for r in runs for t in r["captures"]],
            launches=runs[0]["launches"])
    if [len(r["captures"]) for r in ways[True]] != [1, 0] \
            or any(r["captures"] for r in ways[False]):
        raise AssertionError(f"graph: captures {out}, expected one in the "
                             "first graph call and none in the kept one")
    if after[0] != base[0]:
        raise AssertionError(f"graph: {after[0] - base[0]} bytes in use "
                             "after release_graphs()")
    if not equal:
        raise AssertionError(f"graph: the graph film differs from the eager "
                             f"film ({cfg}; display RMSE {rmse})")
    first = ways[False][0]["stats"]
    if any(r["stats"] != first for runs in ways.values() for r in runs):
        raise AssertionError(f"graph: steps or rays differ: {out}")
    want = {k: (first.n_steps * (1 + len(scene.instanced)) if k in expect
                else 0) for k in KERNELS}
    if any(r["launches"] != want for runs in ways.values() for r in runs):
        raise AssertionError(f"graph: launches differ from {want}: {out}")
    return out


def check_graph(integ, cuda_trace, scene, meta, cam, cfg):
    """The graph phase on the main path's scene and size, fast and
    precise: ``graph_vs_eager``, then the captured step alone: the
    capture's seconds, and a steady step each way (steps 6-9 of the first
    tile, after 2-5 timed without the profiler) by
    ``profile_steps``: device ms, busy share, device ops.
    Gate: in a profiled replay the traversal kernels of the trace equal
    the launches the capture recorded, which are the step's kernels once
    each (the traversal kernels, the two material kernels) and its ten
    Z-Sobol draw calls (MIS) ten draw launches."""
    from tpu_pathtracer_torch.ops.bsdf_kernels import EVAL_NAME as BSDF_EVAL
    from tpu_pathtracer_torch.ops.bsdf_kernels import \
        SAMPLE_NAME as BSDF_SAMPLE
    from tpu_pathtracer_torch.render.sampler import KERNEL_NAME as DRAW
    from tpu_pathtracer_torch.render.sampler import make_sampler

    dev = scene.device
    for names, c in ((FAST, cfg),
                     (PRECISE, dataclasses.replace(cfg, precise=True))):
        summary = graph_vs_eager(integ, cuda_trace, scene, meta, cam, c,
                                 names)
        tile = integ.tile_lanes(c)
        px = integ._pixel_grid(c.width, c.height, dev)[:tile]
        sampler = make_sampler(c.sampler, c.seed, c.spp, (c.width, c.height))
        table = integ._spectral_table(scene)
        accum0 = torch.zeros((tile, 3), device=dev)
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            graph = integ._StepGraph(scene, meta, cam, c, sampler, px, 0,
                                     c.spp, accum0, table)
            torch.cuda.synchronize()
            capture_s = time.perf_counter() - t0
            try:
                replay = profile_steps(graph.replay, 4, dev)
                recorded = dict(graph.recorded.launches)
            finally:
                graph.release()
            box = dict(state=integ._wavefront_step(
                scene, meta, cam, c, sampler, px, c.spp,
                integ._wavefront_init(tile, 0, accum0), table))

            def eager_step():
                box["state"] = integ._wavefront_step(
                    scene, meta, cam, c, sampler, px, c.spp, box["state"],
                    table)
            eager = profile_steps(eager_step, 4, dev)
            del box
        traced = sum(replay["kernels"][k] for k in TRAVERSAL_KERNELS)
        steady = {way: {k: p[k] for k in ("step_ms", "profiled_step_ms",
                                          "device_ms", "busy_share",
                                          "launches", "kernels")}
                  for way, p in (("graph", replay), ("eager", eager))}
        emit("graph", scene=17, width=c.width, height=c.height, spp=c.spp,
             max_depth=c.max_depth, precise=bool(c.precise), **summary,
             capture_s=capture_s, recorded_launches_per_replay=recorded,
             traced_kernels_per_replay=traced, steady_step=steady,
             top_kernels_replayed=replay["top_kernels"][:6])
        if recorded != {**{k: 1 for k in names}, DRAW: 10,
                        BSDF_SAMPLE: 1, BSDF_EVAL: 1} \
                or traced != len(names):
            raise AssertionError(f"graph: the capture recorded {recorded}, "
                                 f"a profiled replay traced {traced} "
                                 "traversal kernels")
    check_kept_scene(integ, scene, meta, cam)


KEPT_SCENE_SIZE = 256


def check_kept_scene(integ, scene, meta, cam):
    """A kept graph reads the call's scene, not the one it was captured
    with: scene 17 at KEPT_SCENE_SIZE^2 (MIS + Z-Sobol, 4 spp, depth 16)
    through ``render_wavefront`` twice, the second time with the dragon's
    coat tint moved and the scene passed as a new object.  Gates: one
    capture, in the first call; the second film equals the eager film of
    the changed scene bit for bit and differs from the first."""
    from tpu_pathtracer_torch import parallel
    from tpu_pathtracer_torch.render import graphs
    from tpu_pathtracer_torch.scene.types import MAT_CLEARCOAT

    n = KEPT_SCENE_SIZE
    c = integ.RenderConfig(width=n, height=n, spp=4, max_depth=16)
    cam_n = dataclasses.replace(cam, width=n, height=n)
    row = int(torch.nonzero(scene.materials.mat_type == MAT_CLEARCOAT)[0])
    coat = scene.materials.coat_tint_coeff.clone()
    coat[row] += 0.5
    changed = parallel.merge_params(scene.map(torch.clone),
                                    {"coat_tint_coeff": coat})
    graphs.release_graphs()
    t0 = time.perf_counter()
    with captures_of(integ._StepGraph) as caps:
        first = integ.render_wavefront(scene, meta, cam_n, c)
        first_captures = len(caps)
        second = integ.render_wavefront(changed, meta, cam_n, c)
    eager, _ = integ._wavefront_film(changed, meta, cam_n, c, 0, None, None,
                                     graphed=False)
    out = dict(captures=[first_captures, len(caps) - first_captures],
               equal_to_eager_of_changed=torch.equal(second, eager),
               differs_from_first=not torch.equal(second, first))
    graphs.release_graphs()
    emit("graph", sub="kept_scene", scene=17, width=n, height=n, spp=c.spp,
         max_depth=c.max_depth, seconds=time.perf_counter() - t0, **out)
    if out["captures"] != [1, 0] or not out["equal_to_eager_of_changed"] \
            or not out["differs_from_first"]:
        raise AssertionError(f"graph: the kept graph did not render the "
                             f"call's scene: {out}")


# samples of the films phase: the AOVs', and the ray count's and sharded
# film's, which share one configuration (the film replays the count's kept
# step graph)
FILMS_AOV_SPP = 4
FILMS_SHARDED_SPP = 1


def check_films(integ, cuda_trace, scene, meta, cam, cfg):
    """The films phase: the AOVs, the ray count and the sharded film of
    scene 17 at ``cfg``'s size, fast and precise, each called as a user
    calls it (``render_accum``, ``count_rays_one_spp``,
    ``parallel.render_sharded``).  The AOVs run eagerly: their launches
    and no capture are gated.  The count and the film are held against
    their eager wavefront forms (the private ``graphed=False`` forms),
    eager first; the first graph call of the count starts from no kept
    graph and captures the step once (timed: its eager warm-up step and
    the capture), a second call replays it, and the sharded film, of the
    same configuration, replays it too."""
    from tpu_pathtracer_torch import parallel
    from tpu_pathtracer_torch.render import graphs

    dev = scene.device
    tile = integ.tile_lanes(cfg)
    n_tiles = -(-cfg.width * cfg.height // tile)

    def run(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_trace.reset_launch_counts()
        captures.clear()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        return dict(result=result, s=time.perf_counter() - t0,
                    peak=torch.cuda.max_memory_allocated(),
                    captures=list(captures),
                    launches={k: cuda_trace.LAUNCHES[k] for k in KERNELS})

    # (lanes, seconds) of each _StepGraph built
    with captures_of(integ._StepGraph) as captures:
        for names, c in ((FAST, cfg),
                         (PRECISE, dataclasses.replace(cfg, precise=True))):
            for a in ("albedo", "normal"):
                ac = dataclasses.replace(c, strategy=a, spp=FILMS_AOV_SPP)
                out = run(lambda: integ.render_accum(scene, meta, cam, ac))
                want = {k: n_tiles * ac.spp if k == names[0] else 0
                        for k in KERNELS}
                emit("films", scene=17, width=c.width, height=c.height,
                     run=a, spp=ac.spp, precise=bool(c.precise),
                     tiles=n_tiles, ms=out["s"] * 1e3,
                     mray_s=c.width * c.height * ac.spp / out["s"] / 1e6,
                     peak_mem_bytes=out["peak"], launches=out["launches"],
                     captures=len(out["captures"]))
                if out["launches"] != want or out["captures"]:
                    raise AssertionError(f"films: {a} launched "
                                         f"{out['launches']} and captured "
                                         f"{out['captures']}, expected "
                                         f"{want} and none")
            path = dataclasses.replace(c, spp=FILMS_SHARDED_SPP)
            graphs.release_graphs()
            rays0 = None
            for label, eager, graph, again in (
                    ("count_rays_one_spp",
                     lambda: integ._count_rays(scene, meta, cam, path, False),
                     lambda: integ.count_rays_one_spp(scene, meta, cam, path),
                     True),
                    ("sharded",
                     lambda: parallel._render_sharded(scene, meta, cam, path,
                                                      None, dev,
                                                      graphed=False),
                     lambda: parallel.render_sharded(scene, meta, cam, path),
                     False)):
                out = {"eager": run(eager), "graph": run(graph)}
                if again:
                    out["graph_again"] = run(graph)
                ref = out["eager"]["result"]
                if label == "count_rays_one_spp":
                    rays0 = ref
                equal = {way: (o["result"] == ref if label ==
                               "count_rays_one_spp"
                               else torch.equal(o["result"], ref))
                         for way, o in out.items() if way != "eager"}
                rays = rays0 * path.spp
                emit("films", scene=17, width=c.width, height=c.height,
                     run=label, spp=path.spp, max_depth=path.max_depth,
                     precise=bool(c.precise), tiles=n_tiles, equal=equal,
                     rays=rays, capture_s=[
                         s for _, s in out["graph"]["captures"]],
                     **{way: dict(ms=o["s"] * 1e3,
                                  mray_s=rays / o["s"] / 1e6,
                                  peak_mem_bytes=o["peak"],
                                  captured_lanes=[n for n, _ in
                                                  o["captures"]],
                                  launches=o["launches"])
                        for way, o in out.items()})
                if not all(equal.values()):
                    raise AssertionError(f"films: the {label} graph differs "
                                         f"from eager ({c})")
                lanes = {way: [n for n, _ in o["captures"]]
                         for way, o in out.items()}
                first = [tile] if label == "count_rays_one_spp" else []
                if lanes != dict(eager=[], graph=first,
                                 **({"graph_again": []} if again else {})):
                    raise AssertionError(f"films: {label} captured {lanes}, "
                                         f"expected {first} on the first "
                                         "graph call only")
                got = {way: o["launches"] for way, o in out.items()}
                if any(n != got["eager"] for n in got.values()) \
                        or not got["eager"][names[0]]:
                    raise AssertionError(f"films: {label} launches {got}")
                del out, ref
    graphs.release_graphs()


def display_rmse(a, b) -> float:
    return float(((a - b) ** 2).mean().sqrt())


def check_progressive_and_cli(integ, scene, meta, cam):
    """``render_progressive`` of scene 7 at 256^2, 4 spp in chunks of 2,
    against the one-shot ``render`` (the tolerance of
    tests/test_progressive.py), then a resume from the checkpoint of the
    first chunk; each run starts from no kept graph and must capture its
    step once, whatever its chunks.  Then the CLI as a subprocess, which
    must exit 0 and write its PNG."""
    from tpu_pathtracer_torch.render import graphs
    from tpu_pathtracer_torch.render.progressive import render_progressive

    cfg = integ.RenderConfig(width=256, height=256, spp=4, max_depth=16)
    t0 = time.perf_counter()
    ref = integ.render(scene, meta, cam, cfg).cpu().numpy()

    class Stop(Exception):
        pass

    def stop_after_first(state):
        if state.spp_done == 2:
            raise Stop

    captures = {}

    def run(label, **kw):
        graphs.release_graphs()
        with captures_of(integ._StepGraph) as caps:
            try:
                return render_progressive(scene, meta, cam, cfg,
                                          chunk_spp=2, **kw)
            finally:
                captures[label] = len(caps)

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "film.npz")
        whole = run("chunks")
        try:
            run("stopped", checkpoint_path=ckpt, on_chunk=stop_after_first)
            raise AssertionError("the render was not stopped after a chunk")
        except Stop:
            pass
        resumed = run("resumed", checkpoint_path=ckpt)
        graphs.release_graphs()
        if captures != dict(chunks=1, stopped=1, resumed=1):
            raise AssertionError(f"progressive: captures {captures}, "
                                 "expected one a run")
        errs = {}
        for label, img in (("chunks", whole), ("resumed", resumed)):
            err = abs(img - ref)
            errs[label] = float(err.max())
            if not bool((err <= 2e-5 + 1e-4 * abs(ref)).all()):
                raise AssertionError(f"progressive ({label}) differs from "
                                     f"the one-shot render by {err.max()}")
        emit("progressive", scene=7, width=256, height=256, spp=4,
             chunk_spp=2, max_abs_err=errs, captures=captures,
             seconds=time.perf_counter() - t0)

        png = os.path.join(tmp, "cli.png")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "tpu_pathtracer_torch.cli", "--scene", "7",
             "--width", "128", "--height", "96", "--spp", "4", "-o", png],
            cwd=REPO, capture_output=True, text=True, timeout=600)
        size = os.path.getsize(png) if os.path.exists(png) else 0
        emit("cli", rc=proc.returncode, png_bytes=size,
             stdout=proc.stdout.strip().splitlines(),
             seconds=time.perf_counter() - t0)
        if proc.returncode != 0 or size == 0:
            raise AssertionError(f"the CLI failed: {proc.stderr[-2000:]}")


GRAD_SIZE, GRAD_SPP, GRAD_DEPTH = 128, 2, 8
ADAM_LR = 0.02
# a graph gradient column against the eager one, over the column's largest
# magnitude: none, as the backward sums in a fixed order (the gathers'
# backward kernel of ops.table_grad)
GRAD_GRAPH_TOL = 0.0


# G1, the gathers' backward kernel (ops.table_grad): a result against the
# plain version in float64, over each row's sum of |g|
GATHER_TOL = 1e-6
GATHER_SOURCE = "tpu_pathtracer_torch/csrc/table_grad.cu"
# seeded sets: (rows, channels, lanes); 8 rows is the largest shipped
# table (scenes 7, 12, 14), 600,000 lanes fill the grid's cap of blocks
GATHER_SETS = tuple((rows, c, n) for rows, n in ((8, 16384), (8, 600_000))
                    for c in (1, 3))


def masked_row_sum(grad_out, idx, rows):
    """The gathers' backward as a masked per-row sum in plain PyTorch: an
    (N, rows, C) product summed over the lanes (timed beside the kernel)."""
    hit = idx[:, None] == torch.arange(rows, device=idx.device)
    if grad_out.dim() == 1:
        return (grad_out[:, None] * hit).sum(0)
    return (grad_out[:, None] * hit[..., None]).sum(0)


def check_gather_grad(step, dev) -> dict:
    """The train phase's gather_grad: G1 on the sites of one grad step
    (``step()``, eager) and on the seeded ``GATHER_SETS``, each against the
    plain version in float64; the step's sites timed with the kernel, the
    plain version, ``index_put_`` and ``masked_row_sum``.  Returns G1's
    row of the final "kernels" line (ms a launch; launches a grad step)."""
    from tpu_pathtracer_torch.ops import table_grad

    sites = []
    kernel = table_grad.gather_rows_grad

    def recorder(grad_out, idx, rows):
        sites.append((grad_out.detach().clone(), idx.clone(), rows))
        return kernel(grad_out, idx, rows)

    table_grad.gather_rows_grad = recorder
    try:
        step()
    finally:
        table_grad.gather_rows_grad = kernel
    torch.cuda.synchronize()
    n_step = len(sites)
    gen = torch.Generator(device=dev).manual_seed(2024)
    for rows, c, n in GATHER_SETS:
        idx = torch.randint(0, rows, (n,), generator=gen, device=dev)
        g = torch.randn((n, c) if c > 1 else (n,), generator=gen, device=dev)
        sites.append((g, idx, rows))

    def index_put(g, idx, rows):
        # as autograd's backward of table[idx] calls it: unsafe, so that no
        # range check reads the indices back to the host
        return torch.ops.aten._index_put_impl_(
            torch.zeros((rows, *g.shape[1:]), device=dev), (idx,), g,
            accumulate=True, unsafe=True)

    # each result's error against the plain version in float64, over each
    # row's sum of |g|: the kernel's gated, the float32 plain version's
    # (index_add_, float atomics) and the masked sum's read beside it
    worst = dict(kernel=0.0, plain_float32=0.0, masked_sum=0.0)
    max_abs_err, failed = 0.0, []
    for k, (g, idx, rows) in enumerate(sites):
        got = kernel(g, idx, rows)
        again = kernel(g, idx, rows)
        g64 = g.double()
        want = table_grad.gather_rows_grad_plain(g64, idx, rows)
        scale = table_grad.gather_rows_grad_plain(g64.abs(), idx, rows)
        for name, val in (
                ("kernel", got),
                ("plain_float32",
                 table_grad.gather_rows_grad_plain(g, idx, rows)),
                ("masked_sum", masked_row_sum(g, idx, rows))):
            err = (val.double() - want).abs()
            share = float((err / scale.clamp_min(1e-300)).max())
            worst[name] = max(worst[name], share)
            if name == "kernel":
                max_abs_err = max(max_abs_err, float(err.max()))
                if not bool((err <= GATHER_TOL * scale).all()):
                    failed.append((k, tuple(g.shape), rows, share))
        if not torch.equal(got, again):
            failed.append((k, "second call differs"))

    step_sites = sites[:n_step]

    def step_ms(fn):
        """Device ms of fn on every site of the step: the sites in chunks,
        so that a batch stays well inside the card's queue of pending
        launches (``index_put_`` launches ~18 kernels a call)."""
        chunks = [step_sites[k:k + 8] for k in range(0, n_step, 8)]
        return sum(device_ms(lambda c=c: [fn(*site) for site in c], 3)
                   for c in chunks)

    times = {name: step_ms(fn) for name, fn in (
        ("kernel", kernel), ("plain", table_grad.gather_rows_grad_plain),
        ("index_put", index_put), ("masked_sum", masked_row_sum))}
    step_bytes = sum(g.numel() * g.element_size() + idx.numel() * 8
                     for g, idx, _ in step_sites)
    bound_ms = step_bytes / PEAK_BYTES_PER_S * 1e3
    shapes = sorted({(tuple(g.shape), rows) for g, _, rows in step_sites})
    emit("train", sub="gather_grad", scene=17, width=GRAD_SIZE,
         height=GRAD_SIZE, spp=GRAD_SPP, max_depth=GRAD_DEPTH,
         step_sites=n_step, step_site_shapes=[list(x) for x in shapes],
         seeded_sets=[list(x) for x in GATHER_SETS],
         worst_err_over_row_abs_sum=worst, tol=GATHER_TOL,
         kernel_max_abs_err=max_abs_err,
         step_device_ms=times, step_bound_ms=bound_ms,
         ms_per_launch={k: v / n_step for k, v in times.items()})
    if not n_step or failed:
        raise AssertionError(f"gather_grad: {n_step} sites a step; "
                             f"failed {failed[:8]}")
    return dict(name=table_grad.KERNEL_NAME, route="cuda",
                source=GATHER_SOURCE, replaces=None, launches=n_step,
                max_abs_err=max_abs_err, ms=times["kernel"] / n_step,
                plain_ms=times["plain"] / n_step,
                bound_ms=bound_ms / n_step, bound_by="bytes",
                library_ms=times["index_put"] / n_step)


SAMPLER_SOURCE = "tpu_pathtracer_torch/csrc/sampler.cu"
# (name, spp, film, lanes, per-lane samples and depths): the render cells'
# wavefront step and the fit's lockstep sample
SAMPLER_SETS = (("step", 64, (800, 600), 262_144, True),
                ("fit", 2, (128, 128), 16_384, False))
# 32-bit integer operations of a lane's draw, counted in csrc/sampler.cu's
# source (not its machine code): a base-4 digit 35 (the digit's shift and
# and 2, the higher bits' test and shift 2, the xor with the dim hash 1,
# fmix32 8, the >> 24 and the % 24 5, the code word's pick 4, the code's
# shift amount 4 and 64-bit shift 3, its and, shift and or 3, the loop 3);
# the rest of a 1-D draw 56 (two spread16 of 13, the Morton index 4, the
# dim hash 1, the scrambler seed 11, the Owen scramble with its reversal
# 11, the float 3; the odd-spp flip left out); a 2-D draw's second value
# 38 (its seed 9, the matrix-1 product 15, its scramble 11, its float 3)
ZSOBOL_OPS_PER_DIGIT = 35
ZSOBOL_OPS_1D = 56
ZSOBOL_OPS_2D_EXTRA = 38
# H100 SXM: 132 SMs, 64 32-bit integer operations an SM a clock, 1.98 GHz
PEAK_INT32_OPS = 132 * 64 * 1.98e9


def step_draw_calls(base):
    """The (2-D, dimension) of the ten draw calls of a MIS step whose
    bounce window starts at ``base``."""
    return ((False, 0), (True, 1), (False, base), (True, base + 1),
            (False, base + 3), (False, base + 4), (False, base + 5),
            (False, base + 6), (True, base + 7), (False, base + 9))


def check_sampler(integ, dev) -> dict:
    """The sampler phase: the draw kernel built from its source (timed,
    ptxas's lines), then on each of ``SAMPLER_SETS`` the ten draw calls of
    a step against the plain version, bit for bit, and timed with it
    beside the bound.  Returns the kernel's row of the final "kernels"
    line (per launch, at the step's lanes)."""
    from tpu_pathtracer_torch.ops import cuda_trace
    from tpu_pathtracer_torch.render import sampler as tsam

    lib_path = cuda_trace.library_path(tsam.KERNEL_SOURCE)
    if os.path.exists(lib_path):
        os.remove(lib_path)           # build from this checkout's source
    t0 = time.perf_counter()
    _, log = cuda_trace.build(tsam.KERNEL_SOURCE)
    ptxas = [ln.strip() for ln in log.splitlines()
             if "Compiling entry" in ln or "registers" in ln
             or "stack frame" in ln]
    emit("sampler", sub="build", seconds=time.perf_counter() - t0,
         ptxas=ptxas)
    gen = torch.Generator(device=dev).manual_seed(17)
    row = None
    for name, spp, (w, h), n, per_lane in SAMPLER_SETS:
        sm = tsam.ZSobolSampler(seed=0, spp=spp, resolution=(w, h))
        px = integ._pixel_grid(w, h, dev)[:n]
        if per_lane:
            sample = torch.randint(-1, spp, (n,), generator=gen, device=dev,
                                   dtype=torch.int32)
            base = 3 + 10 * torch.randint(0, 16, (n,), generator=gen,
                                          device=dev, dtype=torch.int32)
        else:
            sample, base = 1, 3
        calls = [(two_d, sample, dim) for two_d, dim in step_draw_calls(base)]

        def kernel_step():
            return [(sm.get_2d if t else sm.get_1d)(px, s, d)
                    for t, s, d in calls]

        def plain(t, s, d):
            return (sm.get_2d_plain if t else sm.get_1d_plain)(px, s, d)

        cuda_trace.reset_launch_counts()
        got = kernel_step()
        torch.cuda.synchronize()
        launches = cuda_trace.LAUNCHES[tsam.KERNEL_NAME]
        failed = []
        for k, ((t, s, d), g) in enumerate(zip(calls, got)):
            want = plain(t, s, d)
            for a, b in ((g.x, want.x), (g.y, want.y)) if t else ((g, want),):
                if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
                    failed.append((k, int((a != b).sum())))
        del got
        kernel_ms = device_ms(kernel_step, 20)
        plain_ms = sum(device_ms(lambda c=c: plain(*c), 1) for c in calls)
        n_2d = sum(t for t, _, _ in calls)
        in_bytes = 8 + (8 if per_lane else 0)
        step_bytes = n * sum(in_bytes + (8 if t else 4) for t, _, _ in calls)
        step_ops = n * sum(ZSOBOL_OPS_1D + ZSOBOL_OPS_PER_DIGIT
                           * sm.n_base4_digits + ZSOBOL_OPS_2D_EXTRA * t
                           for t, _, _ in calls)
        bytes_ms = step_bytes / PEAK_BYTES_PER_S * 1e3
        ops_ms = step_ops / PEAK_INT32_OPS * 1e3
        info = {("2d" if t else "1d"): tsam.launch_info(t, n)
                for t in (False, True)}
        emit("sampler", sub=name, spp=spp, width=w, height=h, lanes=n,
             log2_spp=sm.log2_spp, n_base4_digits=sm.n_base4_digits,
             per_lane=per_lane, calls=len(calls), calls_2d=n_2d,
             launches=launches, bit_equal=not failed,
             step_device_ms=dict(kernel=kernel_ms, plain=plain_ms),
             step_bound_ms=max(bytes_ms, ops_ms), bytes_ms=bytes_ms,
             int_ops_ms=ops_ms, kernel_over_bound=kernel_ms
             / max(bytes_ms, ops_ms), plain_over_kernel=plain_ms / kernel_ms,
             launch_info=info)
        if failed or launches != len(calls):
            raise AssertionError(f"sampler {name}: {launches} launches for "
                                 f"{len(calls)} calls; draws that differ "
                                 f"(call, lanes): {failed}")
        if row is None:
            row = dict(name=tsam.KERNEL_NAME, route="cuda",
                       source=SAMPLER_SOURCE, replaces=None,
                       launches=len(calls), max_abs_err=0.0,
                       ms=kernel_ms / len(calls),
                       plain_ms=plain_ms / len(calls),
                       bound_ms=max(bytes_ms, ops_ms) / len(calls),
                       bound_by="bytes" if bytes_ms >= ops_ms else "int32 ops",
                       library_ms=None)
    return row


# bytes a lane of the material kernels reads and writes: its material id,
# its float columns (31 for a sample, 25 for an eval), two spectra of four
# wavelengths at most; f, wi, pdf and the wavelength pdfs and two flags
# (sample) or f and pdf (eval)
BSDF_SAMPLE_BYTES = 4 + 31 * 4 + 2 * 16 + 12 * 4 + 2
BSDF_EVAL_BYTES = 4 + 25 * 4 + 2 * 16 + 5 * 4
BSDF_SOURCE = "tpu_pathtracer_torch/csrc/bsdf.cu"
# (set, scene): the render cells' material kinds
BSDF_SETS = (("scan", 17), ("sky", 19))


class _Recorded(Exception):
    """Ends a render once the call a phase needs is recorded."""


def record_material_calls(integ, scene, meta, cam, cfg, step: int) -> dict:
    """The arguments of ``sample_material`` and ``evaluate_material`` at
    wavefront step ``step`` (0: the camera rays') of ``cfg``'s eager render
    of its first tile: {"sample": (args, kwargs), "eval": (args, kwargs)}."""
    from tpu_pathtracer_torch.render import bsdf

    real = {"sample": bsdf.sample_material, "eval": bsdf.evaluate_material}
    seen, calls = {"sample": 0, "eval": 0}, {}

    def recorder(kind):
        def call(*args, **kwargs):
            if seen[kind] == step:
                calls[kind] = (args, kwargs)
            seen[kind] += 1
            if len(calls) == 2:
                raise _Recorded
            return real[kind](*args, **kwargs)
        return call

    try:
        bsdf.sample_material = recorder("sample")
        bsdf.evaluate_material = recorder("eval")
        with torch.no_grad():
            integ._wavefront_film(scene, meta, cam, cfg, 0, None, None,
                                  graphed=False)
    except _Recorded:
        pass
    finally:
        bsdf.sample_material = real["sample"]
        bsdf.evaluate_material = real["eval"]
    return calls


def check_bsdf(integ, scene_at, dev) -> list:
    """The bsdf phase: the material kernels built from their source
    (timed, ptxas's lines), then on each of ``BSDF_SETS`` a step's sample
    and eval call against the torch ops, bit for bit, timed with them
    beside the bound.  Returns the kernels' rows of the final "kernels"
    line (per launch, at the step's lanes: the scan set's)."""
    from tpu_pathtracer_torch.ops import bsdf_kernels, cuda_trace
    from tpu_pathtracer_torch.render import bsdf

    lib_path = cuda_trace.library_path(bsdf_kernels.KERNEL_SOURCE)
    if os.path.exists(lib_path):
        os.remove(lib_path)           # build from this checkout's source
    t0 = time.perf_counter()
    _, log = cuda_trace.build(bsdf_kernels.KERNEL_SOURCE)
    ptxas = [ln.strip() for ln in log.splitlines()
             if "Compiling entry" in ln or "registers" in ln
             or "stack frame" in ln]
    emit("bsdf", sub="build", seconds=time.perf_counter() - t0,
         ptxas=ptxas)
    rows = []
    for name, n_scene in BSDF_SETS:
        scene, meta, cam = scene_at(n_scene, 800, 600)
        cfg = integ.RenderConfig(width=800, height=600, spp=64, max_depth=16)
        calls = record_material_calls(integ, scene, meta, cam, cfg, 2)
        (s_args, s_kw), (e_args, e_kw) = calls["sample"], calls["eval"]
        lanes = s_args[5].shape[0]
        kinds = [k for k in meta.present_mat_kinds if k in bsdf.SAMPLED_KINDS]

        def kernel_sample():
            return bsdf.sample_material(*s_args, **s_kw)

        def kernel_eval():
            return bsdf.evaluate_material(*e_args, **e_kw)

        def ops_sample():
            return bsdf._sample_material_ops(*s_args, s_kw["uc2"],
                                             s_kw["uc3"])

        def ops_eval():
            return bsdf._evaluate_material_ops(*e_args, **e_kw)

        failed = []
        with torch.no_grad():
            cuda_trace.reset_launch_counts()
            got, want = kernel_sample(), ops_sample()
            fe, pe = kernel_eval()
            fe_t, pe_t = ops_eval()
            torch.cuda.synchronize()
            launches = {k: cuda_trace.LAUNCHES[k] for k in (
                bsdf_kernels.SAMPLE_NAME, bsdf_kernels.EVAL_NAME)}
            pairs = [("f", got.f.lanes, want.f.lanes),
                     ("wi_t", (got.wi_t.x, got.wi_t.y, got.wi_t.z),
                      (want.wi_t.x, want.wi_t.y, want.wi_t.z)),
                     ("pdf", (got.pdf,), (want.pdf,)),
                     ("wl_pdf", got.wl.pdf.lanes, want.wl.pdf.lanes),
                     ("eval_f", fe.lanes, fe_t.lanes),
                     ("eval_pdf", (pe,), (pe_t,))]
            for what, gs, ws in pairs:
                for a, b in zip(gs, ws):
                    ne = int((a.view(torch.int32) != b.view(torch.int32))
                             .sum())
                    if ne:
                        failed.append((what, ne))
            for what, a, b in (("sampled", got.sampled, want.sampled),
                               ("specular", got.specular, want.specular)):
                if not torch.equal(a, b):
                    failed.append((what, int((a != b).sum())))
            del got, want, fe, pe, fe_t, pe_t
            ms = dict(sample=device_ms(kernel_sample, 20),
                      eval=device_ms(kernel_eval, 20))
            ops = dict(sample=profile_steps(ops_sample, 3, dev),
                       eval=profile_steps(ops_eval, 3, dev))
        bound_ms = dict(sample=lanes * BSDF_SAMPLE_BYTES / PEAK_BYTES_PER_S
                        * 1e3, eval=lanes * BSDF_EVAL_BYTES
                        / PEAK_BYTES_PER_S * 1e3)
        info = {k: bsdf_kernels.launch_info(k == "eval", lanes)
                for k in ("sample", "eval")}
        emit("bsdf", sub=name, scene=n_scene, lanes=lanes, kinds=kinds,
             launches=launches, bit_equal=not failed, device_ms=ms,
             ops_device_ms={k: v["device_ms"] for k, v in ops.items()},
             ops_launches={k: v["launches"] for k, v in ops.items()},
             bound_ms=bound_ms,
             kernel_over_bound={k: ms[k] / bound_ms[k] for k in ms},
             ops_over_kernel={k: ops[k]["device_ms"] / ms[k] for k in ms},
             launch_info=info)
        if failed or launches != {bsdf_kernels.SAMPLE_NAME: 1,
                                  bsdf_kernels.EVAL_NAME: 1}:
            raise AssertionError(f"bsdf {name}: launches {launches}; "
                                 f"outputs that differ (what, lanes): "
                                 f"{failed}")
        if not rows:
            rows = [dict(name=kname, route="cuda", source=BSDF_SOURCE,
                         replaces=None, launches=1, max_abs_err=0.0,
                         ms=ms[k], plain_ms=ops[k]["device_ms"],
                         bound_ms=bound_ms[k], bound_by="bytes",
                         library_ms=None)
                    for k, kname in (("sample", bsdf_kernels.SAMPLE_NAME),
                                     ("eval", bsdf_kernels.EVAL_NAME))]
        del calls, s_args, e_args
    return rows


def grad_column_errors(grads, ref) -> dict:
    """Each gradient column's largest difference from ``ref``'s over that
    column's largest magnitude in ``ref``; infinite where either column
    holds a non-finite value."""
    out = {}
    for k, g in ref.items():
        if not (torch.isfinite(g).all() and torch.isfinite(grads[k]).all()):
            out[k] = float("inf")
            continue
        out[k] = (float((grads[k] - g).abs().max())
                  / max(float(g.abs().max()), 1e-30))
    return out


def check_train(integ, cuda_trace, scene_at, dev):
    """The train phase: grad_step (fast and precise), gather_grad, adam,
    grad_parity.  Returns the grad step's launches, fast and precise, and
    G1's row of the final "kernels" line."""
    from tpu_pathtracer_torch import parallel
    from tpu_pathtracer_torch.ops.table_grad import KERNEL_NAME as GATHER
    from tpu_pathtracer_torch.render import graphs
    from tpu_pathtracer_torch.render.sampler import KERNEL_NAME as DRAW
    from tpu_pathtracer_torch.scene.types import MAT_CLEARCOAT

    size = GRAD_SIZE
    scene, meta, cam = scene_at(17, size, size)
    cfg = integ.RenderConfig(width=size, height=size, spp=GRAD_SPP,
                             max_depth=GRAD_DEPTH)
    zero = torch.zeros((size * size, 3), device=dev)
    params = parallel.extract_params(scene)
    # other values of every column: a graph that baked the first call's
    # parameters in would give the first call's loss again
    other = {k: v * 0.9 + 0.05 for k, v in params.items()}
    n_values = sum(v.numel() for v in params.values())
    grad_launches = {}
    for names, other_kernels in ((FAST, PRECISE), (PRECISE, FAST)):
        c = dataclasses.replace(cfg, precise=names == PRECISE)
        want = {names[0]: c.spp * (1 + c.max_depth),
                names[1]: c.spp * c.max_depth,
                **{k: 0 for k in other_kernels}}

        def eager(p):
            return parallel._loss_and_grads(p, scene, meta, cam, c, zero,
                                            None, dev, graphed=False)

        def graph(p):
            return parallel.loss_and_grads(p, scene, meta, cam, c, zero)

        parallel.release_graphs()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base_alloc = torch.cuda.memory_allocated()
        base_reserved = torch.cuda.memory_reserved()
        runs = {}
        # eager, the first graph call (warm-up and capture), a replay, and
        # both ways again with other parameter values
        for label, fn, p in (("eager", eager, params),
                             ("graph_first", graph, params),
                             ("graph", graph, params),
                             ("eager_other", eager, other),
                             ("graph_other", graph, other)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            cuda_trace.reset_launch_counts()
            t0 = time.perf_counter()
            loss, grads = fn(p)
            torch.cuda.synchronize()
            runs[label] = dict(
                s=time.perf_counter() - t0, loss=float(loss), grads=grads,
                peak=torch.cuda.max_memory_allocated(),
                launches={k: cuda_trace.LAUNCHES[k] for k in want},
                gathers=cuda_trace.LAUNCHES[GATHER],
                finite=sum(int(torch.isfinite(g).sum())
                           for g in grads.values()))
            del loss, grads
        held = dict(allocated=torch.cuda.memory_allocated() - base_alloc,
                    reserved=torch.cuda.memory_reserved() - base_reserved)
        # the forward alone, without autograd
        px = integ._pixel_grid(size, size, dev)
        cuda_trace.reset_launch_counts()
        with torch.no_grad():
            parallel._accum_linear(scene, meta, cam, c, px)
        torch.cuda.synchronize()
        forward = {k: cuda_trace.LAUNCHES[k] for k in want}
        forward_gathers = cuda_trace.LAUNCHES[GATHER]
        # one replay under the profiler: its kernels and device time
        replay = profile_steps(lambda: graph(params), 1, dev)
        recorded = dict(graphs.kept("grad").recorded.launches)
        traced = sum(replay["kernels"][k] for k in TRAVERSAL_KERNELS)
        errs = {label: grad_column_errors(runs[label]["grads"],
                                          runs[ref]["grads"])
                for label, ref in (("graph_first", "eager"),
                                   ("graph", "eager"),
                                   ("graph_other", "eager_other"))}
        # the memory in use after release, with what this phase made since
        # the base reading dropped
        for r in runs.values():
            del r["grads"]
        del px
        parallel.release_graphs()
        torch.cuda.synchronize()
        released = torch.cuda.memory_allocated() - base_alloc
        emit("train", sub="grad_step", scene=17, width=size, height=size,
             spp=c.spp, max_depth=c.max_depth, precise=bool(c.precise),
             step_s=runs["graph"]["s"], eager_step_s=runs["eager"]["s"],
             first_call_s=runs["graph_first"]["s"],
             first_call_extra_s=runs["graph_first"]["s"] - runs["graph"]["s"],
             other_params_s=dict(graph=runs["graph_other"]["s"],
                                 eager=runs["eager_other"]["s"]),
             loss={k: r["loss"] for k, r in runs.items()},
             grad_err_over_column_max=errs,
             finite_grad_values={k: r["finite"] for k, r in runs.items()},
             grad_values=n_values,
             peak_mem_bytes={k: r["peak"] for k, r in runs.items()},
             held_between_calls_bytes=held,
             allocated_after_release_bytes=released,
             launches={k: r["launches"] for k, r in runs.items()},
             gather_grad_launches={k: r["gathers"] for k, r in runs.items()},
             forward_launches=forward,
             replay=dict((k, replay[k]) for k in (
                 "step_ms", "profiled_step_ms", "device_ms", "busy_share",
                 "launches", "kernels")),
             replay_recorded_launches=recorded,
             top_kernels_replayed=replay["top_kernels"][:6])
        bad = [k for k, r in runs.items() if r["launches"] != want]
        if bad or forward != want:
            raise AssertionError(f"grad_step: launches of {bad} or the "
                                 f"forward alone {forward} differ from "
                                 f"{want}")
        # every value finite, at the rung's parameters and the other values
        if any(r["finite"] != n_values for r in runs.values()) \
                or not runs["eager"]["loss"] > 0.0:
            raise AssertionError("grad_step: a gradient value is not "
                                 "finite or the loss is 0")
        for label, ref in (("graph_first", "eager"), ("graph", "eager"),
                           ("graph_other", "eager_other")):
            if runs[label]["loss"] != runs[ref]["loss"] \
                    or max(errs[label].values()) > GRAD_GRAPH_TOL:
                raise AssertionError(
                    f"grad_step: {label} differs from {ref}: loss "
                    f"{runs[label]['loss']} vs {runs[ref]['loss']}, "
                    f"gradients {errs[label]}")
        if runs["graph_other"]["loss"] == runs["graph"]["loss"]:
            raise AssertionError("grad_step: other parameters gave the "
                                 "same loss")
        # the gathers' backward: the same launches every call, none in the
        # forward alone
        gathers = {r["gathers"] for r in runs.values()}
        if len(gathers) != 1 or not min(gathers) or forward_gathers:
            raise AssertionError(f"grad_step: gather backward launches "
                                 f"{gathers}, {forward_gathers} forward")
        # MIS: two draw calls for the camera ray and eight a bounce, each
        # one launch, every bounce captured
        draws = c.spp * (2 + 8 * c.max_depth)
        if recorded != {**{k: v for k, v in want.items() if v},
                        GATHER: min(gathers), DRAW: draws} \
                or traced != sum(want.values()):
            raise AssertionError(f"grad_step: a replay recorded {recorded}, "
                                 f"its trace {traced} traversal kernels")
        if released > 0:
            raise AssertionError(f"grad_step: {released} bytes still in use "
                                 "after release_graphs()")
        grad_launches[bool(c.precise)] = runs["graph"]["launches"]

    # ---- gather_grad: G1 on the sites of a fast grad step ------------------
    gather_row = check_gather_grad(
        lambda: parallel._loss_and_grads(params, scene, meta, cam, cfg, zero,
                                         None, dev, graphed=False), dev)

    # ---- adam: fit the dragon's colours back to the render as built -------
    # NEE at one bounce, where the loss is a smooth function of every
    # column and autodiff its exact derivative (tests/test_grad.py's
    # one-bounce gates); at depth 8 the attached VNDF sample makes the
    # roughness gradient a poor guide, and Adam steps every coordinate by
    # the learning rate whatever its gradient's size (PERF.md)
    t0 = time.perf_counter()
    acfg = dataclasses.replace(cfg, strategy="nee", max_depth=1)
    target = integ.render_accum(scene, meta, cam, acfg) / acfg.spp
    row = int(torch.nonzero(scene.materials.mat_type == MAT_CLEARCOAT)[0])
    nudge = torch.zeros_like(scene.materials.base_coeff)
    nudge[row, 2] = -2.0
    start = parallel.merge_params(scene, {
        "base_coeff": scene.materials.base_coeff + nudge,
        "coat_tint_coeff": scene.materials.coat_tint_coeff + 1.5 * nudge})
    state = parallel.make_train_state(start, lr=ADAM_LR)
    losses = []
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "train.npz")
        for k in range(5):
            state, loss = parallel.train_step_adam(state, scene, meta, cam,
                                                   acfg, target)
            losses.append(float(loss))
            if k == 2:
                state.save(ckpt)
        losses.append(float(parallel.loss_and_grads(
            state.params, scene, meta, cam, acfg, target)[0]))
        resumed = parallel.TrainState.load(ckpt, scene)
        for _ in range(2):
            resumed, _ = parallel.train_step_adam(resumed, scene, meta, cam,
                                                  acfg, target)
    diff = {k: float((resumed.params[k] - v).abs().max())
            for k, v in state.params.items()}
    exact = all(torch.equal(resumed.params[k], v)
                for k, v in state.params.items())
    close = all(bool(((resumed.params[k] - v).abs()
                      <= 1e-6 + 1e-5 * v.abs()).all())
                for k, v in state.params.items())
    drops = sum(b < a for a, b in zip(losses, losses[1:]))
    emit("train", sub="adam", scene=17, width=size, height=size,
         spp=acfg.spp, max_depth=acfg.max_depth, strategy=acfg.strategy,
         lr=ADAM_LR, losses=losses,
         drops=drops, resumed_step=resumed.step, resume_max_abs_diff=diff,
         bit_exact=exact, seconds=time.perf_counter() - t0)
    if drops < 4 or not losses[-1] < losses[0]:
        raise AssertionError(f"adam: the loss did not fall: {losses}")
    if resumed.step != 5 or not close:
        raise AssertionError(f"adam: the resumed run differs: {diff}")

    # ---- grad_parity: the card against the CPU's plain versions ------------
    pw, ph = 32, 24
    s_cpu, m_cpu, c_cpu = scene_at(17, pw, ph, device="cpu")
    s_gpu = s_cpu.to(dev)
    for precise in (False, True):
        t0 = time.perf_counter()
        pcfg = integ.RenderConfig(width=pw, height=ph, spp=1, max_depth=3,
                                  precise=precise)
        z = torch.zeros((pw * ph, 3))
        l_gpu, g_gpu = parallel.loss_and_grads(
            parallel.extract_params(s_gpu), s_gpu, m_cpu, c_cpu, pcfg, z)
        l_cpu, g_cpu = parallel.loss_and_grads(
            parallel.extract_params(s_cpu), s_cpu, m_cpu, c_cpu, pcfg, z,
            device="cpu")
        l_gpu, l_cpu = float(l_gpu), float(l_cpu)
        rel = grad_column_errors({k: g.cpu() for k, g in g_gpu.items()},
                                 g_cpu)
        emit("train", sub="grad_parity", scene=17, width=pw, height=ph,
             spp=1, max_depth=3, precise=precise, loss_gpu=l_gpu,
             loss_cpu=l_cpu, loss_rel_err=abs(l_gpu - l_cpu) / l_cpu,
             grad_err_over_column_max=rel, seconds=time.perf_counter() - t0)
        if not abs(l_gpu - l_cpu) <= 1e-3 * l_cpu or max(rel.values()) > 1e-2:
            raise AssertionError(f"grad_parity: card vs CPU differ "
                                 f"(precise={precise}): loss {l_gpu} vs "
                                 f"{l_cpu}, gradients {rel}")
    parallel.release_graphs()
    return grad_launches, gather_row


def check_consistency(dev):
    """The consistency phase: the default tier of the reference's
    consistency matrix, then the PT-mean anchors.  Prints each gate's
    value beside its limit and raises once all have run if any missed."""
    from tpu_pathtracer_torch import consistency as cons

    misses = []
    for sid, sampler, floor in cons.DEFAULT_TIER:
        t0 = time.perf_counter()
        rec = cons.check_consistency(sid, sampler, *cons.DEFAULT_SIZE,
                                     cons.DEFAULT_SPP, abs_floor=floor,
                                     device=dev)
        emit("consistency", sub="matrix", abs_floor=floor,
             seconds=time.perf_counter() - t0, **rec)
        misses += rec["misses"]
    anchors = cons.load_anchors()
    for sid in cons.SMOKE_ANCHOR_SCENES:
        t0 = time.perf_counter()
        rec = cons.check_pt_mean_anchor(sid, anchors[str(sid)], device=dev)
        emit("consistency", sub="pt_mean_anchor",
             seconds=time.perf_counter() - t0, **rec)
        misses += rec["misses"]
    if misses:
        raise AssertionError(f"consistency: {misses}")


# ---------------------------------------------------------------------------
# file-backed scenes: OBJ, EXR and PNG inputs, the native SAH builder
# ---------------------------------------------------------------------------

SCAN_N_U, SCAN_N_V = 2304, 192     # 884,736 triangles, ~ the scanned dragon
SCAN_PLAIN_STRIDE = 16             # brute force on every 16th lane
SKY_SIZE = 512


def write_obj(path, m) -> None:
    """A Mesh as v/vt/vn/f lines (``%.9g``: float32 values round-trip)."""
    import numpy as np
    with open(path, "w") as f:
        np.savetxt(f, m.positions, fmt="v %.9g %.9g %.9g")
        np.savetxt(f, m.uvs, fmt="vt %.9g %.9g")
        np.savetxt(f, m.normals, fmt="vn %.9g %.9g %.9g")
        np.savetxt(f, np.repeat(m.indices + 1, 3, axis=1),
                   fmt="f %d/%d/%d %d/%d/%d %d/%d/%d")


def write_zip_half_exr(path, img) -> None:
    """(H, W, 3) float16 -> a ZIP-compressed (16 scanlines a block) HALF
    EXR, laid out as OpenEXR writes one."""
    import struct
    import zlib
    from tpu_pathtracer_torch.utils.exr import _interleave_predict
    h, w, _ = img.shape

    def attr(name, typ, data):
        return (name.encode() + b"\0" + typ.encode() + b"\0"
                + struct.pack("<I", len(data)) + data)
    names = ("B", "G", "R")                  # the file's (alphabetical) order
    chlist = b"".join(n.encode() + b"\0" + struct.pack(
        "<iBBBBii", 1, 0, 0, 0, 0, 1, 1) for n in names) + b"\0"
    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header = (struct.pack("<ii", 20000630, 2)
              + attr("channels", "chlist", chlist)
              + attr("compression", "compression", bytes([3]))
              + attr("dataWindow", "box2i", box)
              + attr("displayWindow", "box2i", box)
              + attr("lineOrder", "lineOrder", b"\0")
              + attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
              + attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0))
              + attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
              + b"\0")
    chunks = []
    for y0 in range(0, h, 16):
        raw = b"".join(img[y, :, "RGB".index(n)].tobytes()
                       for y in range(y0, min(y0 + 16, h)) for n in names)
        comp = zlib.compress(_interleave_predict(raw))
        chunks.append(struct.pack("<iI", y0, len(comp)) + comp)
    offsets, pos = [], len(header) + 8 * len(chunks)
    for c in chunks:
        offsets.append(pos)
        pos += len(c)
    with open(path, "wb") as f:
        f.write(header + struct.pack(f"<{len(chunks)}q", *offsets)
                + b"".join(chunks))


def check_files(integ, cuda_trace, tm_mod, eotf_mod, scene_at, cfg):
    """The files phase: inputs written to a temporary ASSET_DIR, read back
    by the port; scene 17 with the scan-sized OBJ dragon (the native SAH
    build, its kernel set, the fast and precise renders); scene 19 with its
    sky from an EXR.  Returns the dense scene's kernel rows."""
    import numpy as np
    from tpu_pathtracer_torch import native, scenes
    from tpu_pathtracer_torch.cli import write_png
    from tpu_pathtracer_torch.scene import builder, bvh, image_io, mesh
    from tpu_pathtracer_torch.utils import exr

    t_phase = time.perf_counter()
    numpy_builds = []
    real_numpy_build = builder.build_bvh

    def counted(lo, hi):
        numpy_builds.append(len(lo))
        return real_numpy_build(lo, hi)
    builder.build_bvh = counted
    asset_dir = mesh.ASSET_DIR
    tmp = tempfile.TemporaryDirectory()
    try:
        d = tmp.name
        # ---- inputs ---------------------------------------------------------
        dense = mesh.dragon(n_u=SCAN_N_U, n_v=SCAN_N_V)      # procedural
        t0 = time.perf_counter()
        write_obj(os.path.join(d, "dragon.obj"), dense)
        write_s = time.perf_counter() - t0
        with open(os.path.join(d, "bunny.obj"), "w") as f:
            f.write("version https://git-lfs.github.com/spec/v1\n"
                    "oid sha256:0\nsize 0\n")
        sky = scenes._procedural_sky()
        exr.write_exr(os.path.join(d, "sky.exr"), sky)
        rng = np.random.default_rng(8)
        half = (rng.random((37, 53, 3)) * 8.0).astype(np.float16)
        write_zip_half_exr(os.path.join(d, "half.exr"), half)
        px = rng.integers(0, 256, (64, 96, 3), dtype=np.uint8)
        write_png(os.path.join(d, "albedo.png"), px)
        mesh.ASSET_DIR = d

        # ---- readers --------------------------------------------------------
        got_half = exr.read_exr(os.path.join(d, "half.exr"))
        got_sky = image_io.load_env(os.path.join(d, "sky.exr"))
        tex = image_io.texture_from_file(os.path.join(d, "albedo.png"),
                                         kind="rgb", linearize=False)
        readers = dict(
            zip_half_exr=bool(np.array_equal(got_half,
                                             half.astype(np.float32))),
            float_exr_sky=bool(np.array_equal(got_sky, sky)),
            png_texture=bool(np.array_equal(tex.data,
                                            px.astype(np.float32) / 255.0)))
        t0 = time.perf_counter()
        m = mesh.load_obj(os.path.join(d, "dragon.obj"))
        load_s = time.perf_counter() - t0
        tris = m.positions[m.indices]
        readers["obj"] = bool(
            len(m.indices) == 2 * SCAN_N_U * SCAN_N_V
            and np.array_equal(tris, dense.positions[dense.indices])
            and np.array_equal(m.normals[m.indices],
                               dense.normals[dense.indices]))
        bunny = mesh.bunny()            # the LFS stub: the procedural bunny
        readers["lfs_stub_skipped"] = len(bunny.indices) == 9216
        if not native.available():
            raise AssertionError("files: the native SAH builder is not "
                                 "available")
        t0 = time.perf_counter()
        fb = native.build_bvh_native(tris.min(1), tris.max(1))
        native_s = time.perf_counter() - t0
        # the bunny's soup under both builders, in turns
        bt = bunny.positions[bunny.indices]
        times = {"numpy": [], "native": []}
        trees = {}
        for which in ("numpy", "native", "native", "numpy"):
            t0 = time.perf_counter()
            trees[which] = (bvh.build_bvh if which == "numpy"
                            else native.build_bvh_native)(bt.min(1),
                                                          bt.max(1))
            times[which].append(time.perf_counter() - t0)
        same = all(np.array_equal(getattr(trees["numpy"], f),
                                  getattr(trees["native"], f))
                   for f in ("bounds_min", "bounds_max", "left", "right",
                             "count", "order"))
        emit("files", sub="inputs", write_obj_s=write_s,
             obj_bytes=os.path.getsize(os.path.join(d, "dragon.obj")),
             load_obj_s=load_s, triangles=len(m.indices),
             native_sah_s=native_s, native_nodes=fb.n_nodes,
             native_depth=fb.depth, bunny_triangles=len(bunny.indices),
             bunny_numpy_s=times["numpy"], bunny_native_s=times["native"],
             bunny_trees_equal=same, readers=readers)
        if not all(readers.values()):
            raise AssertionError(f"files: a reader failed: {readers}")
        del m, tris, dense, fb

        # ---- scene 17 with the OBJ dragon -----------------------------------
        t0 = time.perf_counter()
        s_d, m_d, c_d = scenes.load_scene(17, cfg.width, cfg.height,
                                          table_res=64)
        build_s = time.perf_counter() - t0
        emit("files", sub="scene17_obj_build", seconds=build_s,
             n_tris=m_d.n_tris, numpy_builds=numpy_builds,
             wide_rows=s_d.bvh.nodes_w.shape[0], wide_depth=s_d.bvh.wide_depth,
             stack_depth=s_d.bvh.stack_depth)
        if m_d.n_tris != 2 * SCAN_N_U * SCAN_N_V + 12 or numpy_builds:
            raise AssertionError("files: scene 17 was not built from the OBJ "
                                 "by the native builder")
        rows = {}
        for names, c in ((FAST, cfg),
                         (PRECISE, dataclasses.replace(cfg, precise=True))):
            rec = launches_on(record_tile_rays(cuda_trace, integ, s_d, m_d,
                                               c_d, c, max_steps=2), s_d.bvh)
            for name in names:
                label = "scan_step2" if name in ("closest_hit",
                                                 "closest_hit_precise") \
                    else "scan_shadow_step2"
                rows[name] = check_kernel(cuda_trace, s_d.bvh, name,
                                          {label: rec[name][1]}, label,
                                          plain_stride=SCAN_PLAIN_STRIDE)
            del rec
        helpers = (integ, cuda_trace, tm_mod, eotf_mod)
        img_f, _ = timed_render(*helpers, "files_render_scan", s_d, m_d, c_d,
                                cfg, expect=FAST, forbid=PRECISE)
        img_p, _ = timed_render(*helpers, "files_render_scan_precise", s_d,
                                m_d, c_d, dataclasses.replace(cfg,
                                                              precise=True),
                                expect=PRECISE, forbid=FAST)
        rmse = display_rmse(img_p, img_f)
        emit("files_render_scan_precise", rmse_vs_fast=rmse)
        if not rmse <= GATE_RMSE:
            raise AssertionError(f"files: scan-sized dragon precise vs fast "
                                 f"display RMSE {rmse} > {GATE_RMSE}")
        del img_f, img_p, s_d

        # ---- scene 19 with its sky from the EXR ----------------------------
        real_sky = scenes._procedural_sky
        scenes._procedural_sky = lambda: image_io.load_env(
            os.path.join(d, "sky.exr"))
        try:
            s_e, m_e, c_e = scenes.load_scene(19, SKY_SIZE, SKY_SIZE,
                                              table_res=64)
        finally:
            scenes._procedural_sky = real_sky
        s_m, m_m, c_m = scene_at(19, SKY_SIZE, SKY_SIZE)
        scfg = integ.RenderConfig(width=SKY_SIZE, height=SKY_SIZE, spp=4,
                                  max_depth=16)
        t0 = time.perf_counter()
        film_e = integ.render_accum(s_e, m_e, c_e, scfg)
        film_m = integ.render_accum(s_m, m_m, c_m, scfg)
        equal = bool(torch.equal(film_e, film_m))
        emit("files", sub="scene19_sky_from_exr", width=SKY_SIZE,
             height=SKY_SIZE, spp=4, film_equal=equal,
             finite=bool(torch.isfinite(film_e).all()),
             seconds=time.perf_counter() - t0)
        if not equal:
            raise AssertionError("files: scene 19 from the EXR sky differs "
                                 "from the in-memory sky")
    finally:
        builder.build_bvh = real_numpy_build
        mesh.ASSET_DIR = asset_dir
        tmp.cleanup()
    loaded = [k for k in ("PIL", "cv2") if k in sys.modules]
    emit("files", sub="done", image_libraries_loaded=loaded,
         seconds=time.perf_counter() - t_phase)
    if loaded:
        raise AssertionError(f"files: {loaded} imported")
    return rows


def delta_e_sweep(gamut, tables, n, dev):
    """tests/test_spectrum.py's round trip: the n^3 rgb sweep through each
    table's albedo spectra, to CIELAB under D65 -> (delta E of each table
    against the targets, delta E between the first two tables' spectra)."""
    import numpy as np
    from tpu_pathtracer_torch.spectrum import cie, grid, rgb2spec

    def lab(x):
        r = x / (gamut.rgb_to_xyz @ np.ones(3))
        f = np.where(r > (6 / 29) ** 3, np.cbrt(np.maximum(r, 1e-12)),
                     r * (29 / 6) ** 2 / 3 + 4 / 29)
        return np.stack([116 * f[:, 1] - 16, 500 * (f[:, 0] - f[:, 1]),
                         200 * (f[:, 1] - f[:, 2])], -1)
    r = np.linspace(0.02, 0.98, n)
    rgb = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(
        -1, 3).astype(np.float32)
    a = np.stack([cie.cie_x(), cie.cie_y(), cie.cie_z()], -1) \
        * cie.illum_d6500()[:, None]
    lam = torch.tensor(grid.DENSE_LAMBDA, dtype=torch.float32,
                       device=dev).expand(len(rgb), -1)
    labs = [lab(rgb2spec.albedo_eval(torch.from_numpy(rgb).to(dev), lam, zn,
                                     co).double().cpu().numpy() @ a)
            for zn, co in tables]
    target = lab(rgb @ gamut.rgb_to_xyz.T)
    return ([np.linalg.norm(x - target, axis=-1) for x in labs],
            np.linalg.norm(labs[0] - labs[1], axis=-1))


# the CLI's table: its scenes' working gamut is sRGB whatever ``--gamut``
# (the output gamut) says, and sRGB is committed at res 16, 32 and 64
CLI_TABLE_RES = 24


def check_fit(dev):
    """The fit phase: ``fit_table(srgb, 64)`` on the card against the
    committed table; the CLI with ``--gamut rec2020`` and a table that is
    not committed (sRGB at res 24), fitted and cached."""
    import numpy as np
    from tpu_pathtracer_torch.color.gamut import by_name
    from tpu_pathtracer_torch.spectrum import rgb2spec

    srgb = by_name("srgb")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    zn, co = rgb2spec.fit_table(srgb, 64, device=dev)
    fit_s = time.perf_counter() - t0
    with np.load(os.path.join(rgb2spec.TABLE_DIR, "srgb_64_v2.npz")) as ref:
        committed = ref["z_nodes"], ref["coeffs"]
    (rt_fit, rt_committed), between = delta_e_sweep(
        srgb, [(zn, co), committed], 7, dev)
    p99 = dict(round_trip=float(np.percentile(rt_fit, 99)),
               committed_round_trip=float(np.percentile(rt_committed, 99)),
               vs_committed=float(np.percentile(between, 99)))
    emit("fit", sub="srgb_64", seconds=fit_s, p99_delta_e=p99,
         max_delta_e_vs_committed=float(between.max()),
         max_abs_coeff_diff=float(np.abs(co - committed[1]).max()),
         z_nodes_equal=bool(np.array_equal(zn, committed[0])))
    if not (p99["round_trip"] < 1.0 and p99["vs_committed"] <= 0.1):
        raise AssertionError(f"fit: srgb at res 64 misses its gates: {p99}")

    cached = os.path.join(rgb2spec.CACHE_DIR,
                          rgb2spec.table_file("srgb", CLI_TABLE_RES))
    if os.path.exists(cached):
        os.remove(cached)          # so that the CLI fits it
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "rec2020.png")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "tpu_pathtracer_torch.cli", "--scene",
             "17", "--gamut", "rec2020", "--table-res", str(CLI_TABLE_RES),
             "--width", "128", "--height", "96", "--spp", "4", "-o", png],
            cwd=REPO, capture_output=True, text=True, timeout=600)
        size = os.path.getsize(png) if os.path.exists(png) else 0
    emit("fit", sub="cli", gamut="rec2020", table_res=CLI_TABLE_RES,
         rc=proc.returncode, png_bytes=size,
         table_cached=os.path.exists(cached),
         stdout=proc.stdout.strip().splitlines(),
         seconds=time.perf_counter() - t0)
    if proc.returncode != 0 or size == 0 or not os.path.exists(cached):
        raise AssertionError(f"fit: the CLI failed: {proc.stderr[-2000:]}")


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

    t_start = time.perf_counter()
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

    # ---- sampler: the Z-Sobol draw kernel against its plain version ----------
    sampler_row = check_sampler(integ, dev)

    # ---- kernels ------------------------------------------------------------
    W = H = 1024
    built = {}

    def scene_at(n, w, h, device=dev):
        """Scene n (table_res 64) on ``device`` with a w x h camera; each
        scene is built once, its build does not depend on the film."""
        if n not in built:
            built[n] = load_scene(n, w, h, table_res=64, device=dev)
        s_n, m_n, c_n = built[n]
        return s_n.to(device), m_n, dataclasses.replace(c_n, width=w,
                                                       height=h)

    # ---- bsdf: the material kernels against the torch ops ------------------
    bsdf_rows = check_bsdf(integ, scene_at, dev)

    scene, meta, cam = scene_at(17, W, H)
    cfg = integ.RenderConfig(width=W, height=H, spp=4, max_depth=16)
    cfg_precise = dataclasses.replace(cfg, precise=True)
    rec_fast = launches_on(
        record_tile_rays(cuda_trace, integ, scene, meta, cam, cfg), scene.bvh)
    rec_precise = launches_on(
        record_tile_rays(cuda_trace, integ, scene, meta, cam, cfg_precise),
        scene.bvh)
    for names, rec, other in ((FAST, rec_fast, PRECISE),
                              (PRECISE, rec_precise, FAST)):
        n_steps = len(rec[names[0]])
        if (n_steps < max(STEPS)
                or any(len(rec[k]) != n_steps for k in names)
                or any(rec[k] for k in other)):
            raise AssertionError("a wavefront step did not launch exactly "
                                 f"its own kernels: "
                                 f"{ {k: len(v) for k, v in rec.items()} }")
    kernel_rows = {}
    for name, (_, _, closest, *_rest) in KERNELS.items():
        rec = rec_precise if name in PRECISE else rec_fast
        prefix = "step" if closest else "shadow_step"
        sets = {"camera": rec[name][0]} if closest else {}
        sets.update((f"{prefix}{k}", rec[name][k - 1])
                    for k in (STEPS if closest else SHADOW_STEPS))
        sets[f"{prefix}2_first_{SMALL_LAUNCH}"] = \
            rec[name][1][:, :SMALL_LAUNCH].contiguous()
        kernel_rows[name] = check_kernel(cuda_trace, scene.bvh, name, sets,
                                         f"{prefix}2")
    del rec_fast, rec_precise

    # ---- kernels on the traffic of glass and of an environment light ----------
    for n, picks in ((8, (("step2", 1, True),)),
                     (19, (("camera", 0, True), ("env_shadow_step2", 1, False)))):
        s_n, m_n, c_n = scene_at(n, 512, 512)
        ncfg = integ.RenderConfig(width=512, height=512, spp=4, max_depth=16)
        for names, c in ((FAST, ncfg),
                         (PRECISE, dataclasses.replace(ncfg, precise=True))):
            rec = launches_on(
                record_tile_rays(cuda_trace, integ, s_n, m_n, c_n, c),
                s_n.bvh)
            for set_name, step, closest in picks:
                name = names[0] if closest else names[1]
                rays = rec[name][step]
                live = rays[6] >= 0.0
                if not closest and not bool((rays[6][live] > 1e38).all()):
                    raise AssertionError("scene 19's shadow rays should all "
                                         "have t_max = 3e38")
                label = f"scene{n}_{set_name}"
                check_kernel(cuda_trace, s_n.bvh, name, {label: rays}, label)
        del rec, s_n

    # ---- kernels on instanced traffic: the group launches of step 2 --------
    # object-space rays (directions of length 1/0.75), the bound of the main
    # soup's closest hit, the lanes outside an instance's box dead
    for n, names in ((7, FAST), (12, PRECISE)):
        s_n, m_n, c_n = scene_at(n, 512, 512)
        g = s_n.instanced[0]
        c = integ.RenderConfig(width=512, height=512, spp=4, max_depth=16,
                               precise=names == PRECISE)
        rec = launches_on(
            record_tile_rays(cuda_trace, integ, s_n, m_n, c_n, c), g.bvh)
        for name in names:
            rays = rec[name][1]
            n_inst = g.inv.shape[0]
            if rays.shape[1] != n_inst * 512 * 512:
                raise AssertionError(f"scene {n}: a group launch of {name} "
                                     f"has {rays.shape[1]} lanes")
            label = f"scene{n}_instances_step2"
            check_kernel(cuda_trace, g.bvh, name, {label: rays}, label)
        del rec
    emit("kernels", precise_over_fast=dict(
        closest=kernel_rows["closest_hit_precise"]["ms"]
        / kernel_rows["closest_hit"]["ms"],
        any=kernel_rows["any_hit_precise"]["ms"]
        / kernel_rows["any_hit"]["ms"]))

    # ---- graph: the captured step against the eager step loop ----------------
    check_graph(integ, cuda_trace, scene, meta, cam, cfg)

    # ---- films: the AOVs, the ray count and the sharded film ----------------
    check_films(integ, cuda_trace, scene, meta, cam, cfg)

    # ---- render: the fast and the precise main paths --------------------------
    helpers = (integ, cuda_trace, tm_mod, eotf_mod)
    img_fast, launches = timed_render(*helpers, "render", scene, meta, cam,
                                      cfg, expect=FAST, forbid=PRECISE,
                                      kept=True)
    img_precise, launches_p = timed_render(
        *helpers, "render_precise", scene, meta, cam, cfg_precise,
        expect=PRECISE, forbid=FAST, kept=True)
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
        s_l, m_l, c_l = scene_at(n, size, size)
        lcfg = integ.RenderConfig(width=size, height=size, spp=4,
                                  max_depth=16, strategy=strategy,
                                  sampler="random", precise=True)
        timed_render(*helpers, f"ladder_scene{n}", s_l, m_l, c_l, lcfg,
                     expect=expect, forbid=forbid)

    # ---- ladder: bench.py's other rungs and the new lights, fast --------------
    for n, size, strategy, sampler in ((3, 256, "pt", "random"),
                                       (8, 512, "mis", "sobol"),
                                       (10, 1024, "mis", "sobol"),
                                       (19, 512, "mis", "sobol"),
                                       (1, 512, "nee", "sobol")):
        s_l, m_l, c_l = scene_at(n, size, size)
        lcfg = integ.RenderConfig(width=size, height=size, spp=4,
                                  max_depth=16, strategy=strategy,
                                  sampler=sampler)
        expect, forbid = ((FAST[:1], PRECISE + FAST[1:]) if strategy == "pt"
                          else (FAST, PRECISE))
        img, _ = timed_render(*helpers, f"ladder_scene{n}", s_l, m_l, c_l,
                              lcfg, expect=expect, forbid=forbid)
        if n == 8:
            img_p, _ = timed_render(
                *helpers, "ladder_scene8_precise", s_l, m_l, c_l,
                dataclasses.replace(lcfg, precise=True), expect=PRECISE,
                forbid=FAST)
            rmse = display_rmse(img_p, img)
            emit("ladder_scene8_precise", rmse_vs_fast=rmse)
            if not rmse <= GATE_RMSE:
                raise AssertionError(f"scene 8 precise vs fast display RMSE "
                                     f"{rmse} > {GATE_RMSE}")
        del s_l, img

    # ---- ladder: the instanced scenes, MIS + Sobol 512^2 --------------------
    for n, modes in ((7, (False,)), (12, (False, True))):
        s_l, m_l, c_l = scene_at(n, 512, 512)
        imgs = {}
        for precise in modes:
            lcfg = integ.RenderConfig(width=512, height=512, spp=4,
                                      max_depth=16, precise=precise)
            phase = f"ladder_scene{n}" + ("_precise" if precise else "")
            imgs[precise], _ = timed_render(
                *helpers, phase, s_l, m_l, c_l, lcfg,
                expect=PRECISE if precise else FAST,
                forbid=FAST if precise else PRECISE)
        if len(imgs) == 2:
            rmse = display_rmse(imgs[True], imgs[False])
            emit(f"ladder_scene{n}_precise", rmse_vs_fast=rmse)
            if not rmse <= GATE_RMSE:
                raise AssertionError(f"scene {n} precise vs fast display "
                                     f"RMSE {rmse} > {GATE_RMSE}")
        del imgs

    # ---- progressive render and the CLI on scene 7 --------------------------
    check_progressive_and_cli(integ, *scene_at(7, 256, 256))

    # ---- parity: card vs CPU plain versions, fast and precise -----------------
    pw, ph = 64, 48
    for n, modes in ((17, (False, True)), (8, (False,)), (19, (False,)),
                     (7, (False, True))):
        s_cpu, m_cpu, c_cpu = scene_at(n, pw, ph, device="cpu")
        for precise in modes:
            pcfg = integ.RenderConfig(width=pw, height=ph, spp=2,
                                      max_depth=6, precise=precise)
            t0 = time.perf_counter()
            img_gpu = integ.render(s_cpu, m_cpu, c_cpu, pcfg,
                                   device=dev).cpu()
            img_cpu = integ.render(s_cpu, m_cpu, c_cpu, pcfg, device="cpu")
            rmse = display_rmse(img_gpu, img_cpu)
            emit("parity", scene=n, width=pw, height=ph, spp=2, max_depth=6,
                 precise=precise, rmse=rmse,
                 seconds=time.perf_counter() - t0)
            if not rmse <= GATE_RMSE:
                raise AssertionError(f"scene {n}: card vs CPU display RMSE "
                                     f"{rmse} > {GATE_RMSE} "
                                     f"(precise={precise})")

    # ---- consistency: the reference's independent checks ------------------
    check_consistency(dev)

    # ---- train: the differentiable pass ---------------------------------------
    _, gather_row = check_train(integ, cuda_trace, scene_at, dev)

    # ---- files: OBJ, EXR and PNG inputs; the scan-sized dragon --------------
    check_files(integ, cuda_trace, tm_mod, eotf_mod, scene_at, cfg)

    # ---- fit: the rgb2spec fitter on the card ----------------------------------
    check_fit(dev)

    emit("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=SOURCE,
             replaces=KERNELS[name][5], launches=launches[name],
             max_abs_err=row["max_abs_err"], ms=row["ms"],
             plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
             bound_by=row["bound_by"], library_ms=None)
        for name, row in kernel_rows.items()]
        + [gather_row, sampler_row, *bsdf_rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
