"""The design stages of the any-hit kernels K2 and K2p, timed in turns on
the GPU (run from the repository root: python3 any_hit_stages.py).  A
record of how the shipped design was chosen: the package does not import
it.

Each stage is rebuilt here as a text patch of the shipped
``csrc/trace_kernels.cu`` (every patched string must occur exactly once, so
a patch that no longer applies fails loudly), compiled with ``nvcc`` into
its own library under ``build/tpu_pathtracer_torch/stages/`` (all builds
started together) and called through ``ctypes``.  The shipped source keeps
no switch for the stages that lost.  K2 ships the binary walk, so every
stage also gets a launcher of the team walk's fast any-hit form
(``team_kernel<false, true>``), which the shipped source does not launch.

  binary        K2 (any_hit), the binary walk; for K2p's rays no
                binary walk is built (its precise form was removed after
                the team walk beat it: PERF.md section 6)
  team          the team walk with the closest-hit agreement as it is
                (nearest hit by reduce_min and shuffles; the lanes on a ray
                stop at their own next leaf once one of them has a hit),
                children sorted, entries with their distance
  ballot        one ballot masked by the ray's group, which ends the ray
                for all its lanes in the same turn; children sorted,
                entries with their distance
  leaf_first    ballot, and a hit leaf child entered before a nearer
                internal one
  refill N / steal N   ballot with TEAM_REFILL_MIN or TEAM_STEAL_MIN at N
                (shipped: 8 and 12; 33: no stealing)
  nearest only  ballot, the nearest hit child found by three exchanges,
                the others pushed unsorted
  slot order    ballot without the sorting network: the first hit child
                next, the others pushed in slot order
  bare stack    stack entries without their entry distance and no cull at
                a pop (an any-hit bound never shrinks, so it culls nothing)
  slot order, bare stack   shipped (K2p)
  full grid     one block a 128 rays in place of the resident grid (a warp
                takes 32 rays and no refill)
  N blocks      __launch_bounds__(128, N): at most 65536 / 128 N registers
  solo          one thread a ray on the wide rows (the one load stream and
                the early out, no team), one block a 128 rays
  two steps     two steps of the walk a turn of the team loop

The rays are those chip_smoke.py records: the NEE shadow rays of steps 2,
6, 12, 24 and 32 of the first 1024x1024 tile of scene 17 (MIS + Z-Sobol,
depth 16, table_res 64; the precise kernel on a precise render's rays),
the first 65,536 and the first 8,192 lanes of step 2, and step 1.  Every
stage's occlusion is held against the plain version on every set (exact).
Then each set is timed with chip_smoke's ``device_ms`` (20 launches behind
a spin kernel), the stages in one order and then in the reverse order; a
stage's ms is the mean of its two readings.  Prints one JSON line per
kernel and set (each stage's ms), the card's nvidia-smi line and, last,
one JSON object with every stage's readings, counters (the longest chain)
and registers.
"""
from __future__ import annotations

import ctypes
import dataclasses
import json
import os
import statistics
import subprocess
import sys

import torch

import chip_smoke as cs
from tpu_pathtracer_torch.ops import cuda_trace

_SLOT = "    if constexpr (ANY) {\n        int first = WIDE_DONE;"
_SORTED_FOR_ANY = (_SLOT, _SLOT.replace("(ANY)", "(false)"))
_FULL_ENTRIES = (
    ("    stack[L.sp++] = ANY ? (unsigned)ref",
     "    stack[L.sp++] = false ? (unsigned)ref"),
    ("    return ANY || __uint_as_float", "    return false || __uint_as_float"))
_BALLOT = "        if constexpr (ANY) {\n            // the lanes on one ray need only know"
_SORTED = """\
    WIDE_ORDER(0, 1) WIDE_ORDER(2, 3) WIDE_ORDER(0, 2) WIDE_ORDER(1, 3)
    WIDE_ORDER(1, 2)
"""
_LEAF_FIRST = _SORTED + """\
#pragma unroll
    for (int k = 3; k >= 1; --k) {  // a hit leaf before a nearer node
        bool s = t[k] < CUDART_INF_F && ref[k] < 0 && ref[k - 1] >= 0;
        float tk = t[k], tj = t[k - 1];
        int rk = ref[k], rj = ref[k - 1];
        t[k] = s ? tj : tk, ref[k] = s ? rj : rk;
        t[k - 1] = s ? tk : tj, ref[k - 1] = s ? rk : rj;
    }
"""
_NEAREST = "    WIDE_ORDER(0, 1) WIDE_ORDER(0, 2) WIDE_ORDER(0, 3)\n"
_BODY = """\
            bool* __restrict__ hit_out, u64* __restrict__ counters) {
    const unsigned all = 0xffffffffu;
"""
_SOLO = """\
            bool* __restrict__ hit_out, u64* __restrict__ counters) {
    if constexpr (ANY) {  // one thread a ray, no team
        for (int i = blockIdx.x * BLOCK_THREADS + threadIdx.x; i < n;
             i += gridDim.x * BLOCK_THREADS) {
            u64 stack[WIDE_MAX_STACK];
            Lane L;
            start_ray<PRECISE>(L, rays, n, i);
            while (L.cur != WIDE_DONE)
                step<PRECISE, ANY>(L, nodes_w, tris, n_tri, stack);
            store<ANY>(L, L.best_tri >= 0, t_out, tri_out, b1_out, b2_out,
                       hit_out, counters);
        }
        return;
    }
    const unsigned all = 0xffffffffu;
"""
_GRID = "    *grid = team ? min(blocks_for(n), sms * *blocks_per_sm) : blocks_for(n);"
_FULL_GRID = (_GRID, "    *grid = blocks_for(n);")
_BOUNDS = "__global__ void __launch_bounds__(BLOCK_THREADS)\nteam_kernel("
_STEP = """\
        if (L.i >= 0 && L.cur != WIDE_DONE)
            step<PRECISE, ANY>(L, nodes_w, tris, n_tri, stack);
"""
_TWO_STEPS = (_STEP, _STEP + _STEP)
_REFILL = "#define TEAM_REFILL_MIN 8 "
_STEAL = "#define TEAM_STEAL_MIN 12 "
# K2's team form, which the shipped source does not launch
_END = 'extern "C" int trace_kernels_max_stack()'
_FAST_TEAM = (_END, """\
extern "C" int launch_any_hit_team(int n, const void* rays,
                                   const void* nodes_w, const void* tri_m12,
                                   int n_tri, void* occ_out, void* counters,
                                   void* stream) {
    return launch_team<false, true>(n, rays, nodes_w, tri_m12, n_tri, nullptr,
                                    nullptr, nullptr, nullptr, occ_out,
                                    counters, stream);
}

extern "C" int any_hit_team_info(int n, int* out) {
    return occupancy(team_kernel<false, true>, true, n, out);
}

""" + _END)


def _bounds(blocks):
    return (_BOUNDS, _BOUNDS.replace("THREADS)", f"THREADS, {blocks})"))


def _define(old, value):
    return (old, old.split()[0] + " " + old.split()[1] + f" {value} ")


_BALLOT_STAGE = (_SORTED_FOR_ANY, *_FULL_ENTRIES)
# stage -> patches of the shipped source ((old, new), each old once)
STAGES = {
    "team": (*_BALLOT_STAGE, (_BALLOT, _BALLOT.replace("(ANY)", "(false)"))),
    "ballot": _BALLOT_STAGE,
    "leaf_first": (*_BALLOT_STAGE, (_SORTED, _LEAF_FIRST)),
    "refill 4": (*_BALLOT_STAGE, _define(_REFILL, 4)),
    "refill 16": (*_BALLOT_STAGE, _define(_REFILL, 16)),
    "steal 8": (*_BALLOT_STAGE, _define(_STEAL, 8)),
    "steal 20": (*_BALLOT_STAGE, _define(_STEAL, 20)),
    "no steal": (*_BALLOT_STAGE, _define(_STEAL, 33)),
    "nearest only": (*_BALLOT_STAGE, (_SORTED, _NEAREST)),
    "full grid": (*_BALLOT_STAGE, _FULL_GRID),
    "12 blocks": (*_BALLOT_STAGE, _bounds(12)),
    "solo": (*_BALLOT_STAGE, (_BODY, _SOLO), _FULL_GRID),
    "slot order": _FULL_ENTRIES,
    "slot order, steal 8": (*_FULL_ENTRIES, _define(_STEAL, 8)),
    "slot order, full grid": (*_FULL_ENTRIES, _FULL_GRID),
    "slot order, 10 blocks": (*_FULL_ENTRIES, _bounds(10)),
    "slot order, two steps": (*_FULL_ENTRIES, _TWO_STEPS),
    "solo, slot order": (*_FULL_ENTRIES, (_BODY, _SOLO), _FULL_GRID),
    "slot order, bare stack": (),
    "slot order, bare stack, two steps": (_TWO_STEPS,),
}
SETS = (2, 6, 12, 24, 32)
SMALL_LAUNCH = 65536


def patched_source(patches) -> str:
    with open(cuda_trace.KERNEL_SOURCE) as f:
        src = f.read()
    for old, new in (*patches, _FAST_TEAM):
        if src.count(old) != 1:
            raise RuntimeError(f"patch does not apply once: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def build_stages() -> dict:
    """Compile every stage at once; returns {stage: bound library}."""
    out_dir = os.path.join(cuda_trace.BUILD_DIR, "stages")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for k, (stage, patches) in enumerate(STAGES.items()):
        src = os.path.join(out_dir, f"stage{k}.cu")
        with open(src, "w") as f:
            f.write(patched_source(patches))
        lib = os.path.join(out_dir, f"stage{k}.so")
        procs[stage] = (lib, subprocess.Popen(
            [cuda_trace._nvcc(), *cuda_trace.NVCC_FLAGS, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for stage, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for stage {stage}:\n{log}")
        libs[stage] = cuda_trace._bind(lib)
        libs[stage].launch_any_hit_team.argtypes = \
            libs[stage].launch_any_hit_precise.argtypes
        libs[stage].any_hit_team_info.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    return libs


def team_any_hit(lib, bvh, precise, rays, counters=None):
    """A stage's team any-hit kernel on the wide rows (K2p's launcher, or
    the fast form's added one) -> (R,) occlusion."""
    tris = bvh.tri9p if precise else bvh.tri_m12
    occ = torch.empty(rays.shape[1], dtype=torch.bool, device=rays.device)
    launch = lib.launch_any_hit_precise if precise else lib.launch_any_hit_team
    rc = launch(rays.shape[1], rays.data_ptr(), bvh.nodes_w.data_ptr(),
                tris.data_ptr(), tris.shape[0], occ.data_ptr(),
                None if counters is None else counters.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"stage launch failed: cudaError {rc}")
    return occ


def team_info(lib, precise, n):
    out = (ctypes.c_int * 4)()
    rc = (lib.kernel_launch_info(cuda_trace.KERNEL_NAMES.index(
        "any_hit_precise"), n, out) if precise
        else lib.any_hit_team_info(n, out))
    if rc != 0:
        raise RuntimeError(f"launch info: cudaError {rc}")
    return dict(zip(("registers", "local_bytes", "blocks_per_sm", "grid"),
                    out))


def main() -> int:
    if not torch.cuda.is_available():
        print("any_hit_stages: no CUDA device available", file=sys.stderr)
        return 2
    from tpu_pathtracer_torch.render import integrator as integ
    from tpu_pathtracer_torch.scenes import load_scene

    smi = cs.nvidia_smi_line()
    libs = build_stages()
    dev = torch.device("cuda")
    scene, meta, cam = load_scene(17, 1024, 1024, table_res=64, device=dev)
    cfg = integ.RenderConfig(width=1024, height=1024, spp=4, max_depth=16)
    bvh = scene.bvh
    results = []
    for name, precise in (("any_hit", False), ("any_hit_precise", True)):
        rec = cs.record_tile_rays(
            cuda_trace, integ, scene, meta, cam,
            dataclasses.replace(cfg, precise=precise))[name]
        sets = {f"shadow_step{k}": rec[k - 1] for k in SETS}
        sets[f"shadow_step2_first_{SMALL_LAUNCH}"] = \
            rec[1][:, :SMALL_LAUNCH].contiguous()
        # the tail: a launch of 1/32 of the rays lasts about as long as
        # its longest ray
        sets["shadow_step2_first_8192"] = rec[1][:, :8192].contiguous()
        sets["shadow_step1"] = rec[0]
        plain = getattr(cuda_trace, name + "_plain")
        tris = bvh.tri9 if precise else bvh.tri_m12
        for set_name, rays in sets.items():
            ref = plain(tris, rays)
            row = {"kernel": name, "rays": set_name,
                   "active": int((rays[6] >= 0.0).sum()),
                   "occluded": int(ref.sum()), "stages": {}}

            def run(stage, counters=None):
                if stage == "binary":
                    return cuda_trace.any_hit(bvh, rays, counters=counters)
                return team_any_hit(libs[stage], bvh, precise, rays,
                                    counters)

            order = [*STAGES] if precise else ["binary", *STAGES]
            times = {s: [] for s in order}
            for stage in order + order[::-1]:
                times[stage].append(cs.device_ms(lambda: run(stage), 20))
            for stage in order:
                counters = torch.zeros(4, dtype=torch.int64, device=dev)
                got = run(stage, counters)
                torch.cuda.synchronize()
                if not torch.equal(got, ref):
                    raise AssertionError(f"{name} stage {stage} differs from "
                                         f"the plain version on {set_name}")
                visits, tests, max_visits, max_tests = counters.tolist()
                row["stages"][stage] = dict(
                    ms=statistics.mean(times[stage]), readings=times[stage],
                    node_visits=visits, tri_tests=tests,
                    max_node_visits_of_a_ray=max_visits,
                    max_tri_tests_of_a_ray=max_tests,
                    **(cuda_trace.launch_info("any_hit", rays.shape[1])
                       if stage == "binary" else
                       team_info(libs[stage], precise, rays.shape[1])))
            print(json.dumps({**{k: v for k, v in row.items() if k != "stages"},
                              **{s: v["ms"] for s, v in row["stages"].items()}}),
                  flush=True)
            results.append(row)
    print(smi)
    print(json.dumps({"nvidia_smi": smi, "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
