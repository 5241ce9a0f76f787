"""The controls of the check: what the compared numbers read when a
candidate other than the sound program stands in the program's place, at
a cell's own size, on the card.

    python3 -m benchmark.control --workload <cell> --seeds <n> [<n> ...]

prints one JSON line a seed with the readings of each candidate against
the float32 reference (with ``--program-seeds``, a fit cell's readings of
the program itself on those seeds, all in one process and one set-up):

* ``bfloat16``: the reference itself with the scene, the carried state (a
  render) or the parameters, gradients and loss (a fit) rounded to
  bfloat16, the nearest precision below the float32 the configurations
  state;
* ``half_batch`` (fit cells): the reference's loss and gradients over the
  first half of the pixel rows, the mean taken over them.

The benchmark's runs do not run it; the limits in ``limits/`` were set
between the program's readings and these.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import torch

from . import compare, harness


def _render_readings(ctx, seed):
    from .drivers.progressive import _config, check_pixels
    from .reference import render as ref_render
    from .reference.tpt.render import integrator as ref_integ
    conf, tr = ctx.conf, ctx.traffic
    if getattr(ctx, "reference_scene", None) is None:
        ctx.reference_scene = ctx.config_module.build(
            "benchmark.reference.tpt", conf, ctx.inputs, conf["width"],
            conf["height"], ctx.device)
    scene, meta, cam = ctx.reference_scene
    cfg = _config(ref_integ, conf, tr, seed)
    pix = torch.as_tensor(check_pixels(conf, tr, seed), device=ctx.device)
    chunk = tr["chunk_spp"]
    ref = ref_render.pass_films(scene, meta, cam, cfg, pix,
                                chunk).cpu().numpy()
    low = ref_render.pass_films(scene, meta, cam, cfg, pix, chunk,
                                precision="bfloat16").cpu().numpy()
    films = [((k + 1) * chunk, low[k]) for k in range(low.shape[0])]
    return {"bfloat16": {"film_mismatch_share":
                         compare.film_mismatch(films, ref, chunk)[0]}}


def _fit_readings(ctx, seed, program=False, controls=True):
    from .drivers.fit import _config, program_steps
    from .reference import fit as ref_fit
    from .reference.tpt.render import integrator as ref_integ
    tr = ctx.traffic
    cfg = _config(ref_integ, ctx.conf, tr, seed)
    if getattr(ctx, "reference_scene", None) is None:
        ctx.reference_scene = ctx.config_module.build(
            "benchmark.reference.tpt", ctx.conf, ctx.inputs, cfg.width,
            cfg.height, ctx.device)
    scene, meta, cam = ctx.reference_scene
    n = tr["checked_steps"]
    ref = ref_fit.follow(scene, meta, cam, cfg, seed, tr["lr"], n)
    readings = {}
    if program:
        readings["program"] = compare.fit_gaps(program_steps(ctx, seed, n),
                                               ref)
    if controls:
        low = ref_fit.follow(scene, meta, cam, cfg, seed, tr["lr"], n,
                             lower=torch.bfloat16)
        half = ref_fit.follow(scene, meta, cam, cfg, seed, tr["lr"], n,
                              n_pixels=cfg.width * cfg.height // 2)
        readings["bfloat16"] = compare.fit_gaps(low, ref)
        readings["half_batch"] = compare.fit_gaps(half, ref)
    return readings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--program-seeds", type=int, nargs="*", default=[],
                    help="fit cells: seeds on which to read the program's "
                    "own gaps too, in this process (with no control "
                    "unless also in --seeds)")
    args = ap.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    dev = torch.device(args.device)
    with tempfile.TemporaryDirectory(prefix="bench_inputs_") as workdir:
        ctx = harness.Context(bench, args.workload, 0, 0.0, False, dev, 0.0,
                              workdir, limits={})
        fit = ctx.traffic["kind"] == "fit"
        seeds = list(dict.fromkeys(args.seeds + args.program_seeds))
        for seed in seeds:
            if fit:
                readings = _fit_readings(
                    ctx, seed, program=seed in args.program_seeds,
                    controls=seed in args.seeds)
            else:
                readings = _render_readings(ctx, seed)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "readings": readings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
