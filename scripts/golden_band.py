"""Render a band of rows of a golden image's frame, through either package.

The goldens (``tpu_pathtracer/data/goldens/scene{N}_{strategy}_{sampler}
.png``) are 200x150 frames at 64 spp, depth 8, ``table_res`` 32, seed 0.
Every draw is a pure function of (pixel, sample, dim), so a band of rows,
handed to the wavefront as its own set of pixels, reproduces those pixels
of the full frame at a fraction of its cost.  The script imports only the
package it renders with: ``--package torch`` never imports JAX, so it runs
on a machine without it.

    # the port on the CPU (plain versions) or on the card (kernels)
    python scripts/golden_band.py render --package torch --device cpu \\
        --golden scene3_pt_random --rows 80:96 --precise -o port_cpu.npz
    # the JAX package on the CPU
    JAX_PLATFORMS=cpu python scripts/golden_band.py render --package jax \\
        --golden scene3_pt_random --rows 80:96 -o jax_cpu.npz
    # display RMSE and largest difference of every pair, and each against
    # the golden's rows
    python scripts/golden_band.py compare jax_cpu.npz port_cpu.npz ...
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(REPO, "tpu_pathtracer", "data", "goldens")
W, H, SPP, DEPTH, TABLE_RES = 200, 150, 64, 8, 32


def _parse_golden(name: str):
    scene, strategy, sampler = name.split("_")
    return int(scene[len("scene"):]), strategy, sampler


def _band_pixels(r0: int, r1: int) -> np.ndarray:
    xs, ys = np.meshgrid(np.arange(W), np.arange(r0, r1))
    return np.stack([xs.reshape(-1), ys.reshape(-1)], -1).astype(np.int32)


def render_torch(sid, strategy, sampler, px, precise, device):
    import torch

    from tpu_pathtracer_torch.render import film
    from tpu_pathtracer_torch.render import integrator as integ
    from tpu_pathtracer_torch.render.sampler import make_sampler
    from tpu_pathtracer_torch.scenes import load_scene

    dev = torch.device(device)
    scene, meta, cam = load_scene(sid, W, H, table_res=TABLE_RES, device=dev)
    cfg = integ.RenderConfig(width=W, height=H, spp=SPP, max_depth=DEPTH,
                             strategy=strategy, sampler=sampler, seed=0,
                             precise=precise)
    sampler_ = make_sampler(sampler, 0, SPP, (W, H))
    table = integ._spectral_table(scene)
    px_t = torch.from_numpy(px).to(dev)
    state = integ._wavefront_init(len(px), 0,
                                  torch.zeros((len(px), 3), device=dev))
    while True:
        for _ in range(integ.SYNC_EVERY):
            state = integ._wavefront_step(scene, meta, cam, cfg, sampler_,
                                          px_t, SPP, state, table)
        done = ~state["tracing"] & (state["sample"] + 1 >= SPP)
        if bool(done.all()):
            break
    a = state["accum"]
    accum = torch.stack([a.x, a.y, a.z], -1)
    img = film.finalize(accum, SPP, tone_map=cfg.tone_map, eotf=cfg.eotf)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")
    return accum.cpu().numpy(), img.cpu().numpy(), name


def render_jax(sid, strategy, sampler, px):
    import jax.numpy as jnp

    from tpu_pathtracer.render import film
    from tpu_pathtracer.render import integrator as integ
    from tpu_pathtracer.scenes import load_scene

    scene, meta, cam = load_scene(sid, W, H, table_res=TABLE_RES)
    cfg = integ.RenderConfig(width=W, height=H, spp=SPP, max_depth=DEPTH,
                             strategy=strategy, sampler=sampler, seed=0)
    state = integ._wavefront_init(len(px), 0, jnp.zeros((len(px), 3)))
    while True:
        state, all_done = integ._wavefront_chunk(
            scene, meta, cam, cfg, integ.WAVEFRONT_ITERS,
            jnp.asarray(SPP, jnp.int32), jnp.asarray(px), state,
            jnp.asarray(DEPTH, jnp.int32))
        if bool(np.asarray(all_done)):
            break
    a = state["accum"]
    accum = jnp.stack([a.x, a.y, a.z], -1)
    img = film.finalize(accum, SPP, tone_map=cfg.tone_map, eotf=cfg.eotf)
    return np.asarray(accum), np.asarray(img), "cpu"


def cmd_render(args) -> int:
    sid, strategy, sampler = _parse_golden(args.golden)
    r0, r1 = (int(v) for v in args.rows.split(":"))
    px = _band_pixels(r0, r1)
    t0 = time.perf_counter()
    if args.package == "torch":
        accum, img, dev = render_torch(sid, strategy, sampler, px,
                                       args.precise, args.device)
    else:
        accum, img, dev = render_jax(sid, strategy, sampler, px)
    seconds = time.perf_counter() - t0
    np.savez(args.output, accum=accum, img=img.reshape(r1 - r0, W, 3),
             golden=args.golden, rows=np.asarray([r0, r1]),
             package=args.package, device=dev, precise=bool(args.precise))
    print(json.dumps(dict(golden=args.golden, rows=[r0, r1],
                          package=args.package, device=dev,
                          precise=bool(args.precise), seconds=seconds,
                          mean=float(img.mean()), out=args.output)))
    return 0


def _label(z) -> str:
    prec = "precise" if bool(z["precise"]) else "fast"
    pkg = str(z["package"])
    return f"{pkg}:{z['device']}" + (f":{prec}" if pkg == "torch" else "")


def cmd_compare(args) -> int:
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_torch_goldens import read_png_rgb8

    bands = [np.load(p) for p in args.files]
    golden = str(bands[0]["golden"])
    r0, r1 = (int(v) for v in bands[0]["rows"])
    if any(str(z["golden"]) != golden or list(z["rows"]) != [r0, r1]
           for z in bands):
        raise SystemExit("the bands are of different goldens or rows")
    ref = read_png_rgb8(os.path.join(GOLDEN_DIR, golden + ".png"))
    ref = ref[r0:r1].astype(np.float32) / 255.0
    rows = []
    for i, a in enumerate(bands):
        img = np.clip(a["img"], 0.0, 1.0)
        d = img - ref
        rows.append(dict(a=_label(a), b="golden png",
                         display_rmse=float(np.sqrt((d ** 2).mean())),
                         max_abs=float(np.abs(d).max())))
        for b in bands[i + 1:]:
            d = a["img"] - b["img"]
            rows.append(dict(a=_label(a), b=_label(b),
                             display_rmse=float(np.sqrt((d ** 2).mean())),
                             max_abs=float(np.abs(d).max()),
                             pixels_over_1e3=int(
                                 (np.abs(d).max(-1) > 1e-3).sum())))
    print(json.dumps(dict(golden=golden, rows=[r0, r1], pairs=rows)))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("render")
    r.add_argument("--package", choices=("torch", "jax"), required=True)
    r.add_argument("--device", default="cuda",
                   help="the port's device: cuda or cpu")
    r.add_argument("--golden", required=True,
                   help="e.g. scene3_pt_random")
    r.add_argument("--rows", default="80:96", help="first:end row")
    r.add_argument("--precise", action="store_true",
                   help="the port's watertight hit test (the JAX package "
                        "on the CPU always uses it)")
    r.add_argument("-o", "--output", required=True)
    c = sub.add_parser("compare")
    c.add_argument("files", nargs="+")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    return cmd_render(args) if args.cmd == "render" else cmd_compare(args)


if __name__ == "__main__":
    sys.exit(main())
