"""Command-line renderer (counterpart of ``tpu_pathtracer/cli.py``).

    python -m tpu_pathtracer_torch.cli --scene 0 --renderer mis \
        --sampler sobol --width 800 --height 600 --spp 64 -o output.png

The flags and prints of the JAX package's CLI, plus ``--device``: the
render runs on ``cuda`` unless ``--device cpu`` asks for the plain
PyTorch versions of the kernels on the CPU.  The PNG is written without
an image library (8-bit RGB, quantized as the JAX package's CLI does).
"""
from __future__ import annotations

import argparse
import struct
import sys
import time
import zlib

import numpy as np


def write_png(path: str, rgb8: np.ndarray) -> None:
    """(H, W, 3) uint8 -> an 8-bit RGB PNG, rows unfiltered."""
    h, w, _ = rgb8.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          np.ascontiguousarray(rgb8).reshape(h, 3 * w)], 1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + chunk(b"IEND", b""))


def quantize(img: np.ndarray) -> np.ndarray:
    """Display-encoded floats -> uint8, rounded to nearest."""
    return np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="tpu_pathtracer_torch")
    ap.add_argument("--scene", type=int, default=0, help="scene number (0-19)")
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--filter", default="box", choices=["box"])
    ap.add_argument("--sampler", default="sobol", choices=["random", "sobol"])
    ap.add_argument("--renderer", default="mis",
                    choices=["albedo", "normal", "pt", "nee", "mis"])
    ap.add_argument("--width", type=int, default=800)
    ap.add_argument("--height", type=int, default=600)
    ap.add_argument("--max-depth", type=int, default=16)
    ap.add_argument("--table-res", type=int, default=64,
                    help="rgb2spec table resolution (32 for fast CPU runs)")
    ap.add_argument("--gamut", default="srgb",
                    help="output color space (srgb, display_p3, adobe_rgb, "
                         "rec709, rec2020, aces_cg, aces_2065_1)")
    ap.add_argument("--eotf", default="srgb",
                    help="output transfer function")
    ap.add_argument("--precise", action="store_true",
                    help="watertight traversal (the precise kernels); the "
                         "default is the fast unit-triangle test")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("-o", "--output", default="output.png")
    args = ap.parse_args(argv)

    from .render.integrator import RenderConfig, render
    from .scenes import load_scene

    t0 = time.time()
    scene, meta, cam = load_scene(args.scene, args.width, args.height,
                                  table_res=args.table_res,
                                  device=args.device)
    print(f"Scene build: {time.time() - t0:.2f}s "
          f"({meta.n_tris} triangles, {meta.n_lights} lights)")

    cfg = RenderConfig(width=args.width, height=args.height, spp=args.spp,
                       max_depth=args.max_depth, strategy=args.renderer,
                       sampler=args.sampler, seed=args.seed,
                       gamut=args.gamut, eotf=args.eotf,
                       precise=True if args.precise else None)
    t0 = time.time()
    img = render(scene, meta, cam, cfg, device=args.device).cpu().numpy()
    dt = time.time() - t0
    rays = args.width * args.height * args.spp
    print(f"Render: {dt:.2f}s ({rays / dt / 1e6:.2f} Mpaths/s)")

    write_png(args.output, quantize(img))
    print(f"Saved {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
