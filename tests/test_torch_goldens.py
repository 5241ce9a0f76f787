"""The port against all 42 committed golden images, of scenes 0, 3, 6, 7,
8, 9 and 10 (Lambert, textured and normal-mapped, gold, four instanced
gold bunnies, SF11 glass, plastic, thin plastic): all six {pt, nee, mis}
x {random, sobol} combinations each, rendered with
``precise=True`` at the goldens' settings (200x150, 64 spp, depth 8,
table_res 32, seed 0), display RMSE gate 0.01 as tests/test_goldens.py.

Marked ``slow``.  The render runs on the GPU where there is one (about a
minute per image on an H100:
``python -m pytest --noconftest -m slow tests/test_torch_goldens.py``);
on the CPU the brute-force plain versions take hours per image.  The PNGs
are decoded here (8-bit RGB, not interlaced), so the test needs no image
library.
"""
import os
import struct
import zlib

import numpy as np
import pytest
import torch

from tpu_pathtracer_torch.render.integrator import RenderConfig, render
from tpu_pathtracer_torch.scenes import load_scene

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "..", "tpu_pathtracer",
                          "data", "goldens")
W, H, SPP = 200, 150, 64


def read_png_rgb8(path) -> np.ndarray:
    """(H, W, 3) uint8 of an 8-bit RGB, non-interlaced PNG."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, head = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    w, h, depth, ctype, _, _, interlace = head
    assert (depth, ctype, interlace) == (8, 2, 0), head
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = raw.reshape(h, 1 + 3 * w)
    out = np.zeros((h, 3 * w), np.int32)
    prev = np.zeros(3 * w, np.int32)
    for y in range(h):
        ft, line = int(rows[y, 0]), rows[y, 1:].astype(np.int32)
        if ft in (0, 2):                       # none / up
            cur = (line + (prev if ft == 2 else 0)) & 255
        else:                                  # sub / average / paeth
            cur = np.zeros(3 * w, np.int32)
            for x in range(3 * w):
                a = cur[x - 3] if x >= 3 else 0
                b = prev[x]
                c = prev[x - 3] if x >= 3 else 0
                if ft == 1:
                    pred = a
                elif ft == 3:
                    pred = (a + b) // 2
                else:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[x] = (line[x] + pred) & 255
        out[y] = cur
        prev = cur
    return out.reshape(h, w, 3).astype(np.uint8)


def test_png_reader_on_a_golden():
    """The reader against an image library where one is installed, and
    against the header otherwise."""
    path = os.path.join(GOLDEN_DIR, "scene0_mis_sobol.png")
    img = read_png_rgb8(path)
    assert img.shape == (H, W, 3) and img.std() > 10
    try:
        from PIL import Image
    except ImportError:
        return
    assert np.array_equal(img, np.asarray(Image.open(path)))


@pytest.mark.slow
@pytest.mark.parametrize("sampler", ["random", "sobol"])
@pytest.mark.parametrize("strat", ["pt", "nee", "mis"])
@pytest.mark.parametrize("sid", [0, 3, 6, 7, 8, 9, 10],
                         ids=lambda sid: f"scene{sid}")
def test_torch_golden_matrix(sid, strat, sampler):
    path = os.path.join(GOLDEN_DIR, f"scene{sid}_{strat}_{sampler}.png")
    golden = read_png_rgb8(path).astype(np.float32) / 255.0
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    scene, meta, cam = load_scene(sid, W, H, table_res=32, device=dev)
    cfg = RenderConfig(width=W, height=H, spp=SPP, max_depth=8,
                       strategy=strat, sampler=sampler, seed=0, precise=True)
    img = render(scene, meta, cam, cfg, device=dev).cpu().numpy()
    rmse = float(np.sqrt(np.mean((np.clip(img, 0.0, 1.0) - golden) ** 2)))
    print(f"golden scene{sid}_{strat}_{sampler}: display RMSE {rmse:.6f} "
          f"on {dev}")
    assert rmse < 0.01, rmse
