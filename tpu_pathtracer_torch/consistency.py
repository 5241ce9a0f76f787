"""The JAX package's independent checks of its integrators, on the port.

Counterparts of ``tests/test_consistency_matrix.py``: ``_check_consistency``
(pt, nee and mis estimate one integral: each pair's median-filtered linear
RMSE under a gate calibrated on the noise of a second pt seed, and the
unfiltered nee-vs-mis means within 2 % plus a share of that noise) and
``test_pt_mean_anchors`` (a PT render's mean against a committed
high-spp anchor, the detector of a flat PT bias).  They share no code with
the integrators but the render call.  Sizes, seeds, depths and tolerances
are the reference's.  The anchors are the reference data of the JAX
package (``tpu_pathtracer/data/pt_mean_anchors.json``, written by its
``scripts/run_matrix.py``); the port reads its byte-for-byte copy in
``data/``.

Each check returns its gate values beside their limits, and the gates it
missed under ``misses``; the caller raises.  A render runs on ``device``
(None: the GPU).
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from .render.integrator import RenderConfig, render
from .scenes import load_scene

TABLE_RES = 32
ANCHORS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "data", "pt_mean_anchors.json")
# the default tier: (scene, sampler, abs_floor) at 48x36, 48 spp
DEFAULT_TIER = ((0, "sobol", 0.02), (0, "random", 0.02), (8, "sobol", 0.03))
DEFAULT_SIZE, DEFAULT_SPP = (48, 36), 48
# the slow tier: every matrix scene and sampler at 64x48, 64 spp, the
# abs_floor 0.035 on scenes 8 and 10, else 0.025
MATRIX_SCENES = (3, 6, 8, 9, 10, 17)
MATRIX_SIZE, MATRIX_SPP = (64, 48), 64
ANCHOR_SPP, ANCHOR_SEED = 128, 7
# the anchored scenes chip_smoke.py checks; the others run in the slow
# tier (tests/test_torch_cuda.py), which keeps the script inside its time
SMOKE_ANCHOR_SCENES = (3, 8, 17)
SLOW_ANCHOR_SCENES = (6, 9, 10)


def _median3(img: torch.Tensor) -> torch.Tensor:
    """3x3 median of each channel of an (H, W, C) image, the edge pixels
    repeated past the border: ``scipy.ndimage.median_filter(img,
    size=(3, 3, 1))`` (its "reflect" mode repeats the edge for a 1-pixel
    border), on the image's device."""
    x = torch.nn.functional.pad(img.permute(2, 0, 1)[None], (1, 1, 1, 1),
                                mode="replicate")[0]
    win = x.unfold(1, 3, 1).unfold(2, 3, 1)            # (C, H, W, 3, 3)
    return win.reshape(*win.shape[:3], 9).median(-1).values.permute(1, 2, 0)


def _render_lin(scene, meta, cam, w, h, spp, strat, sampler, seed=0,
                device=None) -> torch.Tensor:
    cfg = RenderConfig(width=w, height=h, spp=spp, strategy=strat,
                       sampler=sampler, seed=seed, max_depth=8,
                       tone_map="none", eotf="linear")
    return render(scene, meta, cam, cfg, device=device)


def _rmse(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.sqrt(np.mean((a - b) ** 2)))


def check_consistency(scene_id: int, sampler: str, w: int, h: int, spp: int,
                      k_sigma: float = 2.0, abs_floor: float = 0.02,
                      device=None) -> dict:
    """pt vs nee vs mis on scene ``scene_id`` (``_check_consistency``):
    each pair's RMSE of the median-filtered images over the nee image's
    mean, under ``abs_floor + k_sigma * noise`` (noise: pt against pt with
    seed 101, so measured); the unfiltered nee and mis means within
    ``0.02 + k_sigma * noise / 8`` of each other."""
    scene, meta, cam = load_scene(scene_id, w, h, table_res=TABLE_RES,
                                  device=device)
    raw = {s: _render_lin(scene, meta, cam, w, h, spp, s, sampler,
                          device=device) for s in ("pt", "nee", "mis")}
    imgs = {s: _median3(v).cpu().numpy() for s, v in raw.items()}
    raw = {s: v.cpu().numpy() for s, v in raw.items()}
    pt_b = _median3(_render_lin(scene, meta, cam, w, h, spp, "pt", sampler,
                                seed=101, device=device)).cpu().numpy()
    scale = max(float(imgs["nee"].mean()), 1e-6)
    noise = _rmse(imgs["pt"], pt_b) / scale
    gate = abs_floor + k_sigma * noise
    out = dict(scene=scene_id, sampler=sampler, size=[w, h], spp=spp,
               noise=noise, gate=gate, rmse={}, misses=[])
    for a, b in (("pt", "nee"), ("pt", "mis"), ("nee", "mis")):
        rmse = _rmse(imgs[a], imgs[b]) / scale
        out["rmse"][f"{a}_{b}"] = rmse
        if not rmse < gate:
            out["misses"].append(f"{a} vs {b} rmse {rmse} >= gate {gate}")
    rel = abs(float(raw["nee"].mean()) - float(raw["mis"].mean())) / scale
    mean_gate = 0.02 + k_sigma * noise / 8.0
    out.update(nee_mis_mean_rel=rel, mean_gate=mean_gate)
    if not rel < mean_gate:
        out["misses"].append(f"nee vs mis mean {rel} >= {mean_gate}")
    return out


def load_anchors() -> dict:
    with open(ANCHORS_PATH) as f:
        return json.load(f)


def check_pt_mean_anchor(scene_id: int, anchor: dict, device=None) -> dict:
    """A PT render's mean (``ANCHOR_SPP`` spp, Sobol, seed
    ``ANCHOR_SEED``, the anchor's size and depth) against the anchor
    (``test_pt_mean_anchors``): relative difference under ``0.08 + 2 x
    the anchor's two-seed spread scaled to this spp``."""
    w, h = anchor["size"]
    scene, meta, cam = load_scene(scene_id, w, h, table_res=TABLE_RES,
                                  device=device)
    cfg = RenderConfig(width=w, height=h, spp=ANCHOR_SPP, strategy="pt",
                       sampler="sobol", seed=ANCHOR_SEED,
                       max_depth=anchor["max_depth"], tone_map="none",
                       eotf="linear")
    m = float(render(scene, meta, cam, cfg, device=device).cpu().numpy()
              .mean())
    noise = anchor["rel_seed_diff"] * (anchor["spp"] / ANCHOR_SPP) ** 0.5
    tol = 0.08 + 2.0 * noise
    rel = abs(m - anchor["mean"]) / max(anchor["mean"], 1e-9)
    out = dict(scene=scene_id, size=[w, h], spp=ANCHOR_SPP, mean=m,
               anchor=anchor["mean"], rel=rel, tol=tol, misses=[])
    if not rel < tol:
        out["misses"].append(f"PT mean {m} vs anchor {anchor['mean']}: "
                             f"rel {rel} >= tol {tol}")
    return out
