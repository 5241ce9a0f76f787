"""CPU tests of the check that decides ``correct``: a whole run of a cell
at a small size, with the harness's look for a card skipped, comes out
correct; with the timed path broken underneath it comes out not correct;
and the control (the reference at bfloat16 in the program's place) fails
the cell's limits.  The control's readings at the cells' own sizes come
from ``python3 -m benchmark.control`` on the card."""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from benchmark import compare, harness

torch.set_num_threads(2)
BENCH = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
# cells whose files are kept for a later entry in BENCHMARK.json (PERF.md,
# open questions): run here as the entered cells are
STAGED = [{"name": "env_sky.render", "config": "env_spheres_sky1k",
           "traffic": "render", "chips": 1},
          {"name": "dragon_scan.render_pt_random",
           "config": "cornell_dragon_scan", "traffic": "render_pt_random",
           "chips": 1}]
SMALL_CONF = {"width": 20, "height": 12, "spp": 8,
              "mesh_sweep": {"n_u": 64, "n_v": 8, "triangles": 1024},
              "sky": {"width": 64, "height": 32}}
SMALL_FIT = {"resolution": [16, 12], "max_depth": 4}
SMALL_TRAFFIC = {"check_pixels": 48, "chunk_spp": 4, "warm_spp": 2,
                 "restart_every": 4}
LIMITS = {"film_mismatch_share": 0.1}


def _run(cell, tmp_path, seed=2 ** 32 + 11):
    bench = dict(BENCH, workloads=BENCH["workloads"] + STAGED)
    conf = dict(SMALL_CONF, **(SMALL_FIT if cell.endswith("train") else {}))
    ctx = harness.Context(bench, cell, seed, 0.5, False, torch.device("cpu"),
                          time.perf_counter(), str(tmp_path),
                          limits=(LIMITS if cell in [c["name"] for c in
                                                     STAGED] else None),
                          conf_over=conf, traffic_over=SMALL_TRAFFIC)
    harness.run_cell(ctx)
    return ctx


@pytest.mark.parametrize("cell", ["dragon_scan.render", "env_sky.render",
                                  "dragon_scan.render_pt_random",
                                  "dragon_scan.train"])
def test_a_sound_run_is_correct(cell, tmp_path):
    ctx = _run(cell, tmp_path)
    out = harness.result(ctx, {"platform": "cpu"})
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "compared"


def _patched(monkeypatch, module, name, make):
    monkeypatch.setattr(module, name, make(getattr(module, name)))


RENDER_FAULTS = {
    # a pass that returns the film it was given
    "unchanged": lambda real: lambda *a, accum_init=None, **kw: (
        torch.as_tensor(accum_init)),
    # half of the pixels' samples left out
    "half_batch": lambda real: lambda *a, accum_init=None, **kw: torch.cat(
        [real(*a, accum_init=accum_init, **kw)[:120],
         torch.as_tensor(accum_init)[120:]]),
    # an answer altered where it is produced
    "altered": lambda real: lambda *a, **kw: real(*a, **kw) * 1.001,
}


@pytest.mark.parametrize("fault", sorted(RENDER_FAULTS))
def test_a_broken_render_is_not_correct(fault, tmp_path, monkeypatch):
    from tpu_pathtracer_torch.render import progressive
    _patched(monkeypatch, progressive, "render_accum", RENDER_FAULTS[fault])
    assert not _run("dragon_scan.render", tmp_path).correct


def _unchanged(real):
    def adam(state, grads):
        new = real(state, grads)
        return type(state)(params=state.params, count=new.count,
                           mu=state.mu, nu=state.nu, step=new.step,
                           lr=state.lr)
    return adam


def _half_batch(real):
    def lg(params, scene, meta, camera, cfg, target, **kw):
        import dataclasses
        half = dataclasses.replace(cfg, height=cfg.height // 2)
        n = half.width * half.height
        return real(params, scene, meta, camera, half, target[:n], **kw)
    return lg


def _altered(real):
    def lg(*a, **kw):
        loss, grads = real(*a, **kw)
        return loss * 1.1, grads
    return lg


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_a_broken_fit_is_not_correct(fault, tmp_path, monkeypatch):
    from tpu_pathtracer_torch import parallel
    name, make = {"unchanged": ("_adam_update", _unchanged),
                  "half_batch": ("loss_and_grads", _half_batch),
                  "altered": ("loss_and_grads", _altered)}[fault]
    _patched(monkeypatch, parallel, name, make)
    assert not _run("dragon_scan.train", tmp_path).correct


def test_the_bfloat16_control_fails_the_render_limit(tmp_path):
    from benchmark.drivers.progressive import _config, check_pixels
    from benchmark.reference import render as ref_render
    from benchmark.reference.tpt.render import integrator as rinteg
    ctx = _run("dragon_scan.render", tmp_path)
    scene, meta, cam = ctx.config_module.build(
        "benchmark.reference.tpt", ctx.conf, ctx.inputs, 20, 12, ctx.device)
    cfg = _config(rinteg, ctx.conf, ctx.traffic, ctx.seed)
    pix = torch.as_tensor(check_pixels(ctx.conf, ctx.traffic, ctx.seed))
    ref = ref_render.pass_films(scene, meta, cam, cfg, pix, 4).numpy()
    low = ref_render.pass_films(scene, meta, cam, cfg, pix, 4,
                                precision="bfloat16").numpy()
    share, _ = compare.film_mismatch([(4 * (k + 1), low[k])
                                      for k in range(len(low))], ref, 4)
    assert share > ctx.limits["film_mismatch_share"]


def test_the_bfloat16_control_fails_a_fit_limit(tmp_path):
    from benchmark.drivers.fit import _config
    from benchmark.reference import fit as ref_fit
    from benchmark.reference.tpt.render import integrator as rinteg
    ctx = _run("dragon_scan.train", tmp_path)
    tr = ctx.traffic
    cfg = _config(rinteg, ctx.conf, tr, ctx.seed)
    scene, meta, cam = ctx.config_module.build(
        "benchmark.reference.tpt", ctx.conf, ctx.inputs, cfg.width,
        cfg.height, ctx.device)
    ref = ref_fit.follow(scene, meta, cam, cfg, ctx.seed, tr["lr"], 2)
    low = ref_fit.follow(scene, meta, cam, cfg, ctx.seed, tr["lr"], 2,
                         lower=torch.bfloat16)
    gaps = compare.fit_gaps(low, ref)
    assert any(v > ctx.limits[k] for k, v in gaps.items())


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "dragon_scan.render", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=harness.ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
