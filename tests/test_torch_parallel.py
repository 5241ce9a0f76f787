"""Port copies of tests/test_parallel.py: the pixel-sharded render and the
all-reduced gradients of ``tpu_pathtracer_torch.parallel`` on a gloo
process group of two CPU processes, against the same calls with no group
(one device); and with no group, the sharded render against ``render``
bit for bit.

Every case runs in one pair of spawned processes (``_rank_main``), which
render and backpropagate their halves of the padded pixel grid and write
rank 0's results to a file; the tests compare them with the single-device
results of this process.  The pair has a time limit of its own.  Gates are
the JAX tests': film atol 2e-5, rtol 1e-4; loss rtol 1e-5; gradients atol
1e-6, rtol 1e-4.
"""
import datetime
import multiprocessing
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_slice_scene0 import two_torch_threads  # noqa: F401
from tpu_pathtracer_torch import parallel as tpar
from tpu_pathtracer_torch.render import film as tfilm
from tpu_pathtracer_torch.render import integrator as tint
from tpu_pathtracer_torch.scenes import load_scene

W, H = 32, 24
WORLD = 2
PAIR_TIMEOUT_S = 300


def _cfg(**kw):
    kw.setdefault("strategy", "mis")
    kw.setdefault("sampler", "sobol")
    return tint.RenderConfig(width=W, height=H, spp=2, max_depth=3, **kw)


def _uneven_cfg():
    return tint.RenderConfig(width=9, height=7, spp=1, max_depth=2,
                             strategy="pt", sampler="random")


# (name, config, film size): the sharded renders of the pair
RENDERS = (("mis_sobol", _cfg(), (W, H)),
           ("pt_random", _cfg(sampler="random", strategy="pt"), (W, H)),
           ("uneven", _uneven_cfg(), (9, 7)))
# test_parallel.py's pt sees neither of scene 1's point lights (a zero
# loss); NEE makes the gradients something to compare
GRAD_CFG = _cfg(strategy="nee")


def _rank_main(rank, port, out_path):
    """One rank of the pair: every sharded case of this module."""
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", world_size=WORLD,
        rank=rank, timeout=datetime.timedelta(seconds=PAIR_TIMEOUT_S))
    try:
        group = dist.group.WORLD
        out = {"world": np.asarray(dist.get_world_size(group))}
        scenes = {}
        for name, cfg, (w, h) in RENDERS:
            if (w, h) not in scenes:
                scenes[w, h] = load_scene(1, w, h, table_res=16,
                                          device="cpu")
            out[name] = tpar.render_sharded(*scenes[w, h], cfg, group=group,
                                            device="cpu").numpy()
        scene, meta, cam = scenes[W, H]
        loss, grads = tpar.loss_and_grads(
            tpar.extract_params(scene), scene, meta, cam, GRAD_CFG,
            torch.zeros(W * H, 3), group=group, device="cpu")
        out["loss"] = loss.numpy()
        out.update({f"grad_{k}": v.numpy() for k, v in grads.items()})
        if rank == 0:
            np.savez(out_path, **out)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """The pair's results, {name: array}."""
    out_path = str(tmp_path_factory.mktemp("pair") / "rank0.npz")
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, port, out_path))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(PAIR_TIMEOUT_S)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    assert [p.exitcode for p in procs] == [0] * WORLD
    with np.load(out_path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def single():
    """One device: the scenes of the pair, built here."""
    return {(w, h): load_scene(1, w, h, table_res=16, device="cpu")
            for w, h in ((W, H), (9, 7))}


def test_two_ranks_ran(sharded):
    assert int(sharded["world"]) == WORLD


@pytest.mark.parametrize("name", ["mis_sobol", "pt_random"])
def test_sharded_render_matches_single_device(sharded, single, name):
    """The samplers are pure functions of (pixel, sample, dim), so the
    split changes no sample (the random sampler is pixel-keyed)."""
    _, cfg, size = next(r for r in RENDERS if r[0] == name)
    img1 = tint.render(*single[size], cfg, device="cpu").numpy()
    img2 = sharded[name]
    assert img2.shape == img1.shape == (H, W, 3)
    np.testing.assert_allclose(img2, img1, atol=2e-5, rtol=1e-4)


def test_grads_independent_of_world_size(sharded, single):
    scene, meta, cam = single[W, H]
    l1, g1 = tpar.loss_and_grads(tpar.extract_params(scene), scene, meta,
                                 cam, GRAD_CFG, torch.zeros(W * H, 3),
                                 device="cpu")
    np.testing.assert_allclose(float(sharded["loss"]), float(l1), rtol=1e-5)
    for k, g in g1.items():
        np.testing.assert_allclose(sharded[f"grad_{k}"], g.numpy(),
                                   atol=1e-6, rtol=1e-4, err_msg=k)
    assert float(l1) > 0.0
    assert np.abs(g1["base_coeff"].numpy()).max() > 0.0


def test_uneven_pixel_count_pads(sharded, single):
    """W*H not divisible by the world size (63 pixels on 2 ranks): the
    grid is padded, and the film equals the single-device render."""
    img = sharded["uneven"]
    assert img.shape == (7, 9, 3)
    assert np.isfinite(img).all()
    ref = tint.render(*single[9, 7], _uneven_cfg(), device="cpu").numpy()
    np.testing.assert_allclose(img, ref, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("scene,sampler", [(8, "random"), (17, "sobol")],
                         ids=["s8-mis-random", "s17-mis-sobol"])
def test_sharded_render_with_no_group_is_render(monkeypatch, scene, sampler):
    """With no group the one block is the grid, rendered through the
    wavefront with the grid's tiling: the linear film equals
    ``render_accum``'s and the image ``render``'s, bit for bit (scene 8's
    dispersive glass, scene 17's clearcoat dragon)."""
    s, m, c = load_scene(scene, 16, 12, table_res=16, device="cpu")
    cfg = tint.RenderConfig(width=16, height=12, spp=2, max_depth=4,
                            strategy="mis", sampler=sampler)
    films = []
    real = tfilm.finalize
    monkeypatch.setattr(tfilm, "finalize",
                        lambda acc, *a, **k: films.append(acc)
                        or real(acc, *a, **k))
    img = tint.render(s, m, c, cfg, device="cpu")
    sharded = tpar.render_sharded(s, m, c, cfg, device="cpu")
    # films[0] is render's: render_accum's film
    assert len(films) == 2 and torch.equal(films[1], films[0])
    assert torch.equal(sharded, img) and float(img.mean()) > 0
