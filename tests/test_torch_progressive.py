"""Progressive rendering with checkpoint/resume in the port: port copies
of tests/test_progressive.py's three tests on the CPU (matches the one-shot
render, bit-exact resume after a simulated preemption, a checkpoint of
another config ignored), with its tolerance (atol 2e-5, rtol 1e-4), and
the port's ``render_progressive`` against the JAX package's on scene 1
built by the JAX package and bridged (display values within 1e-5, the
slice renders' agreement on the same draws, as in
tests/test_torch_slice_scene0.py's AOV test).
"""
import dataclasses
import os

import numpy as np
import pytest

from tpu_pathtracer.render import integrator as jint
from tpu_pathtracer.render import progressive as jprog
from tpu_pathtracer.scenes import load_scene as jload
from tpu_pathtracer_torch.bridge import as_numpy_tree, scene_from_numpy
from tpu_pathtracer_torch.render.integrator import RenderConfig, render
from tpu_pathtracer_torch.render.progressive import (FilmState,
                                                     render_progressive)
from tpu_pathtracer_torch.scenes import load_scene

from test_torch_slice_scene0 import two_torch_threads  # noqa: F401

W, H = 24, 18


def _cfg(spp=8):
    return RenderConfig(width=W, height=H, spp=spp, max_depth=3,
                        strategy="mis", sampler="sobol")


@pytest.fixture(scope="module")
def scene1():
    return load_scene(1, W, H, table_res=16, device="cpu")


def _one_shot(scene, cfg):
    s, m, c = scene
    return render(s, m, c, cfg, device="cpu").numpy()


def test_progressive_matches_one_shot(scene1, tmp_path):
    cfg = _cfg()
    img_pro = render_progressive(*scene1, cfg,
                                 checkpoint_path=str(tmp_path / "ckpt.npz"),
                                 chunk_spp=3, device="cpu")
    np.testing.assert_allclose(img_pro, _one_shot(scene1, cfg), atol=2e-5,
                               rtol=1e-4)


def test_resume_from_checkpoint(scene1, tmp_path):
    cfg = _cfg()
    ckpt = str(tmp_path / "ckpt.npz")

    class Stop(Exception):
        pass

    def bail(state):
        if state.spp_done >= 3:
            raise Stop

    with pytest.raises(Stop):
        render_progressive(*scene1, cfg, checkpoint_path=ckpt, chunk_spp=3,
                           on_chunk=bail, device="cpu")
    assert os.path.exists(ckpt)
    st = FilmState.load(ckpt)
    assert 0 < st.spp_done < cfg.spp

    img = render_progressive(*scene1, cfg, checkpoint_path=ckpt, chunk_spp=3,
                             device="cpu")
    np.testing.assert_allclose(img, _one_shot(scene1, cfg), atol=2e-5,
                               rtol=1e-4)


def test_stale_checkpoint_ignored(scene1, tmp_path):
    ckpt = str(tmp_path / "ckpt.npz")
    render_progressive(*scene1, _cfg(spp=4), checkpoint_path=ckpt,
                       chunk_spp=2, device="cpu")
    img = render_progressive(*scene1, _cfg(spp=6), checkpoint_path=ckpt,
                             chunk_spp=2, device="cpu")
    np.testing.assert_allclose(img, _one_shot(scene1, _cfg(spp=6)),
                               atol=2e-5, rtol=1e-4)


def test_progressive_matches_jax(tmp_path):
    """Both packages' ``render_progressive`` on the bridged scene 1, four
    chunks of two samples."""
    js, jm, jc = jload(1, W, H, table_res=16)
    ts, tm, tc = scene_from_numpy(as_numpy_tree(js), jm._asdict(),
                                  dataclasses.asdict(jc), device="cpu")
    common = dict(width=W, height=H, spp=8, max_depth=3, strategy="mis",
                  sampler="sobol")
    jimg = jprog.render_progressive(js, jm, jc, jint.RenderConfig(**common),
                                    checkpoint_path=str(tmp_path / "j.npz"),
                                    chunk_spp=2)
    timg = render_progressive(ts, tm, tc, RenderConfig(**common),
                              checkpoint_path=str(tmp_path / "t.npz"),
                              chunk_spp=2, device="cpu")
    assert timg.shape == (H, W, 3) and timg.mean() > 0.05
    np.testing.assert_allclose(timg, np.asarray(jimg), rtol=0, atol=1e-5)
