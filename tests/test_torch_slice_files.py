"""File-backed scenes end to end, each package building its own scene
from the same files: scene 17 with its dragon loaded from an OBJ in
``ASSET_DIR`` (each package's native SAH build), and scene 19 with its
sky read back from a FLOAT EXR.

Gates: the port's scene tables equal to the JAX package's (integer and BVH
tables exactly, floats within 1e-6 relative, as tests/test_torch_scene.py
holds them); the port's ``render_accum`` against the JAX package's
wavefront render by ``check_slice`` (display RMSE <= 0.002, linear mean,
traced rays and ``count_rays_one_spp`` within 1 %); scene 19 from the EXR
renders the film of the in-memory sky bit for bit (the FLOAT round trip
is exact).
"""
import numpy as np
import pytest
import torch

from tpu_pathtracer import scenes as jscenes
from tpu_pathtracer.scene import image_io as jimage_io
from tpu_pathtracer.scene import mesh as jmesh
from tpu_pathtracer_torch import scenes as tscenes
from tpu_pathtracer_torch.render import integrator as tint
from tpu_pathtracer_torch.scene import image_io as timage_io
from tpu_pathtracer_torch.scene import mesh as tmesh
from tpu_pathtracer_torch.utils import exr

from test_torch_image_io import write_obj
from test_torch_native import jax_native_ready
from test_torch_scene import _tables_match
from test_torch_slice_scene0 import (H, SPP, W, check_slice,
                                     two_torch_threads)  # noqa: F401


@pytest.fixture(scope="module")
def scene17_from_obj(tmp_path_factory):
    """Scene 17 whose dragon is an OBJ file (v/vt/vn/f, a denser mesh
    than the procedural stand-in), built by each package."""
    jax_native_ready()
    assets = tmp_path_factory.mktemp("assets")
    write_obj(assets / "dragon.obj", tmesh.dragon(n_u=320, n_v=20))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmesh, "ASSET_DIR", str(assets))
        mp.setattr(jmesh, "ASSET_DIR", str(assets))
        j = jscenes.load_scene(17, W, H, table_res=16)
        t = tscenes.load_scene(17, W, H, table_res=16, device="cpu")
    return j, t


def test_scene17_from_obj_tables_match(scene17_from_obj):
    j, t = scene17_from_obj
    _tables_match(j, t)
    # the OBJ's dragon, not the procedural one (256 x 24 quads)
    assert t[1].n_tris == 10 + 2 * 320 * 20 + 2


@pytest.mark.parametrize("precise", [True, False])
def test_slice_scene17_from_obj(scene17_from_obj, precise):
    stats = check_slice(*scene17_from_obj, "mis", "sobol", precise=precise)
    assert stats.n_steps >= SPP


def test_slice_scene19_sky_from_exr(tmp_path):
    path = str(tmp_path / "sky.exr")
    exr.write_exr(path, tscenes._procedural_sky())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tscenes, "_procedural_sky",
                   lambda: timage_io.load_env(path))
        mp.setattr(jscenes, "_procedural_sky",
                   lambda: jimage_io.load_env(path))
        j = jscenes.load_scene(19, W, H, table_res=16)
        t = tscenes.load_scene(19, W, H, table_res=16, device="cpu")
    _tables_match(j, t)
    check_slice(j, t, "mis", "sobol", precise=False)
    in_memory = tscenes.load_scene(19, W, H, table_res=16, device="cpu")
    assert np.array_equal(in_memory[0].env.rgb.numpy(),
                          t[0].env.rgb.numpy())
    cfg = tint.RenderConfig(width=W, height=H, spp=2, max_depth=4)
    assert torch.equal(tint.render_accum(*t, cfg),
                       tint.render_accum(*in_memory, cfg))
