"""Textures and rough glass end to end: scene 3 (checker albedo and normal
map on a Lambert bunny) with pt + random and scene 15 (PBR dragon with
base color, metallic, roughness and normal maps) with mis + sobol, fast
hit test; scene 11 (rough SF11 glass) with nee + random and
``precise=True``.  The port's ``render_accum`` against the JAX package's
wavefront render on the bridged scene.  Gates as
tests/test_torch_slice_scene0.py: display RMSE <= 0.002, linear mean,
traced rays and ``count_rays_one_spp`` within 1 %.
"""
import dataclasses

import pytest

from tpu_pathtracer.scenes import load_scene as jload
from tpu_pathtracer_torch.bridge import as_numpy_tree, scene_from_numpy

from test_torch_slice_scene0 import (H, SPP, W, check_slice,
                                     two_torch_threads)  # noqa: F401


@pytest.mark.parametrize("scene,strategy,sampler,precise", [
    (3, "pt", "random", False), (15, "mis", "sobol", False),
    (11, "nee", "random", True)])
def test_slice_materials(scene, strategy, sampler, precise):
    js, jm, jc = jload(scene, W, H, table_res=16)
    t = scene_from_numpy(as_numpy_tree(js), jm._asdict(),
                         dataclasses.asdict(jc), device="cpu")
    stats = check_slice((js, jm, jc), t, strategy, sampler, precise)
    assert stats.n_steps >= SPP
