"""Delta and environment lights end to end: scene 1 (two point lights,
no box) with nee + sobol and scene 19 (PBR, clearcoat and plastic spheres
under a sky, no box: camera and continuation rays that miss everything)
with mis + sobol, fast hit test; the port's ``render_accum`` against the
JAX package's wavefront render on the bridged scene.  Gates as
tests/test_torch_slice_scene0.py: display RMSE <= 0.002, linear mean,
traced rays and ``count_rays_one_spp`` within 1 %.
"""
import dataclasses

import pytest

from tpu_pathtracer.scenes import load_scene as jload
from tpu_pathtracer_torch.bridge import as_numpy_tree, scene_from_numpy

from test_torch_slice_scene0 import (H, SPP, W, check_slice,
                                     two_torch_threads)  # noqa: F401


@pytest.mark.parametrize("scene,strategy,sampler", [(1, "nee", "sobol"),
                                                    (19, "mis", "sobol")])
def test_slice_lights(scene, strategy, sampler):
    js, jm, jc = jload(scene, W, H, table_res=16)
    t = scene_from_numpy(as_numpy_tree(js), jm._asdict(),
                         dataclasses.asdict(jc), device="cpu")
    stats = check_slice((js, jm, jc), t, strategy, sampler, precise=False)
    assert stats.n_steps >= SPP
