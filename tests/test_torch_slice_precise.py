"""The precise slice end to end on scenes 6 (gold bunny, nee + random) and
17 (rough clearcoat dragon, mis + sobol): the port's ``render_accum`` with
``precise=True`` against the JAX package's wavefront render on the bridged
scene.  Gates as tests/test_torch_slice_scene0.py: display RMSE <= 0.002,
linear mean, traced rays and ``count_rays_one_spp`` within 1 %.
"""
import dataclasses

import pytest

from tpu_pathtracer.scenes import load_scene as jload
from tpu_pathtracer_torch.bridge import as_numpy_tree, scene_from_numpy

from test_torch_slice_scene0 import (H, SPP, W, check_slice,
                                     two_torch_threads)  # noqa: F401


@pytest.mark.parametrize("scene,strategy,sampler", [(6, "nee", "random"),
                                                    (17, "mis", "sobol")])
def test_slice_precise(scene, strategy, sampler):
    js, jm, jc = jload(scene, W, H, table_res=16)
    t = scene_from_numpy(as_numpy_tree(js), jm._asdict(),
                         dataclasses.asdict(jc), device="cpu")
    stats = check_slice((js, jm, jc), t, strategy, sampler)
    assert stats.n_steps >= SPP
