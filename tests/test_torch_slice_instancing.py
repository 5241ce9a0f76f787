"""Instanced scenes end to end: scene 7 (four gold bunnies) with nee +
sobol, fast; scene 12 (four rough BK7 glass bunnies) with mis + sobol,
precise; scene 14 (four plastic bunnies) with mis + random, fast.  Each
is built by the JAX package, carried to the port with the bridge, and
rendered through both packages at 32x24.  Gates as
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
    (7, "nee", "sobol", False),
    (12, "mis", "sobol", True),
    (14, "mis", "random", False)])
def test_slice_instancing(scene, strategy, sampler, precise):
    js, jm, jc = jload(scene, W, H, table_res=16)
    assert len(js.instanced) == 1
    t = scene_from_numpy(as_numpy_tree(js), jm._asdict(),
                         dataclasses.asdict(jc), device="cpu")
    stats = check_slice((js, jm, jc), t, strategy, sampler, precise=precise)
    assert stats.n_steps >= SPP
