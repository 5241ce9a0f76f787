"""Scene 17 (a rough clearcoat dragon in the Cornell box under its area
light) with the dragon loaded as a scan: the benchmark's sweep of 884,736
triangles written as ``dragon.obj`` and read from ``TPT_ASSET_DIR``, the
directory a user's scan is read from."""
from __future__ import annotations

import importlib
import os

from .. import yardstick


def make_inputs(conf: dict, workdir: str, seed: int) -> dict:
    """Write the mesh (the same for every seed) and point the program's
    asset directory at it."""
    sweep = conf["mesh_sweep"]
    pos, uvs, idx = yardstick.dragon_sweep(sweep["n_u"], sweep["n_v"])
    yardstick.write_obj(os.path.join(workdir, "dragon.obj"), pos, uvs, idx)
    os.environ["TPT_ASSET_DIR"] = workdir
    return {"asset_dir": workdir}


def build(package: str, conf: dict, inputs: dict, width: int, height: int,
          device):
    """(scene, meta, camera) of ``package`` (the program's or the
    reference's) on ``device``."""
    mesh = importlib.import_module(package + ".scene.mesh")
    mesh.ASSET_DIR = inputs["asset_dir"]
    scenes = importlib.import_module(package + ".scenes")
    scene, meta, cam = scenes.load_scene(conf["scene"], width, height,
                                         table_res=conf["table_res"],
                                         device=device)
    want = 2 * conf["mesh_sweep"]["n_u"] * conf["mesh_sweep"]["n_v"]
    if meta.n_tris < want:
        raise RuntimeError(f"{package}: the scene has {meta.n_tris} "
                           f"triangles, not the {want} of the scan")
    return scene, meta, cam
