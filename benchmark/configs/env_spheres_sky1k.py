"""Scene 19 (PBR, clearcoat and plastic spheres on a floor under an
environment light, no box) with its sky read from a float32 EXR of
1024 x 512, the published sky's size."""
from __future__ import annotations

import importlib
import os

from .. import yardstick
from ..reference.tpt.utils.exr import write_exr


def make_inputs(conf: dict, workdir: str, seed: int) -> dict:
    """Write the sky (the same for every seed)."""
    path = os.path.join(workdir, "sky.exr")
    write_exr(path, yardstick.procedural_sky(conf["sky"]["height"],
                                             conf["sky"]["width"]))
    return {"sky": path}


def build(package: str, conf: dict, inputs: dict, width: int, height: int,
          device):
    """(scene, meta, camera) of ``package``: scene 19's objects as its
    ``scenes.scene_19`` places them, the sky from the EXR."""
    def mod(name):
        return importlib.import_module(f"{package}.{name}")
    builder, mesh, common = mod("scene.builder"), mod("scene.mesh"), \
        mod("scenes.common")
    sky = mod("scene.image_io").load_env(inputs["sky"])
    cam = mod("render.camera").default_camera(width, height, fov=45.0)
    sb = builder.SceneBuilder(table_res=conf["table_res"])
    s = common.BOX_HALF
    floor = sb.add_material(builder.Lambert(albedo=(0.7, 0.7, 0.7)))
    sb.add_mesh(mesh.quad([-2 * s, 0, 2 * s], [2 * s, 0, 2 * s],
                          [2 * s, 0, -2 * s], [-2 * s, 0, -2 * s]), floor)
    m_pbr = sb.add_material(builder.Pbr(base_color=(0.8, 0.3, 0.25),
                                        metallic=0.9, roughness=0.25,
                                        eta=1.5))
    m_coat = sb.add_material(builder.Clearcoat(
        base_color=(0.7, 0.7, 0.75), metallic=1.0, roughness=0.5,
        coat_roughness=0.02, coat_tint=(0.8, 0.9, 1.0), coat_thickness=0.5))
    m_plastic = sb.add_material(builder.Plastic(color=(0.9, 0.85, 0.4),
                                                eta=1.49, roughness=0.05))
    sph = mesh.uv_sphere(0.45, 24, 48)
    sb.add_mesh(sph, m_pbr, common.translate(-1.0, 0.45, 0.0))
    sb.add_mesh(sph, m_coat, common.translate(0.0, 0.45, -0.6))
    sb.add_mesh(sph, m_plastic, common.translate(1.0, 0.45, 0.2))
    sb.add_env_light(sky, intensity=1.0)
    cam = cam.look_to((-1.5, 0.8, 2.5), (1.5, -0.4, -2.5))
    scene, meta = sb.build(cam.position)
    return scene.to(device), meta, cam
