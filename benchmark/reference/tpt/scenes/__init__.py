"""The scenes the benchmark's configurations use: a frozen copy of
``tpu_pathtracer_torch/scenes`` cut to scene 17 (scene 19's objects are
placed by ``benchmark/configs/env_spheres_sky1k.py``)."""
from __future__ import annotations

from ..device import resolve_device
from ..render.camera import default_camera
from ..scene.builder import Clearcoat, SceneBuilder
from .common import CAMERA_DIR, CAMERA_POS, add_cornell_box, dragon_on_floor


def load_scene(n: int, width: int, height: int, table_res: int = 64,
               device=None):
    """Build scene n on ``device`` (None: the GPU, raising if there is
    none).  Returns (SceneData, SceneMeta, Camera)."""
    if n not in _REGISTRY:
        raise ValueError(f"no scene {n} (available: {sorted(_REGISTRY)})")
    dev = resolve_device(device)
    cam = default_camera(width, height, fov=45.0)
    cam = cam.look_to(CAMERA_POS, CAMERA_DIR)
    sb = SceneBuilder(table_res=table_res)
    cam = _REGISTRY[n](sb, cam) or cam
    data, meta = sb.build(cam.position)
    return data.to(dev), meta, cam


def _dragon_scene(sb: SceneBuilder, material) -> None:
    """The Cornell box with one dragon of ``material``."""
    add_cornell_box(sb)
    m = sb.add_material(material)
    drg, t = dragon_on_floor(scale=1.3)
    sb.add_mesh(drg, m, t)


def _clearcoat(coat_roughness, coat_thickness=0.8):
    return Clearcoat(
        base_color=(0.8, 0.8, 0.8), metallic=1.0, roughness=0.7, eta=1.5,
        coat_eta=1.5, coat_roughness=coat_roughness,
        coat_tint=(0.7, 0.8, 1.0), coat_thickness=coat_thickness)


def scene_17(sb: SceneBuilder, cam):
    """Rough clearcoat dragon (coat roughness 0.75)."""
    _dragon_scene(sb, _clearcoat(0.75))
    return cam


_REGISTRY = {17: scene_17}
