"""Demo scenes (counterpart of ``tpu_pathtracer/scenes/__init__.py``).

Scenes 0, 6, 16 and 17 are ported so far; ``load_scene`` raises
``NotImplementedError`` for the others.
"""
from __future__ import annotations

from typing import Callable, Dict

from ..device import resolve_device
from ..render.camera import default_camera
from ..scene.builder import Clearcoat, Lambert, Metal, SceneBuilder
from .common import (CAMERA_DIR, CAMERA_POS, add_cornell_box, bunny_on_floor,
                     dragon_on_floor)

_REGISTRY: Dict[int, Callable] = {}


def register(n):
    def deco(fn):
        _REGISTRY[n] = fn
        return fn
    return deco


def available_scenes():
    return sorted(_REGISTRY)


def load_scene(n: int, width: int, height: int, table_res: int = 64,
               device=None):
    """Build scene n on ``device`` (None: the GPU, raising if there is
    none).  Returns (SceneData, SceneMeta, Camera)."""
    if n not in _REGISTRY:
        raise NotImplementedError(
            f"scene {n} is not ported yet (ported: {available_scenes()})")
    dev = resolve_device(device)
    cam = default_camera(width, height, fov=45.0)
    cam = cam.look_to(CAMERA_POS, CAMERA_DIR)
    sb = SceneBuilder(table_res=table_res)
    cam = _REGISTRY[n](sb, cam) or cam
    data, meta = sb.build(cam.position)
    return data.to(dev), meta, cam


@register(0)
def scene_0(sb: SceneBuilder, cam):
    """Lambert bunny in the Cornell box."""
    add_cornell_box(sb)
    m = sb.add_material(Lambert(albedo=(0.8, 0.8, 0.8)))
    bun, t = bunny_on_floor()
    sb.add_mesh(bun, m, t)
    return cam


@register(6)
def scene_6(sb: SceneBuilder, cam):
    """Smooth gold bunny (roughness 0)."""
    add_cornell_box(sb)
    m = sb.add_material(Metal(kind="gold", roughness=0.0))
    bun, t = bunny_on_floor()
    sb.add_mesh(bun, m, t)
    return cam


def _clearcoat_dragon(sb: SceneBuilder, coat_roughness: float):
    add_cornell_box(sb)
    m = sb.add_material(Clearcoat(
        base_color=(0.8, 0.8, 0.8), metallic=1.0, roughness=0.7, eta=1.5,
        coat_eta=1.5, coat_roughness=coat_roughness,
        coat_tint=(0.7, 0.8, 1.0), coat_thickness=0.8))
    drg, t = dragon_on_floor(scale=1.3)
    sb.add_mesh(drg, m, t)


@register(16)
def scene_16(sb: SceneBuilder, cam):
    """Clearcoat PBR dragon (coat roughness 0.01)."""
    _clearcoat_dragon(sb, 0.01)
    return cam


@register(17)
def scene_17(sb: SceneBuilder, cam):
    """Rough clearcoat dragon (coat roughness 0.75)."""
    _clearcoat_dragon(sb, 0.75)
    return cam
