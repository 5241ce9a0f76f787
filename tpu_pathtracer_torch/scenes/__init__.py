"""Demo scenes (counterpart of ``tpu_pathtracer/scenes/__init__.py``).

All 20 scenes; 7, 12 and 14 hold four instanced bunnies each (one stored
copy of the mesh under four affines).  The procedural textures and the
sky are numpy, as in the JAX package.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np

from ..device import resolve_device
from ..render.camera import default_camera
from ..scene import mesh
from ..scene.builder import (Clearcoat, Glass, Lambert, Metal, Pbr, Plastic,
                             SceneBuilder, Texture)
from ..spectrum.cie import illum_d6500
from . import common
from .common import (CAMERA_DIR, CAMERA_POS, add_cornell_box, bunny_on_floor,
                     dragon_on_floor, translate)

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
        raise ValueError(f"no scene {n} (available: {available_scenes()})")
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


@register(1)
def scene_1(sb: SceneBuilder, cam):
    """Two point lights over a floor and a bunny."""
    m = sb.add_material(Lambert(albedo=(0.8, 0.8, 0.8)))
    s = common.BOX_HALF
    sb.add_mesh(mesh.quad([-s, 0, s], [s, 0, s], [s, 0, -s], [-s, 0, -s]), m)
    bun, t = bunny_on_floor()
    sb.add_mesh(bun, m, t)
    sb.add_point_light((-1.5, 3.0, 1.5), illum_d6500(), 16.0)
    sb.add_point_light((1.5, 3.0, 1.5), (0.9, 0.4, 0.2), 12.0)
    return cam


@register(2)
def scene_2(sb: SceneBuilder, cam):
    """Cornell box lit by a point light."""
    add_cornell_box(sb, with_light=False)
    m = sb.add_material(Lambert(albedo=(0.8, 0.8, 0.8)))
    bun, t = bunny_on_floor()
    sb.add_mesh(bun, m, t)
    sb.add_point_light((0.0, 3.6, 0.0), illum_d6500(), 20.0)
    return cam


def _checker_texture(n=256, a=(0.9, 0.9, 0.9), b=(0.2, 0.3, 0.6), tiles=8):
    ij = np.indices((n, n)).sum(0)
    mask = ((ij * tiles // n) % 2).astype(np.float32)[..., None]
    img = np.asarray(a) * (1 - mask) + np.asarray(b) * mask
    return Texture(img.astype(np.float32), kind="rgb")


def _normal_map_texture(n=256, bumps=12, amp=0.6):
    y, x = np.mgrid[0:n, 0:n] / n
    h = np.sin(x * bumps * 2 * np.pi) * np.sin(y * bumps * 2 * np.pi) * amp
    dx = np.gradient(h, axis=1) * n
    dy = np.gradient(h, axis=0) * n
    nrm = np.stack([-dx, -dy, np.ones_like(h)], -1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    return Texture(((nrm + 1.0) * 0.5).astype(np.float32), kind="normal")


def _metal_mask_texture(n=128):
    y, x = np.mgrid[0:n, 0:n] / n
    v = ((np.sin(x * 12) * np.sin(y * 9)) > 0.2).astype(np.float32)
    return Texture(v[..., None], kind="gray")


def _roughness_texture(n=128):
    y, x = np.mgrid[0:n, 0:n] / n
    v = (0.2 + 0.6 * (0.5 + 0.5 * np.sin(x * 20 + 3 * y))).astype(np.float32)
    return Texture(v[..., None], kind="gray")


def _thickness_texture(n=128):
    y, x = np.mgrid[0:n, 0:n] / n
    v = (1.2 * ((np.sin(x * 15) * np.cos(y * 15)) > 0.0)).astype(np.float32)
    return Texture(v[..., None], kind="gray")


def _procedural_sky(h=128, w=256, sun_dir=(0.4, 0.5, -0.3)):
    """Sky: a gradient, a sun disk, a glow around it and a dim ground."""
    v, u = np.mgrid[0:h, 0:w]
    theta = (v + 0.5) / h * np.pi
    phi = (u + 0.5) / w * 2 * np.pi
    d = np.stack([np.sin(theta) * np.cos(phi), np.cos(theta),
                  -np.sin(theta) * np.sin(phi)], -1)
    sun = np.asarray(sun_dir) / np.linalg.norm(sun_dir)
    cos_sun = (d @ sun).clip(-1, 1)
    sky = np.zeros((h, w, 3), np.float32)
    t = np.clip(d[..., 1], 0, 1)[..., None]
    sky += (1 - t) * np.asarray([0.9, 0.85, 0.8]) + t * np.asarray([0.25, 0.45, 0.9])
    sky += np.exp((cos_sun - 1.0) / 0.0008)[..., None] * np.asarray([80.0, 70.0, 55.0])
    sky += np.exp((cos_sun - 1.0) / 0.08)[..., None] * np.asarray([1.2, 1.0, 0.7])
    ground = d[..., 1] < 0
    sky[ground] = sky[ground] * 0.0 + np.asarray([0.25, 0.22, 0.2]) * (
        0.3 + 0.7 * np.abs(d[ground][:, 1:2]))
    return sky.astype(np.float32)


def _bunny_scene(sb: SceneBuilder, material) -> None:
    """The Cornell box with one bunny of ``material``."""
    add_cornell_box(sb)
    m = sb.add_material(material)
    bun, t = bunny_on_floor()
    sb.add_mesh(bun, m, t)


def _dragon_scene(sb: SceneBuilder, material) -> None:
    """The Cornell box with one dragon of ``material``."""
    add_cornell_box(sb)
    m = sb.add_material(material)
    drg, t = dragon_on_floor(scale=1.3)
    sb.add_mesh(drg, m, t)


@register(3)
def scene_3(sb: SceneBuilder, cam):
    """Textured and normal-mapped bunny."""
    _bunny_scene(sb, Lambert(albedo=_checker_texture(),
                             normal=_normal_map_texture()))
    return cam


@register(4)
def scene_4(sb: SceneBuilder, cam):
    """Bunny with the second texture set (warmer checker, other bumps)."""
    _bunny_scene(sb, Lambert(
        albedo=_checker_texture(a=(0.85, 0.75, 0.6), b=(0.45, 0.3, 0.25),
                                tiles=5),
        normal=_normal_map_texture(bumps=9, amp=0.4)))
    return cam


@register(5)
def scene_5(sb: SceneBuilder, cam):
    """Constant color with a normal map."""
    _bunny_scene(sb, Lambert(albedo=(0.75, 0.71, 0.68),
                             normal=_normal_map_texture(bumps=6, amp=0.9)))
    return cam


@register(6)
def scene_6(sb: SceneBuilder, cam):
    """Smooth gold bunny (roughness 0)."""
    _bunny_scene(sb, Metal(kind="gold", roughness=0.0))
    return cam


def _four_on_floor(sb: SceneBuilder, materials, scale=0.75, flatten=False):
    """Four small bunnies left to right, one material each.  Instanced:
    the bunny's triangles and BVH are stored once under four affines;
    ``flatten=True`` adds four transformed copies to the main soup
    instead (the instancing tests render both)."""
    xs = [-1.3, -0.5, 0.3, 1.1]
    bun = mesh.bunny()
    lo = bun.positions.min(0)
    ts = [translate(x, -lo[1] * scale, -0.5) @ np.diag([scale] * 3 + [1.0])
          for x in xs]
    if flatten:
        for t, mat in zip(ts, materials):
            sb.add_mesh(bun, mat, t)
    else:
        sb.add_instances(bun, list(zip(ts, materials)))


@register(7)
def scene_7(sb: SceneBuilder, cam):
    """Four gold bunnies, roughness 0.05, 0.25, 0.5, 0.75."""
    add_cornell_box(sb)
    mats = [sb.add_material(Metal(kind="gold", roughness=r))
            for r in (0.05, 0.25, 0.5, 0.75)]
    _four_on_floor(sb, mats)
    return cam


@register(8)
def scene_8(sb: SceneBuilder, cam):
    """Smooth SF11 glass bunny."""
    _bunny_scene(sb, Glass(kind="sf11", roughness=0.0))
    return cam


@register(9)
def scene_9(sb: SceneBuilder, cam):
    """Smooth plastic bunny, eta 1.8."""
    _bunny_scene(sb, Plastic(color=(1.0, 1.0, 1.0), eta=1.8, roughness=0.0))
    return cam


@register(10)
def scene_10(sb: SceneBuilder, cam):
    """Thin plastic bunny, eta 1.8."""
    _bunny_scene(sb, Plastic(color=(1.0, 1.0, 1.0), eta=1.8, roughness=0.0,
                             thin=True))
    return cam


@register(11)
def scene_11(sb: SceneBuilder, cam):
    """Rough SF11 glass bunny (roughness 0.2)."""
    _bunny_scene(sb, Glass(kind="sf11", roughness=0.2))
    return cam


@register(12)
def scene_12(sb: SceneBuilder, cam):
    """Four BK7 glass bunnies, roughness 0.05, 0.25, 0.5, 0.75."""
    add_cornell_box(sb)
    mats = [sb.add_material(Glass(kind="bk7", roughness=r))
            for r in (0.05, 0.25, 0.5, 0.75)]
    _four_on_floor(sb, mats)
    return cam


@register(13)
def scene_13(sb: SceneBuilder, cam):
    """Colored plastic bunny (linear rgb (0.4, 0.9, 1.0), eta 1.5)."""
    _bunny_scene(sb, Plastic(color=(0.4, 0.9, 1.0), eta=1.5, roughness=0.0))
    return cam


@register(14)
def scene_14(sb: SceneBuilder, cam):
    """Four colored plastic bunnies, roughness 0.05, 0.1, 0.3, 0.5."""
    add_cornell_box(sb)
    colors = [(1.0, 0.5, 0.5), (0.5, 1.0, 0.5), (0.5, 0.5, 1.0),
              (1.0, 0.8, 0.4)]
    roughs = (0.05, 0.1, 0.3, 0.5)
    mats = [sb.add_material(Plastic(color=c, eta=1.5, roughness=r))
            for c, r in zip(colors, roughs)]
    _four_on_floor(sb, mats)
    return cam


@register(15)
def scene_15(sb: SceneBuilder, cam):
    """PBR dragon with base color, metallic, roughness and normal maps."""
    _dragon_scene(sb, Pbr(
        base_color=_checker_texture(a=(0.8, 0.55, 0.3), b=(0.35, 0.4, 0.5),
                                    tiles=6),
        metallic=_metal_mask_texture(),
        roughness=_roughness_texture(),
        normal=_normal_map_texture(bumps=16, amp=0.3),
        eta=1.5))
    return cam


def _clearcoat(coat_roughness, coat_thickness=0.8):
    return Clearcoat(
        base_color=(0.8, 0.8, 0.8), metallic=1.0, roughness=0.7, eta=1.5,
        coat_eta=1.5, coat_roughness=coat_roughness,
        coat_tint=(0.7, 0.8, 1.0), coat_thickness=coat_thickness)


@register(16)
def scene_16(sb: SceneBuilder, cam):
    """Clearcoat PBR dragon (coat roughness 0.01)."""
    _dragon_scene(sb, _clearcoat(0.01))
    return cam


@register(17)
def scene_17(sb: SceneBuilder, cam):
    """Rough clearcoat dragon (coat roughness 0.75)."""
    _dragon_scene(sb, _clearcoat(0.75))
    return cam


@register(18)
def scene_18(sb: SceneBuilder, cam):
    """Clearcoat dragon with a coat-thickness map."""
    _dragon_scene(sb, _clearcoat(0.05, coat_thickness=_thickness_texture()))
    return cam


@register(19)
def scene_19(sb: SceneBuilder, cam):
    """PBR, clearcoat and plastic spheres on a floor under a sky (an
    environment light), no box."""
    s = common.BOX_HALF
    floor = sb.add_material(Lambert(albedo=(0.7, 0.7, 0.7)))
    sb.add_mesh(mesh.quad([-2 * s, 0, 2 * s], [2 * s, 0, 2 * s],
                          [2 * s, 0, -2 * s], [-2 * s, 0, -2 * s]), floor)
    m_pbr = sb.add_material(Pbr(base_color=(0.8, 0.3, 0.25), metallic=0.9,
                                roughness=0.25, eta=1.5))
    m_coat = sb.add_material(Clearcoat(base_color=(0.7, 0.7, 0.75),
                                       metallic=1.0, roughness=0.5,
                                       coat_roughness=0.02,
                                       coat_tint=(0.8, 0.9, 1.0),
                                       coat_thickness=0.5))
    m_plastic = sb.add_material(Plastic(color=(0.9, 0.85, 0.4), eta=1.49,
                                        roughness=0.05))
    sph = mesh.uv_sphere(0.45, 24, 48)
    sb.add_mesh(sph, m_pbr, translate(-1.0, 0.45, 0.0))
    sb.add_mesh(sph, m_coat, translate(0.0, 0.45, -0.6))
    sb.add_mesh(sph, m_plastic, translate(1.0, 0.45, 0.2))
    sb.add_env_light(_procedural_sky(), intensity=1.0)
    return cam.look_to((-1.5, 0.8, 2.5), (1.5, -0.4, -2.5))
