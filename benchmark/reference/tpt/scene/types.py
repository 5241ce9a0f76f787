"""Compiled scene representation: dataclasses of tensors.

Counterpart of ``tpu_pathtracer/scene/types.py``, with the same field
names.  ``SceneData`` and its tables are frozen dataclasses of tensors with
``.to(device)``; ``SceneMeta`` is a small hashable record of static facts.
The port carries the main triangle soup, its textures, the environment
map and the instanced groups (one object-space mesh under I affine
instances each).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from ..ops.trace import BVHArrays

# material kind tags (mat_type column)
MAT_LAMBERT = 0
MAT_METAL = 1
MAT_GLASS = 2
MAT_PLASTIC = 3
MAT_PBR = 4
MAT_CLEARCOAT = 5
MAT_EMISSIVE = 6

MAT_NAMES = {
    MAT_LAMBERT: "lambert", MAT_METAL: "metal", MAT_GLASS: "glass",
    MAT_PLASTIC: "plastic", MAT_PBR: "pbr", MAT_CLEARCOAT: "clearcoat",
    MAT_EMISSIVE: "emissive",
}

# light kind tags
LIGHT_AREA = 0
LIGHT_POINT = 1
LIGHT_SPOT = 2
LIGHT_DIRECTIONAL = 3
LIGHT_ENV = 4

LIGHT_NAMES = {
    LIGHT_AREA: "area", LIGHT_POINT: "point", LIGHT_SPOT: "spot",
    LIGHT_DIRECTIONAL: "directional", LIGHT_ENV: "environment",
}


def map_tensors(fn, x):
    """``x`` -- a tensor, or tuples and dataclasses of them (a scene, its
    tables, the BVH) -- with every tensor ``t`` replaced by ``fn(t)``, in
    field order; anything else is kept as it is."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, tuple):
        return tuple(map_tensors(fn, v) for v in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: map_tensors(fn, getattr(x, f.name))
            for f in dataclasses.fields(x)})
    return x


def tensors_of(x) -> list:
    """The tensors of ``x``, in ``map_tensors``'s order."""
    out = []
    map_tensors(lambda t: out.append(t) or t, x)
    return out


class _Tensors:
    """``.map(fn)`` and ``.to(device)`` over every tensor field,
    recursively."""

    def map(self, fn):
        return map_tensors(fn, self)

    def to(self, device):
        return self.map(lambda t: t.to(device))


@dataclasses.dataclass(frozen=True)
class MaterialTable(_Tensors):
    """One row per material instance; unused columns hold zeros/-1."""
    mat_type: torch.Tensor       # (M,) i32
    base_coeff: torch.Tensor     # (M, 3) sigmoid coeffs of base color/albedo
    base_tex: torch.Tensor       # (M,) i32 texture id, -1 = use base_coeff
    roughness: torch.Tensor      # (M,) f32
    roughness_tex: torch.Tensor  # (M,) i32
    metallic: torch.Tensor       # (M,) f32
    metallic_tex: torch.Tensor   # (M,) i32
    normal_tex: torch.Tensor     # (M,) i32
    eta_row: torch.Tensor        # (M,) i32
    k_row: torch.Tensor          # (M,) i32
    const_eta: torch.Tensor      # (M,) f32
    thin: torch.Tensor           # (M,) i32
    emission_row: torch.Tensor   # (M,) i32 spectra-bank row of radiance SPD
    emission_scale: torch.Tensor  # (M,) f32
    emission_tex: torch.Tensor   # (M,) i32
    coat_tint_coeff: torch.Tensor   # (M, 3)
    coat_thickness: torch.Tensor    # (M,) f32 (mm)
    coat_thickness_tex: torch.Tensor  # (M,) i32
    coat_roughness: torch.Tensor    # (M,) f32
    coat_eta: torch.Tensor          # (M,) f32


@dataclasses.dataclass(frozen=True)
class LightTable(_Tensors):
    """One row per light primitive (SoA)."""
    light_type: torch.Tensor     # (L,) i32
    position: torch.Tensor       # (L, 3)
    direction: torch.Tensor      # (L, 3)
    spectrum_row: torch.Tensor   # (L,) i32 row in spectra bank
    intensity: torch.Tensor      # (L,) f32
    cos_inner: torch.Tensor      # (L,) f32
    cos_outer: torch.Tensor      # (L,) f32
    angle_inner: torch.Tensor    # (L,) f32
    angle_outer: torch.Tensor    # (L,) f32
    phi_scale: torch.Tensor      # (L,) f32 power factor (area: area sum)
    area_first_tri: torch.Tensor  # (L,) i32 first row in area_tri_* (-1)
    area_n_tris: torch.Tensor     # (L,) i32
    area_total: torch.Tensor      # (L,) f32 total area
    mat_id: torch.Tensor          # (L,) i32 emissive material row


@dataclasses.dataclass(frozen=True)
class EnvMap(_Tensors):
    """Equirect HDR environment with its two-stage sampling CDFs."""
    rgb: torch.Tensor              # (H, W, 3) linear rgb
    marginal_cdf: torch.Tensor     # (H,) row CDF
    conditional_cdf: torch.Tensor  # (H, W) per-row column CDF
    avg_rgb: torch.Tensor          # (3,) sin(theta)-weighted average color
    rotation: torch.Tensor         # () f32 azimuth rotation (radians)


@dataclasses.dataclass(frozen=True)
class InstancedGroup(_Tensors):
    """One canonical mesh shared by I transformed instances.

    The mesh is stored once, in object space, with its own BVH; a query
    transforms the rays into every instance's object space (directions
    left unnormalized, so t is the render-space ray parameter) and traces
    all I x R lanes in one kernel launch, lanes outside an instance's world
    AABB dead.  A hit in the group has the composite triangle id
    ``base + inst * Tc + tri`` past the main soup (``render/surface.py``
    decodes it).  Instances are never emissive (the builder refuses it).
    """
    bvh: BVHArrays               # canonical object-space mesh
    tri_attr: torch.Tensor       # (Tc, 18) canonical shading attributes
    fwd: torch.Tensor            # (I, 12) object->render affine rows [A|t]
    inv: torch.Tensor            # (I, 12) render->object affine rows [A|t]
    mat_id: torch.Tensor         # (I,) i32 material row per instance
    aabb_min: torch.Tensor       # (I, 3) render-space instance AABB
    aabb_max: torch.Tensor       # (I, 3)


@dataclasses.dataclass(frozen=True)
class SceneData(_Tensors):
    """Everything the integrator needs, as tensors."""
    bvh: BVHArrays
    # packed per-triangle shading attributes in BVH leaf order:
    # [n0 n1 n2 | uv0 uv1 uv2 | tangent] = (T, 18)
    tri_attr: torch.Tensor
    tri_mat: torch.Tensor        # (T,) i32 material row
    tri_light: torch.Tensor      # (T,) i32 area-light row or -1
    materials: MaterialTable
    lights: LightTable
    spectra: torch.Tensor        # (K, 470) dense spectra bank (row 0 = D65)
    area_tri: torch.Tensor       # (AT,) i32 triangle id (leaf order)
    area_tri_area: torch.Tensor  # (AT,) f32
    area_tri_cdf: torch.Tensor   # (AT,) f32 per-light CDF
    textures: Tuple[torch.Tensor, ...]  # each (H, W, C) f32, decoded
    env: Optional[EnvMap]
    world_radius: torch.Tensor   # () f32
    rs_zn: torch.Tensor          # (res,) rgb2spec z nodes
    rs_coeffs: torch.Tensor      # (3, res, res, res, 3)
    instanced: Tuple[InstancedGroup, ...] = ()

    @property
    def device(self) -> torch.device:
        return self.tri_attr.device


class SceneMeta(NamedTuple):
    """Static (hashable) facts the integrator specializes on."""
    mat_types: Tuple[int, ...]
    light_types: Tuple[int, ...]
    n_tris: int
    has_env: bool
    texture_shapes: Tuple[Tuple[int, ...], ...]
    max_area_tris: int = 1
    has_emission_tex: bool = False

    @property
    def present_mat_kinds(self) -> Tuple[int, ...]:
        return tuple(sorted(set(self.mat_types)))

    @property
    def n_lights(self) -> int:
        return len(self.light_types)


def check_ported(meta: SceneMeta) -> None:
    """Raise NotImplementedError for a material or light kind the port
    does not know."""
    unknown = sorted(set(meta.mat_types) - set(MAT_NAMES))
    if unknown:
        raise NotImplementedError(f"material kinds {unknown} are not ported")
    unknown = sorted(set(meta.light_types) - set(LIGHT_NAMES))
    if unknown:
        raise NotImplementedError(f"light kinds {unknown} are not ported")
