"""Compiled scene representation: dataclasses of tensors.

Counterpart of ``tpu_pathtracer/scene/types.py``, with the same field
names.  ``SceneData`` and its tables are frozen dataclasses of tensors with
``.to(device)``; ``SceneMeta`` is a small hashable record of static facts.
The slice carries the main triangle soup only (no textures, environment
map or instanced groups).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

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
# the material kinds this port renders
PORTED_MAT_KINDS = frozenset((MAT_LAMBERT, MAT_METAL, MAT_CLEARCOAT,
                              MAT_EMISSIVE))

# light kind tags
LIGHT_AREA = 0
LIGHT_POINT = 1
LIGHT_SPOT = 2
LIGHT_DIRECTIONAL = 3
LIGHT_ENV = 4


class _Tensors:
    """``.to(device)`` over every tensor field, recursively."""

    def to(self, device):
        def move(v):
            # tensors, tables and the BVH all have .to(device)
            return v.to(device) if hasattr(v, "to") else v
        return dataclasses.replace(
            self, **{f.name: move(getattr(self, f.name))
                     for f in dataclasses.fields(self)})


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
    world_radius: torch.Tensor   # () f32
    rs_zn: torch.Tensor          # (res,) rgb2spec z nodes
    rs_coeffs: torch.Tensor      # (3, res, res, res, 3)

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
    """Raise NotImplementedError for scene features outside the port."""
    missing = set(meta.mat_types) - PORTED_MAT_KINDS
    if missing:
        names = sorted(MAT_NAMES[k] for k in missing)
        raise NotImplementedError(
            f"materials {names} are not ported yet (ported: lambert, "
            "metal, clearcoat, emissive)")
    if any(t != LIGHT_AREA for t in meta.light_types):
        raise NotImplementedError(
            "delta and environment lights are not ported yet (area lights only)")
    if meta.has_env:
        raise NotImplementedError("environment maps are not ported yet")
    if meta.texture_shapes or meta.has_emission_tex:
        raise NotImplementedError("textures are not ported yet")
