"""SceneBuilder: host-side scene description -> SceneData of tensors.

Counterpart of ``tpu_pathtracer/scene/builder.py`` for the materials and
lights of the ported slice: Lambert, Clearcoat and Emissive materials
(constant colors, dense emission spectra) and the area lights that
emissive meshes make.  Anything else raises ``NotImplementedError``.

``build(camera_position)`` bakes all meshes into one triangle soup in
render space (world minus camera position), reorders it by one SAH BVH
(the pure-numpy builder), and packs the material, light and spectra
tables.  Spectra-bank row 0 is always the normalized D65.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from ..spectrum import cie, rgb2spec
from ..spectrum.grid import N_DENSE
from .bvh import build_bvh
from .mesh import Mesh
from ..ops.trace import pack_bvh
from .types import (LIGHT_AREA, MAT_CLEARCOAT, MAT_EMISSIVE, MAT_LAMBERT,
                    LightTable, MaterialTable, SceneData, SceneMeta)

RGB = Tuple[float, float, float]


@dataclasses.dataclass
class Lambert:
    """Diffuse material (constant albedo)."""
    albedo: RGB = (0.8, 0.8, 0.8)


@dataclasses.dataclass
class Clearcoat:
    """PBR base + clearcoat layer (constant parameters)."""
    base_color: RGB = (0.8, 0.8, 0.8)
    metallic: float = 0.0
    roughness: float = 0.5
    eta: float = 1.5
    coat_tint: RGB = (1.0, 1.0, 1.0)
    coat_thickness: float = 1.0  # mm
    coat_roughness: float = 0.0
    coat_eta: float = 1.5


@dataclasses.dataclass
class Emissive:
    """Uniform emitter; spectrum: a dense (470,) SPD."""
    spectrum: np.ndarray
    intensity: float = 1.0


class SceneBuilder:
    def __init__(self, table_res: int = 64, gamut: str = "srgb"):
        from ..color import by_name
        self.table_res = table_res
        self.gamut = by_name(gamut)
        self._materials: list = []
        self._meshes: List[Tuple[Mesh, int]] = []

    def add_material(self, desc) -> int:
        if not isinstance(desc, (Lambert, Clearcoat, Emissive)):
            raise NotImplementedError(
                f"material {type(desc).__name__} is not ported yet")
        self._materials.append(desc)
        return len(self._materials) - 1

    def add_mesh(self, mesh: Mesh, material: int, transform=None) -> None:
        if transform is not None:
            mesh = mesh.transformed(np.asarray(transform))
        self._meshes.append((mesh, material))

    def _table(self):
        return rgb2spec.get_table(self.gamut.name, res=self.table_res)

    def _rgb_coeff(self, rgb) -> np.ndarray:
        zn, coeffs = self._table()
        c = rgb2spec.lookup_coeffs(
            torch.tensor(np.asarray(rgb, np.float32))[None, :],
            torch.tensor(zn), torch.tensor(coeffs))
        return c.numpy()[0]

    @staticmethod
    def _dense(spectrum) -> np.ndarray:
        s = np.asarray(spectrum)
        if s.shape != (N_DENSE,):
            raise NotImplementedError(
                "emission other than a dense (470,) spectrum is not ported yet")
        return s.astype(np.float32)

    def build(self, camera_position) -> Tuple[SceneData, SceneMeta]:
        """Compile the scene into CPU tensors (``.to(device)`` moves it)."""
        cam_pos = np.asarray(camera_position, np.float64)

        bank: List[np.ndarray] = [cie.illum_d6500().astype(np.float32)]

        def bank_row(dense: np.ndarray) -> int:
            bank.append(np.asarray(dense, np.float32))
            return len(bank) - 1

        M = len(self._materials)
        mt = dict(
            mat_type=np.zeros(M, np.int32),
            base_coeff=np.zeros((M, 3), np.float32),
            base_tex=np.full(M, -1, np.int32),
            roughness=np.zeros(M, np.float32),
            roughness_tex=np.full(M, -1, np.int32),
            metallic=np.zeros(M, np.float32),
            metallic_tex=np.full(M, -1, np.int32),
            normal_tex=np.full(M, -1, np.int32),
            eta_row=np.full(M, -1, np.int32),
            k_row=np.full(M, -1, np.int32),
            const_eta=np.full(M, 1.5, np.float32),
            thin=np.zeros(M, np.int32),
            emission_row=np.full(M, -1, np.int32),
            emission_scale=np.zeros(M, np.float32),
            emission_tex=np.full(M, -1, np.int32),
            coat_tint_coeff=np.zeros((M, 3), np.float32),
            coat_thickness=np.zeros(M, np.float32),
            coat_thickness_tex=np.full(M, -1, np.int32),
            coat_roughness=np.zeros(M, np.float32),
            coat_eta=np.full(M, 1.5, np.float32),
        )
        for i, d in enumerate(self._materials):
            if isinstance(d, Lambert):
                mt["mat_type"][i] = MAT_LAMBERT
                mt["base_coeff"][i] = self._rgb_coeff(d.albedo)
            elif isinstance(d, Clearcoat):
                mt["mat_type"][i] = MAT_CLEARCOAT
                mt["base_coeff"][i] = self._rgb_coeff(d.base_color)
                mt["metallic"][i] = d.metallic
                mt["roughness"][i] = d.roughness
                mt["const_eta"][i] = d.eta
                mt["coat_tint_coeff"][i] = self._rgb_coeff(d.coat_tint)
                mt["coat_thickness"][i] = d.coat_thickness
                mt["coat_roughness"][i] = d.coat_roughness
                mt["coat_eta"][i] = d.coat_eta
            else:
                mt["mat_type"][i] = MAT_EMISSIVE
                mt["emission_row"][i] = bank_row(self._dense(d.spectrum))
                mt["emission_scale"][i] = d.intensity

        # all meshes -> one world-space triangle soup
        if not self._meshes:
            raise ValueError("scene has no geometry")
        pos_list, n_list, uv_list, tan_list, mat_list, prim_list = \
            [], [], [], [], [], []
        for prim_id, (mesh, mat_id) in enumerate(self._meshes):
            idx = mesh.indices
            pos_list.append(mesh.positions[idx])
            n_list.append(mesh.normals[idx])
            uv_list.append(mesh.uvs[idx])
            tan_list.append(mesh.tangents)
            mat_list.append(np.full(len(idx), mat_id, np.int32))
            prim_list.append(np.full(len(idx), prim_id, np.int32))
        P = np.concatenate(pos_list, 0).astype(np.float64)
        N = np.concatenate(n_list, 0).astype(np.float32)
        UV = np.concatenate(uv_list, 0).astype(np.float32)
        TAN = np.concatenate(tan_list, 0).astype(np.float32)
        MATID = np.concatenate(mat_list, 0)
        PRIM = np.concatenate(prim_list, 0)

        # render space: subtract the camera position
        P = (P - cam_pos).astype(np.float32)

        fb = build_bvh(P.min(1), P.max(1))
        o = fb.order
        P, N, UV, TAN, MATID, PRIM = P[o], N[o], UV[o], TAN[o], MATID[o], PRIM[o]
        bvh = pack_bvh(fb, P)

        lo, hi = P.reshape(-1, 3).min(0), P.reshape(-1, 3).max(0)
        world_radius = float(np.linalg.norm(hi - lo) / 2.0) or 1.0

        # area lights: one per emissive-material primitive
        lights: List[dict] = []
        tri_light = np.full(len(P), -1, np.int32)
        area_tri, area_area, area_cdf = [], [], []
        for prim_id, (mesh, mat_id) in enumerate(self._meshes):
            if mt["mat_type"][mat_id] != MAT_EMISSIVE:
                continue
            sel = np.nonzero(PRIM == prim_id)[0]           # leaf-order rows
            e1 = P[sel, 1] - P[sel, 0]
            e2 = P[sel, 2] - P[sel, 0]
            areas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
            total = float(areas.sum())
            cdf = np.cumsum(areas) / max(total, 1e-20)
            tri_light[sel] = len(lights)
            first = len(area_tri)
            area_tri.extend(sel.tolist())
            area_area.extend(areas.tolist())
            area_cdf.extend(cdf.tolist())
            lights.append(dict(
                spectrum_row=int(mt["emission_row"][mat_id]),
                intensity=float(mt["emission_scale"][mat_id]),
                phi_scale=total, area_first=first, area_n=len(sel),
                area_total=total, mat_id=mat_id))

        L = max(len(lights), 1)
        lt = dict(
            light_type=np.full(L, -1, np.int32),
            position=np.zeros((L, 3), np.float32),
            direction=np.tile(np.asarray([0.0, 0.0, 1.0], np.float32), (L, 1)),
            spectrum_row=np.zeros(L, np.int32),
            intensity=np.zeros(L, np.float32),
            cos_inner=np.ones(L, np.float32),
            cos_outer=np.zeros(L, np.float32),
            angle_inner=np.zeros(L, np.float32),
            angle_outer=np.zeros(L, np.float32),
            phi_scale=np.zeros(L, np.float32),
            area_first_tri=np.full(L, -1, np.int32),
            area_n_tris=np.zeros(L, np.int32),
            area_total=np.zeros(L, np.float32),
            mat_id=np.full(L, -1, np.int32),
        )
        for i, l in enumerate(lights):
            lt["light_type"][i] = LIGHT_AREA
            lt["spectrum_row"][i] = l["spectrum_row"]
            lt["intensity"][i] = l["intensity"]
            lt["phi_scale"][i] = l["phi_scale"]
            lt["area_first_tri"][i] = l["area_first"]
            lt["area_n_tris"][i] = l["area_n"]
            lt["area_total"][i] = l["area_total"]
            lt["mat_id"][i] = l["mat_id"]

        zn, coeffs = self._table()
        tri_attr = np.concatenate(
            [N.reshape(len(P), 9), UV.reshape(len(P), 6), TAN],
            axis=1).astype(np.float32)

        def t(a, dtype=None):
            return torch.from_numpy(np.array(a, dtype=dtype))

        data = SceneData(
            bvh=bvh,
            tri_attr=t(tri_attr),
            tri_mat=t(MATID), tri_light=t(tri_light),
            materials=MaterialTable(**{k: t(v) for k, v in mt.items()}),
            lights=LightTable(**{k: t(v) for k, v in lt.items()}),
            spectra=t(np.stack(bank, 0)),
            area_tri=t(np.asarray(area_tri, np.int32).reshape(-1)),
            area_tri_area=t(np.asarray(area_area, np.float32).reshape(-1)),
            area_tri_cdf=t(np.asarray(area_cdf, np.float32).reshape(-1)),
            world_radius=t(world_radius, np.float32),
            rs_zn=t(zn),
            rs_coeffs=t(coeffs),
        )
        meta = SceneMeta(
            mat_types=tuple(int(x) for x in mt["mat_type"]),
            light_types=tuple(LIGHT_AREA for _ in lights),
            n_tris=len(P),
            has_env=False,
            texture_shapes=(),
            max_area_tris=max([l["area_n"] for l in lights], default=1),
            has_emission_tex=False,
        )
        return data, meta
