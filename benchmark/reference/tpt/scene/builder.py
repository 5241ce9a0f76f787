"""SceneBuilder: host-side scene description -> SceneData of tensors.

Counterpart of ``tpu_pathtracer/scene/builder.py``: the material
descriptors the benchmark's configurations reach (Lambert, Plastic, Pbr,
Clearcoat, Emissive; this copy leaves out the port's Metal and Glass),
textures decoded once at build, area lights from emissive meshes, point,
spot and directional lights, and one environment light with its
two-stage sampling CDFs, and instanced meshes (one stored copy under I
affine instances).

``build(camera_position)`` bakes all meshes into one triangle soup in
render space (world minus camera position), reorders it by one BVH
(in this frozen copy the reference's own, ``ops/bvh_ref.py``), builds each instanced mesh's object-space soup and BVH once,
and packs the material, light and spectra tables.
Spectra-bank row 0 is always the normalized D65.  The tables are numpy
computed as the JAX package computes them, so that both packages build the
same scene.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ..spectrum import cie, rgb2spec
from ..spectrum.grid import DENSE_LAMBDA, N_DENSE
from ..ops.bvh_ref import build_bvh
from .mesh import Mesh
from ..ops.trace import pack_bvh
from .types import (LIGHT_AREA, LIGHT_DIRECTIONAL, LIGHT_ENV, LIGHT_POINT,
                    LIGHT_SPOT, MAT_CLEARCOAT, MAT_EMISSIVE,
                    MAT_LAMBERT, MAT_PBR, MAT_PLASTIC, EnvMap,
                    InstancedGroup, LightTable, MaterialTable, SceneData,
                    SceneMeta)


def sah_bvh(tri_min: np.ndarray, tri_max: np.ndarray):
    """The reference's tree over (T, 3) triangle boxes (the program builds
    an SAH tree here; only the hits matter)."""
    return build_bvh(tri_min, tri_max)


@dataclasses.dataclass
class Texture:
    """An image parameter.

    data: (H, W, C) float array.  kind: "rgb" | "gray" | "normal".
    gamut / eotf: the color metadata of an rgb texture; the builder decodes
    the EOTF and converts to the scene's working gamut once, texel by
    texel.  eotf="linear" means the data is linear already.  Gray textures
    honor eotf only; normal maps ignore both."""
    data: np.ndarray
    kind: str = "rgb"
    gamut: str = "srgb"
    eotf: str = "linear"

    def __post_init__(self):
        self.data = np.asarray(self.data, np.float32)
        if self.data.ndim == 2:
            self.data = self.data[..., None]

    def decoded(self, scene_gamut) -> np.ndarray:
        """Linear data in the scene's working gamut."""
        from .. import color as color_mod
        from ..color import eotf as eotf_mod
        data = self.data
        if self.kind == "normal":
            return data
        if self.eotf != "linear":
            data = eotf_mod.decode(torch.from_numpy(data), self.eotf).numpy()
        if self.kind == "rgb" and self.gamut != scene_gamut.name:
            data = color_mod.convert_gamut(
                torch.from_numpy(np.asarray(data, np.float32)),
                color_mod.by_name(self.gamut), scene_gamut).numpy()
        return np.asarray(data, np.float32)


RGB = Tuple[float, float, float]
FloatParam = Union[float, Texture]
ColorParam = Union[RGB, Texture]


@dataclasses.dataclass
class Lambert:
    """Diffuse material."""
    albedo: ColorParam = (0.8, 0.8, 0.8)
    normal: Optional[Texture] = None


@dataclasses.dataclass
class Plastic:
    """Constant-eta dielectric with a color tint on transmission."""
    color: ColorParam = (0.8, 0.8, 0.8)
    roughness: FloatParam = 0.0
    eta: float = 1.5
    thin: bool = False


@dataclasses.dataclass
class Pbr:
    """Metallic/roughness PBR."""
    base_color: ColorParam = (0.8, 0.8, 0.8)
    metallic: FloatParam = 0.0
    roughness: FloatParam = 0.5
    eta: float = 1.5
    normal: Optional[Texture] = None


@dataclasses.dataclass
class Clearcoat:
    """PBR base + clearcoat layer."""
    base_color: ColorParam = (0.8, 0.8, 0.8)
    metallic: FloatParam = 0.0
    roughness: FloatParam = 0.5
    eta: float = 1.5
    normal: Optional[Texture] = None
    coat_tint: RGB = (1.0, 1.0, 1.0)
    coat_thickness: FloatParam = 1.0  # mm
    coat_roughness: float = 0.0
    coat_eta: float = 1.5


@dataclasses.dataclass
class Emissive:
    """Uniform emitter.  spectrum: a dense (470,) SPD, an RGB triple (an
    illuminant spectrum) or a Texture (a radiance texture)."""
    spectrum: Union[np.ndarray, RGB, Texture] = (1.0, 1.0, 1.0)
    intensity: float = 1.0


MaterialDesc = Union[Lambert, Plastic, Pbr, Clearcoat, Emissive]
_MATERIAL_TYPES = (Lambert, Plastic, Pbr, Clearcoat, Emissive)


class SceneBuilder:
    def __init__(self, table_res: int = 64, gamut: str = "srgb"):
        """``gamut``: the scene's working color space (material RGB values
        and, after conversion, textures are in it; the RGB->spectrum table
        is the one fitted for it)."""
        from ..color import by_name
        self.table_res = table_res
        self.gamut = by_name(gamut)
        self._materials: List[MaterialDesc] = []
        self._meshes: List[Tuple[Mesh, int]] = []
        self._instanced: List[Tuple[Mesh, List[Tuple[np.ndarray, int]]]] = []
        self._delta_lights: List[dict] = []
        self._env: Optional[dict] = None
        self._textures: List[Texture] = []

    # -- description API ----------------------------------------------------

    def add_material(self, desc: MaterialDesc) -> int:
        if not isinstance(desc, _MATERIAL_TYPES):
            raise NotImplementedError(
                f"material {type(desc).__name__} is not ported")
        self._materials.append(desc)
        return len(self._materials) - 1

    def add_mesh(self, mesh: Mesh, material: int, transform=None) -> None:
        if transform is not None:
            mesh = mesh.transformed(np.asarray(transform))
        self._meshes.append((mesh, material))

    def add_instances(self, mesh: Mesh, instances) -> None:
        """One mesh shared by many (4x4 transform, material) instances: its
        triangles and BVH are stored once, each instance adds an affine and
        a material row.  Emissive instance materials are refused (area
        lights are sampled on the main soup only)."""
        insts = [(np.asarray(t, np.float64), int(m)) for t, m in instances]
        if not insts:
            raise ValueError("add_instances needs at least one instance")
        for _, m in insts:
            if isinstance(self._materials[m], Emissive):
                raise ValueError("instanced meshes cannot be emissive")
        self._instanced.append((mesh, insts))

    def add_triangle(self, p0, p1, p2, material: int) -> None:
        """A single-triangle primitive, its tangent along the first edge."""
        pos = np.asarray([p0, p1, p2], np.float32)
        n = np.cross(pos[1] - pos[0], pos[2] - pos[0])
        n = n / max(np.linalg.norm(n), 1e-20)
        m = Mesh(positions=pos, normals=np.tile(n, (3, 1)).astype(np.float32),
                 uvs=np.zeros((3, 2), np.float32),
                 indices=np.asarray([[0, 1, 2]], np.int32),
                 tangents=np.zeros((1, 3), np.float32))
        t = pos[1] - pos[0]
        m.tangents[0] = t / max(np.linalg.norm(t), 1e-20)
        self._meshes.append((m, material))

    def add_point_light(self, position, spectrum, intensity: float) -> None:
        """Point light; phi = 4 pi I."""
        self._delta_lights.append(dict(
            type=LIGHT_POINT, position=np.asarray(position, np.float32),
            spectrum=self._dense(spectrum), intensity=float(intensity)))

    def add_spot_light(self, position, direction, angle_inner: float,
                       angle_outer: float, spectrum, intensity: float) -> None:
        """Spot light around ``direction``, with a smoothstep falloff in
        cos-angle space between the outer and the inner cone."""
        d = np.asarray(direction, np.float64)
        d = d / np.linalg.norm(d)
        self._delta_lights.append(dict(
            type=LIGHT_SPOT, position=np.asarray(position, np.float32),
            direction=d.astype(np.float32), spectrum=self._dense(spectrum),
            intensity=float(intensity), angle_inner=float(angle_inner),
            angle_outer=float(angle_outer)))

    def add_directional_light(self, direction, spectrum,
                              intensity: float) -> None:
        """Directional light; ``direction`` points toward the light."""
        d = np.asarray(direction, np.float64)
        d = d / np.linalg.norm(d)
        self._delta_lights.append(dict(
            type=LIGHT_DIRECTIONAL, direction=d.astype(np.float32),
            spectrum=self._dense(spectrum), intensity=float(intensity)))

    def add_env_light(self, rgb_image: np.ndarray, intensity: float = 1.0,
                      rotation_deg: float = 0.0) -> None:
        """Equirect HDR environment light; one per scene (the MIS pdf of an
        escape sums over environment lights, and that sum is this one)."""
        if self._env is not None:
            raise ValueError("scene already has an environment light; "
                             "only one is supported")
        img = np.asarray(rgb_image, np.float32) * intensity
        self._env = dict(rgb=img, rotation=float(np.radians(rotation_deg)))

    # -- helpers ------------------------------------------------------------

    def _dense(self, spectrum) -> np.ndarray:
        if isinstance(spectrum, np.ndarray) and spectrum.shape == (N_DENSE,):
            return np.asarray(spectrum, np.float32)
        if isinstance(spectrum, (tuple, list)) and len(spectrum) == 3:
            # rgb -> illuminant spectrum baked to the dense grid
            return self._rgb_to_illum_dense(np.asarray(spectrum))
        raise TypeError(f"bad spectrum {type(spectrum)}")

    def _table(self):
        return rgb2spec.get_table(self.gamut.name, res=self.table_res)

    def _rgb_to_illum_dense(self, rgb) -> np.ndarray:
        """RGB -> illuminant spectrum on the dense grid (float32)."""
        zn, coeffs = self._table()
        lam = torch.tensor(DENSE_LAMBDA, dtype=torch.float32)[None, :]
        out = rgb2spec.illuminant_eval(
            torch.tensor(np.asarray(rgb, np.float32))[None, :], lam,
            torch.tensor(zn), torch.tensor(coeffs), cie.illum_d6500())
        return out.numpy()[0]

    def _rgb_coeff(self, rgb) -> np.ndarray:
        zn, coeffs = self._table()
        c = rgb2spec.lookup_coeffs(
            torch.tensor(np.asarray(rgb, np.float32))[None, :],
            torch.tensor(zn), torch.tensor(coeffs))
        return c.numpy()[0]

    def _add_texture(self, tex: Optional[Texture]) -> int:
        if tex is None:
            return -1
        self._textures.append(tex)
        return len(self._textures) - 1

    def _color_param(self, p: ColorParam):
        """-> (coeff (3,), texture id)"""
        if isinstance(p, Texture):
            return np.zeros(3, np.float32), self._add_texture(p)
        return self._rgb_coeff(p), -1

    def _float_param(self, p: FloatParam):
        if isinstance(p, Texture):
            return 0.0, self._add_texture(p)
        return float(p), -1

    # -- compile ------------------------------------------------------------

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
                mt["base_coeff"][i], mt["base_tex"][i] = \
                    self._color_param(d.albedo)
                mt["normal_tex"][i] = self._add_texture(d.normal)
            elif isinstance(d, Plastic):
                mt["mat_type"][i] = MAT_PLASTIC
                mt["base_coeff"][i], mt["base_tex"][i] = \
                    self._color_param(d.color)
                mt["roughness"][i], mt["roughness_tex"][i] = \
                    self._float_param(d.roughness)
                mt["const_eta"][i] = d.eta
                mt["thin"][i] = int(d.thin)
            elif isinstance(d, Pbr):
                mt["mat_type"][i] = MAT_PBR
                mt["base_coeff"][i], mt["base_tex"][i] = \
                    self._color_param(d.base_color)
                mt["metallic"][i], mt["metallic_tex"][i] = \
                    self._float_param(d.metallic)
                mt["roughness"][i], mt["roughness_tex"][i] = \
                    self._float_param(d.roughness)
                mt["const_eta"][i] = d.eta
                mt["normal_tex"][i] = self._add_texture(d.normal)
            elif isinstance(d, Clearcoat):
                mt["mat_type"][i] = MAT_CLEARCOAT
                mt["base_coeff"][i], mt["base_tex"][i] = \
                    self._color_param(d.base_color)
                mt["metallic"][i], mt["metallic_tex"][i] = \
                    self._float_param(d.metallic)
                mt["roughness"][i], mt["roughness_tex"][i] = \
                    self._float_param(d.roughness)
                mt["const_eta"][i] = d.eta
                mt["normal_tex"][i] = self._add_texture(d.normal)
                mt["coat_tint_coeff"][i] = self._rgb_coeff(d.coat_tint)
                (mt["coat_thickness"][i],
                 mt["coat_thickness_tex"][i]) = \
                    self._float_param(d.coat_thickness)
                mt["coat_roughness"][i] = d.coat_roughness
                mt["coat_eta"][i] = d.coat_eta
            else:
                mt["mat_type"][i] = MAT_EMISSIVE
                if isinstance(d.spectrum, Texture):
                    mt["emission_tex"][i] = self._add_texture(d.spectrum)
                    # the light's power uses the average texel
                    avg = d.spectrum.data.reshape(-1, 3).mean(0)
                    mt["emission_row"][i] = bank_row(
                        self._rgb_to_illum_dense(avg))
                else:
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

        fb = sah_bvh(P.min(1), P.max(1))
        o = fb.order
        P, N, UV, TAN, MATID, PRIM = P[o], N[o], UV[o], TAN[o], MATID[o], PRIM[o]
        bvh = pack_bvh(fb, P)

        built = [self._build_group(mesh, insts, cam_pos)
                 for mesh, insts in self._instanced]
        groups = [g for g, _, _ in built]

        # world bounding sphere (directional and env power, env distance),
        # the instances' world AABBs (float64, before rounding) included
        lo, hi = P.reshape(-1, 3).min(0), P.reshape(-1, 3).max(0)
        if built:
            lo = np.minimum(lo, np.concatenate([b[1] for b in built]).min(0))
            hi = np.maximum(hi, np.concatenate([b[2] for b in built]).max(0))
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
                type=LIGHT_AREA, spectrum_row=int(mt["emission_row"][mat_id]),
                intensity=float(mt["emission_scale"][mat_id]),
                phi_scale=total, area_first=first, area_n=len(sel),
                area_total=total, mat_id=mat_id))

        for dl in self._delta_lights:
            row = bank_row(dl["spectrum"])
            if dl["type"] == LIGHT_POINT:
                lights.append(dict(
                    type=LIGHT_POINT, spectrum_row=row,
                    intensity=dl["intensity"],
                    position=dl["position"] - cam_pos,
                    phi_scale=4.0 * np.pi * dl["intensity"]))
            elif dl["type"] == LIGHT_SPOT:
                ai, ao = dl["angle_inner"], dl["angle_outer"]
                # analytic integral of the cone's falloff
                phi = 2.0 * np.pi * ((1.0 - np.cos(ai))
                                     + (np.cos(ai) - np.cos(ao)) / 2.0)
                lights.append(dict(
                    type=LIGHT_SPOT, spectrum_row=row,
                    intensity=dl["intensity"],
                    position=dl["position"] - cam_pos,
                    direction=dl["direction"],
                    cos_inner=float(np.cos(ai)), cos_outer=float(np.cos(ao)),
                    angle_inner=ai, angle_outer=ao,
                    phi_scale=float(phi) * dl["intensity"]))
            else:
                # power through the scene bounding sphere's cross-section
                lights.append(dict(
                    type=LIGHT_DIRECTIONAL, spectrum_row=row,
                    intensity=dl["intensity"], direction=dl["direction"],
                    phi_scale=float(np.pi * world_radius ** 2)
                    * dl["intensity"]))

        env = None
        if self._env is not None:
            img = self._env["rgb"]
            h, w = img.shape[:2]
            # luminance * sin(theta) importance: a row CDF and one column
            # CDF per row
            lum = img @ np.asarray([0.2126, 0.7152, 0.0722])
            sin_t = np.sin((np.arange(h) + 0.5) / h * np.pi)
            weights = lum * sin_t[:, None] + 1e-12
            row_sum = weights.sum(1)
            marginal = np.cumsum(row_sum) / row_sum.sum()
            conditional = np.cumsum(weights, 1) / weights.sum(1, keepdims=True)
            # the solid-angle (sin theta) weighted average radiance
            avg_rgb = ((img * sin_t[:, None, None]).sum((0, 1))
                       / (sin_t.sum() * w))
            env = EnvMap(
                rgb=torch.from_numpy(np.array(img, np.float32)),
                marginal_cdf=torch.from_numpy(np.asarray(marginal, np.float32)),
                conditional_cdf=torch.from_numpy(
                    np.asarray(conditional, np.float32)),
                avg_rgb=torch.from_numpy(np.asarray(avg_rgb, np.float32)),
                rotation=torch.tensor(self._env["rotation"],
                                      dtype=torch.float32))
            # power: the average spectrum over a sphere of the scene's size
            avg_row = bank_row(self._rgb_to_illum_dense(avg_rgb))
            lights.append(dict(
                type=LIGHT_ENV, spectrum_row=avg_row, intensity=1.0,
                phi_scale=float(4.0 * np.pi * np.pi * world_radius ** 2)))

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
            lt["light_type"][i] = l["type"]
            lt["spectrum_row"][i] = l["spectrum_row"]
            lt["intensity"][i] = l.get("intensity", 0.0)
            lt["phi_scale"][i] = l.get("phi_scale", 0.0)
            if "position" in l:
                lt["position"][i] = l["position"]
            if "direction" in l:
                lt["direction"][i] = l["direction"]
            if "cos_inner" in l:
                lt["cos_inner"][i] = l["cos_inner"]
                lt["cos_outer"][i] = l["cos_outer"]
                lt["angle_inner"][i] = l["angle_inner"]
                lt["angle_outer"][i] = l["angle_outer"]
            if "area_first" in l:
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
            textures=tuple(t(x.decoded(self.gamut)) for x in self._textures),
            env=env,
            world_radius=t(world_radius, np.float32),
            rs_zn=t(zn),
            rs_coeffs=t(coeffs),
            instanced=tuple(groups),
        )
        meta = SceneMeta(
            mat_types=tuple(int(x) for x in mt["mat_type"]),
            light_types=tuple(int(l["type"]) for l in lights),
            n_tris=len(P),
            has_env=env is not None,
            texture_shapes=tuple(tuple(x.data.shape) for x in self._textures),
            max_area_tris=max([l["area_n"] for l in lights
                               if "area_first" in l], default=1),
            has_emission_tex=bool((mt["emission_tex"] >= 0).any()),
        )
        return data, meta

    @staticmethod
    def _build_group(mesh: Mesh, insts, cam_pos):
        """The canonical object-space soup ordered by its own SAH BVH, its
        attribute rows, and per instance the render-space affine rows
        (``fwd``, ``inv``; the translation made camera-relative) and the
        world AABB of the 8 transformed corners of the mesh's box.
        -> (InstancedGroup, AABB lows (I, 3) f64, AABB highs (I, 3) f64)."""
        idx = mesh.indices
        P = mesh.positions[idx].astype(np.float64)
        N = mesh.normals[idx].astype(np.float32)
        UV = mesh.uvs[idx].astype(np.float32)
        TAN = mesh.tangents.astype(np.float32)
        fb = sah_bvh(P.min(1), P.max(1))
        o = fb.order
        P, N, UV, TAN = P[o], N[o], UV[o], TAN[o]
        gbvh = pack_bvh(fb, P.astype(np.float32))
        attr = np.concatenate(
            [N.reshape(len(P), 9), UV.reshape(len(P), 6), TAN],
            axis=1).astype(np.float32)
        lo_o = P.reshape(-1, 3).min(0)
        hi_o = P.reshape(-1, 3).max(0)
        corners = np.array([[x, y, z]
                            for x in (lo_o[0], hi_o[0])
                            for y in (lo_o[1], hi_o[1])
                            for z in (lo_o[2], hi_o[2])])
        fwd, inv, mats, g_lo, g_hi = [], [], [], [], []
        for t4, m in insts:
            a = t4[:3, :3]
            tr = t4[:3, 3] - cam_pos               # render space
            ai = np.linalg.inv(a)
            fwd.append(np.concatenate([a.reshape(9), tr]))
            inv.append(np.concatenate([ai.reshape(9), -ai @ tr]))
            mats.append(m)
            wc = corners @ a.T + tr
            g_lo.append(wc.min(0))
            g_hi.append(wc.max(0))

        def f32(rows):
            return torch.from_numpy(np.asarray(np.stack(rows), np.float32))
        group = InstancedGroup(
            bvh=gbvh, tri_attr=torch.from_numpy(attr),
            fwd=f32(fwd), inv=f32(inv),
            mat_id=torch.from_numpy(np.asarray(mats, np.int32)),
            aabb_min=f32(g_lo), aabb_max=f32(g_hi))
        return group, np.stack(g_lo), np.stack(g_hi)
