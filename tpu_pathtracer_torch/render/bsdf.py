"""Material sample / evaluate with tag dispatch, for the ported materials.

Counterpart of ``tpu_pathtracer/render/bsdf.py`` restricted to Lambert,
the clearcoat (generalized-Schlick coat over the simple-PBR substrate with
Beer-Lambert tint) and emission; a scene with any other material kind
raises ``NotImplementedError``.  Each kind present in the scene is
evaluated over the whole ray batch and merged by ``mat_type`` masks.

Conventions (as in the JAX package): directions live in the vertex
shading-tangent frame (+Z = shading normal); f includes |cos theta_i|;
opaque materials reject samples on the other side of the geometric
normal.  The ported materials carry no textures, so there is no
normal-map frame.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..scene.types import (MAT_CLEARCOAT, MAT_EMISSIVE, MAT_LAMBERT,
                           PORTED_MAT_KINDS, MAT_NAMES)
from ..spectrum import grid as sgrid
from ..spectrum import rgb2spec
from ..spectrum.sampled import SampledWavelengths, terminate_secondary
from ..utils.vec import (Frame, S4, V2, V3, dot3, normalize3, s4_mean,
                         sel, smap, to_frame)
from . import microfacet as mf

INV_PI = 1.0 / math.pi
SMOOTH_ALPHA = 1e-3   # effectively-smooth threshold


class MaterialSample(NamedTuple):
    f: S4                   # BSDF value (cosine included)
    wi_t: V3                # sampled direction, vertex-tangent space
    pdf: torch.Tensor       # (R,)
    sampled: torch.Tensor   # (R,) bool
    specular: torch.Tensor  # (R,) bool
    wl: SampledWavelengths


def _check_kinds(meta) -> set:
    kinds = set(meta.present_mat_kinds)
    missing = kinds - PORTED_MAT_KINDS
    if missing:
        raise NotImplementedError(
            f"materials {sorted(MAT_NAMES[k] for k in missing)} are not "
            "ported yet (ported: lambert, clearcoat, emissive)")
    return kinds


def _bank_eval(scene, row, wl) -> S4:
    """Spectra-bank row at the path wavelengths (needs ``wl.bank``)."""
    return sgrid.bank_pick(wl.bank, row)


def _s4_ones(like) -> S4:
    one = torch.ones_like(like)
    return S4(one, one, one, one)


def _albedo_spectrum(scene, it, wl) -> S4:
    """Base color as an S4 reflectance (constant colors only)."""
    return rgb2spec.sigmoid_poly_s4(scene.materials.base_coeff[it.mat_id.long()],
                                    wl.lam)


def sample_cosine_hemisphere(uv: V2) -> V3:
    r = torch.sqrt(uv.x)
    theta = 2.0 * math.pi * uv.y
    z = torch.sqrt(torch.clamp(1.0 - uv.x, min=0.0))
    return V3(r * torch.cos(theta), r * torch.sin(theta), z)


def _mirror(v: V3) -> V3:
    return V3(-v.x, -v.y, v.z)


def _flip_z(v: V3, flip) -> V3:
    return V3(v.x, v.y, torch.where(flip, -v.z, v.z))


# ---------------------------------------------------------------------------
# Lambert
# ---------------------------------------------------------------------------

def _lambert_sample(scene, it, wo_t, uv2, wl):
    albedo = _albedo_spectrum(scene, it, wl)
    wi = sample_cosine_hemisphere(uv2)
    wi = _flip_z(wi, wo_t.z < 0.0)
    cos_i = torch.abs(wi.z)
    f = albedo * (cos_i * INV_PI)
    pdf = cos_i * INV_PI
    ok = (wo_t.z != 0.0) & (wi.z != 0.0)
    return f, wi, pdf, ok


def _lambert_eval(scene, it, wo_t, wi_t, wl):
    albedo = _albedo_spectrum(scene, it, wl)
    cos_o = wo_t.z
    cos_i = wi_t.z
    same = (torch.sign(cos_o) == torch.sign(cos_i)) & (cos_o != 0.0) & (cos_i != 0.0)
    f = albedo * torch.where(same, torch.abs(cos_i) * INV_PI, 0.0)
    pdf = torch.where(same, torch.abs(cos_i) * INV_PI, 0.0)
    return f, pdf


# ---------------------------------------------------------------------------
# Generalized Schlick, R-only (PBR lobes and the coat)
# ---------------------------------------------------------------------------

def _schlick_fresnel(cos_theta, r0: S4, r90: S4, exponent, tint: S4) -> S4:
    """F = r0 + (r90-r0)(1-cos)^exp - a cos (1-cos)^6 (Lazanyi dip term)."""
    c = torch.clamp(cos_theta, 0.0, 1.0)
    omc = 1.0 - c
    cos_max = 1.0 / 7.0
    omc_max = 1.0 - cos_max
    base = r0 + (r90 - r0) * omc ** exponent
    f_max = r0 + (r90 - r0) * (omc_max ** exponent)
    a = f_max * (1.0 - tint) * (1.0 / (cos_max * omc_max ** 6))
    return base - a * (c * omc ** 6)


def _schlick_r_sample(wo, uv2, alpha, r0, r90, tint, exponent=5.0):
    """Sample the R-only lobe (smooth -> delta); local frame."""
    smooth = alpha < SMOOTH_ALPHA
    wi_s = _mirror(wo)
    f_s = _schlick_fresnel(torch.abs(wi_s.z), r0, r90, exponent, tint)
    wm = mf.sample_vndf(wo, uv2, alpha, alpha)
    wi_m = mf.reflect(wo, wm)
    same = mf.same_hemisphere(wo, wi_m)
    cos_o = torch.clamp(torch.abs(wo.z), min=1e-12)
    fres = _schlick_fresnel(torch.abs(dot3(wo, wm)), r0, r90, exponent, tint)
    d = mf.distribution_d(wm, alpha, alpha)
    g = mf.g2(wo, wi_m, alpha, alpha)
    f_m = fres * (d * g / (4.0 * cos_o))
    pdf_m = mf.vndf_pdf(wo, wm, alpha, alpha) / torch.clamp(
        4.0 * torch.abs(dot3(wo, wm)), min=1e-12)

    zero4 = smap(torch.zeros_like, f_m)
    f = sel(smooth, f_s, sel(same, f_m, zero4))
    wi = sel(smooth, wi_s, wi_m)
    pdf = torch.where(smooth, 1.0, pdf_m)
    ok = (wo.z != 0.0) & (smooth | (same & (pdf_m > 0.0)))
    return f, wi, pdf, ok, smooth


def _schlick_r_eval(wo, wi, alpha, r0, r90, tint, exponent=5.0):
    smooth = alpha < SMOOTH_ALPHA
    wm = wo + wi
    ok = (~smooth) & mf.same_hemisphere(wo, wi) & (dot3(wm, wm) > 0.0) & \
        (wo.z != 0.0) & (wi.z != 0.0)
    wm = normalize3(wm)
    cos_o = torch.clamp(torch.abs(wo.z), min=1e-12)
    fres = _schlick_fresnel(torch.abs(dot3(wo, wm)), r0, r90, exponent, tint)
    d = mf.distribution_d(wm, alpha, alpha)
    g = mf.g2(wo, wi, alpha, alpha)
    f = fres * (d * g / (4.0 * cos_o))
    pdf = mf.vndf_pdf(wo, wm, alpha, alpha) / torch.clamp(
        4.0 * torch.abs(dot3(wo, wm)), min=1e-12)
    return smap(lambda x: torch.where(ok, x, 0.0), f), torch.where(ok, pdf, 0.0)


# ---------------------------------------------------------------------------
# SimplePbr substrate: metallic Schlick lobe + (Schlick specular / Lambert)
# ---------------------------------------------------------------------------

def _pbr_params(scene, it, wl):
    m = scene.materials
    mat = it.mat_id.long()
    base = _albedo_spectrum(scene, it, wl)
    metallic = m.metallic[mat]
    rough = m.roughness[mat]
    alpha = rough * rough
    ior = m.const_eta[mat]
    r = (ior - 1.0) / (ior + 1.0)
    r2 = r * r
    return base, metallic, alpha, S4(r2, r2, r2, r2)


def _pbr_sample(wo, uc, uc2, uv2, params):
    """uc <= metallic -> metal lobe; else dielectric with a Fresnel-weighted
    specular (uc2 < F) / diffuse choice.  Local frame."""
    base, metallic, alpha, r0_diel = params
    one = _s4_ones(wo.z)

    pick_metal = uc <= metallic
    f_m, wi_m, pdf_m, ok_m, spec_m = _schlick_r_sample(wo, uv2, alpha,
                                                       base, one, one)
    fbar = s4_mean(_schlick_fresnel(torch.abs(wo.z), r0_diel, one, 5.0, one))
    pick_spec = uc2 < fbar
    f_s, wi_s, pdf_s, ok_s, spec_s = _schlick_r_sample(wo, uv2, alpha,
                                                       r0_diel, one, one)
    pdf_s = pdf_s * fbar
    wi_d = sample_cosine_hemisphere(uv2)
    wi_d = _flip_z(wi_d, wo.z < 0.0)
    cos_d = torch.abs(wi_d.z)
    f_d = base * (cos_d * INV_PI * (1.0 - fbar))
    pdf_d = cos_d * INV_PI * (1.0 - fbar)
    ok_d = (wo.z != 0.0) & (wi_d.z != 0.0)

    f = sel(pick_metal, f_m, sel(pick_spec, f_s, f_d))
    wi = sel(pick_metal, wi_m, sel(pick_spec, wi_s, wi_d))
    pdf = torch.where(pick_metal, pdf_m, torch.where(pick_spec, pdf_s, pdf_d))
    ok = torch.where(pick_metal, ok_m, torch.where(pick_spec, ok_s, ok_d))
    spec = torch.where(pick_metal, spec_m,
                       torch.where(pick_spec, spec_s, False))
    return f, wi, pdf, ok, spec


def _pbr_eval(wo, wi, params):
    """Metallic lerp of the metal lobe and (Schlick + (1-F) Lambert)."""
    base, metallic, alpha, r0_diel = params
    one = _s4_ones(wo.z)
    f_metal, pdf_metal = _schlick_r_eval(wo, wi, alpha, base, one, one)
    f_spec, pdf_spec = _schlick_r_eval(wo, wi, alpha, r0_diel, one, one)
    fbar = s4_mean(_schlick_fresnel(torch.abs(wo.z), r0_diel, one, 5.0, one))
    cos_o, cos_i = wo.z, wi.z
    same = (torch.sign(cos_o) == torch.sign(cos_i)) & (cos_o != 0.0) & (cos_i != 0.0)
    f_lamb = base * torch.where(same, torch.abs(cos_i) * INV_PI, 0.0)
    pdf_lamb = torch.where(same, torch.abs(cos_i) * INV_PI, 0.0)

    f_diel = f_spec + f_lamb * (1.0 - fbar)
    pdf_diel = fbar * pdf_spec + (1.0 - fbar) * pdf_lamb
    return f_metal * metallic + f_diel * (1.0 - metallic), \
        metallic * pdf_metal + (1.0 - metallic) * pdf_diel


# ---------------------------------------------------------------------------
# Clearcoat: Schlick coat over the PBR substrate with Beer-Lambert tint
# ---------------------------------------------------------------------------

def _coat_params(scene, it, wl):
    m = scene.materials
    mat = it.mat_id.long()
    thickness = m.coat_thickness[mat]
    coat_alpha = m.coat_roughness[mat] ** 2
    ior = m.coat_eta[mat]
    rr = (ior - 1.0) / (ior + 1.0)
    r2 = rr * rr
    r0 = S4(r2, r2, r2, r2)
    tint = rgb2spec.sigmoid_poly_s4(m.coat_tint_coeff[mat], wl.lam)
    return thickness, coat_alpha, r0, tint


def _beer_lambert(tint: S4, thickness_mm, cos_theta) -> S4:
    """exp(-sigma L), sigma = -ln(tint)/1mm, L = thickness/cos."""
    l = thickness_mm * 0.001 / torch.clamp(cos_theta, min=1e-4)
    return smap(lambda t: torch.exp(torch.log(torch.clamp(t, min=1e-6))
                                    * (l / 0.001)), tint)


def _clearcoat_sample(scene, it, wo_t, uc, uc2, uc3, uv2, wl):
    """Coat vs substrate chosen by the coat's analytic Schlick albedo at
    wo; uc picks coat/substrate, uc2 the substrate's metal lobe, uc3 its
    specular/diffuse split."""
    wo = wo_t
    one = _s4_ones(wo.z)
    thickness, coat_alpha, coat_r0, tint = _coat_params(scene, it, wl)
    params = _pbr_params(scene, it, wl)

    e_coat = s4_mean(_schlick_fresnel(torch.abs(wo.z), coat_r0, one, 5.0, one))
    has_coat = thickness > 0.0
    e_coat = torch.where(has_coat, e_coat, 0.0)
    pick_coat = uc < e_coat

    f_c, wi_c, pdf_c, ok_c, spec_c = _schlick_r_sample(wo, uv2, coat_alpha,
                                                       coat_r0, one, one)
    pdf_c = pdf_c * e_coat

    f_b, wi_b, pdf_b, ok_b, spec_b = _pbr_sample(wo, uc2, uc3, uv2, params)
    att = _beer_lambert(tint, thickness, torch.abs(wo.z)) * \
        _beer_lambert(tint, thickness, torch.abs(wi_b.z))
    att = sel(has_coat, att, one)
    f_b = f_b * att
    pdf_b = pdf_b * torch.where(has_coat, 1.0 - e_coat, 1.0)

    f = sel(pick_coat, f_c, f_b)
    wi = sel(pick_coat, wi_c, wi_b)
    pdf = torch.where(pick_coat, pdf_c, pdf_b)
    ok = torch.where(pick_coat, ok_c, ok_b)
    spec = torch.where(pick_coat, spec_c, spec_b)
    return f, wi, pdf, ok, spec


def _clearcoat_eval(scene, it, wo_t, wi_t, wl):
    """f = f_coat + att * f_substrate; pdf lerped by the coat albedo."""
    wo, wi = wo_t, wi_t
    one = _s4_ones(wo.z)
    thickness, coat_alpha, coat_r0, tint = _coat_params(scene, it, wl)
    has_coat = thickness > 0.0

    f_c, pdf_c = _schlick_r_eval(wo, wi, coat_alpha, coat_r0, one, one)
    e_coat = s4_mean(_schlick_fresnel(torch.abs(wo.z), coat_r0, one, 5.0, one))
    e_coat = torch.where(has_coat, e_coat, 0.0)

    f_b, pdf_b = _pbr_eval(wo, wi, _pbr_params(scene, it, wl))
    att = _beer_lambert(tint, thickness, torch.abs(wo.z)) * \
        _beer_lambert(tint, thickness, torch.abs(wi.z))
    att = sel(has_coat, att, one)

    zero4 = smap(torch.zeros_like, f_c)
    f = sel(has_coat, f_c, zero4) + f_b * att
    pdf = e_coat * pdf_c + (1.0 - e_coat) * pdf_b
    return f, pdf


# ---------------------------------------------------------------------------
# Public dispatch API
# ---------------------------------------------------------------------------

def _geo_sidedness(it, frame: Frame, wo_t: V3, wi_t: V3):
    """sign(wo . ng) must equal sign(wi . ng), in the vertex-tangent frame."""
    ng_t = to_frame(frame, it.geo_n)
    co = dot3(wo_t, ng_t)
    ci = dot3(wi_t, ng_t)
    return torch.sign(co) == torch.sign(ci)


def _mat_type(scene, it):
    return scene.materials.mat_type[it.mat_id.long()]


def sample_material(scene, meta, it, frame: Frame, wo_t: V3, uc, uv2: V2,
                    wl, uc2, uc3) -> MaterialSample:
    """Batched material sample over all rays.

    uc / uc2 / uc3: independent 1-D draws for up to three sequential lobe
    decisions; uv2: the 2-D lobe sample."""
    kinds = _check_kinds(meta)
    r = uc.shape[0]
    mat_type = _mat_type(scene, it)

    zero = torch.zeros_like(uc)
    f = S4(zero, zero, zero, zero)
    wi_t = V3(zero, zero, torch.ones_like(uc))
    pdf = zero
    sampled = torch.zeros(r, dtype=torch.bool, device=uc.device)
    specular = torch.zeros_like(sampled)

    def merge(m, kf, kwi, kpdf, kok, kspec):
        nonlocal f, wi_t, pdf, sampled, specular
        f = sel(m, kf, f)
        wi_t = sel(m, kwi, wi_t)
        pdf = torch.where(m, kpdf, pdf)
        sampled = torch.where(m, kok, sampled)
        specular = torch.where(m, kspec, specular)

    if MAT_LAMBERT in kinds:
        lf, lwi, lpdf, lok = _lambert_sample(scene, it, wo_t, uv2, wl)
        merge(mat_type == MAT_LAMBERT, lf, lwi, lpdf, lok,
              torch.zeros_like(sampled))
    if MAT_CLEARCOAT in kinds:
        cf, cwi, cpdf, cok, cspec = _clearcoat_sample(scene, it, wo_t, uc,
                                                      uc2, uc3, uv2, wl)
        merge(mat_type == MAT_CLEARCOAT, cf, cwi, cpdf, cok, cspec)

    # no ported material is dispersive: terminate nothing
    out_wl = terminate_secondary(wl, torch.zeros_like(sampled))

    opaque = (mat_type == MAT_LAMBERT) | (mat_type == MAT_CLEARCOAT)
    side_ok = _geo_sidedness(it, frame, wo_t, wi_t)
    sampled = sampled & (~opaque | side_ok)
    return MaterialSample(f=f, wi_t=wi_t, pdf=pdf, sampled=sampled,
                          specular=specular, wl=out_wl)


def evaluate_material(scene, meta, it, frame: Frame, wo_t: V3, wi_t: V3, wl):
    """Batched evaluate + pdf (used by NEE).  Returns (f S4, pdf (R,))."""
    kinds = _check_kinds(meta)
    mat_type = _mat_type(scene, it)
    zero = torch.zeros_like(wo_t.z)
    f = S4(zero, zero, zero, zero)
    pdf = zero

    def merge(m, kf, kpdf):
        nonlocal f, pdf
        f = sel(m, kf, f)
        pdf = torch.where(m, kpdf, pdf)

    if MAT_LAMBERT in kinds:
        lf, lpdf = _lambert_eval(scene, it, wo_t, wi_t, wl)
        merge(mat_type == MAT_LAMBERT, lf, lpdf)
    if MAT_CLEARCOAT in kinds:
        cf, cpdf = _clearcoat_eval(scene, it, wo_t, wi_t, wl)
        merge(mat_type == MAT_CLEARCOAT, cf, cpdf)

    opaque = (mat_type == MAT_LAMBERT) | (mat_type == MAT_CLEARCOAT)
    keep = ~opaque | _geo_sidedness(it, frame, wo_t, wi_t)
    return smap(lambda x: torch.where(keep, x, 0.0), f), torch.where(keep, pdf, 0.0)


def is_bsdf_material(scene, it):
    """(R,) bool -- emissive-only surfaces end paths."""
    return _mat_type(scene, it) != MAT_EMISSIVE


def emission_spectral(scene, meta, mat_id, uv: V2, wl) -> S4:
    """Radiance spectrum x intensity for material rows ``mat_id``, no
    emissive-type gating (constant spectra only)."""
    if meta.has_emission_tex:
        raise NotImplementedError("textured emission is not ported yet")
    m = scene.materials
    mat = mat_id.long()
    row = m.emission_row[mat]
    scale = m.emission_scale[mat]
    le_bank = _bank_eval(scene, torch.clamp(row, min=0), wl)
    le = smap(lambda x: torch.where(row >= 0, x, 0.0), le_bank)
    return le * scale


def emitted_radiance(scene, meta, it, wl) -> S4:
    """Le at an emissive hit, S4."""
    le = emission_spectral(scene, meta, it.mat_id, it.uv, wl)
    is_emissive = _mat_type(scene, it) == MAT_EMISSIVE
    return smap(lambda x: torch.where(is_emissive, x, 0.0), le)
