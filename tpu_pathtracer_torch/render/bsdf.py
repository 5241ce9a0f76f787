"""Material sample / evaluate with tag dispatch.

Counterpart of ``tpu_pathtracer/render/bsdf.py``: Lambert, the
measured-IOR conductor (metal), the dielectrics (glass: dispersive and
untinted; plastic: tinted, constant eta; smooth, rough and thin forms),
PBR, the clearcoat (generalized-Schlick coat over the PBR substrate with
Beer-Lambert tint) and emission, with textured albedo, roughness,
metallic, coat thickness and emission and the normal-map frame.  As torch
ops, each kind present in the scene is evaluated over the whole ray batch
and merged by ``mat_type`` masks; ``sample_material`` and
``evaluate_material`` run instead, where ``uses_kernel`` says so (an
untextured scene on a CUDA device, no gradient through the material
table), one CUDA kernel each that runs every lane's own kind alone, bit
for bit the torch ops (``ops.bsdf_kernels``).

Conventions (as in the JAX package): directions live in the vertex
shading-tangent frame (+Z = shading normal); f includes |cos theta_i|;
a normal map rotates into a second frame inside each material; opaque
materials reject samples on the other side of the geometric normal.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..scene.types import (MAT_CLEARCOAT, MAT_EMISSIVE, MAT_GLASS,
                           MAT_LAMBERT, MAT_METAL, MAT_PBR, MAT_PLASTIC,
                           tensors_of)
from ..spectrum import grid as sgrid
from ..spectrum import rgb2spec
from ..spectrum.sampled import SampledWavelengths, terminate_secondary
from ..ops import bsdf_kernels
from ..ops.table_grad import gather_rows
from ..utils.math import M32
from ..utils.vec import (Frame, S4, V2, V3, dot3, from_frame, make_frame,
                         normalize3, s4_mean, sel, smap, to_frame)
from . import microfacet as mf
from . import texture as tex_mod
from .sampler import _fmix32

INV_PI = 1.0 / math.pi
SMOOTH_ALPHA = 1e-3   # effectively-smooth threshold


class MaterialSample(NamedTuple):
    f: S4                   # BSDF value (cosine included)
    wi_t: V3                # sampled direction, vertex-tangent space
    pdf: torch.Tensor       # (R,)
    sampled: torch.Tensor   # (R,) bool
    specular: torch.Tensor  # (R,) bool
    wl: SampledWavelengths  # dispersion may have terminated the secondaries


# ---------------------------------------------------------------------------
# Shared helpers
# ---------------------------------------------------------------------------

def _hash_unit(u, salt: int):
    """A uniform draw from the bits of the float32 draw u, for a caller
    that omits uc2/uc3: the MurmurHash3 finalizer of bits(u) ^ salt, as a
    float in [0, 1] (the JAX package's ``_hash_unit``, bit for bit)."""
    bits = u.to(torch.float32).view(torch.int32).to(torch.int64) & M32
    h = _fmix32(bits ^ salt)
    return h.to(torch.float32) * (2.0 ** -32)


def _bank_eval(scene, row, wl) -> S4:
    """Spectra-bank row at the path wavelengths (needs ``wl.bank``)."""
    return sgrid.bank_pick(wl.bank, row)


def _s4_ones(like) -> S4:
    one = torch.ones_like(like)
    return S4(one, one, one, one)


def _texture(scene, tex_ids, uv: V2, n_channels: int, default):
    return tex_mod.sample_indexed(scene.textures, tex_ids, uv, n_channels,
                                  default)


def _textured_float(scene, it, value, tex_col):
    """A float parameter: the material's constant, or its gray texture at
    the hit where it has one."""
    mat = it.mat_id.long()
    value = gather_rows(value, mat)
    if scene.textures:
        tex_ids = tex_col[mat]
        t = _texture(scene, tex_ids, it.uv, 1, [0.0])[:, 0]
        value = torch.where(tex_ids >= 0, t, value)
    return value


def _albedo_spectrum(scene, it, wl) -> S4:
    """Base color as an S4 reflectance: constant colors were resolved to
    sigmoid coefficients at build; a texel is looked up in the table."""
    m = scene.materials
    mat = it.mat_id.long()
    coeff = gather_rows(m.base_coeff, mat)
    if scene.textures:
        tex_ids = m.base_tex[mat]
        rgb = _texture(scene, tex_ids, it.uv, 3, [0.0, 0.0, 0.0])
        tex_coeff = rgb2spec.lookup_coeffs(rgb, scene.rs_zn, scene.rs_coeffs)
        coeff = torch.where((tex_ids >= 0)[:, None], tex_coeff, coeff)
    return rgb2spec.sigmoid_poly_s4(coeff, wl.lam)


def _normal_map_frame(scene, it):
    """Per-ray normal-map rotation within the vertex-tangent frame: a Frame
    N with v_nm = to_frame(N, v_t), the identity where the material has no
    normal map; None when the scene has no textures."""
    if not scene.textures:
        return None
    tex_ids = scene.materials.normal_tex[it.mat_id.long()]
    raw = _texture(scene, tex_ids, it.uv, 3, [0.5, 0.5, 1.0])
    n = normalize3(V3(raw[:, 0] * 2.0 - 1.0, raw[:, 1] * 2.0 - 1.0,
                      raw[:, 2] * 2.0 - 1.0))
    z = torch.zeros_like(n.x)
    n = sel(tex_ids >= 0, n, V3(z, z, torch.ones_like(n.x)))
    # the frame around the perturbed normal keeps +X as its tangent
    return make_frame(n, V3(torch.ones_like(n.x), z, z))


def _nm_to(nm_frame, v: V3) -> V3:
    return to_frame(nm_frame, v) if nm_frame is not None else v


def _nm_from(nm_frame, v: V3) -> V3:
    return from_frame(nm_frame, v) if nm_frame is not None else v


def _smooth_split(alpha):
    """(smooth, the alpha of the microfacet branch): a lane below
    SMOOTH_ALPHA takes the delta branch, and the microfacet branch it also
    computes, then discards, runs at alpha 1 there.  Its value at the
    lane's own alpha (infinite D at alpha 0, as on every lane of a kind
    that has no roughness) is discarded all the same, but would pass a NaN
    into the gradient (0 x inf in the backward of the discarding select).
    No kept value changes."""
    smooth = alpha < SMOOTH_ALPHA
    return smooth, torch.where(smooth, 1.0, alpha)


def _roughness(scene, it):
    m = scene.materials
    return _textured_float(scene, it, m.roughness, m.roughness_tex)


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

def _lambert_sample(scene, it, wo_t, uv2, wl, nm_frame=None):
    albedo = _albedo_spectrum(scene, it, wl)
    wo_nm = _nm_to(nm_frame, wo_t)
    wi_nm = sample_cosine_hemisphere(uv2)
    wi_nm = _flip_z(wi_nm, wo_nm.z < 0.0)
    cos_i = torch.abs(wi_nm.z)
    f = albedo * (cos_i * INV_PI)
    pdf = cos_i * INV_PI
    ok = (wo_nm.z != 0.0) & (wi_nm.z != 0.0)
    return f, _nm_from(nm_frame, wi_nm), pdf, ok


def _lambert_eval(scene, it, wo_t, wi_t, wl, nm_frame=None):
    albedo = _albedo_spectrum(scene, it, wl)
    cos_o = _nm_to(nm_frame, wo_t).z
    cos_i = _nm_to(nm_frame, wi_t).z
    same = (torch.sign(cos_o) == torch.sign(cos_i)) & (cos_o != 0.0) & (cos_i != 0.0)
    f = albedo * torch.where(same, torch.abs(cos_i) * INV_PI, 0.0)
    pdf = torch.where(same, torch.abs(cos_i) * INV_PI, 0.0)
    return f, pdf


# ---------------------------------------------------------------------------
# Conductor / Metal
# ---------------------------------------------------------------------------

def _metal_eta_k(scene, it, wl):
    m = scene.materials
    mat = it.mat_id.long()
    eta = _bank_eval(scene, torch.clamp(m.eta_row[mat], min=0), wl)
    k = _bank_eval(scene, torch.clamp(m.k_row[mat], min=0), wl)
    return eta, k


def _torrance_sparrow_f(wo, wi, wm, eta, k, alpha):
    cos_o = torch.abs(wo.z)
    fres = mf.fresnel_complex(torch.abs(dot3(wo, wm)), eta, k)
    d = mf.distribution_d(wm, alpha, alpha)
    g = mf.g2(wo, wi, alpha, alpha)
    return fres * torch.where(cos_o > 0.0,
                              d * g / torch.clamp(4.0 * cos_o, min=1e-12), 0.0)


def _metal_sample(scene, it, wo_t, uv2, wl, nm_frame=None):
    eta, k = _metal_eta_k(scene, it, wl)
    rough = _roughness(scene, it)
    alpha = rough * rough
    smooth, alpha = _smooth_split(alpha)
    wo = _nm_to(nm_frame, wo_t)

    # specular branch: wi = mirror, f = F, pdf = 1
    wi_s = _mirror(wo)
    f_s = mf.fresnel_complex(torch.abs(wi_s.z), eta, k)

    # microfacet branch
    wm = mf.sample_vndf(wo, uv2, alpha, alpha)
    wi_m = mf.reflect(wo, wm)
    same = mf.same_hemisphere(wo, wi_m)
    f_m = _torrance_sparrow_f(wo, wi_m, wm, eta, k, alpha)
    pdf_m = mf.vndf_pdf(wo, wm, alpha, alpha) / torch.clamp(
        4.0 * torch.abs(dot3(wo, wm)), min=1e-12)

    zero4 = smap(torch.zeros_like, f_m)
    f = sel(smooth, f_s, sel(same, f_m, zero4))
    wi = sel(smooth, wi_s, wi_m)
    pdf = torch.where(smooth, 1.0, pdf_m)
    ok = (wo.z != 0.0) & (smooth | (same & (pdf_m > 0.0)))
    return f, _nm_from(nm_frame, wi), pdf, ok, smooth


def _metal_eval(scene, it, wo_t, wi_t, wl, nm_frame=None):
    eta, k = _metal_eta_k(scene, it, wl)
    rough = _roughness(scene, it)
    alpha = rough * rough
    smooth, alpha = _smooth_split(alpha)
    wo = _nm_to(nm_frame, wo_t)
    wi = _nm_to(nm_frame, wi_t)
    wm = wo + wi
    ok = (~smooth) & mf.same_hemisphere(wo, wi) & (dot3(wm, wm) > 0.0) & \
        (wo.z != 0.0) & (wi.z != 0.0)
    wm = normalize3(wm)
    f = _torrance_sparrow_f(wo, wi, wm, eta, k, alpha)
    pdf = mf.vndf_pdf(wo, wm, alpha, alpha) / torch.clamp(
        4.0 * torch.abs(dot3(wo, wm)), min=1e-12)
    return smap(lambda x: torch.where(ok, x, 0.0), f), torch.where(ok, pdf, 0.0)


# ---------------------------------------------------------------------------
# Dielectrics: glass (measured dispersive eta) and plastic (constant eta,
# tinted transmission)
# ---------------------------------------------------------------------------

def _dielectric_eta(scene, it, wl, dispersive: bool) -> S4:
    """S4 absolute IOR of the medium."""
    m = scene.materials
    mat = it.mat_id.long()
    if dispersive:
        return _bank_eval(scene, torch.clamp(m.eta_row[mat], min=0), wl)
    e = m.const_eta[mat]
    return S4(e, e, e, e)


def _refl_trans_probs(avg_fresnel, thin):
    """(pr, pt); a thin surface uses the geometric series of its internal
    reflections for pr."""
    r = avg_fresnel
    t = 1.0 - r
    r2 = r * r
    r_thin = torch.where(r2 > 1.0, 1.0,
                         r + (t * t * r) / torch.clamp(1.0 - r2, min=1e-12))
    return torch.where(thin, r_thin, r), t


def _dielectric_sample(scene, it, wo_t, uc, uv2, wl, nm_frame,
                       dispersive: bool, tinted: bool):
    """Returns (f, wi_t, pdf, ok, specular, terminate); ``terminate`` marks
    the dispersive transmissions that collapse the secondary wavelengths."""
    n_abs = _dielectric_eta(scene, it, wl, dispersive)
    entering = dot3(it.geo_n, it.wo) > 0.0
    thin = scene.materials.thin[it.mat_id.long()] > 0
    alpha = _roughness(scene, it)          # raw roughness, not squared
    smooth, alpha = _smooth_split(alpha)

    wo = _nm_to(nm_frame, wo_t)

    # relative IOR: entering or thin -> n, leaving -> 1/n
    ent = entering | thin
    eta_rel = smap(lambda n: torch.where(ent, n, 1.0 / n), n_abs)
    eta_scalar = eta_rel.a

    # ---- smooth ------------------------------------------------------------
    zero = torch.zeros_like(uc)
    n_vec = V3(zero, zero, torch.where(entering, 1.0, -1.0))
    fres_s = mf.fresnel_dielectric(torch.abs(wo.z), eta_rel)
    pr_s, pt_s = _refl_trans_probs(s4_mean(fres_s), thin)
    sum_s = torch.clamp(pr_s + pt_s, min=1e-12)
    choose_refl_s = uc < pr_s / sum_s
    wi_refl = _mirror(wo)
    wt, refract_ok = mf.refract(wo, n_vec, eta_scalar)
    # transmit: thin -> (1-F); solid -> (1-F)/eta^2 (radiance scaling)
    one_m_f = 1.0 - fres_s
    f_trans_s = sel(thin, one_m_f, one_m_f * (1.0 / (eta_scalar ** 2)))
    wi_s = sel(choose_refl_s, wi_refl, sel(thin, -wo, wt))
    f_s = sel(choose_refl_s, fres_s, f_trans_s)
    pdf_s = torch.where(choose_refl_s, pr_s / sum_s, pt_s / sum_s)
    ok_s = torch.where(choose_refl_s, torch.abs(wo.z) > 1e-6,
                       thin | refract_ok)

    # ---- rough -------------------------------------------------------------
    wm = mf.sample_vndf(wo, uv2, alpha, alpha)
    fres_m = mf.fresnel_dielectric(torch.abs(dot3(wo, wm)), eta_rel)
    pr_m, pt_m = _refl_trans_probs(s4_mean(fres_m), thin)
    sum_m = torch.clamp(pr_m + pt_m, min=1e-12)
    choose_refl_m = uc < pr_m / sum_m

    # reflection lobe: f = F D G / (4 cos_o)
    wi_mr = mf.reflect(wo, wm)
    same_r = mf.same_hemisphere(wo, wi_mr)
    d = mf.distribution_d(wm, alpha, alpha)
    g_r = mf.g2(wo, wi_mr, alpha, alpha)
    cos_o = torch.clamp(torch.abs(wo.z), min=1e-12)
    prob_r = pr_m / sum_m
    f_mr = fres_m * (d * g_r / (4.0 * cos_o))
    pdf_mr = mf.vndf_pdf(wo, wm, alpha, alpha) / torch.clamp(
        4.0 * torch.abs(dot3(wo, wm)), min=1e-12) * prob_r
    ok_mr = same_r & (torch.abs(dot3(wo, wm)) > 1e-6)

    # transmission lobe; thin rough transmission passes straight through
    wm_refr = sel(entering, wm, -wm)
    wi_mt, refr_ok_m = mf.refract(wo, wm_refr, eta_scalar)
    prob_t = pt_m / sum_m
    wi_mt = sel(thin, -wo, wi_mt)
    denom = (dot3(wi_mt, wm) + dot3(wo, wm) / eta_scalar) ** 2
    dwm_dwi = torch.abs(dot3(wi_mt, wm)) / torch.clamp(denom, min=1e-12)
    g_t = mf.g2(wo, wi_mt, alpha, alpha)
    f_mt_solid = (1.0 - fres_m) * (
        d * g_t * torch.abs(dot3(wi_mt, wm)) * torch.abs(dot3(wo, wm))
        / (torch.clamp(denom, min=1e-12) * cos_o * eta_scalar ** 2))
    pdf_mt_solid = mf.vndf_pdf(wo, wm, alpha, alpha) * dwm_dwi * prob_t
    f_mt = sel(thin, 1.0 - fres_m, f_mt_solid)
    pdf_mt = torch.where(thin, prob_t, pdf_mt_solid)
    ok_mt = thin | (refr_ok_m & ~mf.same_hemisphere(wo, wi_mt)
                    & (torch.abs(wi_mt.z) > 0.0))

    wi_m = sel(choose_refl_m, wi_mr, wi_mt)
    f_m = sel(choose_refl_m, f_mr, f_mt)
    pdf_m = torch.where(choose_refl_m, pdf_mr, pdf_mt)
    ok_m = torch.where(choose_refl_m, ok_mr, ok_mt)

    # ---- merge smooth / rough ---------------------------------------------
    choose_refl = torch.where(smooth, choose_refl_s, choose_refl_m)
    wi = sel(smooth, wi_s, wi_m)
    f = sel(smooth, f_s, f_m)
    pdf = torch.where(smooth, pdf_s, pdf_m)
    ok = torch.where(smooth, ok_s, ok_m) & (wo.z != 0.0)

    if tinted:
        # the plastic's color tints transmission (at the surface uv)
        tint = _albedo_spectrum(scene, it, wl)
        transmitted = (dot3(wi, wo) < 0.0) & ~choose_refl
        f = sel(transmitted, f * tint, f)

    terminate = (~choose_refl & ok) if dispersive else torch.zeros_like(ok)
    return f, _nm_from(nm_frame, wi), pdf, ok, smooth, terminate


def _dielectric_eval(scene, it, wo_t, wi_t, wl, nm_frame, dispersive: bool,
                     tinted: bool):
    """f and pdf of a rough dielectric; zero for a smooth one (a delta)."""
    n_abs = _dielectric_eta(scene, it, wl, dispersive)
    entering = dot3(it.geo_n, it.wo) > 0.0
    thin = scene.materials.thin[it.mat_id.long()] > 0
    alpha = _roughness(scene, it)
    smooth, alpha = _smooth_split(alpha)

    wo = _nm_to(nm_frame, wo_t)
    wi = _nm_to(nm_frame, wi_t)

    ent = entering | thin
    eta_rel = smap(lambda n: torch.where(ent, n, 1.0 / n), n_abs)
    eta_scalar = eta_rel.a

    cos_o = wo.z
    cos_i = wi.z
    is_refl = cos_i * cos_o > 0.0

    # generalized half vector
    etap = torch.where(is_refl, 1.0,
                       torch.where(cos_o > 0.0, eta_scalar, 1.0 / eta_scalar))
    wm = wi * etap + wo
    ok = (cos_i != 0.0) & (cos_o != 0.0) & (dot3(wm, wm) > 0.0) & ~smooth
    wm = normalize3(wm)
    wm = sel(wm.z < 0.0, -wm, wm)
    ok = ok & (dot3(wm, wi) * cos_i >= 0.0) & (dot3(wm, wo) * cos_o >= 0.0)

    fres = mf.fresnel_dielectric(torch.abs(dot3(wo, wm)), eta_rel)
    pr, pt = _refl_trans_probs(s4_mean(fres), thin)
    d = mf.distribution_d(wm, alpha, alpha)
    g = mf.g2(wo, wi, alpha, alpha)
    aco = torch.clamp(torch.abs(cos_o), min=1e-12)

    f_refl = fres * (d * g / (4.0 * aco))
    denom = (dot3(wi, wm) + dot3(wo, wm) / eta_scalar) ** 2
    f_trans = (1.0 - fres) * (
        d * g * torch.abs(dot3(wi, wm)) * torch.abs(dot3(wo, wm))
        / (torch.clamp(denom, min=1e-12) * aco * eta_scalar ** 2))
    f = sel(is_refl, f_refl, f_trans)

    vnd = mf.vndf_pdf(wo, wm, alpha, alpha)
    sum_p = torch.clamp(pr + pt, min=1e-12)
    pdf_refl = vnd / torch.clamp(4.0 * torch.abs(dot3(wo, wm)), min=1e-12) \
        * pr / sum_p
    dwm_dwi = torch.abs(dot3(wi, wm)) / torch.clamp(denom, min=1e-12)
    pdf_trans_solid = vnd * dwm_dwi * pt / sum_p
    pdf_trans = torch.where(thin, pt / sum_p, pdf_trans_solid)
    pdf = torch.where(is_refl, pdf_refl, pdf_trans)

    if tinted:
        tint = _albedo_spectrum(scene, it, wl)
        f = sel(~is_refl, f * tint, f)

    return smap(lambda x: torch.where(ok, x, 0.0), f), torch.where(ok, pdf, 0.0)


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
    smooth, alpha = _smooth_split(alpha)
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
    smooth, alpha = _smooth_split(alpha)
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
# PBR: metallic Schlick lobe + (Schlick specular / Lambert) dielectric
# ---------------------------------------------------------------------------

def _pbr_params(scene, it, wl):
    m = scene.materials
    base = _albedo_spectrum(scene, it, wl)
    metallic = _textured_float(scene, it, m.metallic, m.metallic_tex)
    rough = _roughness(scene, it)
    alpha = rough * rough
    ior = m.const_eta[it.mat_id.long()]
    r = (ior - 1.0) / (ior + 1.0)
    r2 = r * r
    return base, metallic, alpha, S4(r2, r2, r2, r2)


def _pbr_sample(scene, it, wo_t, uc, uc2, uv2, wl, nm_frame=None,
                params=None):
    """uc <= metallic -> metal lobe; else dielectric with a Fresnel-weighted
    specular (uc2 < F) / diffuse choice.  The 2-D sample uv2 is shared by
    the three mutually exclusive lobes."""
    wo = _nm_to(nm_frame, wo_t)
    base, metallic, alpha, r0_diel = params or _pbr_params(scene, it, wl)
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
    return f, _nm_from(nm_frame, wi), pdf, ok, spec


def _pbr_eval(scene, it, wo_t, wi_t, wl, nm_frame=None):
    """Metallic lerp of the metal lobe and (Schlick + (1-F) Lambert)."""
    wo = _nm_to(nm_frame, wo_t)
    wi = _nm_to(nm_frame, wi_t)
    base, metallic, alpha, r0_diel = _pbr_params(scene, it, wl)
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
    thickness = _textured_float(scene, it, m.coat_thickness,
                                m.coat_thickness_tex)
    coat_alpha = gather_rows(m.coat_roughness, mat) ** 2
    ior = m.coat_eta[mat]
    rr = (ior - 1.0) / (ior + 1.0)
    r2 = rr * rr
    r0 = S4(r2, r2, r2, r2)
    tint = rgb2spec.sigmoid_poly_s4(gather_rows(m.coat_tint_coeff, mat),
                                    wl.lam)
    return thickness, coat_alpha, r0, tint


def _beer_lambert(tint: S4, thickness_mm, cos_theta) -> S4:
    """exp(-sigma L), sigma = -ln(tint)/1mm, L = thickness/cos."""
    l = thickness_mm * 0.001 / torch.clamp(cos_theta, min=1e-4)
    return smap(lambda t: torch.exp(torch.log(torch.clamp(t, min=1e-6))
                                    * (l / 0.001)), tint)


def _clearcoat_sample(scene, it, wo_t, uc, uc2, uc3, uv2, wl, nm_frame=None):
    """Coat vs substrate chosen by the coat's analytic Schlick albedo at
    wo; uc picks coat/substrate, uc2 the substrate's metal lobe, uc3 its
    specular/diffuse split."""
    wo = _nm_to(nm_frame, wo_t)
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

    f_b, wi_b_t, pdf_b, ok_b, spec_b = _pbr_sample(
        scene, it, wo_t, uc2, uc3, uv2, wl, nm_frame, params=params)
    wi_b = _nm_to(nm_frame, wi_b_t)
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
    return f, _nm_from(nm_frame, wi), pdf, ok, spec


def _clearcoat_eval(scene, it, wo_t, wi_t, wl, nm_frame=None):
    """f = f_coat + att * f_substrate; pdf lerped by the coat albedo."""
    wo = _nm_to(nm_frame, wo_t)
    wi = _nm_to(nm_frame, wi_t)
    one = _s4_ones(wo.z)
    thickness, coat_alpha, coat_r0, tint = _coat_params(scene, it, wl)
    has_coat = thickness > 0.0

    f_c, pdf_c = _schlick_r_eval(wo, wi, coat_alpha, coat_r0, one, one)
    e_coat = s4_mean(_schlick_fresnel(torch.abs(wo.z), coat_r0, one, 5.0, one))
    e_coat = torch.where(has_coat, e_coat, 0.0)

    f_b, pdf_b = _pbr_eval(scene, it, wo_t, wi_t, wl, nm_frame)
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

OPAQUE_KINDS = (MAT_LAMBERT, MAT_METAL, MAT_PBR, MAT_CLEARCOAT)
# the kinds ``sample_material``'s torch ops sample, each over every lane
SAMPLED_KINDS = (MAT_LAMBERT, MAT_METAL, MAT_GLASS, MAT_PLASTIC, MAT_PBR,
                 MAT_CLEARCOAT)


def n_sampled_kinds(meta) -> int:
    """The material kinds of the scene that ``sample_material``'s torch
    ops sample."""
    return len(set(meta.present_mat_kinds) & set(SAMPLED_KINDS))


def uses_kernel(scene, device) -> bool:
    """Whether ``sample_material`` and ``evaluate_material`` run the
    kernels of ``ops.bsdf_kernels`` for lanes on ``device``: a CUDA
    device, no gradient to take through the material table (grad mode
    off, or no column requires one: ``gather_rows``'s rule) and a scene
    without textures (the kernels read the constant columns).  Otherwise
    they run the torch ops."""
    return (torch.device(device).type == "cuda" and not scene.textures
            and not (torch.is_grad_enabled()
                     and any(t.requires_grad
                             for t in tensors_of(scene.materials))))


def _geo_sidedness(it, frame: Frame, wo_t: V3, wi_t: V3):
    """sign(wo . ng) must equal sign(wi . ng), in the vertex-tangent frame."""
    ng_t = to_frame(frame, it.geo_n)
    co = dot3(wo_t, ng_t)
    ci = dot3(wi_t, ng_t)
    return torch.sign(co) == torch.sign(ci)


def _mat_type(scene, it):
    return scene.materials.mat_type[it.mat_id.long()]


def _opaque(mat_type):
    out = mat_type == OPAQUE_KINDS[0]
    for k in OPAQUE_KINDS[1:]:
        out = out | (mat_type == k)
    return out


def sample_material(scene, meta, it, frame: Frame, wo_t: V3, uc, uv2: V2,
                    wl, uc2=None, uc3=None) -> MaterialSample:
    """Batched material sample over all rays.

    uc / uc2 / uc3: independent 1-D draws for up to three sequential lobe
    decisions; uv2: the 2-D lobe sample.  The integrators pass sampler
    dims; a caller that omits uc2/uc3 gets bit hashes of uc.  One launch
    of ``bsdf_sample_kernel`` where ``uses_kernel``, else torch ops."""
    if uc2 is None:
        uc2 = _hash_unit(uc, 0x9E3779B9)
    if uc3 is None:
        uc3 = _hash_unit(uc, 0x85EBCA6B)
    if uses_kernel(scene, uc.device):
        f, wi_t, pdf, sampled, specular, wl_pdf = bsdf_kernels.sample(
            scene, meta, it, frame, wo_t, uc, uv2, wl, uc2, uc3)
        return MaterialSample(f=f, wi_t=wi_t, pdf=pdf, sampled=sampled,
                              specular=specular, wl=wl._replace(pdf=wl_pdf))
    return _sample_material_ops(scene, meta, it, frame, wo_t, uc, uv2, wl,
                                uc2, uc3)


def _sample_material_ops(scene, meta, it, frame: Frame, wo_t: V3, uc,
                         uv2: V2, wl, uc2, uc3) -> MaterialSample:
    """``sample_material`` as torch ops: every kind present over every
    lane, merged by mask."""
    kinds = set(meta.present_mat_kinds)
    r = uc.shape[0]
    mat_type = _mat_type(scene, it)
    nm_frame = _normal_map_frame(scene, it)

    zero = torch.zeros_like(uc)
    f = S4(zero, zero, zero, zero)
    wi_t = V3(zero, zero, torch.ones_like(uc))
    pdf = zero
    sampled = torch.zeros(r, dtype=torch.bool, device=uc.device)
    specular = torch.zeros_like(sampled)
    terminate = torch.zeros_like(sampled)

    def merge(m, kf, kwi, kpdf, kok, kspec):
        nonlocal f, wi_t, pdf, sampled, specular
        f = sel(m, kf, f)
        wi_t = sel(m, kwi, wi_t)
        pdf = torch.where(m, kpdf, pdf)
        sampled = torch.where(m, kok, sampled)
        specular = torch.where(m, kspec, specular)

    if MAT_LAMBERT in kinds:
        lf, lwi, lpdf, lok = _lambert_sample(scene, it, wo_t, uv2, wl,
                                             nm_frame)
        merge(mat_type == MAT_LAMBERT, lf, lwi, lpdf, lok,
              torch.zeros_like(sampled))
    if MAT_METAL in kinds:
        mf_, mwi, mpdf, mok, mspec = _metal_sample(scene, it, wo_t, uv2, wl,
                                                   nm_frame)
        merge(mat_type == MAT_METAL, mf_, mwi, mpdf, mok, mspec)
    if MAT_GLASS in kinds:
        gf, gwi, gpdf, gok, gspec, gterm = _dielectric_sample(
            scene, it, wo_t, uc, uv2, wl, nm_frame, dispersive=True,
            tinted=False)
        m = mat_type == MAT_GLASS
        merge(m, gf, gwi, gpdf, gok, gspec)
        terminate = terminate | (m & gterm)
    if MAT_PLASTIC in kinds:
        pf, pwi, ppdf, pok, pspec, _ = _dielectric_sample(
            scene, it, wo_t, uc, uv2, wl, nm_frame, dispersive=False,
            tinted=True)
        merge(mat_type == MAT_PLASTIC, pf, pwi, ppdf, pok, pspec)
    if MAT_PBR in kinds:
        bf, bwi, bpdf, bok, bspec = _pbr_sample(scene, it, wo_t, uc, uc2,
                                                uv2, wl, nm_frame)
        merge(mat_type == MAT_PBR, bf, bwi, bpdf, bok, bspec)
    if MAT_CLEARCOAT in kinds:
        cf, cwi, cpdf, cok, cspec = _clearcoat_sample(scene, it, wo_t, uc,
                                                      uc2, uc3, uv2, wl,
                                                      nm_frame)
        merge(mat_type == MAT_CLEARCOAT, cf, cwi, cpdf, cok, cspec)

    # a dispersive transmission collapses the path to its hero wavelength
    out_wl = terminate_secondary(wl, terminate)

    side_ok = _geo_sidedness(it, frame, wo_t, wi_t)
    sampled = sampled & (~_opaque(mat_type) | side_ok)
    return MaterialSample(f=f, wi_t=wi_t, pdf=pdf, sampled=sampled,
                          specular=specular, wl=out_wl)


def evaluate_material(scene, meta, it, frame: Frame, wo_t: V3, wi_t: V3, wl):
    """Batched evaluate + pdf (used by NEE).  Returns (f S4, pdf (R,)):
    one launch of ``bsdf_eval_kernel`` where ``uses_kernel``, else torch
    ops."""
    if uses_kernel(scene, wo_t.x.device):
        return bsdf_kernels.evaluate(scene, meta, it, frame, wo_t, wi_t, wl)
    return _evaluate_material_ops(scene, meta, it, frame, wo_t, wi_t, wl)


def _evaluate_material_ops(scene, meta, it, frame: Frame, wo_t: V3,
                           wi_t: V3, wl):
    """``evaluate_material`` as torch ops: every kind present over every
    lane, merged by mask."""
    kinds = set(meta.present_mat_kinds)
    mat_type = _mat_type(scene, it)
    nm_frame = _normal_map_frame(scene, it)
    zero = torch.zeros_like(wo_t.z)
    f = S4(zero, zero, zero, zero)
    pdf = zero

    def merge(m, kf, kpdf):
        nonlocal f, pdf
        f = sel(m, kf, f)
        pdf = torch.where(m, kpdf, pdf)

    if MAT_LAMBERT in kinds:
        lf, lpdf = _lambert_eval(scene, it, wo_t, wi_t, wl, nm_frame)
        merge(mat_type == MAT_LAMBERT, lf, lpdf)
    if MAT_METAL in kinds:
        mf_, mpdf = _metal_eval(scene, it, wo_t, wi_t, wl, nm_frame)
        merge(mat_type == MAT_METAL, mf_, mpdf)
    if MAT_GLASS in kinds:
        gf, gpdf = _dielectric_eval(scene, it, wo_t, wi_t, wl, nm_frame,
                                    dispersive=True, tinted=False)
        merge(mat_type == MAT_GLASS, gf, gpdf)
    if MAT_PLASTIC in kinds:
        pf, ppdf = _dielectric_eval(scene, it, wo_t, wi_t, wl, nm_frame,
                                    dispersive=False, tinted=True)
        merge(mat_type == MAT_PLASTIC, pf, ppdf)
    if MAT_PBR in kinds:
        bf, bpdf = _pbr_eval(scene, it, wo_t, wi_t, wl, nm_frame)
        merge(mat_type == MAT_PBR, bf, bpdf)
    if MAT_CLEARCOAT in kinds:
        cf, cpdf = _clearcoat_eval(scene, it, wo_t, wi_t, wl, nm_frame)
        merge(mat_type == MAT_CLEARCOAT, cf, cpdf)

    keep = ~_opaque(mat_type) | _geo_sidedness(it, frame, wo_t, wi_t)
    return smap(lambda x: torch.where(keep, x, 0.0), f), torch.where(keep, pdf, 0.0)


def is_bsdf_material(scene, it):
    """(R,) bool -- emissive-only surfaces end paths."""
    return _mat_type(scene, it) != MAT_EMISSIVE


def emission_spectral(scene, meta, mat_id, uv: V2, wl) -> S4:
    """Radiance spectrum x intensity for material rows ``mat_id`` at
    ``uv`` (a constant spectrum or an RGB texture), no emissive-type
    gating."""
    m = scene.materials
    mat = mat_id.long()
    row = m.emission_row[mat]
    scale = gather_rows(m.emission_scale, mat)
    le_bank = _bank_eval(scene, torch.clamp(row, min=0), wl)
    le = smap(lambda x: torch.where(row >= 0, x, 0.0), le_bank)
    if meta.has_emission_tex and scene.textures:
        tex_ids = m.emission_tex[mat]
        rgb = _texture(scene, tex_ids, uv, 3, [0.0, 0.0, 0.0])
        # D65 is spectra-bank row 0
        d65 = sgrid.bank_pick(wl.bank, torch.zeros_like(row))
        le_tex = rgb2spec.illuminant_eval_s4(rgb, wl.lam, scene.rs_zn,
                                             scene.rs_coeffs,
                                             scene.spectra[0], d65_vals=d65)
        le = sel(tex_ids >= 0, le_tex, le)
    return le * scale


def emitted_radiance(scene, meta, it, wl) -> S4:
    """Le at an emissive hit, S4."""
    le = emission_spectral(scene, meta, it.mat_id, it.uv, wl)
    is_emissive = _mat_type(scene, it) == MAT_EMISSIVE
    return smap(lambda x: torch.where(is_emissive, x, 0.0), le)


def sample_albedo(scene, meta, it, wl) -> S4:
    """Base-color reflectance at the hit, for the albedo AOV."""
    return _albedo_spectrum(scene, it, wl)
