"""Light sampling: power CDF, NEE, MIS pdfs.

Counterpart of ``tpu_pathtracer/render/lights.py``: area, point, spot,
directional and environment lights.  phi(lambda) of every light is an
O(K) select over the per-step wavelength bank; the light count is static,
so the CDF walk unrolls.  MIS weights include the light-selection
probability on both the NEE and BSDF sides, as in the JAX package.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops import trace
from ..scene.types import (LIGHT_AREA, LIGHT_DIRECTIONAL, LIGHT_ENV,
                           LIGHT_POINT, LIGHT_SPOT)
from ..utils.vec import (S4, V2, V3, cross3, dot3, normalize3, s4_mean, sel,
                         smap, to_frame, v3_unstack)
from . import bsdf as bsdf_mod
from . import env as env_mod

RAY_EPS_NEE = 1.0e-4
BIG_T = 3.0e38


class NeeResult(NamedTuple):
    contribution: S4
    mis_weight: torch.Tensor    # (R,)
    # (R,) bool: the lanes whose shadow ray goes to the environment light
    # (picked, and traced); None where the scene has none
    to_env: torch.Tensor | None = None


def _phi_lambda(scene, wl, n_l: int):
    """Per-light mean-over-lanes spectral power: list of L (R,) tensors."""
    rows = scene.lights.spectrum_row                      # (L,)
    means = [s4_mean(s) for s in wl.bank.spectra]         # K x (R,)
    cols = []
    for s in range(n_l):
        v = torch.where(rows[s] == 0, means[0], 0.0)
        for i in range(1, len(means)):
            v = torch.where(rows[s] == i, means[i], v)
        cols.append(v)
    return [c * scene.lights.phi_scale[s] for s, c in enumerate(cols)]


def pick_light(scene, meta, wl, u):
    """Sample a light row per ray from the power CDF.

    Returns (light_row (R,) int64, probability (R,), any_light (R,) bool)."""
    n_lights = meta.n_lights
    r = u.shape[0]
    if n_lights == 0:
        z = torch.zeros_like(u)
        return torch.zeros(r, dtype=torch.int64, device=u.device), z, z > 0.0
    w = _phi_lambda(scene, wl, n_lights)
    total = w[0]
    for wi in w[1:]:
        total = total + wi
    inv_total = 1.0 / torch.clamp(total, min=1e-20)
    row = torch.zeros(r, dtype=torch.int64, device=u.device)
    if n_lights == 1:
        prob = w[0] * inv_total
    else:
        cum = torch.zeros_like(u)
        for wi in w[:-1]:
            cum = cum + wi
            row = row + (u >= cum * inv_total).to(torch.int64)
        prob = torch.where(row == 0, w[0], 0.0)
        for i in range(1, n_lights):
            prob = torch.where(row == i, w[i], prob)
        prob = prob * inv_total
    return row, prob, total > 0.0


def light_probability(scene, meta, wl, light_row):
    """Selection probability of a given light row (0 for row < 0)."""
    n_lights = meta.n_lights
    if n_lights == 0:
        return torch.zeros(light_row.shape[0], device=light_row.device)
    w = _phi_lambda(scene, wl, n_lights)
    total = w[0]
    for wi in w[1:]:
        total = total + wi
    pw = torch.where(light_row == 0, w[0], 0.0)
    for i in range(1, n_lights):
        pw = torch.where(light_row == i, w[i], pw)
    return torch.where(light_row >= 0, pw / torch.clamp(total, min=1e-20), 0.0)


def _sample_area_point(scene, meta, light_row, s, uv2: V2):
    """Uniform-area point on an area light: the triangle by a lower-bound
    binary search of the light's CDF run (ceil(log2(max_area_tris + 1))
    static steps), then a barycentric warp.

    Returns (p V3, light normal V3, tri (R,), uv V2)."""
    first = scene.lights.area_first_tri[light_row].long()
    n_tris = scene.lights.area_n_tris[light_row].long()
    n_rows = scene.area_tri.shape[0]

    lo = torch.zeros_like(light_row)
    hi = torch.clamp(n_tris, min=1)
    steps = int(math.ceil(math.log2(meta.max_area_tris + 1)))
    for _ in range(steps):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        c = scene.area_tri_cdf[torch.clamp(first + mid, 0, n_rows - 1)]
        go_right = s >= c
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right, hi, mid)
    at = torch.minimum(lo, torch.clamp(n_tris - 1, min=0)).clamp(min=0)
    gi = torch.clamp(first + at, 0, n_rows - 1)
    tri = scene.area_tri[gi].long()

    u0, u1 = uv2.x, uv2.y
    b0 = torch.where(u0 < u1, u0 / 2.0, u0 - u1 / 2.0)
    b1 = torch.where(u0 < u1, u1 - u0 / 2.0, u1 / 2.0)
    b2 = 1.0 - b0 - b1

    vrow = scene.bvh.tri9[tri]
    p0 = v3_unstack(vrow[:, 0:3])
    p1 = v3_unstack(vrow[:, 3:6])
    p2 = v3_unstack(vrow[:, 6:9])
    p = p0 * b0 + p1 * b1 + p2 * b2
    n = normalize3(cross3(p1 - p0, p2 - p0))
    arow = scene.tri_attr[tri]
    uv = V2(arow[:, 9] * b0 + arow[:, 11] * b1 + arow[:, 13] * b2,
            arow[:, 10] * b0 + arow[:, 12] * b1 + arow[:, 14] * b2)
    return p, n, tri, uv


def evaluate_nee(scene, meta, it, frame, wo_t: V3, wl, u_light, u_s,
                 u_uv: V2, with_mis: bool, precise: bool = False) -> NeeResult:
    """One NEE event per ray, over the light kinds present, with one
    batched shadow-ray (any-hit) query."""
    zero = torch.zeros_like(u_light)
    zero4 = S4(zero, zero, zero, zero)
    if meta.n_lights == 0:
        return NeeResult(zero4, torch.ones_like(u_light))

    light_row, prob, any_l = pick_light(scene, meta, wl, u_light)
    lights = scene.lights
    lt = lights.light_type[light_row]
    l_spec = bsdf_mod._bank_eval(scene, lights.spectrum_row[light_row], wl)
    l_int = lights.intensity[light_row]
    types = set(meta.light_types)

    # shadow ray and light term per light kind, merged by masks
    wi = V3(zero, zero, torch.ones_like(u_light))
    t_max = torch.full_like(u_light, BIG_T)
    light_term = zero4                     # before 1/prob and the BSDF
    pdf_dir = torch.ones_like(u_light)     # direction pdf for MIS
    is_delta = torch.ones_like(any_l)
    to_env = None

    if LIGHT_POINT in types or LIGHT_SPOT in types:
        lp = v3_unstack(lights.position[light_row])
        dvec = lp - it.position
        d2 = torch.clamp(dot3(dvec, dvec), min=1e-12)
        wdir = dvec * (1.0 / torch.sqrt(d2))
        m = (lt == LIGHT_POINT) | (lt == LIGHT_SPOT)
        # I spec / d^2; a spot adds its smoothstep falloff
        inten = l_spec * l_int
        if LIGHT_SPOT in types:
            axis = v3_unstack(lights.direction[light_row])
            cos_t = dot3(-wdir, axis)
            ci = lights.cos_inner[light_row]
            co = lights.cos_outer[light_row]
            tt = torch.clamp((cos_t - co) / torch.clamp(ci - co, min=1e-8),
                             0.0, 1.0)
            falloff = tt * tt * (3.0 - 2.0 * tt)
            inten = sel(lt == LIGHT_SPOT, inten * falloff, inten)
        wi = sel(m, wdir, wi)
        t_max = torch.where(m, torch.sqrt(d2) - 2.0 * RAY_EPS_NEE, t_max)
        light_term = sel(m, inten * (1.0 / d2), light_term)

    if LIGHT_DIRECTIONAL in types:
        m = lt == LIGHT_DIRECTIONAL
        wi = sel(m, v3_unstack(lights.direction[light_row]), wi)
        t_max = torch.where(m, BIG_T, t_max)
        light_term = sel(m, l_spec * l_int, light_term)

    if LIGHT_AREA in types:
        m = lt == LIGHT_AREA
        p, ln, _tri, uv_l = _sample_area_point(scene, meta, light_row, u_s,
                                               u_uv)
        dvec = p - it.position
        d2 = torch.clamp(dot3(dvec, dvec), min=1e-12)
        wdir = dvec * (1.0 / torch.sqrt(d2))
        cos_l = torch.abs(dot3(ln, -wdir))
        area_total = torch.clamp(lights.area_total[light_row], min=1e-12)
        pdf_area = 1.0 / area_total
        g = cos_l / d2
        # the emitter's radiance at the sampled point (texture or spectrum)
        le = bsdf_mod.emission_spectral(
            scene, meta, torch.clamp(lights.mat_id[light_row], min=0),
            uv_l, wl)
        wi = sel(m, wdir, wi)
        t_max = torch.where(m, torch.sqrt(d2) - 2.0 * RAY_EPS_NEE, t_max)
        light_term = sel(m, le * (g / pdf_area), light_term)
        pdf_dir = torch.where(
            m, pdf_area * d2 / torch.clamp(cos_l, min=1e-8), pdf_dir)
        is_delta = is_delta & ~m

    if LIGHT_ENV in types and scene.env is not None:
        m = lt == LIGHT_ENV
        wdir, le, p_dir = env_mod.sample_env_direction(scene, wl, u_uv)
        wi = sel(m, wdir, wi)
        t_max = torch.where(m, BIG_T, t_max)
        light_term = sel(m, le * (1.0 / torch.clamp(p_dir, min=1e-12)),
                         light_term)
        pdf_dir = torch.where(m, p_dir, pdf_dir)
        is_delta = is_delta & ~m
        to_env = m & any_l & it.valid

    shadow_o = it.position + wi * RAY_EPS_NEE
    occluded = trace.intersect_p_scene(scene, shadow_o, wi, t_max,
                                       active=any_l & it.valid,
                                       precise=precise)
    visible = ~occluded & any_l & it.valid

    wi_t = to_frame(frame, wi)
    f, pdf_bsdf = bsdf_mod.evaluate_material(scene, meta, it, frame, wo_t,
                                             wi_t, wl)
    contrib = f * light_term * (1.0 / torch.clamp(prob, min=1e-12))
    contrib = smap(lambda x: torch.where(visible, x, 0.0), contrib)

    if with_mis:
        w = torch.where(is_delta, 1.0, _balance(prob * pdf_dir, pdf_bsdf))
        w = torch.where(visible, w, 1.0)
    else:
        w = torch.ones_like(u_light)
    return NeeResult(contribution=contrib, mis_weight=w, to_env=to_env)


def _balance(pdf_a, pdf_b):
    """Balance heuristic with 0/0 -> 0."""
    s = pdf_a + pdf_b
    return torch.where(s > 0.0, pdf_a / torch.where(s > 0.0, s, 1.0), 0.0)


def pdf_light_for_hit_pos(scene, meta, prev_pos: V3, next_it, wl):
    """Direction pdf of NEE having sampled the point that BSDF sampling
    hit: selection probability x area pdf x area->solid-angle Jacobian;
    0 for non-light hits."""
    light_row = next_it.light_id.long()
    is_area = (light_row >= 0) & next_it.valid
    prob = light_probability(scene, meta, wl, light_row)
    area_total = torch.clamp(
        scene.lights.area_total[torch.clamp(light_row, min=0)], min=1e-12)
    dvec = prev_pos - next_it.position
    d2 = torch.clamp(dot3(dvec, dvec), min=1e-12)
    cos_l = torch.abs(dot3(next_it.geo_n, dvec)) / torch.sqrt(d2)
    pdf_dir = (1.0 / area_total) * d2 / torch.clamp(cos_l, min=1e-8)
    return torch.where(is_area, prob * pdf_dir, 0.0)


def pdf_env_for_direction(scene, meta, wl, direction: V3):
    """Summed pdf over environment lights of a BSDF-sampled escape
    direction (the builder allows one environment light)."""
    r = direction.x.shape[0]
    if not meta.has_env:
        return torch.zeros_like(direction.x)
    pdf = torch.zeros_like(direction.x)
    for er, t in enumerate(meta.light_types):
        if t != LIGHT_ENV:
            continue
        row = torch.full((r,), er, dtype=torch.int64, device=direction.x.device)
        prob = light_probability(scene, meta, wl, row)
        pdf = pdf + prob * env_mod.env_pdf_direction(scene, direction)
    return pdf
