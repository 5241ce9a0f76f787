"""Trowbridge-Reitz (GGX) microfacet functions on (R,) components.

Counterpart of ``tpu_pathtracer/render/microfacet.py`` (D, Lambda, G1,
G2, the VNDF and its pdf, reflect, refract, and the dielectric and
conductor Fresnel terms).
Directions are V3 in a local shading frame with +Z the normal.
"""
from __future__ import annotations

import math

import torch

from ..utils.vec import S4, V2, V3, cross3, dot3, normalize3, sel


def _sqrt0(x):
    """sqrt of x >= 0 whose gradient is 0 at x = 0 (where sqrt's is
    infinite): a lane at exactly 0 (a normal-incidence direction, the
    critical angle) would turn the zero gradient of a discarded value into
    0 x inf = NaN.  The same values as ``torch.sqrt``."""
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def _cos2_theta(w: V3):
    return w.z * w.z


def _tan2_theta(w: V3):
    c2 = _cos2_theta(w)
    return torch.where(c2 > 0.0, (1.0 - c2) / torch.clamp(c2, min=1e-20),
                       float("inf"))


def _cos_sin_phi(w: V3):
    sin_t = _sqrt0(torch.clamp(1.0 - _cos2_theta(w), min=0.0))
    safe = sin_t > 0.0
    # 0 off ``safe``, where the value is discarded: 1 / clamp(sin_t, 1e-20)
    # has the backward 0 x 1e40 = NaN there (clamp's own backward drops it)
    inv = torch.where(safe, 1.0 / torch.where(safe, sin_t, 1.0), 0.0)
    cp = torch.where(safe, torch.clamp(w.x * inv, -1, 1), 1.0)
    sp = torch.where(safe, torch.clamp(w.y * inv, -1, 1), 0.0)
    return cp, sp


def distribution_d(wm: V3, ax, ay):
    """Trowbridge-Reitz D(wm)."""
    t2 = _tan2_theta(wm)
    c4 = _cos2_theta(wm) ** 2
    keep = torch.isfinite(t2) & (c4 > 0)
    # a discarded lane computes with tan^2 = 0 and cos^4 = 1: its infinite
    # tan^2, or the 1e40 of 1 / 1e-20^2, would put 0 x inf = NaN into the
    # gradient of alpha
    t2 = torch.where(keep, t2, 0.0)
    cp, sp = _cos_sin_phi(wm)
    e = t2 * (cp * cp / torch.clamp(ax * ax, min=1e-12)
              + sp * sp / torch.clamp(ay * ay, min=1e-12))
    c4 = torch.clamp(torch.where(keep, c4, 1.0), min=1e-20)
    d = 1.0 / (math.pi * ax * ay * c4 * (1.0 + e) ** 2)
    return torch.where(keep, d, 0.0)


def lambda_(w: V3, ax, ay):
    """Smith Lambda."""
    t2 = _tan2_theta(w)
    fin = torch.isfinite(t2)
    cp, sp = _cos_sin_phi(w)
    a2 = (cp * ax) ** 2 + (sp * ay) ** 2
    # 0 on a discarded (grazing) lane: a2 x inf would put 0 x inf = NaN into
    # the gradient of alpha
    lam = (torch.sqrt(1.0 + a2 * torch.where(fin, t2, 0.0)) - 1.0) / 2.0
    return torch.where(fin, lam, 0.0)


def g1(w: V3, ax, ay):
    return 1.0 / (1.0 + lambda_(w, ax, ay))


def g2(wo: V3, wi: V3, ax, ay):
    """Bidirectional masking-shadowing."""
    return 1.0 / (1.0 + lambda_(wo, ax, ay) + lambda_(wi, ax, ay))


def vndf_pdf(w: V3, wm: V3, ax, ay):
    """Visible normal distribution D_w(wm)."""
    cos_w = torch.abs(w.z)
    d = g1(w, ax, ay) / torch.clamp(cos_w, min=1e-20) * distribution_d(wm, ax, ay) \
        * torch.abs(dot3(w, wm))
    return torch.where(cos_w > 0.0, d, 0.0)


def sample_vndf(w: V3, u: V2, ax, ay) -> V3:
    """Sample the visible normal distribution (Heitz's ellipsoid warp)."""
    wh = normalize3(V3(ax * w.x, ay * w.y, w.z))
    wh = sel(wh.z < 0.0, -wh, wh)

    zero = torch.zeros_like(wh.z)
    x_axis = V3(torch.ones_like(wh.z), zero, zero)
    # a discarded lane normalizes x_axis: the cross product there may be
    # near 0, where rsqrt's backward overflows and 0 x inf = NaN
    tilted = wh.z < 0.99999
    t1 = sel(tilted, normalize3(sel(tilted, V3(-wh.y, wh.x, zero), x_axis)),
             x_axis)
    t2 = cross3(wh, t1)

    r = torch.sqrt(u.x)
    phi = 2.0 * math.pi * u.y
    px = r * torch.cos(phi)
    py = r * torch.sin(phi)
    h = torch.sqrt(torch.clamp(1.0 - px * px, min=0.0))
    lerp_f = (1.0 + wh.z) / 2.0
    py = h * (1.0 - lerp_f) + py * lerp_f
    pz = torch.sqrt(torch.clamp(1.0 - px * px - py * py, min=0.0))
    nh = t1 * px + t2 * py + wh * pz
    return normalize3(V3(ax * nh.x, ay * nh.y, torch.clamp(nh.z, min=1e-6)))


def reflect(wo: V3, n: V3) -> V3:
    """Mirror wo about n."""
    return n * (2.0 * dot3(wo, n)) - wo


def refract(wi: V3, n: V3, eta):
    """Refraction of wi through n with relative IOR eta -> (wt, ok); ok is
    False on total internal reflection."""
    cos_i = dot3(wi, n)
    sin2_i = torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    sin2_t = sin2_i / (eta * eta)
    tir = sin2_t >= 1.0
    cos_t = _sqrt0(torch.clamp(1.0 - sin2_t, min=0.0))
    wt = -wi * (1.0 / eta) + n * (cos_i / eta - cos_t)
    ok = ~tir & (dot3(wt, wt) > 1e-12)
    return normalize3(wt), ok


def same_hemisphere(a: V3, b: V3):
    return a.z * b.z > 0.0


def _fresnel_dielectric_lane(ci, eta):
    """(R,) dielectric Fresnel for one wavelength lane (1 on TIR)."""
    sin2_i = 1.0 - ci * ci
    sin2_t = sin2_i / (eta * eta)
    cos_t = _sqrt0(torch.clamp(1.0 - sin2_t, 0.0, 1.0))
    r_par = (eta * ci - cos_t) / (eta * ci + cos_t)
    r_per = (ci - eta * cos_t) / (ci + eta * cos_t)
    return 0.5 * (r_par * r_par + r_per * r_per)


def fresnel_dielectric(cos_i, eta: S4) -> S4:
    """Spectral dielectric Fresnel: cos_i (R,), eta an S4 of relative
    IOR -> S4 reflectance."""
    ci = torch.clamp(cos_i, 0.0, 1.0)
    return S4(*(_fresnel_dielectric_lane(ci, e) for e in eta.lanes))


def _fresnel_complex_lane(ci, er, ei):
    """(R,) conductor Fresnel for one lane, in explicit real/imaginary
    arithmetic (term for term that of the JAX package)."""
    sin2_i = 1.0 - ci * ci

    # sin2_t = sin2_i / eta^2 in complex arithmetic, eta_c = er + i ei
    e2r = er * er - ei * ei
    e2i = 2.0 * er * ei
    den = torch.clamp(e2r * e2r + e2i * e2i, min=1e-20)
    s2t_r = sin2_i * e2r / den
    s2t_i = -sin2_i * e2i / den

    # cos_t = sqrt(1 - sin2_t)
    wr = 1.0 - s2t_r
    wi_ = -s2t_i
    mag = torch.sqrt(wr * wr + wi_ * wi_)
    ang = torch.atan2(wi_, wr) * 0.5
    sq = torch.sqrt(mag)
    ctr = sq * torch.cos(ang)
    cti = sq * torch.sin(ang)

    def cdiv(ar, ai, br, bi):
        d = torch.clamp(br * br + bi * bi, min=1e-20)
        return (ar * br + ai * bi) / d, (ai * br - ar * bi) / d

    # r_parl = (eta*ci - cos_t) / (eta*ci + cos_t)
    pr, pi = cdiv(er * ci - ctr, ei * ci - cti, er * ci + ctr, ei * ci + cti)
    # r_perp = (ci - eta*cos_t) / (ci + eta*cos_t)
    ect_r = er * ctr - ei * cti
    ect_i = er * cti + ei * ctr
    sr, si = cdiv(ci - ect_r, -ect_i, ci + ect_r, ect_i)

    return 0.5 * ((pr * pr + pi * pi) + (sr * sr + si * si))


def fresnel_complex(cos_i, eta: S4, k: S4) -> S4:
    """Spectral conductor Fresnel with complex IOR eta + i k."""
    ci = torch.clamp(cos_i, 0.0, 1.0)
    return S4(*(_fresnel_complex_lane(ci, er, ei)
                for er, ei in zip(eta.lanes, k.lanes)))
