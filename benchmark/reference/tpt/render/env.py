"""Environment (infinite) light: equirect mapping, CDF importance sampling.

Counterpart of ``tpu_pathtracer/render/env.py``: a luminance x sin(theta)
two-stage CDF built by the scene builder, sampling by search in it, the
texel pdf with the W*H/(2 pi^2 sin(theta)) solid-angle Jacobian, and
per-lookup RGB -> illuminant-spectrum upsampling.

Directions are y-up: u = phi/2pi with phi = atan2(-z, x), v = theta/pi with
theta from +y (v = 0 at the zenith).

The JAX package searches the CDFs by an (R, K) compare-and-count, a TPU
idiom that here would gather a whole (R, W) CDF row per ray.  The port
finds the same index (the count of entries <= u, plateaus included) with
``torch.searchsorted`` in the row CDF and a binary search in the one
column-CDF row each ray needs.
"""
from __future__ import annotations

import math

import torch

from ..spectrum import grid as sgrid
from ..spectrum import rgb2spec
from ..utils.vec import S4, V2, V3
from . import texture as tex_mod


def dir_to_uv(d: V3, rotation=0.0) -> V2:
    """Unit directions -> uv on the map rotated by ``rotation`` (radians)."""
    theta = torch.arccos(torch.clamp(d.y, -1.0, 1.0))
    phi = torch.atan2(-d.z, d.x)
    u = ((phi - rotation) / (2.0 * math.pi)) % 1.0
    v = theta / math.pi
    return V2(u, v)


def uv_to_dir(uv: V2, rotation=0.0) -> V3:
    theta = uv.y * math.pi
    phi = uv.x * 2.0 * math.pi + rotation
    sin_t = torch.sin(theta)
    return V3(sin_t * torch.cos(phi), torch.cos(theta), -sin_t * torch.sin(phi))


def env_radiance(scene, wl, d: V3) -> S4:
    """Escape radiance for directions d: bilinear texel -> spectrum (S4)."""
    env = scene.env
    uv = dir_to_uv(d, env.rotation)
    # sample_bilinear flips v; the map stores v = 0 at its top row, which is
    # this orientation already, so flip back
    rgb = tex_mod.sample_bilinear(env.rgb, V2(uv.x, 1.0 - uv.y))
    d65 = sgrid.bank_pick(wl.bank, torch.zeros_like(uv.x, dtype=torch.int64))
    return rgb2spec.illuminant_eval_s4(rgb, wl.lam, scene.rs_zn,
                                       scene.rs_coeffs, scene.spectra[0],
                                       d65_vals=d65)


def _count_le_in_rows(table, row, u):
    """Per ray, the count of entries <= u[i] in row ``row[i]`` of the
    (H, W) table whose rows are non-decreasing: a lower-bound binary
    search of ceil(log2(W + 1)) steps, one gathered entry a ray a step."""
    w = table.shape[1]
    flat = table.reshape(-1)
    base = row * w
    lo = torch.zeros_like(row)
    hi = torch.full_like(row, w)
    for _ in range(int(math.ceil(math.log2(w + 1)))):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        le = flat[base + torch.clamp(mid, max=w - 1)] <= u
        go_right = le & (lo < hi)
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right, hi, mid)
    return lo


def sample_env_direction(scene, wl, u_uv: V2):
    """Importance-sample the env map -> (dir V3, radiance S4, pdf (R,))."""
    env = scene.env
    h, w = env.rgb.shape[0], env.rgb.shape[1]
    marg = env.marginal_cdf
    cond = env.conditional_cdf.reshape(-1)
    row = torch.clamp(torch.searchsorted(marg, u_uv.x, right=True), 0, h - 1)
    col = torch.clamp(_count_le_in_rows(env.conditional_cdf, row, u_uv.y),
                      0, w - 1)

    # cell probabilities and the CDF below each cell
    row_lo = torch.where(row > 0, marg[torch.clamp(row - 1, min=0)], 0.0)
    p_row = marg[row] - row_lo
    at = row * w + col
    col_lo = torch.where(col > 0, cond[torch.clamp(at - 1, min=0)], 0.0)
    p_col = cond[at] - col_lo

    # jitter within the texel: the CDF remainder of the search value is
    # uniform in [0, 1) given the cell
    jv = torch.clamp((u_uv.x - row_lo) / torch.clamp(p_row, min=1e-20),
                     0.0, 1.0)
    ju = torch.clamp((u_uv.y - col_lo) / torch.clamp(p_col, min=1e-20),
                     0.0, 1.0)

    u = (col.to(torch.float32) + ju) / w
    v = (row.to(torch.float32) + jv) / h
    d = uv_to_dir(V2(u, v), env.rotation)

    sin_t = torch.clamp(torch.sin(v * math.pi), min=1e-6)
    # texel -> solid angle Jacobian
    pdf = p_row * p_col * (w * h) / (2.0 * math.pi * math.pi * sin_t)
    return d, env_radiance(scene, wl, d), pdf


def env_pdf_direction(scene, d: V3):
    """pdf of ``sample_env_direction`` choosing direction d."""
    env = scene.env
    h, w = env.rgb.shape[0], env.rgb.shape[1]
    marg = env.marginal_cdf
    cond = env.conditional_cdf.reshape(-1)
    uv = dir_to_uv(d, env.rotation)
    col = torch.clamp((uv.x * w).to(torch.int64), 0, w - 1)
    row = torch.clamp((uv.y * h).to(torch.int64), 0, h - 1)
    p_row = marg[row] - torch.where(row > 0, marg[torch.clamp(row - 1, min=0)],
                                    0.0)
    at = row * w + col
    p_col = cond[at] - torch.where(col > 0, cond[torch.clamp(at - 1, min=0)],
                                   0.0)
    sin_t = torch.clamp(torch.sin(uv.y * math.pi), min=1e-6)
    return p_row * p_col * (w * h) / (2.0 * math.pi * math.pi * sin_t)
