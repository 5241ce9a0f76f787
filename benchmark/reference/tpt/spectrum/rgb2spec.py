"""RGB -> spectrum sigmoid-polynomial tables: loading and batched lookup.

A frozen copy of ``tpu_pathtracer_torch/spectrum/rgb2spec.py`` without the
fitter.  A table is
(z_nodes (res,), coeffs (3, res, res, res, 3)): [max component][zi][yi][xi]
[c0, c1, c2], and a spectrum is reconstructed as
  s(lambda) = sigmoid(c0*t^2 + c1*t + c2),  t = (lambda-360)/470.

``get_table`` reads the tables committed in ``tpu_pathtracer/data/
rgb2spec`` (data files, read by path, as the program reads them: an input
of both sides, like the benchmark's mesh and sky).
"""
from __future__ import annotations

import os
from functools import lru_cache

import numpy as np
import torch

from ..utils.math import select_lane
from ..utils.vec import S4
from . import cie
from .grid import LAMBDA_MAX, LAMBDA_MIN, N_DENSE

DEFAULT_RES = 64

# the checkout (this file is benchmark/reference/tpt/spectrum/rgb2spec.py)
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))))
# the committed (3, res, res, res, 3) coefficient tables, one file per
# gamut and resolution
TABLE_DIR = os.path.join(_ROOT, "tpu_pathtracer", "data", "rgb2spec")


def table_file(gamut_name: str, res: int) -> str:
    # v2: fitted against the standard CIE 1931 1nm CMF tables
    return f"{gamut_name}_{res}_v2.npz"


@lru_cache(maxsize=None)
def get_table(gamut_name: str, res: int = DEFAULT_RES):
    """(z_nodes (res,), coeffs (3, res, res, res, 3)) float32 numpy arrays,
    read-only: the committed table."""
    fname = table_file(gamut_name, res)
    path = os.path.join(TABLE_DIR, fname)
    if not os.path.exists(path):
        raise FileNotFoundError(f"{path}: the reference reads committed "
                                "tables only")
    with np.load(path) as data:
        zn, coeffs = data["z_nodes"], data["coeffs"]
    zn.setflags(write=False)
    coeffs.setflags(write=False)
    return zn, coeffs


def lookup_coeffs(rgb, zn, coeffs):
    """Trilinear coefficient lookup.

    rgb: (..., 3) LINEAR rgb (clamped to [0, 1]); zn: (res,) tensor;
    coeffs: (3, res, res, res, 3) tensor.  Returns (..., 3)."""
    res = zn.shape[0]
    rgb = rgb.clamp(0.0, 1.0)

    maxc = torch.argmax(rgb, dim=-1)
    z = rgb.amax(dim=-1)
    c1 = select_lane(rgb, (maxc + 1) % 3)
    c2 = select_lane(rgb, (maxc + 2) % 3)
    zsafe = torch.clamp(z, min=1e-8)
    x = c1 * (res - 1.0) / zsafe
    y = c2 * (res - 1.0) / zsafe

    xi = x.to(torch.int64).clamp(0, res - 2)
    yi = y.to(torch.int64).clamp(0, res - 2)
    # first zi with zn[zi+1] > z
    zi = ((zn <= z[..., None]).sum(dim=-1) - 1).clamp(0, res - 2)
    dx = x - xi
    dy = y - yi
    zn_lo = zn[zi]
    zn_hi = zn[zi + 1]
    dz = (z - zn_lo) / torch.clamp(zn_hi - zn_lo, min=1e-12)

    cflat = coeffs.reshape(-1, coeffs.shape[-1])

    def gather(ddx, ddy, ddz):
        flat = ((maxc * res + (zi + ddz)) * res + (yi + ddy)) * res + (xi + ddx)
        return cflat[flat]

    def lerp(a, b, t):
        return a + (b - a) * t[..., None]

    c = lerp(
        lerp(lerp(gather(0, 0, 0), gather(1, 0, 0), dx),
             lerp(gather(0, 1, 0), gather(1, 1, 0), dx), dy),
        lerp(lerp(gather(0, 0, 1), gather(1, 0, 1), dx),
             lerp(gather(0, 1, 1), gather(1, 1, 1), dx), dy),
        dz)

    # uniform rgb -> constant spectrum sigmoid^-1(v)
    uniform = (rgb[..., 0] == rgb[..., 1]) & (rgb[..., 1] == rgb[..., 2])
    v = rgb[..., 0].clamp(1e-5, 1.0 - 1e-5)
    const_c = torch.stack(
        [torch.zeros_like(v), torch.zeros_like(v), torch.log(v / (1.0 - v))],
        dim=-1)
    return torch.where(uniform[..., None], const_c, c)


def sigmoid_poly_max_value(c):
    """The maximum of the sigmoid polynomial over [LAMBDA_MIN, LAMBDA_MAX]:
    at an end, or at the parabola's vertex when it lies inside."""
    def val(lam):
        t = (lam - LAMBDA_MIN) / (LAMBDA_MAX - LAMBDA_MIN)
        return torch.sigmoid(c[..., 0] * t * t + c[..., 1] * t + c[..., 2])
    result = torch.maximum(val(LAMBDA_MIN), val(LAMBDA_MAX))
    tc = -c[..., 1] / (2.0 * c[..., 0])
    lam_c = tc * (LAMBDA_MAX - LAMBDA_MIN) + LAMBDA_MIN
    interior = (lam_c >= LAMBDA_MIN) & (lam_c <= LAMBDA_MAX)
    return torch.where(interior, torch.maximum(result, val(lam_c)), result)


def albedo_eval(rgb, lam, zn, coeffs):
    """RgbAlbedoSpectrum: rgb in [0, 1] -> reflectance at ``lam``.
    rgb: (..., 3); lam: (..., L); zn, coeffs: a table (numpy or tensors).
    Returns (..., L)."""
    def tensor(a):
        if isinstance(a, torch.Tensor):
            return a.to(rgb.device)
        return torch.tensor(np.asarray(a), device=rgb.device)
    return sigmoid_poly(lookup_coeffs(rgb, tensor(zn), tensor(coeffs)), lam)


def sigmoid_poly(c, lam):
    """sigmoid(c0 t^2 + c1 t + c2) at wavelengths ``lam``; c: (..., 3),
    lam broadcastable to (..., L)."""
    t = (lam - LAMBDA_MIN) / (LAMBDA_MAX - LAMBDA_MIN)
    c0, c1, c2 = c[..., 0:1], c[..., 1:2], c[..., 2:3]
    return torch.sigmoid(c0 * t * t + c1 * t + c2)


def unbounded_eval(rgb, lam, zn, coeffs):
    """RgbUnboundedSpectrum at wavelengths ``lam``: scale = 2*max(rgb),
    poly of rgb/scale.  rgb: (..., 3); lam: (..., L)."""
    scale = 2.0 * rgb.amax(dim=-1, keepdim=True)
    rgb_n = torch.where(scale > 0, rgb / torch.clamp(scale, min=1e-12), 0.0)
    c = lookup_coeffs(rgb_n, zn, coeffs)
    return scale * sigmoid_poly(c, lam)


def illuminant_eval(rgb, lam, zn, coeffs, d65_dense):
    """RgbIlluminantSpectrum at wavelengths ``lam``: the unbounded
    spectrum times D65 (a dense (470,) array)."""
    from .grid import eval_dense
    base = unbounded_eval(rgb, lam, zn, coeffs)
    d65 = torch.tensor(np.asarray(d65_dense), dtype=base.dtype)
    return base * eval_dense(d65, lam)


def sigmoid_poly_s4(c, lam: S4) -> S4:
    """sigmoid(c0 t^2 + c1 t + c2) at S4 wavelengths; c: (R, 3)."""
    c0, c1, c2 = c[..., 0], c[..., 1], c[..., 2]
    scale = 1.0 / (LAMBDA_MAX - LAMBDA_MIN)

    def lane(l):
        t = (l - LAMBDA_MIN) * scale
        return torch.sigmoid((c0 * t + c1) * t + c2)

    return S4(*(lane(l) for l in lam.lanes))


def unbounded_eval_s4(rgb, lam: S4, zn, coeffs) -> S4:
    """RgbUnboundedSpectrum: scale = 2*max(rgb), poly of rgb/scale."""
    scale = 2.0 * rgb.amax(dim=-1)
    rgb_n = torch.where(scale[:, None] > 0,
                        rgb / torch.clamp(scale[:, None], min=1e-12), 0.0)
    c = lookup_coeffs(rgb_n, zn, coeffs)
    return sigmoid_poly_s4(c, lam) * scale


def illuminant_eval_s4(rgb, lam: S4, zn, coeffs, d65_dense,
                       d65_vals=None) -> S4:
    """RgbIlluminantSpectrum: unbounded poly x D65; d65_vals: optional S4
    of D65 already evaluated at ``lam``."""
    from .grid import eval_dense_s4
    base = unbounded_eval_s4(rgb, lam, zn, coeffs)
    if d65_vals is not None:
        return base * d65_vals
    return base * eval_dense_s4(d65_dense.to(torch.float32), lam)
