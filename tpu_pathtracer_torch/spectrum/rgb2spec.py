"""RGB -> spectrum sigmoid-polynomial tables: fitting, loading and
batched lookup.

Counterpart of ``tpu_pathtracer/spectrum/rgb2spec.py``.  A table is
(z_nodes (res,), coeffs (3, res, res, res, 3)): [max component][zi][yi][xi]
[c0, c1, c2], and a spectrum is reconstructed as
  s(lambda) = sigmoid(c0*t^2 + c1*t + c2),  t = (lambda-360)/470.

``get_table`` reads the tables committed with the JAX package in
``tpu_pathtracer/data/rgb2spec`` (all 7 gamuts at res 32 and 64, sRGB at
16: 66 MB of data, read by file path rather than copied into the port),
then the port's own cache ``.cache/tpu_pathtracer_torch/rgb2spec`` in the
checkout (gitignored); a table found in neither is fitted by ``fit_table``
(on the GPU when there is one) and written to that cache.
"""
from __future__ import annotations

import os
import tempfile
from functools import lru_cache

import numpy as np
import torch

from ..utils.math import select_lane
from ..utils.vec import S4
from . import cie
from .grid import LAMBDA_MAX, LAMBDA_MIN, N_DENSE

DEFAULT_RES = 64

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# the committed (3, res, res, res, 3) coefficient tables, one file per
# gamut and resolution
TABLE_DIR = os.path.join(_ROOT, "tpu_pathtracer", "data", "rgb2spec")
# tables fitted by the port
CACHE_DIR = os.path.join(_ROOT, ".cache", "tpu_pathtracer_torch", "rgb2spec")


def table_file(gamut_name: str, res: int) -> str:
    # v2: fitted against the standard CIE 1931 1nm CMF tables
    return f"{gamut_name}_{res}_v2.npz"


@lru_cache(maxsize=None)
def get_table(gamut_name: str, res: int = DEFAULT_RES):
    """(z_nodes (res,), coeffs (3, res, res, res, 3)) float32 numpy arrays,
    read-only: the committed table, else the cached fit, else a new fit
    (on the GPU when there is one, else on the CPU), cached."""
    from ..color.gamut import by_name
    gamut = by_name(gamut_name)
    fname = table_file(gamut_name, res)
    for d in (TABLE_DIR, CACHE_DIR):
        path = os.path.join(d, fname)
        if os.path.exists(path):
            with np.load(path) as data:
                zn, coeffs = data["z_nodes"], data["coeffs"]
            break
    else:
        zn, coeffs = fit_table(gamut, res, device="cuda"
                               if torch.cuda.is_available() else "cpu")
        os.makedirs(CACHE_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".npz", dir=CACHE_DIR)
        os.close(fd)
        try:
            np.savez_compressed(tmp, z_nodes=zn, coeffs=coeffs)
            os.replace(tmp, os.path.join(CACHE_DIR, fname))
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    zn.setflags(write=False)
    coeffs.setflags(write=False)
    return zn, coeffs


# ---------------------------------------------------------------------------
# Fitting
# ---------------------------------------------------------------------------

def _smoothstep(x):
    return 3.0 * x * x - 2.0 * x * x * x


def z_nodes(res: int) -> np.ndarray:
    """Double-smoothstep z spacing (denser near 0 and 1)."""
    k = np.arange(res) / (res - 1)
    return _smoothstep(_smoothstep(k))


_LAB_EPS = (6.0 / 29.0) ** 3
_LAB_KAPPA = (29.0 / 6.0) ** 2 / 3.0


def _lab_from_xyz(xyz, white):
    """CIELAB of (..., 3) XYZ tensors against the white point ``white``."""
    r = xyz / white
    f = torch.where(r > _LAB_EPS, torch.clamp(r, min=1e-12) ** (1.0 / 3.0),
                    _LAB_KAPPA * r + 4.0 / 29.0)
    L = 116.0 * f[..., 1] - 16.0
    a = 500.0 * (f[..., 0] - f[..., 1])
    b = 200.0 * (f[..., 1] - f[..., 2])
    return torch.stack([L, a, b], dim=-1)


GN_STEPS = 25    # Gauss-Newton steps a slice


def _fit_slice(c_init, rgb_targets, a_matrix, rgb_to_xyz, white, t_grid):
    """Damped Gauss-Newton fit of the sigmoid-polynomial coefficients of
    one z-slice, every cell at once: the residual is the CIELAB difference
    of the spectrum's XYZ (under ``a_matrix``) from the target's, the
    Jacobian analytic, the 3x3 normal equations solved in a batch, and a
    cell takes a step only where it lowers its residual.

    c_init: (cells, 3) warm start; rgb_targets: (cells, 3) linear rgb;
    a_matrix: (470, 3) CMFs x D65 (albedo-normalized); t_grid: (470,)."""
    lab_target = _lab_from_xyz(rgb_targets @ rgb_to_xyz.T, white)
    # the t^2, t^1, t^0 basis rows of the analytic Jacobian
    t_pows = torch.stack([t_grid * t_grid, t_grid, torch.ones_like(t_grid)])
    damp = 1e-4 * torch.eye(3, dtype=c_init.dtype, device=c_init.device)

    def spectrum_and_xyz(c):
        s = torch.sigmoid(c[..., 0:1] * t_grid * t_grid
                          + c[..., 1:2] * t_grid + c[..., 2:3])
        return s, s @ a_matrix                          # (cells, 470), (cells, 3)

    c = c_init
    for _ in range(GN_STEPS):
        s, xyz = spectrum_and_xyz(c)
        r = _lab_from_xyz(xyz, white) - lab_target       # (cells, 3)
        # dxyz/dc_k = (s (1 - s) t^k) @ A
        ds = s * (1.0 - s)
        dxyz_dc = torch.einsum("kl,cl,lj->cjk", t_pows, ds, a_matrix)
        # dLab/dxyz from f'(xyz / white) / white
        ratio = xyz / white
        fp = torch.where(ratio > _LAB_EPS,
                         (1.0 / 3.0) * torch.clamp(ratio, min=1e-12)
                         ** (-2.0 / 3.0),
                         _LAB_KAPPA) / white              # (cells, 3)
        zero = torch.zeros_like(fp[..., 0])
        dlab = torch.stack([
            torch.stack([zero, 116.0 * fp[..., 1], zero], -1),
            torch.stack([500.0 * fp[..., 0], -500.0 * fp[..., 1], zero], -1),
            torch.stack([zero, 200.0 * fp[..., 1], -200.0 * fp[..., 2]], -1),
        ], -2)                                            # (cells, Lab, xyz)
        j = dlab @ dxyz_dc                                # (cells, Lab, c)
        jtj = j.transpose(1, 2) @ j
        jtr = (j.transpose(1, 2) @ r[..., None])[..., 0]
        delta = torch.linalg.solve(jtj + damp, jtr)
        c_new = c - delta
        _, xyz_new = spectrum_and_xyz(c_new)
        r_new = _lab_from_xyz(xyz_new, white) - lab_target
        better = (r_new ** 2).sum(-1) < (r ** 2).sum(-1)
        c = torch.where(better[:, None], c_new, c)
    return c


def fit_table(gamut, res: int = DEFAULT_RES, verbose: bool = False,
              device=None):
    """Fit the (3, res, res, res, 3) coefficient table of ``gamut`` on
    ``device`` (None: the GPU, raising without one).

    The z-slices are fitted outward from the middle one, each warm-started
    from its neighbour's coefficients (from 0 for the middle slice), each
    one vectorized Gauss-Newton solve over its 3 res^2 cells, in float32.
    Returns float32 numpy (z_nodes (res,), coeffs)."""
    from ..device import resolve_device
    dev = resolve_device(device)
    zn = z_nodes(res)
    d65 = cie.illum_d6500()             # normalized: <D65, ybar> == 1
    cmf = np.stack([cie.cie_x(), cie.cie_y(), cie.cie_z()], axis=-1)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    a_matrix = f32(cmf * d65[:, None])
    rgb_to_xyz = f32(gamut.rgb_to_xyz)
    white = f32(gamut.rgb_to_xyz @ np.ones(3))
    t_grid = f32(np.arange(N_DENSE) / (LAMBDA_MAX - LAMBDA_MIN))

    # a slice's cell targets: for max component m at value z, the other
    # two channels sweep [0, z] on a res x res grid
    xy = np.stack(np.meshgrid(np.arange(res), np.arange(res),
                              indexing="ij"), -1)
    frac = xy[..., ::-1] / (res - 1)                     # x, y fractions

    def slice_targets(zi):
        z = max(zn[zi], 1e-4)
        rgbs = []
        for m in range(3):
            rgb = np.zeros((res, res, 3))
            rgb[..., m] = z
            rgb[..., (m + 1) % 3] = frac[..., 0] * z
            rgb[..., (m + 2) % 3] = frac[..., 1] * z
            rgbs.append(rgb.reshape(-1, 3))
        return np.concatenate(rgbs, 0)                   # (3 res^2, 3)

    coeffs = np.zeros((3, res, res, res, 3), np.float32)
    mid = res // 2
    c_mid = torch.zeros((3 * res * res, 3), dtype=torch.float32, device=dev)
    for order in (range(mid, res), range(mid - 1, -1, -1)):
        c = c_mid
        for zi in order:
            c = _fit_slice(c, f32(slice_targets(zi)), a_matrix, rgb_to_xyz,
                           white, t_grid)
            coeffs[:, zi] = c.cpu().numpy().reshape(3, res, res, 3)
            if zi == mid:
                c_mid = c
            if verbose:
                print(f"  slice {zi} done")
    return zn.astype(np.float32), coeffs


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
