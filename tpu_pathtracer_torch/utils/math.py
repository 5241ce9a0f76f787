"""The parts of ``tpu_pathtracer/utils/math.py`` the ported path uses:
the Morton code, and the watertight ray/triangle test with its
Dekker-compensated edge functions and the slab test (the building blocks
of the precise kernels' plain versions and of ``ops.trace.intersect_brute``).

Unsigned 32-bit integers are emulated in int64 tensors: every value is
kept in [0, 2^32) by masking with ``M32`` after each multiply, add and
left shift.
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF


def select_lane(values, idx):
    """values (..., K) indexed per element by idx (...) -> (...)."""
    return torch.gather(values, -1, idx.long().unsqueeze(-1)).squeeze(-1)


def morton2(x, y):
    """Interleave 16-bit x, y into a 32-bit Morton code (int64 tensors)."""
    def spread(v):
        v = v.long() & 0x0000FFFF
        v = (v ^ (v << 8)) & 0x00FF00FF
        v = (v ^ (v << 4)) & 0x0F0F0F0F
        v = (v ^ (v << 2)) & 0x33333333
        v = (v ^ (v << 1)) & 0x55555555
        return v
    return ((spread(y) << 1) | spread(x)) & M32


# ---------------------------------------------------------------------------
# Ray-triangle intersection (watertight, PBRT-style)
# ---------------------------------------------------------------------------

def _diff_of_products(a, b, c, d):
    """a*b - c*d with Dekker/TwoProduct compensation (f32-exact sign).

    Each product is computed as (p, err) where err is the rounding error of
    p (error-free split with 2^12 + 1), and the difference is corrected by
    the error terms.  Only meaningful when no multiply-add is contracted
    and nothing is reassociated: eager PyTorch ops qualify, and the CUDA
    kernels are built with ``--fmad=false``."""
    split = 4097.0

    def two_prod(x, y):
        p = x * y
        xs = split * x
        x_hi = xs - (xs - x)
        x_lo = x - x_hi
        ys = split * y
        y_hi = ys - (ys - y)
        y_lo = y - y_hi
        err = ((x_hi * y_hi - p) + x_hi * y_lo + x_lo * y_hi) + x_lo * y_lo
        return p, err

    p, pe = two_prod(a, b)
    q, qe = two_prod(c, d)
    return (p - q) + (pe - qe)


def _axis(v, k):
    """Component k (0/1/2 per element) of v = (x, y, z) tensors."""
    return torch.where(k == 0, v[0], torch.where(k == 1, v[1], v[2]))


def shear_test(ox, oy, oz, dx, dy, dz, kz, verts, t_max):
    """The watertight test on broadcastable component tensors.

    Translate to the ray origin, permute so axis ``kz`` is z, shear the
    ray onto +z, three compensated edge functions, the sign-consistent
    bound test against ``t_max`` before the divide, ``t > 1e-6``.
    verts: ((x, y, z) of p0, of p1, of p2).  Returns (t, b1, b2, hit)."""
    kx = (kz + 1) % 3
    ky = (kz + 2) % 3
    o = (ox, oy, oz)
    d = (dx, dy, dz)
    dpz = _axis(d, kz)
    sx = -_axis(d, kx) / dpz
    sy = -_axis(d, ky) / dpz
    sz = 1.0 / dpz
    opx, opy, opz = _axis(o, kx), _axis(o, ky), _axis(o, kz)

    pxs, pys, pzs = [], [], []
    for v in verts:
        vx = _axis(v, kx) - opx
        vy = _axis(v, ky) - opy
        vz = _axis(v, kz) - opz
        pxs.append(vx + sx * vz)
        pys.append(vy + sy * vz)
        pzs.append(sz * vz)

    e0 = _diff_of_products(pxs[1], pys[2], pys[1], pxs[2])
    e1 = _diff_of_products(pxs[2], pys[0], pys[2], pxs[0])
    e2 = _diff_of_products(pxs[0], pys[1], pys[0], pxs[1])

    same_side = (((e0 <= 0) & (e1 <= 0) & (e2 <= 0))
                 | ((e0 >= 0) & (e1 >= 0) & (e2 >= 0)))
    det = e0 + e1 + e2
    det_ok = det != 0.0
    t_scaled = e0 * pzs[0] + e1 * pzs[1] + e2 * pzs[2]
    bound = t_max * det
    t_ok = torch.where(det < 0.0,
                       (t_scaled <= 0.0) & (t_scaled > bound),
                       (t_scaled >= 0.0) & (t_scaled < bound))
    inv_det = torch.where(det_ok, 1.0 / torch.where(det_ok, det, 1.0), 0.0)
    t = t_scaled * inv_det
    hit = same_side & det_ok & t_ok & (t > 1e-6)
    return t, e1 * inv_det, e2 * inv_det, hit


def intersect_triangle(ray_o, ray_d, p0, p1, p2, t_max):
    """Watertight ray/triangle test on (..., 3) tensors (broadcasting).

    The axis with the largest |d| becomes z, the first one on ties
    (``argmax``), as in the JAX package's ``intersect_triangle``.  Returns
    (t, b1, b2, hit); b1, b2 are the barycentric weights of p1, p2."""
    def comps(a):
        return a[..., 0], a[..., 1], a[..., 2]

    kz = torch.argmax(ray_d.abs(), dim=-1)
    return shear_test(*comps(ray_o), *comps(ray_d), kz,
                      (comps(p0), comps(p1), comps(p2)), t_max)


def intersect_aabb(ray_o, inv_d, bmin, bmax, t_max):
    """Slab test with precomputed 1/d on (..., 3) tensors -> (t_near, hit).
    Flat rays (inv_d = +-inf) are handled by IEEE rules."""
    t0 = (bmin - ray_o) * inv_d
    t1 = (bmax - ray_o) * inv_d
    tn = torch.minimum(t0, t1).amax(dim=-1)
    tf = torch.maximum(t0, t1).amin(dim=-1)
    return tn, (tn <= tf) & (tf > 0.0) & (tn < t_max)
