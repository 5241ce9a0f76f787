"""Surface interactions: gather + interpolate hit attributes.

Counterpart of ``tpu_pathtracer/render/surface.py``: two row gathers (the
vertex row ``bvh.tri9`` and the attribute row ``tri_attr``) feed
barycentric interpolation of position, shading normal, uv and tangent;
everything is carried as (R,) components.  A composite id of an instanced
group gathers the group's canonical rows and carries them into render
space through the instance's affine.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.vec import (V2, V3, cross3, dot3, generate_tangent3, normalize3,
                         orthogonalize3, sel, v3_unstack)


class Interaction(NamedTuple):
    """Batched surface interaction (R rays; masked by ``valid``)."""
    valid: torch.Tensor      # (R,) bool
    position: V3
    geo_n: V3
    shading_n: V3
    tangent: V3
    uv: V2
    mat_id: torch.Tensor     # (R,) int
    light_id: torch.Tensor   # (R,) int area-light row or -1
    tri: torch.Tensor        # (R,) int
    t: torch.Tensor
    wo: V3


def _attrs_at(vrow, arow, b0, b1, b2):
    p0 = v3_unstack(vrow[:, 0:3])
    p1 = v3_unstack(vrow[:, 3:6])
    p2 = v3_unstack(vrow[:, 6:9])
    position = p0 * b0 + p1 * b1 + p2 * b2
    geo_n = normalize3(cross3(p1 - p0, p2 - p0))

    n0 = v3_unstack(arow[:, 0:3])
    n1 = v3_unstack(arow[:, 3:6])
    n2 = v3_unstack(arow[:, 6:9])
    shading_n = normalize3(n0 * b0 + n1 * b1 + n2 * b2)
    # degenerate interpolated normal -> fall back to the geometric normal
    bad_n = dot3(shading_n, shading_n) < 0.5
    shading_n = sel(bad_n, geo_n, shading_n)

    uv = V2(arow[:, 9] * b0 + arow[:, 11] * b1 + arow[:, 13] * b2,
            arow[:, 10] * b0 + arow[:, 12] * b1 + arow[:, 14] * b2)
    raw_t = v3_unstack(arow[:, 15:18])
    return position, geo_n, shading_n, uv, raw_t


def _affine(m, v: V3, rows) -> V3:
    """The linear part of (R, 12) affine rows applied to v, ``rows`` the
    three column triples to read (the matrix, or read transposed)."""
    return V3(*(m[:, c[0]] * v.x + m[:, c[1]] * v.y + m[:, c[2]] * v.z
                for c in rows))


_ROWS = ((0, 1, 2), (3, 4, 5), (6, 7, 8))
_COLS = ((0, 3, 6), (1, 4, 7), (2, 5, 8))


def make_interaction(scene, hit, ray_o: V3, ray_d: V3) -> Interaction:
    """Gather per-triangle attributes at the hit and interpolate.

    A hit in an instanced group (id past the main soup) gathers the
    group's canonical object-space rows: positions and tangents go
    through the instance's forward affine, shading normals through the
    inverse read transposed, the geometric normal comes from the
    render-space edges; the material is the instance's, the light row -1.
    Merged by mask with the main-soup result."""
    tri = torch.clamp(hit.tri, min=0)
    b1 = hit.b1
    b2 = hit.b2
    b0 = 1.0 - b1 - b2

    n_main = scene.bvh.tri9.shape[0]
    tri_main = torch.clamp(tri, max=n_main - 1).long()
    vrow = scene.bvh.tri9[tri_main]
    arow = scene.tri_attr[tri_main]
    position, geo_n, shading_n, uv, raw_t = _attrs_at(vrow, arow, b0, b1, b2)
    mat_id = scene.tri_mat[tri_main]
    light_id = scene.tri_light[tri_main]

    base = n_main
    for g in scene.instanced:
        n_inst = g.inv.shape[0]
        tc = g.bvh.tri9.shape[0]
        in_g = (tri >= base) & (tri < base + n_inst * tc)
        local = torch.clamp(tri - base, 0, n_inst * tc - 1).long()
        inst = local // tc
        tl = torch.where(in_g, local % tc, 0)
        vr = g.bvh.tri9[tl]
        ar = g.tri_attr[tl]
        pos_o, _, sn_o, uv_g, rt_o = _attrs_at(vr, ar, b0, b1, b2)
        f = g.fwd[inst]
        iv = g.inv[inst]
        shift = V3(f[:, 9], f[:, 10], f[:, 11])
        pos_g = _affine(f, pos_o, _ROWS) + shift
        p0w, p1w, p2w = (_affine(f, v3_unstack(vr[:, c:c + 3]), _ROWS) + shift
                         for c in (0, 3, 6))
        gn_g = normalize3(cross3(p1w - p0w, p2w - p0w))
        sn_g = normalize3(_affine(iv, sn_o, _COLS))
        tan_g = _affine(f, rt_o, _ROWS)

        position = sel(in_g, pos_g, position)
        geo_n = sel(in_g, gn_g, geo_n)
        shading_n = sel(in_g, sn_g, shading_n)
        uv = sel(in_g, uv_g, uv)
        raw_t = sel(in_g, tan_g, raw_t)
        mat_id = torch.where(in_g, g.mat_id[inst], mat_id)
        light_id = torch.where(in_g, -1, light_id)
        base += n_inst * tc

    # orthogonalize the per-triangle tangent against the shading normal;
    # fall back where they are parallel
    t_proj = raw_t - shading_n * dot3(raw_t, shading_n)
    parallel = dot3(t_proj, t_proj) < 1e-12
    tangent = sel(parallel, generate_tangent3(shading_n),
                  orthogonalize3(raw_t, shading_n))

    return Interaction(
        valid=hit.hit,
        position=position,
        geo_n=geo_n,
        shading_n=shading_n,
        tangent=tangent,
        uv=uv,
        mat_id=mat_id,
        light_id=light_id,
        tri=tri,
        t=hit.t,
        wo=-ray_d,
    )
