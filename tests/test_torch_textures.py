"""Port vs JAX: texture sampling and decode, the normal-map frame, the
textured material parameters (albedo, roughness, metallic, coat
thickness), the PBR material and textured emission.

Scenes 3 (checker albedo + normal map on a Lambert bunny), 15 (PBR dragon
with base color, metallic, roughness and normal maps) and 18 (clearcoat
dragon with a thickness map) are built by the JAX package and carried to
the port with the bridge; the JAX hits of camera rays are handed to both
packages.  Tolerance rtol 1e-5 / atol 1e-6 for sampling and decode; for
what depends on the normal-map frame, rtol 1e-5 / atol 1e-5, the tolerance
of ``test_torch_metal.py``: where a mapped normal nearly meets the frame's
+X axis, its tangent normalize(x - n (n . x)) cancels, and a last-bit
difference of n (rsqrt, fused multiply-adds) grows to 1e-5 there.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pathtracer import color as jcolor
from tpu_pathtracer.ops import trace as jtrace
from tpu_pathtracer.render import bsdf as jbsdf
from tpu_pathtracer.render import integrator as jint
from tpu_pathtracer.render import surface as jsurf
from tpu_pathtracer.render import texture as jtex
from tpu_pathtracer.scene import builder as jbuilder
from tpu_pathtracer.scene import mesh as jmesh
from tpu_pathtracer.scenes import load_scene as jload
from tpu_pathtracer.spectrum import sampled as jswl
from tpu_pathtracer.utils import vec as jvec
from tpu_pathtracer_torch import color as tcolor
from tpu_pathtracer_torch.bridge import as_numpy_tree, scene_from_numpy
from tpu_pathtracer_torch.render import bsdf as tbsdf
from tpu_pathtracer_torch.render import integrator as tint
from tpu_pathtracer_torch.render import surface as tsurf
from tpu_pathtracer_torch.render import texture as ttex
from tpu_pathtracer_torch.scene import builder as tbuilder
from tpu_pathtracer_torch.scene import mesh as tmesh
from tpu_pathtracer_torch.spectrum import grid as tgrid
from tpu_pathtracer_torch.spectrum import sampled as tswl
from tpu_pathtracer_torch.utils import vec as tvec

TOL = dict(rtol=1e-5, atol=1e-6)
TOL_FRAME = dict(rtol=1e-5, atol=1e-5)
W, H = 64, 48


def _t(x):
    if isinstance(x, (jvec.V3, jvec.V2, jvec.S4)):
        cls = {jvec.V3: tvec.V3, jvec.V2: tvec.V2, jvec.S4: tvec.S4}[type(x)]
        return cls(*(_t(v) for v in dataclasses.astuple(x)))
    if isinstance(x, jvec.Frame):
        return tvec.Frame(_t(x.t), _t(x.b), _t(x.n))
    return torch.tensor(np.asarray(x))


def _close(t, j, mask=None, **tol):
    if isinstance(t, (tvec.V3, tvec.V2, tvec.S4)):
        for a, b in zip(dataclasses.astuple(t), dataclasses.astuple(j)):
            _close(a, b, mask, **tol)
        return
    if isinstance(t, tvec.Frame):
        for a, b in ((t.t, j.t), (t.b, j.b), (t.n, j.n)):
            _close(a, b, mask, **tol)
        return
    t, j = t.numpy(), np.asarray(j)
    if mask is not None:
        t, j = t[mask], j[mask]
    np.testing.assert_allclose(t, j, **(tol or TOL))


def _uv(n, rng):
    """uv in [-2.5, 3.5) with the wrap points themselves among them."""
    uv = rng.uniform(-2.5, 3.5, size=(2, n)).astype(np.float32)
    edge = np.asarray([-1e-7, 0.0, 1.0, -1.0, 0.9999999, 2.0, -2.5, 1e-7],
                      np.float32)
    uv[0, :len(edge)] = edge
    uv[1, :len(edge)] = edge[::-1]
    return uv


def test_sample_bilinear_and_indexed_match():
    rng = np.random.default_rng(0)
    texs = [rng.uniform(0, 2, size=s).astype(np.float32)
            for s in ((8, 16, 3), (5, 7, 1), (4, 4, 3))]
    n = 2048
    uv = _uv(n, rng)
    juv = jvec.V2(*map(jnp.asarray, uv))
    tuv = tvec.V2(*map(torch.from_numpy, uv))
    for tex in texs:
        _close(ttex.sample_bilinear(torch.from_numpy(tex), tuv),
               jtex.sample_bilinear(jnp.asarray(tex), juv))
    ids = rng.integers(-1, 3, n).astype(np.int32)
    for ch, default in ((3, [0.5, 0.5, 1.0]), (1, [0.25])):
        j = jtex.sample_indexed(tuple(map(jnp.asarray, texs)),
                                jnp.asarray(ids), juv, ch,
                                jnp.asarray(default))
        t = ttex.sample_indexed(tuple(map(torch.from_numpy, texs)),
                                torch.from_numpy(ids), tuv, ch, default)
        assert t.shape == (n, ch)
        _close(t, j)
        assert np.array_equal(t.numpy()[ids < 0],
                              np.broadcast_to(default, (int((ids < 0).sum()), ch)))


@pytest.mark.parametrize("kind,gamut,eotf", [
    ("rgb", "srgb", "srgb"), ("rgb", "display_p3", "srgb"),
    ("rgb", "rec2020", "linear"), ("gray", "srgb", "gamma2_2"),
    ("normal", "display_p3", "srgb")])
def test_texture_decode_matches(kind, gamut, eotf):
    """The decode done once at build: the EOTF, then the gamut conversion
    to the scene's working gamut (rgb only; normal maps are left as they
    are)."""
    rng = np.random.default_rng(1)
    data = rng.uniform(0, 1, size=(6, 5, 1 if kind == "gray" else 3))
    j = jbuilder.Texture(data, kind=kind, gamut=gamut, eotf=eotf)
    t = tbuilder.Texture(data, kind=kind, gamut=gamut, eotf=eotf)
    srgb = jcolor.by_name("srgb")
    out = t.decoded(tcolor.by_name("srgb"))
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, np.asarray(j.decoded(srgb)), **TOL)
    xyz = rng.uniform(0, 1, size=(16, 3)).astype(np.float32)
    g = tcolor.by_name(gamut)
    _close(tcolor.xyz_to_rgb(torch.from_numpy(xyz), g),
           jcolor.xyz_to_rgb(jnp.asarray(xyz), jcolor.by_name(gamut)))
    _close(tcolor.rgb_to_xyz(torch.from_numpy(xyz), g),
           jcolor.rgb_to_xyz(jnp.asarray(xyz), jcolor.by_name(gamut)))


@pytest.fixture(scope="module", params=[3, 15, 18])
def world(request):
    """A textured scene by the JAX package, bridged; the JAX hits of its
    camera rays, wavelengths and uniforms."""
    js, jm, jc = jload(request.param, W, H, table_res=16)
    assert len(js.textures) > 0
    ts, tm, _ = scene_from_numpy(as_numpy_tree(js), jm._asdict(),
                                 dataclasses.asdict(jc), device="cpu")
    rng = np.random.default_rng(request.param)
    uv = rng.uniform(size=(2, W * H)).astype(np.float32)
    ray_o, ray_d, _ = jc.generate_rays(
        jint._pixel_grid(W, H), jvec.V2(jnp.asarray(uv[0]),
                                        jnp.asarray(uv[1])))
    hit = jtrace.intersect_scene(js, ray_o, ray_d, jnp.asarray(3e38))
    it_j = jsurf.make_interaction(js, hit, ray_o, ray_d)
    it_t = tsurf.Interaction(*(_t(v) for v in it_j))
    hero = np.asarray(it_j.valid) & (np.asarray(it_j.mat_id) == 4)
    assert hero.sum() > 100
    u = rng.uniform(size=(6, W * H)).astype(np.float32)
    jwl = jint._attach_bank(js, jswl.sample_uniform(jnp.asarray(u[0])))
    twl = tswl.sample_uniform(torch.from_numpy(u[0]))
    twl = twl._replace(bank=tgrid.lambda_slice_bank(tint._spectral_table(ts),
                                                    twl.lam))
    jf = jvec.make_frame(it_j.shading_n, it_j.tangent)
    tf = tvec.make_frame(it_t.shading_n, it_t.tangent)
    return dict(n=request.param, js=js, jm=jm, ts=ts, tm=tm, it_j=it_j,
                it_t=it_t, hero=hero, u=u, jwl=jwl, twl=twl, jf=jf, tf=tf,
                jwo=jvec.to_frame(jf, it_j.wo), two=tvec.to_frame(tf, it_t.wo))


def test_normal_map_frame_matches(world):
    jn = jbsdf._normal_map_frame(world["js"], world["it_j"], world["jwo"])
    tn = tbsdf._normal_map_frame(world["ts"], world["it_t"])
    valid = np.asarray(world["it_j"].valid)
    _close(tn, jn, valid, **TOL_FRAME)
    # the scene's normal map tilts the normal on the hero mesh (scene 18
    # has none: the identity there)
    tilted = (tn.n.z.numpy() < 1.0 - 1e-4)[world["hero"]]
    assert tilted.any() == (world["n"] != 18)


def test_textured_parameters_match(world):
    """Textured albedo, roughness, metallic and coat thickness at the hits."""
    js, ts, it_j, it_t = world["js"], world["ts"], world["it_j"], world["it_t"]
    valid = np.asarray(it_j.valid)
    _close(tbsdf._albedo_spectrum(ts, it_t, world["twl"]),
           jbsdf._albedo_spectrum(js, it_j, world["jwl"]), valid)
    _close(tbsdf._roughness(ts, it_t), jbsdf._roughness(js, it_j), valid)
    tb, tmet, talpha, tr0 = tbsdf._pbr_params(ts, it_t, world["twl"])
    jb, jmet, jalpha, jr0 = jbsdf._pbr_params(js, it_j, world["jwl"])
    _close(tmet, jmet, valid)
    _close(talpha, jalpha, valid)
    tthick = tbsdf._coat_params(ts, it_t, world["twl"])[0]
    jthick = jbsdf._coat_params(js, it_j, world["jwl"])[0]
    _close(tthick, jthick, valid)
    hero = world["hero"]
    varies = {3: tbsdf._albedo_spectrum(ts, it_t, world["twl"]).a,
              15: tmet, 18: tthick}[world["n"]].numpy()[hero]
    assert varies.max() > varies.min() + 0.1      # the texture shows


def test_pbr_sample_and_eval_match(world):
    """The PBR material with the scene's maps (its sample and eval, in the
    normal-map frame) and the dispatch over the whole batch."""
    js, ts, it_j, it_t = world["js"], world["ts"], world["it_j"], world["it_t"]
    u = world["u"]
    valid = np.asarray(it_j.valid)
    juv = jvec.V2(jnp.asarray(u[1]), jnp.asarray(u[2]))
    tuv = tvec.V2(torch.from_numpy(u[1]), torch.from_numpy(u[2]))
    jnm = jbsdf._normal_map_frame(js, it_j, world["jwo"])
    tnm = tbsdf._normal_map_frame(ts, it_t)
    jf_, jwi, jpdf, jok, jspec = jbsdf._pbr_sample(
        js, it_j, world["jwo"], jnp.asarray(u[3]), jnp.asarray(u[4]), juv,
        world["jwl"], jnm)
    tf_, twi, tpdf, tok, tspec = tbsdf._pbr_sample(
        ts, it_t, world["two"], torch.from_numpy(u[3]),
        torch.from_numpy(u[4]), tuv, world["twl"], tnm)
    assert np.array_equal(tok.numpy()[valid], np.asarray(jok)[valid])
    assert np.array_equal(tspec.numpy()[valid], np.asarray(jspec)[valid])
    ok = np.asarray(jok) & valid
    _close(tf_, jf_, ok, **TOL_FRAME)
    _close(tpdf, jpdf, ok, **TOL_FRAME)
    _close(twi, jwi, ok, **TOL_FRAME)
    jef, jep = jbsdf._pbr_eval(js, it_j, world["jwo"], jwi, world["jwl"], jnm)
    tef, tep = tbsdf._pbr_eval(ts, it_t, world["two"], _t(jwi), world["twl"],
                               tnm)
    _close(tef, jef, ok, rtol=5e-5, atol=1e-5)
    _close(tep, jep, ok, rtol=5e-5, atol=1e-5)

    jms = jbsdf.sample_material(js, world["jm"], it_j, world["jf"],
                                world["jwo"], jnp.asarray(u[3]), juv,
                                world["jwl"], uc2=jnp.asarray(u[4]),
                                uc3=jnp.asarray(u[5]))
    tms = tbsdf.sample_material(ts, world["tm"], it_t, world["tf"],
                                world["two"], torch.from_numpy(u[3]), tuv,
                                world["twl"], uc2=torch.from_numpy(u[4]),
                                uc3=torch.from_numpy(u[5]))
    assert np.array_equal(tms.sampled.numpy()[valid],
                          np.asarray(jms.sampled)[valid])
    ok = np.asarray(jms.sampled) & valid
    # where a lobe is narrow (scene 18's coat, alpha = 0.05^2; scene 15's
    # smoothest texels) and the sample sits on its peak (pdf >= 10), D's
    # 1 - cos^2 cancels: float32 holds f and pdf there to a few percent in
    # either package.  Those lanes are held at 5 %, the others as the rest
    peak = np.asarray(jms.pdf) >= 10.0
    _close(tms.f, jms.f, ok & peak, rtol=5e-2, atol=1e-5)
    _close(tms.pdf, jms.pdf, ok & peak, rtol=5e-2, atol=1e-5)
    ok = ok & ~peak
    _close(tms.f, jms.f, ok, **TOL_FRAME)
    _close(tms.pdf, jms.pdf, ok, **TOL_FRAME)
    _close(tms.wi_t, jms.wi_t, ok, **TOL_FRAME)
    jf2, jp2 = jbsdf.evaluate_material(js, world["jm"], it_j, world["jf"],
                                       world["jwo"], jms.wi_t, world["jwl"])
    tf2, tp2 = tbsdf.evaluate_material(ts, world["tm"], it_t, world["tf"],
                                       world["two"], _t(jms.wi_t),
                                       world["twl"])
    _close(tf2, jf2, valid & ~peak, rtol=5e-5, atol=1e-5)
    _close(tp2, jp2, valid & ~peak, rtol=5e-5, atol=1e-5)
    _close(tf2, jf2, valid & peak, rtol=5e-2, atol=1e-5)
    _close(tp2, jp2, valid & peak, rtol=5e-2, atol=1e-5)


def _emitter_scene(pkg_builder, pkg_mesh, tex):
    sb = pkg_builder.SceneBuilder(table_res=16)
    m_e = sb.add_material(pkg_builder.Emissive(
        spectrum=pkg_builder.Texture(tex), intensity=2.0))
    sb.add_mesh(pkg_mesh.quad([-1, 0, 1], [1, 0, 1], [1, 0, -1], [-1, 0, -1]),
                m_e)
    return sb.build((0.0, 2.0, 3.0))


def test_textured_emission_matches():
    """An emitter with a radiance texture, built by both packages: the
    tables (the light's power row from the average texel) and its
    radiance at uvs across the texture."""
    rng = np.random.default_rng(2)
    tex = rng.uniform(0, 4, size=(3, 5, 3)).astype(np.float32)
    js, jm = _emitter_scene(jbuilder, jmesh, tex)
    ts, tm = _emitter_scene(tbuilder, tmesh, tex)
    assert tm.has_emission_tex and jm.has_emission_tex
    assert tuple(tm) == tuple(jm)
    np.testing.assert_allclose(ts.spectra.numpy(), np.asarray(js.spectra),
                               rtol=1e-6)
    np.testing.assert_array_equal(ts.textures[0].numpy(),
                                  np.asarray(js.textures[0]))
    n = 1024
    uv = _uv(n, rng)
    mat = np.zeros(n, np.int32)
    u = rng.uniform(size=n).astype(np.float32)
    jwl = jint._attach_bank(js, jswl.sample_uniform(jnp.asarray(u)))
    twl = tswl.sample_uniform(torch.from_numpy(u))
    twl = twl._replace(bank=tgrid.lambda_slice_bank(tint._spectral_table(ts),
                                                    twl.lam))
    j = jbsdf.emission_spectral(js, jm, jnp.asarray(mat),
                                jvec.V2(*map(jnp.asarray, uv)), jwl)
    t = tbsdf.emission_spectral(ts, tm, torch.from_numpy(mat),
                                tvec.V2(*map(torch.from_numpy, uv)), twl)
    _close(t, j)
    assert float(t.a.max()) > 2.0 * float(t.a.min()) + 1e-3

