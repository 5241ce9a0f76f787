"""Port vs JAX: the dielectric BSDFs (glass: dispersive, untinted; plastic:
tinted, constant eta) and their helpers, within rtol 1e-5 / atol 1e-6
(1e-5 absolute for evaluate near the critical angle, as for the metal).

The scene is scene 8 (the SF11 glass bunny) built by the JAX package and
carried to the port with the bridge; the bunny's material row is rewritten
into each case (SF11 and BK7 glass at roughness 0 and 0.2, plastic eta 1.8
smooth and thin, colored plastic eta 1.5 at roughness 0.05) in the JAX
tables before the bridge copies them.  The JAX hits of camera rays are
handed to both packages with outgoing directions drawn on both sides of
the surface, so rays enter and leave the medium (and reflect totally
inside it).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pathtracer.ops import trace as jtrace
from tpu_pathtracer.render import bsdf as jbsdf
from tpu_pathtracer.render import integrator as jint
from tpu_pathtracer.render import microfacet as jmf
from tpu_pathtracer.render import surface as jsurf
from tpu_pathtracer.scene.builder import SceneBuilder as JSceneBuilder
from tpu_pathtracer.scene.types import MAT_GLASS, MAT_PLASTIC
from tpu_pathtracer.scenes import load_scene as jload
from tpu_pathtracer.spectrum import cie as jcie
from tpu_pathtracer.spectrum import sampled as jswl
from tpu_pathtracer.utils import vec as jvec
from tpu_pathtracer_torch.bridge import as_numpy_tree, scene_from_numpy
from tpu_pathtracer_torch.render import bsdf as tbsdf
from tpu_pathtracer_torch.render import integrator as tint
from tpu_pathtracer_torch.render import microfacet as tmf
from tpu_pathtracer_torch.render import surface as tsurf
from tpu_pathtracer_torch.spectrum import cie as tcie
from tpu_pathtracer_torch.spectrum import grid as tgrid
from tpu_pathtracer_torch.spectrum import sampled as tswl
from tpu_pathtracer_torch.utils import vec as tvec

TOL = dict(rtol=1e-5, atol=1e-6)
W, H = 64, 48
BUNNY = 4            # material row: three walls and the light come first

# case -> (mat_type, glass or None, roughness, thin, eta, color)
CASES = {
    "sf11_smooth": (MAT_GLASS, "sf11", 0.0, 0, 1.5, None),
    "sf11_rough": (MAT_GLASS, "sf11", 0.2, 0, 1.5, None),
    "bk7_smooth": (MAT_GLASS, "bk7", 0.0, 0, 1.5, None),
    "bk7_rough": (MAT_GLASS, "bk7", 0.2, 0, 1.5, None),
    "plastic_1.8_smooth": (MAT_PLASTIC, None, 0.0, 0, 1.8, (1.0, 1.0, 1.0)),
    "plastic_1.8_thin": (MAT_PLASTIC, None, 0.0, 1, 1.8, (1.0, 1.0, 1.0)),
    "plastic_color_1.5_rough": (MAT_PLASTIC, None, 0.05, 0, 1.5,
                                (0.4, 0.9, 1.0)),
}


def _t(x):
    if isinstance(x, jvec.V3):
        return tvec.V3(_t(x.x), _t(x.y), _t(x.z))
    if isinstance(x, jvec.V2):
        return tvec.V2(_t(x.x), _t(x.y))
    if isinstance(x, jvec.S4):
        return tvec.S4(*(_t(v) for v in x.lanes))
    return torch.tensor(np.asarray(x))


def _close(t, j, mask=None, **tol):
    if isinstance(t, (tvec.V3, tvec.V2, tvec.S4)):
        for a, b in zip(dataclasses.astuple(t), dataclasses.astuple(j)):
            _close(a, b, mask, **tol)
        return
    t, j = t.numpy(), np.asarray(j)
    if mask is not None:
        t, j = t[mask], j[mask]
    np.testing.assert_allclose(t, j, **(tol or TOL))


@pytest.fixture(scope="module")
def base():
    """Scene 8 by the JAX package, the JAX hits of its camera rays with
    outgoing directions drawn on both sides of the surface, and uniforms."""
    js, jm, jc = jload(8, W, H, table_res=16)
    assert jm.mat_types[BUNNY] == MAT_GLASS
    px = jint._pixel_grid(W, H)
    rng = np.random.default_rng(0)
    uv = rng.uniform(size=(2, W * H)).astype(np.float32)
    ray_o, ray_d, _ = jc.generate_rays(
        px, jvec.V2(jnp.asarray(uv[0]), jnp.asarray(uv[1])))
    hit = jtrace.intersect_scene(js, ray_o, ray_d, jnp.asarray(3e38))
    it = jsurf.make_interaction(js, hit, ray_o, ray_d)
    wo = rng.normal(size=(3, W * H)).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=0, keepdims=True)
    it = it._replace(wo=jvec.V3(*map(jnp.asarray, wo)))
    bunny = np.asarray(it.valid) & (np.asarray(it.mat_id) == BUNNY)
    assert bunny.sum() > 60
    entering = np.asarray(jvec.dot3(it.geo_n, it.wo)) > 0
    assert 0.3 < entering[bunny].mean() < 0.7
    u = rng.uniform(size=(6, W * H)).astype(np.float32)
    coeff = {c: JSceneBuilder(table_res=16)._rgb_coeff(c)
             for case in CASES.values() if (c := case[5]) is not None}
    return dict(js=js, jm=jm, jc=jc, it=it, bunny=bunny, u=u, coeff=coeff)


@pytest.fixture(scope="module", params=list(CASES))
def world(base, request):
    """The bunny's material row set to one case, in both packages."""
    kind, glass, rough, thin, eta, color = CASES[request.param]
    js, jm = base["js"], base["jm"]
    m = js.materials
    eta_row = int(m.eta_row[BUNNY])
    spectra = js.spectra
    if glass is not None:
        spectra = spectra.at[eta_row].set(
            jnp.asarray(jcie.glass_eta(glass), jnp.float32))
    mats = m._replace(
        mat_type=m.mat_type.at[BUNNY].set(kind),
        roughness=m.roughness.at[BUNNY].set(rough),
        thin=m.thin.at[BUNNY].set(thin),
        const_eta=m.const_eta.at[BUNNY].set(eta),
        eta_row=m.eta_row.at[BUNNY].set(eta_row if glass else -1),
        base_coeff=(m.base_coeff if color is None else
                    m.base_coeff.at[BUNNY].set(base["coeff"][color])))
    js = js._replace(materials=mats, spectra=spectra)
    jm = jm._replace(mat_types=tuple(
        kind if i == BUNNY else k for i, k in enumerate(jm.mat_types)))
    ts, tm, _ = scene_from_numpy(as_numpy_tree(js), jm._asdict(),
                                 dataclasses.asdict(base["jc"]), device="cpu")
    u = base["u"]
    jwl = jint._attach_bank(js, jswl.sample_uniform(jnp.asarray(u[0])))
    twl = tswl.sample_uniform(torch.from_numpy(u[0]))
    twl = twl._replace(bank=tgrid.lambda_slice_bank(tint._spectral_table(ts),
                                                    twl.lam))
    it_j = base["it"]
    it_t = tsurf.Interaction(*(_t(v) for v in it_j))
    jf = jvec.make_frame(it_j.shading_n, it_j.tangent)
    tf = tvec.make_frame(it_t.shading_n, it_t.tangent)
    return dict(base, js=js, jm=jm, ts=ts, tm=tm, jwl=jwl, twl=twl,
                it_j=it_j, it_t=it_t, jf=jf, tf=tf,
                jwo=jvec.to_frame(jf, it_j.wo), two=tvec.to_frame(tf, it_t.wo),
                case=CASES[request.param])


def test_dielectric_sample_matches(world):
    kind, glass, rough = world["case"][:3]
    u, m = world["u"], world["bunny"]
    juv = jvec.V2(jnp.asarray(u[1]), jnp.asarray(u[2]))
    tuv = tvec.V2(torch.from_numpy(u[1]), torch.from_numpy(u[2]))
    flags = dict(dispersive=glass is not None, tinted=kind == MAT_PLASTIC)
    j = jbsdf._dielectric_sample(world["js"], world["it_j"], world["jwo"],
                                 jnp.asarray(u[3]), juv, world["jwl"], None,
                                 **flags)
    t = tbsdf._dielectric_sample(world["ts"], world["it_t"], world["two"],
                                 torch.from_numpy(u[3]), tuv, world["twl"],
                                 None, **flags)
    jf_, jwi, jpdf, jok, jspec, jterm = j
    tf_, twi, tpdf, tok, tspec, tterm = t
    for a, b in ((tok, jok), (tspec, jspec), (tterm, jterm)):
        assert np.array_equal(a.numpy()[m], np.asarray(b)[m])
    ok = np.asarray(jok) & m
    assert ok.sum() > 40
    _close(tf_, jf_, ok)
    _close(tpdf, jpdf, ok)
    _close(twi, jwi, ok)
    # both lobes are drawn: reflection and transmission
    refl = (np.asarray(jwi.z) * np.asarray(world["jwo"].z) > 0)[ok]
    assert 0 < refl.sum() < ok.sum()
    assert bool(tspec.numpy()[m].all()) == (rough == 0.0)
    assert bool(tterm.numpy()[m].any()) == (glass is not None)


def test_dielectric_eval_and_pdf_match(world):
    kind, glass, rough = world["case"][:3]
    m = world["bunny"]
    rng = np.random.default_rng(1)
    wi = rng.normal(size=(3, W * H)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=0, keepdims=True)
    flags = dict(dispersive=glass is not None, tinted=kind == MAT_PLASTIC)
    jf_, jpdf = jbsdf._dielectric_eval(world["js"], world["it_j"],
                                       world["jwo"],
                                       jvec.V3(*map(jnp.asarray, wi)),
                                       world["jwl"], None, **flags)
    tf_, tpdf = tbsdf._dielectric_eval(world["ts"], world["it_t"],
                                       world["two"],
                                       tvec.V3(*map(torch.from_numpy, wi)),
                                       world["twl"], None, **flags)
    # near the critical angle inside the glass the Fresnel term of a
    # secondary wavelength amplifies the last-bit differences of the
    # transcendentals (4e-5 relative, 1.6e-6 absolute on one of 3,072 lanes):
    # f is held at test_torch_metal's absolute tolerance, 1e-5
    _close(tf_, jf_, m, rtol=1e-5, atol=1e-5)
    _close(tpdf, jpdf, m, rtol=1e-5, atol=1e-5)
    # a smooth dielectric is a delta: it evaluates to 0
    assert bool((np.asarray(jpdf)[m] > 0).any()) == (rough > 0.0)


def test_material_dispatch_with_dielectric_matches(world):
    """sample_material / evaluate_material over the whole batch, with the
    wavelengths each returns: a dispersive transmission keeps the hero
    wavelength alone (pdf/4) and gives the three others pdf 0."""
    u = world["u"]
    valid = np.asarray(world["it_j"].valid)
    juv = jvec.V2(jnp.asarray(u[1]), jnp.asarray(u[2]))
    tuv = tvec.V2(torch.from_numpy(u[1]), torch.from_numpy(u[2]))
    jms = jbsdf.sample_material(
        world["js"], world["jm"], world["it_j"], world["jf"], world["jwo"],
        jnp.asarray(u[3]), juv, world["jwl"], uc2=jnp.asarray(u[4]),
        uc3=jnp.asarray(u[5]))
    tms = tbsdf.sample_material(
        world["ts"], world["tm"], world["it_t"], world["tf"], world["two"],
        torch.from_numpy(u[3]), tuv, world["twl"],
        uc2=torch.from_numpy(u[4]), uc3=torch.from_numpy(u[5]))
    assert np.array_equal(tms.sampled.numpy()[valid],
                          np.asarray(jms.sampled)[valid])
    assert np.array_equal(tms.specular.numpy()[valid],
                          np.asarray(jms.specular)[valid])
    ok = np.asarray(jms.sampled) & valid
    _close(tms.f, jms.f, ok)
    _close(tms.pdf, jms.pdf, ok)
    _close(tms.wi_t, jms.wi_t, ok)
    for a, b in zip(tms.wl.pdf.lanes, jms.wl.pdf.lanes):
        assert np.array_equal(a.numpy()[valid], np.asarray(b)[valid])
    collapsed = (np.asarray(jms.wl.pdf.b) == 0)[valid]
    assert collapsed.any() == (world["case"][1] is not None)

    jf_, jpdf = jbsdf.evaluate_material(
        world["js"], world["jm"], world["it_j"], world["jf"], world["jwo"],
        jms.wi_t, world["jwl"])
    tf_, tpdf = tbsdf.evaluate_material(
        world["ts"], world["tm"], world["it_t"], world["tf"], world["two"],
        _t(jms.wi_t), world["twl"])
    # at the sampled direction the microfacet D sits on its peak, where
    # float32 rounding is amplified (as for the metal): 5e-5 relative
    _close(tf_, jf_, valid, rtol=5e-5, atol=1e-6)
    _close(tpdf, jpdf, valid, rtol=5e-5, atol=1e-6)


def test_sample_material_without_uc2_uc3_matches(world):
    """A direct call that omits uc2 and uc3: both packages derive them from
    the bits of uc (``_hash_unit``, bit for bit), so the lobe choices agree
    lane for lane and the samples within the tolerance above."""
    u = world["u"]
    valid = np.asarray(world["it_j"].valid)
    for salt in (0x9E3779B9, 0x85EBCA6B):
        assert np.array_equal(
            tbsdf._hash_unit(torch.from_numpy(u[3]), salt).numpy(),
            np.asarray(jbsdf._hash_unit(jnp.asarray(u[3]), salt)))
    jms = jbsdf.sample_material(
        world["js"], world["jm"], world["it_j"], world["jf"], world["jwo"],
        jnp.asarray(u[3]), jvec.V2(jnp.asarray(u[1]), jnp.asarray(u[2])),
        world["jwl"])
    tms = tbsdf.sample_material(
        world["ts"], world["tm"], world["it_t"], world["tf"], world["two"],
        torch.from_numpy(u[3]),
        tvec.V2(torch.from_numpy(u[1]), torch.from_numpy(u[2])),
        world["twl"])
    for k in ("sampled", "specular"):
        assert np.array_equal(getattr(tms, k).numpy()[valid],
                              np.asarray(getattr(jms, k))[valid]), k
    ok = np.asarray(jms.sampled) & valid
    assert ok.any()
    _close(tms.f, jms.f, ok)
    _close(tms.pdf, jms.pdf, ok)
    _close(tms.wi_t, jms.wi_t, ok)


def test_refract_matches():
    rng = np.random.default_rng(3)
    n = 4096
    wi = rng.normal(size=(3, n)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=0, keepdims=True)
    nv = rng.normal(size=(3, n)).astype(np.float32)
    nv /= np.linalg.norm(nv, axis=0, keepdims=True)
    eta = rng.uniform(0.4, 2.5, n).astype(np.float32)
    jwt, jok = jmf.refract(jvec.V3(*map(jnp.asarray, wi)),
                           jvec.V3(*map(jnp.asarray, nv)), jnp.asarray(eta))
    twt, tok = tmf.refract(tvec.V3(*map(torch.from_numpy, wi)),
                           tvec.V3(*map(torch.from_numpy, nv)),
                           torch.from_numpy(eta))
    assert np.array_equal(tok.numpy(), np.asarray(jok))
    ok = np.asarray(jok)
    assert 0.2 < ok.mean() < 0.95          # total internal reflection too
    _close(twt, jwt, ok)


def test_fresnel_dielectric_matches():
    rng = np.random.default_rng(4)
    n = 4096
    ci = rng.uniform(-0.1, 1.1, n).astype(np.float32)   # clipped inside
    ci[:4] = (0.0, 1.0, 1e-4, 0.5)
    eta = rng.uniform(0.4, 2.5, (4, n)).astype(np.float32)
    j = jmf.fresnel_dielectric(jnp.asarray(ci),
                               jvec.S4(*map(jnp.asarray, eta)))
    t = tmf.fresnel_dielectric(torch.from_numpy(ci),
                               tvec.S4(*map(torch.from_numpy, eta)))
    _close(t, j)
    # (at cos 0 under total internal reflection both give 0/0)
    lit = torch.from_numpy(ci > 0.0)
    assert all(0.0 <= float(x[lit].min()) and float(x[lit].max()) <= 1.0 + 1e-6
               for x in t.lanes)


@pytest.mark.parametrize("name", ["bk7", "baf10", "fk51a", "lasf9", "sf5",
                                  "sf10", "sf11"])
def test_glass_eta_matches(name):
    assert tcie.GLASSES == jcie.GLASSES
    te = tcie.glass_eta(name)
    assert np.array_equal(te, jcie.glass_eta(name))
    assert te.shape == (470,) and (np.diff(te) < 0).all()   # normal dispersion
