"""Port vs JAX: the conductor (metal) BSDF and its Fresnel term, on the
gold bunny of scene 6, with roughness 0 (the specular branch) and 0.25
(the microfacet branch), within 1e-5.

The scene is built by the JAX package and carried to the port with the
bridge; the JAX hits and Interaction are handed to both packages.
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
from tpu_pathtracer.scene.types import MAT_METAL
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

TOL = dict(rtol=1e-5, atol=1e-5)
W, H = 32, 24


def _t(x):
    if isinstance(x, jvec.V3):
        return tvec.V3(_t(x.x), _t(x.y), _t(x.z))
    if isinstance(x, jvec.V2):
        return tvec.V2(_t(x.x), _t(x.y))
    if isinstance(x, jvec.S4):
        return tvec.S4(*(_t(v) for v in x.lanes))
    return torch.tensor(np.asarray(x))


def _close(t, j, **tol):
    if isinstance(t, (tvec.V3, tvec.V2, tvec.S4)):
        for a, b in zip(dataclasses.astuple(t), dataclasses.astuple(j)):
            _close(a, b, **tol)
        return
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **(tol or TOL))


@pytest.fixture(scope="module")
def base():
    """Scene 6 by the JAX package, JAX hits of the camera rays that land
    on the bunny, wavelengths and uniforms."""
    js, jm, jc = jload(6, W, H, table_res=16)
    px = jint._pixel_grid(W, H)
    rng = np.random.default_rng(0)
    uv = rng.uniform(size=(2, W * H)).astype(np.float32)
    ray_o, ray_d, _ = jc.generate_rays(
        px, jvec.V2(jnp.asarray(uv[0]), jnp.asarray(uv[1])))
    hit = jtrace.intersect_scene(js, ray_o, ray_d, jnp.asarray(3e38))
    it = jsurf.make_interaction(js, hit, ray_o, ray_d)
    metal = np.asarray(it.valid) & (
        np.asarray(js.materials.mat_type)[np.asarray(it.mat_id)] == MAT_METAL)
    assert metal.sum() > 40
    u = rng.uniform(size=(4, W * H)).astype(np.float32)
    return dict(js=js, jm=jm, jc=jc, it=it, metal=metal, u=u)


@pytest.fixture(scope="module", params=[0.0, 0.25], ids=["smooth", "rough"])
def world(base, request):
    """The scene with the metal's roughness set, in both packages."""
    js = base["js"]
    mats = js.materials
    rough = jnp.where(mats.mat_type == MAT_METAL, request.param,
                      mats.roughness)
    js = js._replace(materials=mats._replace(roughness=rough))
    ts, tm, _ = scene_from_numpy(as_numpy_tree(js), base["jm"]._asdict(),
                                 dataclasses.asdict(base["jc"]), device="cpu")
    jwl = jint._attach_bank(js, jswl.sample_uniform(jnp.asarray(base["u"][0])))
    twl = tswl.sample_uniform(torch.from_numpy(base["u"][0]))
    twl = twl._replace(bank=tgrid.lambda_slice_bank(tint._spectral_table(ts),
                                                    twl.lam))
    it_j = base["it"]
    it_t = tsurf.Interaction(*(_t(v) for v in it_j))
    jf = jvec.make_frame(it_j.shading_n, it_j.tangent)
    tf = tvec.make_frame(it_t.shading_n, it_t.tangent)
    return dict(base, js=js, ts=ts, tm=tm, jwl=jwl, twl=twl, it_j=it_j,
                it_t=it_t, jf=jf, tf=tf, jwo=jvec.to_frame(jf, it_j.wo),
                two=tvec.to_frame(tf, it_t.wo), rough=request.param)


def test_metal_sample_matches(world):
    u, m = world["u"], world["metal"]
    juv = jvec.V2(jnp.asarray(u[1]), jnp.asarray(u[2]))
    tuv = tvec.V2(torch.from_numpy(u[1]), torch.from_numpy(u[2]))
    jf_, jwi, jpdf, jok, jspec = jbsdf._metal_sample(
        world["js"], world["it_j"], world["jwo"], juv, world["jwl"], None)
    tf_, twi, tpdf, tok, tspec = tbsdf._metal_sample(
        world["ts"], world["it_t"], world["two"], tuv, world["twl"])
    ok = np.asarray(jok) & m
    assert np.array_equal(tok.numpy()[m], np.asarray(jok)[m])
    assert np.array_equal(tspec.numpy()[m], np.asarray(jspec)[m])
    assert bool(tspec[torch.from_numpy(m)].all()) == (world["rough"] == 0.0)
    assert ok.sum() > 40
    for a, b in zip(tf_.lanes, jf_.lanes):
        np.testing.assert_allclose(a.numpy()[ok], np.asarray(b)[ok], **TOL)
    np.testing.assert_allclose(tpdf.numpy()[ok], np.asarray(jpdf)[ok],
                               rtol=1e-5, atol=1e-5)
    for a, b in zip(dataclasses.astuple(twi), dataclasses.astuple(jwi)):
        np.testing.assert_allclose(a.numpy()[ok], np.asarray(b)[ok], **TOL)
    # gold reflects: the Fresnel-weighted value is well above zero
    assert float(tf_.a[torch.from_numpy(ok)].max()) > 0.3


def test_metal_eval_and_pdf_match(world):
    m = world["metal"]
    rng = np.random.default_rng(1)
    wi = rng.normal(size=(3, W * H)).astype(np.float32)
    wi[2] = np.abs(wi[2]) * np.sign(np.asarray(world["jwo"].z))
    wi /= np.linalg.norm(wi, axis=0, keepdims=True)
    jf_, jpdf = jbsdf._metal_eval(world["js"], world["it_j"], world["jwo"],
                                  jvec.V3(*map(jnp.asarray, wi)),
                                  world["jwl"], None)
    tf_, tpdf = tbsdf._metal_eval(world["ts"], world["it_t"], world["two"],
                                  tvec.V3(*map(torch.from_numpy, wi)),
                                  world["twl"])
    for a, b in zip(tf_.lanes, jf_.lanes):
        np.testing.assert_allclose(a.numpy()[m], np.asarray(b)[m], **TOL)
    np.testing.assert_allclose(tpdf.numpy()[m], np.asarray(jpdf)[m], **TOL)
    lit = (np.asarray(jpdf) > 0)[m]
    assert lit.any() == (world["rough"] > 0.0)   # a smooth lobe evaluates to 0


def test_material_dispatch_with_metal_matches(world):
    """sample_material / evaluate_material over the whole batch (Lambert
    walls, emissive light and the metal bunny merged by mat_type)."""
    u = world["u"]
    jms = jbsdf.sample_material(
        world["js"], world["jm"], world["it_j"], world["jf"], world["jwo"],
        jnp.asarray(u[3]), jvec.V2(jnp.asarray(u[1]), jnp.asarray(u[2])),
        world["jwl"], uc2=jnp.asarray(u[0]), uc3=jnp.asarray(u[3]))
    tms = tbsdf.sample_material(
        world["ts"], world["tm"], world["it_t"], world["tf"], world["two"],
        torch.from_numpy(u[3]),
        tvec.V2(torch.from_numpy(u[1]), torch.from_numpy(u[2])),
        world["twl"], uc2=torch.from_numpy(u[0]), uc3=torch.from_numpy(u[3]))
    ok = np.asarray(jms.sampled) & np.asarray(world["it_j"].valid)
    assert np.array_equal(tms.sampled.numpy(), np.asarray(jms.sampled))
    assert np.array_equal(tms.specular.numpy(), np.asarray(jms.specular))
    for a, b in zip(tms.f.lanes, jms.f.lanes):
        np.testing.assert_allclose(a.numpy()[ok], np.asarray(b)[ok], **TOL)
    np.testing.assert_allclose(tms.pdf.numpy()[ok], np.asarray(jms.pdf)[ok],
                               **TOL)
    jf_, jpdf = jbsdf.evaluate_material(
        world["js"], world["jm"], world["it_j"], world["jf"], world["jwo"],
        jms.wi_t, world["jwl"])
    tf_, tpdf = tbsdf.evaluate_material(
        world["ts"], world["tm"], world["it_t"], world["tf"], world["two"],
        _t(jms.wi_t), world["twl"])
    # at the sampled direction the microfacet D sits on its peak, where
    # float32 rounding is amplified: 5e-5 relative here
    _close(tf_, jf_, rtol=5e-5, atol=1e-5)
    _close(tpdf, jpdf, rtol=5e-5, atol=1e-5)
    _close(tbsdf.sample_albedo(world["ts"], world["tm"], world["it_t"],
                               world["twl"]),
           jbsdf.sample_albedo(world["js"], world["jm"], world["it_j"],
                               world["jwl"]))


def test_fresnel_complex_matches():
    rng = np.random.default_rng(2)
    n = 4096
    ci = rng.uniform(-0.1, 1.1, n).astype(np.float32)   # clipped inside
    ci[:4] = (0.0, 1.0, 1e-4, 0.5)
    eta = rng.uniform(0.1, 3.0, (4, n)).astype(np.float32)
    k = rng.uniform(0.0, 7.0, (4, n)).astype(np.float32)
    k[:, ::9] = 0.0                                       # dielectric limit
    j = jmf.fresnel_complex(jnp.asarray(ci), jvec.S4(*map(jnp.asarray, eta)),
                            jvec.S4(*map(jnp.asarray, k)))
    t = tmf.fresnel_complex(torch.from_numpy(ci),
                            tvec.S4(*map(torch.from_numpy, eta)),
                            tvec.S4(*map(torch.from_numpy, k)))
    _close(t, j)
    assert all(0.0 <= float(x.min()) and float(x.max()) <= 1.0 + 1e-5
               for x in t.lanes)


@pytest.mark.parametrize("name", ["au", "ag", "cu", "al", "cuzn"])
def test_metal_tables_match(name):
    je, jk = jcie.metal_eta_k(name)
    te, tk = tcie.metal_eta_k(name)
    assert np.array_equal(te, je) and np.array_equal(tk, jk)
    assert te.shape == (470,) and (tk > 0).all()
