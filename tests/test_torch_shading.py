"""Port vs JAX, per shading module on identical inputs: the hit record
(make_interaction), the materials (Lambert + clearcoat sample / evaluate,
emission) and the lights (area-light NEE, light pick, MIS pdf), within
1e-5 (float32 on both sides; transcendentals differ in the last bits
between XLA and PyTorch).

The scene is scene 17 built by the JAX package and carried to the port
with ``bridge.scene_from_numpy``; hits come from the JAX traversal, and
the JAX Interaction is handed to both packages' shading code.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pathtracer.ops import trace as jtrace
from tpu_pathtracer.render import bsdf as jbsdf
from tpu_pathtracer.render import integrator as jint
from tpu_pathtracer.render import lights as jlights
from tpu_pathtracer.render import surface as jsurf
from tpu_pathtracer.scenes import load_scene as jload
from tpu_pathtracer.spectrum import sampled as jswl
from tpu_pathtracer.utils import vec as jvec
from tpu_pathtracer_torch.bridge import as_numpy_tree, scene_from_numpy
from tpu_pathtracer_torch.ops import trace as ttrace
from tpu_pathtracer_torch.render import bsdf as tbsdf
from tpu_pathtracer_torch.render import integrator as tint
from tpu_pathtracer_torch.render import lights as tlights
from tpu_pathtracer_torch.render import surface as tsurf
from tpu_pathtracer_torch.spectrum import grid as tgrid
from tpu_pathtracer_torch.spectrum import sampled as tswl
from tpu_pathtracer_torch.utils import vec as tvec

TOL = dict(rtol=1e-5, atol=1e-5)
N_RANDOM = 768


def _t(x):
    """JAX array / SoA value / NamedTuple -> the port's torch form."""
    if isinstance(x, jvec.V3):
        return tvec.V3(_t(x.x), _t(x.y), _t(x.z))
    if isinstance(x, jvec.V2):
        return tvec.V2(_t(x.x), _t(x.y))
    if isinstance(x, jvec.S4):
        return tvec.S4(*(_t(v) for v in x.lanes))
    return torch.tensor(np.asarray(x))


def _close(t, j, **kw):
    if isinstance(t, (tvec.V3, tvec.V2, tvec.S4)):
        for a, b in zip(dataclasses.astuple(t), dataclasses.astuple(j)):
            _close(a, b, **kw)
        return
    np.testing.assert_allclose(t.numpy(), np.asarray(j), equal_nan=True,
                               **(kw or TOL))


@pytest.fixture(scope="module")
def world():
    """JAX scene 17 + its port, and JAX hits for camera + random rays."""
    js, jm, jc = jload(17, 32, 24, table_res=16)
    ts, tm, tc = scene_from_numpy(as_numpy_tree(js), jm._asdict(),
                                  dataclasses.asdict(jc), device="cpu")
    rng = np.random.default_rng(0)
    px = jint._pixel_grid(32, 24)
    from tpu_pathtracer.render.sampler import make_sampler
    uv = make_sampler("sobol", 0, 1, (32, 24)).get_2d(px, 0, 1)
    cam_o, cam_d, _ = jc.generate_rays(px, uv)
    # random rays from inside the box (render space: camera at the origin)
    o = rng.uniform([-1.9, 0.1, -1.9], [1.9, 3.9, 1.9], (N_RANDOM, 3)) \
        - np.asarray(jc.position)
    d = rng.normal(size=(N_RANDOM, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ray_o = jvec.V3(*(jnp.concatenate([c, jnp.asarray(o[:, k], jnp.float32)])
                      for k, c in enumerate((cam_o.x, cam_o.y, cam_o.z))))
    ray_d = jvec.V3(*(jnp.concatenate([c, jnp.asarray(d[:, k], jnp.float32)])
                      for k, c in enumerate((cam_d.x, cam_d.y, cam_d.z))))
    hit = jtrace.intersect_scene(js, ray_o, ray_d, jnp.asarray(3e38))
    jit_ = jsurf.make_interaction(js, hit, ray_o, ray_d)
    r = ray_o.x.shape[0]
    u = rng.uniform(size=(8, r)).astype(np.float32)
    jwl = jswl.sample_uniform(jnp.asarray(u[0]))
    jwl = jint._attach_bank(js, jwl)
    twl = tswl.sample_uniform(torch.from_numpy(u[0]))
    twl = twl._replace(bank=tgrid.lambda_slice_bank(tint._spectral_table(ts),
                                                    twl.lam))
    return dict(js=js, jm=jm, ts=ts, tm=tm, ray_o=ray_o, ray_d=ray_d,
                hit=hit, jit=jit_, u=u, jwl=jwl, twl=twl)


def _port_it(j):
    return tsurf.Interaction(*(_t(v) for v in j))


def test_make_interaction_matches(world):
    hit = world["hit"]
    assert np.asarray(hit.hit).mean() > 0.7     # the box is open at the front
    th = ttrace.Hit(*(_t(v) for v in hit))
    it_t = tsurf.make_interaction(world["ts"], th, _t(world["ray_o"]),
                                  _t(world["ray_d"]))
    it_j = world["jit"]
    for name in it_j._fields:
        _close(getattr(it_t, name), getattr(it_j, name))


def test_wavelength_bank_matches(world):
    jb, tb = world["jwl"].bank, world["twl"].bank
    for a, b in zip((tb.cmf_x, tb.cmf_y, tb.cmf_z) + tb.spectra,
                    (jb.cmf_x, jb.cmf_y, jb.cmf_z) + jb.spectra):
        _close(a, b)


def _frames(world):
    it_j = world["jit"]
    jf = jvec.make_frame(it_j.shading_n, it_j.tangent)
    it_t = _port_it(it_j)
    tf = tvec.make_frame(it_t.shading_n, it_t.tangent)
    return it_j, it_t, jf, tf, jvec.to_frame(jf, it_j.wo), \
        tvec.to_frame(tf, it_t.wo)


def test_sample_material_matches(world):
    it_j, it_t, jf, tf, jwo, two = _frames(world)
    u = world["u"]
    uc, ux, uy, uc2, uc3 = u[1], u[2], u[3], u[4], u[5]
    jms = jbsdf.sample_material(world["js"], world["jm"], it_j, jf, jwo,
                                jnp.asarray(uc),
                                jvec.V2(jnp.asarray(ux), jnp.asarray(uy)),
                                world["jwl"], uc2=jnp.asarray(uc2),
                                uc3=jnp.asarray(uc3))
    tms = tbsdf.sample_material(world["ts"], world["tm"], it_t, tf, two,
                                torch.from_numpy(uc),
                                tvec.V2(torch.from_numpy(ux),
                                        torch.from_numpy(uy)),
                                world["twl"], uc2=torch.from_numpy(uc2),
                                uc3=torch.from_numpy(uc3))
    ok = np.array(jms.sampled)
    assert np.array_equal(tms.sampled.numpy(), ok)
    assert np.array_equal(tms.specular.numpy(), np.asarray(jms.specular))
    assert ok.mean() > 0.5
    for a, b in zip(tms.f.lanes, jms.f.lanes):
        _close(a[ok], np.asarray(b)[ok])
    _close(tms.pdf[ok], np.asarray(jms.pdf)[ok])
    for a, b in zip(dataclasses.astuple(tms.wi_t), dataclasses.astuple(jms.wi_t)):
        _close(a[ok], np.asarray(b)[ok])
    _close(tms.wl.pdf, jms.wl.pdf)


def test_sample_material_without_uc2_uc3_matches(world):
    """The clearcoat batch with uc2 and uc3 omitted: both packages hash
    them from the bits of uc (``_hash_unit``), so the lobe choices agree
    lane for lane and the samples within TOL."""
    it_j, it_t, jf, tf, jwo, two = _frames(world)
    u = world["u"]
    jms = jbsdf.sample_material(world["js"], world["jm"], it_j, jf, jwo,
                                jnp.asarray(u[1]),
                                jvec.V2(jnp.asarray(u[2]), jnp.asarray(u[3])),
                                world["jwl"])
    tms = tbsdf.sample_material(world["ts"], world["tm"], it_t, tf, two,
                                torch.from_numpy(u[1]),
                                tvec.V2(torch.from_numpy(u[2]),
                                        torch.from_numpy(u[3])),
                                world["twl"])
    ok = np.array(jms.sampled)
    assert np.array_equal(tms.sampled.numpy(), ok)
    assert np.array_equal(tms.specular.numpy(), np.asarray(jms.specular))
    assert ok.mean() > 0.5
    for a, b in zip(tms.f.lanes, jms.f.lanes):
        _close(a[ok], np.asarray(b)[ok])
    _close(tms.pdf[ok], np.asarray(jms.pdf)[ok])
    for a, b in zip(dataclasses.astuple(tms.wi_t),
                    dataclasses.astuple(jms.wi_t)):
        _close(a[ok], np.asarray(b)[ok])


def test_evaluate_material_and_emission_match(world):
    it_j, it_t, jf, tf, jwo, two = _frames(world)
    rng = np.random.default_rng(1)
    wi = rng.normal(size=(3, two.x.shape[0])).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=0, keepdims=True)
    jf_, jpdf = jbsdf.evaluate_material(world["js"], world["jm"], it_j, jf,
                                        jwo, jvec.V3(*map(jnp.asarray, wi)),
                                        world["jwl"])
    tf_, tpdf = tbsdf.evaluate_material(world["ts"], world["tm"], it_t, tf,
                                        two, tvec.V3(*map(torch.from_numpy, wi)),
                                        world["twl"])
    _close(tf_, jf_)
    _close(tpdf, jpdf)
    assert (np.asarray(jpdf) > 0).mean() > 0.2
    _close(tbsdf.emitted_radiance(world["ts"], world["tm"], it_t, world["twl"]),
           jbsdf.emitted_radiance(world["js"], world["jm"], it_j,
                                  world["jwl"]))
    assert np.array_equal(
        tbsdf.is_bsdf_material(world["ts"], it_t).numpy(),
        np.asarray(jbsdf.is_bsdf_material(world["js"], it_j)))


def test_evaluate_nee_matches(world):
    it_j, it_t, jf, tf, jwo, two = _frames(world)
    u = world["u"]
    valid = np.asarray(it_j.valid) & (u[7] < 0.9)
    it_j = it_j._replace(valid=jnp.asarray(valid))
    it_t = it_t._replace(valid=torch.from_numpy(valid))
    jn = jlights.evaluate_nee(world["js"], world["jm"], it_j, jf, jwo,
                              world["jwl"], jnp.asarray(u[1]),
                              jnp.asarray(u[2]),
                              jvec.V2(jnp.asarray(u[3]), jnp.asarray(u[4])),
                              with_mis=True)
    tn = tlights.evaluate_nee(world["ts"], world["tm"], it_t, tf, two,
                              world["twl"], torch.from_numpy(u[1]),
                              torch.from_numpy(u[2]),
                              tvec.V2(torch.from_numpy(u[3]),
                                      torch.from_numpy(u[4])),
                              with_mis=True)
    lit = np.asarray(jn.contribution.a) > 0
    assert lit.mean() > 0.2
    _close(tn.contribution, jn.contribution)
    _close(tn.mis_weight, jn.mis_weight)


def test_light_pick_probability_and_area_point_match(world):
    u = world["u"]
    jrow, jprob, jany = jlights.pick_light(world["js"], world["jm"],
                                           world["jwl"], jnp.asarray(u[1]))
    trow, tprob, tany = tlights.pick_light(world["ts"], world["tm"],
                                           world["twl"], torch.from_numpy(u[1]))
    assert np.array_equal(trow.numpy(), np.asarray(jrow))
    assert np.array_equal(tany.numpy(), np.asarray(jany))
    _close(tprob, jprob)
    rows = np.where(u[2] < 0.5, 0, -1).astype(np.int32)
    _close(tlights.light_probability(world["ts"], world["tm"], world["twl"],
                                     torch.from_numpy(rows)),
           jlights.light_probability(world["js"], world["jm"], world["jwl"],
                                     jnp.asarray(rows)))
    jp, jn, jtri, juv = jlights._sample_area_point(
        world["js"], world["jm"], jrow, jnp.asarray(u[3]),
        jvec.V2(jnp.asarray(u[4]), jnp.asarray(u[5])))
    tp, tn, ttri, tuv = tlights._sample_area_point(
        world["ts"], world["tm"], trow, torch.from_numpy(u[3]),
        tvec.V2(torch.from_numpy(u[4]), torch.from_numpy(u[5])))
    assert np.array_equal(ttri.numpy(), np.asarray(jtri))
    for a, b in ((tp, jp), (tn, jn), (tuv, juv)):
        _close(a, b)


def test_pdf_light_for_hit_pos_and_balance_match(world):
    it_j = world["jit"]
    it_t = _port_it(it_j)
    rng = np.random.default_rng(2)
    prev = rng.uniform(-2, 2, (3, it_t.t.shape[0])).astype(np.float32)
    j = jlights.pdf_light_for_hit_pos(world["js"], world["jm"],
                                      jvec.V3(*map(jnp.asarray, prev)), it_j,
                                      world["jwl"])
    t = tlights.pdf_light_for_hit_pos(world["ts"], world["tm"],
                                      tvec.V3(*map(torch.from_numpy, prev)),
                                      it_t, world["twl"])
    _close(t, j)
    assert (np.asarray(j) > 0).any()
    a, b = rng.uniform(0, 2, (2, 64)).astype(np.float32)
    a[:4] = 0.0
    b[:2] = 0.0
    _close(tlights._balance(torch.from_numpy(a), torch.from_numpy(b)),
           jlights._balance(jnp.asarray(a), jnp.asarray(b)))
