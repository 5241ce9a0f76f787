"""Port vs JAX: point, spot and directional NEE, the environment light
(mapping, radiance, CDF sampling, pdfs) and the MIS pdf of an escape;
then the two NumPy-oracle cases of ``test_oracle.py`` that need these
lights (a point light over a Lambert floor, a constant environment),
rendered by the port.

No demo scene builds a spot or a directional light, so they are held here
only, on a small scene built by the JAX package and carried over with the
bridge: a floor with an occluding triangle, a point light, a spot light
and two directional lights, one of them along the +Y axis (shadow rays
with zero x and z components and t_max = 3e38).  Environment sampling is
held with search values drawn exactly on CDF entries, on scene 19's sky
and on a map with black rows and columns (exact plateaus in the CDFs).
Tolerance rtol 1e-5 / atol 1e-6.
"""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_oracle import (TABLE_RES, _pixel_rays, _plane_hit,
                         _sigmoid_spectrum, _spectral_to_rgb)
from test_oracle import H as OH
from test_oracle import W as OW
from tpu_pathtracer.ops import trace as jtrace
from tpu_pathtracer.render import camera as jcamera
from tpu_pathtracer.render import env as jenv
from tpu_pathtracer.render import integrator as jint
from tpu_pathtracer.render import lights as jlights
from tpu_pathtracer.render import surface as jsurf
from tpu_pathtracer.scene import builder as jbuilder
from tpu_pathtracer.scene import mesh as jmesh
from tpu_pathtracer.scenes import load_scene as jload
from tpu_pathtracer.spectrum import rgb2spec as jr2s
from tpu_pathtracer.spectrum import sampled as jswl
from tpu_pathtracer.utils import vec as jvec
from tpu_pathtracer_torch.bridge import as_numpy_tree, scene_from_numpy
from tpu_pathtracer_torch.render import camera as tcamera
from tpu_pathtracer_torch.render import env as tenv
from tpu_pathtracer_torch.render import integrator as tint
from tpu_pathtracer_torch.render import lights as tlights
from tpu_pathtracer_torch.render import surface as tsurf
from tpu_pathtracer_torch.scene import builder as tbuilder
from tpu_pathtracer_torch.scene import mesh as tmesh
from tpu_pathtracer_torch.spectrum import grid as tgrid
from tpu_pathtracer_torch.spectrum import sampled as tswl
from tpu_pathtracer_torch.utils import vec as tvec

TOL = dict(rtol=1e-5, atol=1e-6)
W, H = 48, 36


def _t(x):
    if isinstance(x, (jvec.V3, jvec.V2, jvec.S4)):
        cls = {jvec.V3: tvec.V3, jvec.V2: tvec.V2, jvec.S4: tvec.S4}[type(x)]
        return cls(*(_t(v) for v in dataclasses.astuple(x)))
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


def _bridge(js, jm, jc):
    return scene_from_numpy(as_numpy_tree(js), jm._asdict(),
                            dataclasses.asdict(jc), device="cpu")


def _wavelengths(js, ts, u):
    jwl = jint._attach_bank(js, jswl.sample_uniform(jnp.asarray(u)))
    twl = tswl.sample_uniform(torch.from_numpy(u))
    return jwl, twl._replace(bank=tgrid.lambda_slice_bank(
        tint._spectral_table(ts), twl.lam))


def _camera_hits(js, jc, rng):
    uv = rng.uniform(size=(2, jc.width * jc.height)).astype(np.float32)
    ray_o, ray_d, _ = jc.generate_rays(
        jint._pixel_grid(jc.width, jc.height),
        jvec.V2(jnp.asarray(uv[0]), jnp.asarray(uv[1])))
    hit = jtrace.intersect_scene(js, ray_o, ray_d, jnp.asarray(3e38))
    return jsurf.make_interaction(js, hit, ray_o, ray_d)


# ---------------------------------------------------------------------------
# delta lights
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def delta_scene():
    sb = jbuilder.SceneBuilder(table_res=16)
    m = sb.add_material(jbuilder.Lambert(albedo=(0.7, 0.6, 0.5)))
    s = 3.0
    sb.add_mesh(jmesh.quad([-s, 0, s], [s, 0, s], [s, 0, -s], [-s, 0, -s]), m)
    sb.add_triangle([-0.5, 0.8, 0.5], [0.8, 0.8, 0.5], [-0.5, 0.8, -0.8], m)
    sb.add_point_light((-1.0, 2.0, 1.0), (1.0, 1.0, 1.0), 6.0)
    sb.add_spot_light((1.0, 2.5, 0.0), (-0.3, -1.0, 0.1), 0.3, 0.6,
                      (0.9, 0.8, 0.4), 20.0)
    sb.add_directional_light((0.0, 1.0, 0.0), (1.0, 1.0, 1.0), 1.5)
    sb.add_directional_light((0.5, 1.0, -0.4), (0.3, 0.5, 1.0), 2.0)
    jc = jcamera.default_camera(W, H).look_to((0.0, 3.0, 5.0),
                                              (0.0, -0.5, -1.0))
    js, jm = sb.build(jc.position)
    assert set(jm.light_types) == {1, 2, 3}
    return (js, jm, jc), _bridge(js, jm, jc)


@pytest.mark.parametrize("with_mis", [False, True])
def test_delta_light_nee_matches(delta_scene, with_mis):
    """Point, spot and directional NEE (light pick, light term, the shadow
    ray against the occluder, the BSDF) on the floor and the occluder."""
    (js, jm, jc), (ts, tm, _) = delta_scene
    rng = np.random.default_rng(0)
    it_j = _camera_hits(js, jc, rng)
    it_t = tsurf.Interaction(*(_t(v) for v in it_j))
    u = rng.uniform(size=(5, W * H)).astype(np.float32)
    jwl, twl = _wavelengths(js, ts, u[0])
    jf = jvec.make_frame(it_j.shading_n, it_j.tangent)
    tf = tvec.make_frame(it_t.shading_n, it_t.tangent)
    j = jlights.evaluate_nee(js, jm, it_j, jf, jvec.to_frame(jf, it_j.wo),
                             jwl, jnp.asarray(u[1]), jnp.asarray(u[2]),
                             jvec.V2(jnp.asarray(u[3]), jnp.asarray(u[4])),
                             with_mis=with_mis)
    t = tlights.evaluate_nee(ts, tm, it_t, tf, tvec.to_frame(tf, it_t.wo),
                             twl, torch.from_numpy(u[1]),
                             torch.from_numpy(u[2]),
                             tvec.V2(torch.from_numpy(u[3]),
                                     torch.from_numpy(u[4])),
                             with_mis=with_mis, precise=True)
    _close(t.contribution, j.contribution)
    _close(t.mis_weight, j.mis_weight)
    valid = np.array(it_j.valid)
    lit = (t.contribution.a.numpy() > 0)[valid]
    assert 0.3 < lit.mean() < 1.0          # some shadowed, most lit
    rows = tlights.pick_light(ts, tm, twl, torch.from_numpy(u[1]))[0]
    assert set(rows[torch.from_numpy(valid)].tolist()) == {0, 1, 2, 3}
    # the light kinds are deltas: MIS gives them weight 1
    assert bool((t.mis_weight == 1.0).all())


def test_axis_directional_shadow_rays_fast_and_precise_agree(delta_scene):
    """Shadow rays along +Y with t_max = 3e38: the fast and the watertight
    plain any-hit versions give the JAX package's occlusion."""
    (js, jm, jc), (ts, tm, _) = delta_scene
    rng = np.random.default_rng(1)
    it_j = _camera_hits(js, jc, rng)
    valid = np.array(it_j.valid)
    pos = it_j.position
    zero = jnp.zeros_like(pos.x)
    d = jvec.V3(zero, zero + 1.0, zero)
    o = pos + d * 1e-4
    t_max = jnp.full_like(pos.x, 3e38)
    jocc = np.asarray(jtrace.intersect_p_scene(js, o, d, t_max,
                                               active=jnp.asarray(valid)))
    from tpu_pathtracer_torch.ops import trace as ttrace
    for precise in (False, True):
        tocc = ttrace.intersect_p_scene(ts, _t(o), _t(d), _t(t_max),
                                        active=torch.from_numpy(valid),
                                        precise=precise).numpy()
        assert np.array_equal(tocc, jocc), precise
    assert 0 < jocc[valid].sum() < valid.sum()   # under the occluder or not


# ---------------------------------------------------------------------------
# environment
# ---------------------------------------------------------------------------

def _plateau_env_builder(pkg):
    """A map with black rows and columns (exact plateaus in both CDFs) and
    a point light, over a floor."""
    img = np.full((16, 32, 3), 0.3, np.float32)
    # black texels after bright ones add less than an ulp to the CDF
    img[5:8] = 0.0                      # black rows: a marginal plateau
    img[10:12, 10:20] = 0.0             # black columns in two rows
    img[13, 3] = (40.0, 30.0, 20.0)     # a sun
    sb = pkg.SceneBuilder(table_res=16)
    m = sb.add_material(pkg.Lambert(albedo=(0.5, 0.5, 0.5)))
    return sb, m, img


@pytest.fixture(scope="module", params=["sky19", "plateaus"])
def env_scene(request):
    if request.param == "sky19":
        js, jm, jc = jload(19, W, H, table_res=16)
    else:
        sb, m, img = _plateau_env_builder(jbuilder)
        sb.add_mesh(jmesh.quad([-3, 0, 3], [3, 0, 3], [3, 0, -3],
                               [-3, 0, -3]), m)
        sb.add_point_light((0.0, 2.0, 0.0), (1.0, 1.0, 1.0), 4.0)
        sb.add_env_light(img, intensity=1.5, rotation_deg=30.0)
        jc = jcamera.default_camera(W, H).look_to((0.0, 1.0, 4.0),
                                                  (0.0, 0.1, -1.0))
        js, jm = sb.build(jc.position)
    return (js, jm, jc), _bridge(js, jm, jc)


def _unit_dirs(n, rng):
    d = rng.normal(size=(3, n)).astype(np.float32)
    d[:, :6] = np.asarray([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                           [0, 0, 1], [0, 0, -1]], np.float32).T
    return d / np.linalg.norm(d, axis=0, keepdims=True)


def test_env_mapping_radiance_and_pdf_match(env_scene):
    (js, jm, jc), (ts, tm, _) = env_scene
    rng = np.random.default_rng(2)
    n = 4096
    d = _unit_dirs(n, rng)
    jd, td = jvec.V3(*map(jnp.asarray, d)), tvec.V3(*map(torch.from_numpy, d))
    rot = js.env.rotation
    juv = jenv.dir_to_uv(jd, rot)
    tuv = tenv.dir_to_uv(td, ts.env.rotation)
    _close(tuv, juv)
    _close(tenv.uv_to_dir(tuv, ts.env.rotation), jenv.uv_to_dir(juv, rot))
    jwl, twl = _wavelengths(js, ts, rng.uniform(size=n).astype(np.float32))
    _close(tenv.env_radiance(ts, twl, td), jenv.env_radiance(js, jwl, jd))
    _close(tenv.env_pdf_direction(ts, td), jenv.env_pdf_direction(js, jd))
    _close(tlights.pdf_env_for_direction(ts, tm, twl, td),
           jlights.pdf_env_for_direction(js, jm, jwl, jd))


def test_env_sampling_matches_on_cdf_entries(env_scene):
    """Search values drawn on CDF entries (and at random): the same texel,
    direction, radiance and pdf as the JAX package's compare-and-count."""
    (js, jm, jc), (ts, tm, _) = env_scene
    rng = np.random.default_rng(3)
    marg = np.asarray(js.env.marginal_cdf)
    cond = np.asarray(js.env.conditional_cdf)
    h, w = cond.shape
    n = 4096
    ux = rng.uniform(size=n).astype(np.float32)
    uy = rng.uniform(size=n).astype(np.float32)
    on = rng.uniform(size=n) < 0.5
    ux[on] = marg[rng.integers(0, h, on.sum())]
    # the row the search picks, then an entry of that row's CDF
    row = np.clip(np.sum(marg[None, :] <= ux[:, None], 1), 0, h - 1)
    uy[on] = cond[row[on], rng.integers(0, w, on.sum())]
    jwl, twl = _wavelengths(js, ts, rng.uniform(size=n).astype(np.float32))
    jd, jl, jp = jenv.sample_env_direction(
        js, jwl, jvec.V2(jnp.asarray(ux), jnp.asarray(uy)))
    td, tl, tp = tenv.sample_env_direction(
        ts, twl, tvec.V2(torch.from_numpy(ux), torch.from_numpy(uy)))
    _close(td, jd)
    _close(tl, jl)
    _close(tp, jp)
    # the counts themselves, plateaus included
    trow = torch.searchsorted(ts.env.marginal_cdf, torch.from_numpy(ux),
                              right=True).numpy()
    assert np.array_equal(np.clip(trow, 0, h - 1), row)
    col = np.sum(cond[row] <= uy[:, None], 1)
    tcol = tenv._count_le_in_rows(ts.env.conditional_cdf,
                                  torch.from_numpy(row), torch.from_numpy(uy))
    assert np.array_equal(tcol.numpy(), col)
    if h == 16:      # the map with black rows and columns
        assert (np.diff(marg) == 0).any() and (np.diff(cond, axis=1) == 0).any()


# ---------------------------------------------------------------------------
# the NumPy oracle, on the port
# ---------------------------------------------------------------------------

def _port_render_mean(scene, meta, cam, strategy, spp, max_depth=1):
    cfg = tint.RenderConfig(width=OW, height=OH, spp=spp, strategy=strategy,
                            sampler="sobol", max_depth=max_depth, seed=0,
                            tone_map="none", eotf="linear")
    acc = tint.render_accum(scene, meta, cam, cfg).numpy()
    return (acc / spp).reshape(OH, OW, 3)


def _port_floor_builder(albedo=(0.65, 0.45, 0.3)):
    sb = tbuilder.SceneBuilder(table_res=TABLE_RES)
    m = sb.add_material(tbuilder.Lambert(albedo=albedo))
    s = 50.0
    sb.add_mesh(tmesh.quad([-s, 0, s], [s, 0, s], [s, 0, -s], [-s, 0, -s]), m)
    return sb


def test_oracle_point_light_direct_on_port():
    """Point light: L = albedo/pi * I * cos / d^2, per pixel."""
    inten = 5.0
    sb = _port_floor_builder()
    lp = (0.5, 2.5, -1.0)
    sb.add_point_light(lp, (1.0, 1.0, 1.0), inten)
    cam = tcamera.default_camera(OW, OH).look_to((0.0, 1.5, 6.0),
                                                 (0.0, -0.25, -1.0))
    scene, meta = sb.build(cam.position)
    img = _port_render_mean(scene, meta, cam, "nee", spp=64)

    alb_spd = _sigmoid_spectrum(scene.materials.base_coeff.numpy()[0])
    row = int(scene.lights.spectrum_row[0])
    l_spd = scene.spectra.numpy()[row] * inten
    base_rgb = _spectral_to_rgb(alb_spd / math.pi * l_spd)

    o, dirs = _pixel_rays((0.0, 1.5, 6.0), (0.0, -0.25, -1.0))
    t, p = _plane_hit(o, dirs, y=0.0)
    floor_hit = (t > 0) & (dirs[..., 1] < 0)
    dvec = np.asarray(lp)[None, None, :] - p
    d2 = np.sum(dvec * dvec, -1)
    expect = base_rgb[None, None, :] * (dvec[..., 1] / np.sqrt(d2) / d2)[..., None]
    expect[~floor_hit] = 0.0
    sel = expect[..., 1] > 1e-4
    rel = np.abs(img[sel] - expect[sel]) / np.maximum(expect[sel], 1e-4)
    assert np.median(rel) < 0.02, np.median(rel)


def test_oracle_constant_env_on_port():
    """Constant env: background pixels = L0; floor = albedo * L0."""
    sb = tbuilder.SceneBuilder(table_res=TABLE_RES)
    m = sb.add_material(tbuilder.Lambert(albedo=(0.5, 0.6, 0.7)))
    s = 3.0
    sb.add_mesh(tmesh.quad([-s, 0, s], [s, 0, s], [s, 0, -s], [-s, 0, -s]), m)
    sb.add_env_light(np.full((8, 16, 3), 0.8, np.float32))
    cam = tcamera.default_camera(OW, OH).look_to((0.0, 2.0, 6.0),
                                                 (0.0, -0.2, -1.0))
    scene, meta = sb.build(cam.position)
    img = _port_render_mean(scene, meta, cam, "mis", spp=192, max_depth=1)

    rgb = np.full(3, 0.8)
    scale = 2.0 * rgb.max()
    c = np.asarray(jr2s.lookup_coeffs(jnp.asarray(rgb / scale)[None, :],
                                      jnp.asarray(scene.rs_zn.numpy()),
                                      jnp.asarray(scene.rs_coeffs.numpy())))[0]
    env_spd = scale * _sigmoid_spectrum(c) * scene.spectra.numpy()[0]
    env_rgb = _spectral_to_rgb(env_spd)
    alb_spd = _sigmoid_spectrum(scene.materials.base_coeff.numpy()[0])
    floor_rgb = _spectral_to_rgb(alb_spd * env_spd)

    o, dirs = _pixel_rays((0.0, 2.0, 6.0), (0.0, -0.2, -1.0))
    t, p = _plane_hit(o, dirs, y=0.0)
    on_floor = (t > 0) & (dirs[..., 1] < 0) & (np.abs(p[..., 0]) <= s) \
        & (np.abs(p[..., 2]) <= s)
    interior = on_floor & (np.abs(p[..., 0]) <= s - 0.4) \
        & (np.abs(p[..., 2]) <= s - 0.4)
    sky = ~on_floor & (dirs[..., 1] > 0.05)
    rel_sky = np.abs(img[sky] - env_rgb) / env_rgb
    assert np.median(rel_sky) < 0.02, np.median(rel_sky)
    rel_floor = (np.abs(img[interior].mean(0) - floor_rgb)
                 / np.maximum(floor_rgb, 1e-6))
    assert rel_floor.max() < 0.04, (img[interior].mean(0), floor_rgb)
