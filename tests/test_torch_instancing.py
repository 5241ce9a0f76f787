"""Two-level instancing in the port: scenes 7, 12 and 14 store the bunny
once under four affines.

Port copies of tests/test_instancing.py's seven tests, on the port with
``device="cpu"`` (one stored copy; hits, occlusion and the finite-t_max
contract against the flattened build; render against flattened; the
scene-7 smoke test; emissive instances refused), and the port against the
JAX package on seeded inputs:

  * scene 7's group tables and ``world_radius``: the port's default build
    bit for bit against the JAX package's default (native) build, and
    under TPT_NO_NATIVE against its numpy SAH build;
  * ``intersect_scene`` / ``intersect_p_scene`` over the bridged scene on
    4,096 rays: precise against the JAX BVH walk (equal hit, id and
    occlusion; t within 1e-6 relative of the jitted walk, and t, b1, b2
    bit for bit against the hit triangle's ``intersect_triangle``
    evaluated op by op on the instance's object-space ray, as
    tests/test_torch_trace_precise.py holds the main soup); fast against
    the JAX package's Pallas fast kernel in interpret mode (equal hit, id
    and occlusion; t within 1e-6 relative, b1 and b2 within 4e-6);
  * ``make_interaction`` on instanced hits, within 1e-5 (the tolerance of
    tests/test_torch_shading.py: float32 on both sides, transcendentals
    differing in the last bits);
  * the instance cull's NaN on axis-parallel rays whose origin lies on a
    box plane: the same mask in both packages.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pathtracer.ops import pallas_trace
from tpu_pathtracer.ops import trace as jtrace
from tpu_pathtracer.render import surface as jsurf
from tpu_pathtracer.scenes import load_scene as jload
from tpu_pathtracer.utils import math as jmath
from tpu_pathtracer.utils import vec as jvec
from tpu_pathtracer_torch import scenes as tscenes
from tpu_pathtracer_torch.bridge import as_numpy_tree, scene_from_numpy
from tpu_pathtracer_torch.ops import trace as ttrace
from tpu_pathtracer_torch.render import surface as tsurf
from tpu_pathtracer_torch.render.camera import default_camera
from tpu_pathtracer_torch.render.integrator import RenderConfig, render
from tpu_pathtracer_torch.scene import mesh as tmesh
from tpu_pathtracer_torch.scene.builder import Emissive, Metal, SceneBuilder
from tpu_pathtracer_torch.utils.vec import V3

from test_torch_native import jax_native_ready
from test_torch_slice_scene0 import two_torch_threads  # noqa: F401

TABLE_RES = 16
W, H = 48, 36
N_RAYS = 4096


# ---------------------------------------------------------------------------
# Port copies of tests/test_instancing.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def builds():
    """The instanced and the flattened build of scene 7's geometry."""
    out = {}
    for flatten in (False, True):
        sb = SceneBuilder(table_res=TABLE_RES)
        cam = default_camera(W, H)
        tscenes.add_cornell_box(sb)
        mats = [sb.add_material(Metal(kind="gold", roughness=r))
                for r in (0.05, 0.25, 0.5, 0.75)]
        tscenes._four_on_floor(sb, mats, flatten=flatten)
        cam = cam.look_to(tscenes.CAMERA_POS, tscenes.CAMERA_DIR)
        scene, meta = sb.build(cam.position)
        out[flatten] = (scene, meta, cam)
    return out[False], out[True]


def test_instanced_build_stores_mesh_once(builds):
    (inst, _, _), (flat, _, _) = builds
    assert len(inst.instanced) == 1
    g = inst.instanced[0]
    n_bunny = g.bvh.tri9.shape[0]
    assert flat.bvh.tri9.shape[0] == inst.bvh.tri9.shape[0] + 4 * n_bunny
    assert g.fwd.shape == (4, 12)
    assert len(set(g.mat_id.tolist())) == 4


def _copy_rays(n, seed=0):
    """tests/test_instancing.py's rays."""
    rng = np.random.default_rng(seed)
    o = rng.uniform([-1.8, 0.2, -3.6], [1.8, 3.6, -0.4], size=(n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return _v3(o), _v3(d)


def _v3(a):
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return V3(t[:, 0], t[:, 1], t[:, 2])


def test_instanced_intersect_matches_flattened(builds):
    (inst, _, _), (flat, _, _) = builds
    o, d = _copy_rays(N_RAYS)
    hi = ttrace.intersect_scene(inst, o, d, 3.0e38)
    hf = ttrace.intersect_scene(flat, o, d, 3.0e38)
    hit_i, hit_f = hi.hit.numpy(), hf.hit.numpy()
    assert (hit_i == hit_f).mean() > 0.999
    both = hit_i & hit_f
    dt = np.abs(hi.t.numpy()[both] - hf.t.numpy()[both])
    rel = dt / np.maximum(hf.t.numpy()[both], 1e-3)
    assert np.quantile(rel, 0.999) < 1e-3, np.quantile(rel, 0.999)


def test_instanced_occlusion_matches_flattened(builds):
    (inst, _, _), (flat, _, _) = builds
    o, d = _copy_rays(N_RAYS, seed=3)
    t_max = torch.full((N_RAYS,), 1.5)
    oi = ttrace.intersect_p_scene(inst, o, d, t_max).numpy()
    of = ttrace.intersect_p_scene(flat, o, d, t_max).numpy()
    assert (oi == of).mean() > 0.999


def test_instanced_finite_tmax_contract(builds):
    """Hits reported by the instance pass respect a finite t_max."""
    (inst, _, _), _ = builds
    o, d = _copy_rays(2048, seed=5)
    h_far = ttrace.intersect_scene(inst, o, d, 3.0e38)
    h_near = ttrace.intersect_scene(inst, o, d, torch.full((2048,), 0.8))
    t = h_near.t.numpy()[h_near.hit.numpy()]
    assert (t <= 0.8 + 1e-5).all()
    near_true = h_far.hit.numpy() & (h_far.t.numpy() < 0.75)
    assert h_near.hit.numpy()[near_true].all()


def test_instanced_render_matches_flattened(builds):
    """Same sampler streams, same geometry: the images agree to float
    noise (hit ids differ; radiometry must not).  At 24x18 and 4 spp
    (the JAX test: 48x36, 12 spp): the plain versions test every live
    lane against all 36,876 triangles of the flattened build."""
    (inst, meta_i, cam), (flat, meta_f, _) = builds
    cfg = RenderConfig(width=24, height=18, spp=4, strategy="mis",
                       sampler="sobol", max_depth=5, tone_map="none",
                       eotf="linear")
    cam = dataclasses.replace(cam, width=24, height=18)
    img_i = render(inst, meta_i, cam, cfg, device="cpu").numpy()
    img_f = render(flat, meta_f, cam, cfg, device="cpu").numpy()
    scale = max(img_f.mean(), 1e-6)
    rmse = float(np.sqrt(np.mean((img_i - img_f) ** 2))) / scale
    assert rmse < 0.02, rmse
    assert abs(img_i.mean() - img_f.mean()) / scale < 0.005


def test_instanced_scene7_smoke():
    """The registered scene 7 builds instanced and renders finite."""
    scene, meta, cam = tscenes.load_scene(7, W, H, table_res=TABLE_RES,
                                          device="cpu")
    assert len(scene.instanced) == 1
    cfg = RenderConfig(width=W, height=H, spp=4, strategy="nee",
                       sampler="sobol", max_depth=4)
    img = render(scene, meta, cam, cfg, device="cpu").numpy()
    assert np.isfinite(img).all()
    assert img.mean() > 0.01


@pytest.mark.parametrize("deg", [0.0, 30.0, -135.0])
def test_rotate_y_matches_jax(deg):
    """The instance-transform helper of scenes/common.py."""
    from tpu_pathtracer.scenes import common as jcommon
    from tpu_pathtracer_torch.scenes import common as tcommon
    assert np.array_equal(tcommon.rotate_y(deg), jcommon.rotate_y(deg))


def test_emissive_instances_rejected():
    sb = SceneBuilder(table_res=TABLE_RES)
    m = sb.add_material(Emissive(spectrum=(1.0, 1.0, 1.0)))
    q = tmesh.quad([-1, 0, 1], [1, 0, 1], [1, 0, -1], [-1, 0, -1])
    with pytest.raises(ValueError):
        sb.add_instances(q, [(np.eye(4), m)])
    with pytest.raises(ValueError):
        sb.add_instances(q, [])


# ---------------------------------------------------------------------------
# The port against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scene7():
    """JAX scene 7 built with the JAX package's numpy SAH builder, its
    bridge into the port, the port's own builds of scene 7 (the default,
    native, and the numpy one under TPT_NO_NATIVE), and the JAX package's
    group built by its default (native) builder."""
    jax_native_ready()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPT_NO_NATIVE", "1")
        js, jm, jc = jload(7, 32, 24, table_res=TABLE_RES)
        own_numpy = tscenes.load_scene(7, 32, 24, table_res=TABLE_RES,
                                       device="cpu")
    bridged = scene_from_numpy(as_numpy_tree(js), jm._asdict(),
                               dataclasses.asdict(jc), device="cpu")
    own = tscenes.load_scene(7, 32, 24, table_res=TABLE_RES, device="cpu")
    native = jload(7, 32, 24, table_res=TABLE_RES)[0].instanced[0]
    return (js, jm, jc), bridged, (own, own_numpy), native


def _eq(t, j, name):
    j = np.asarray(j)
    assert t.shape == j.shape and t.dtype == j.dtype, name
    assert np.array_equal(t, j), name


def _group_eq(tg, jg):
    for f in ("tri_attr", "fwd", "inv", "mat_id", "aabb_min", "aabb_max"):
        _eq(getattr(tg, f).numpy(), getattr(jg, f), f)
    for f in ("nodes_f", "nodes_i", "tri9"):
        _eq(getattr(tg.bvh, f).numpy(), getattr(jg.bvh, f), f)
    n = jg.bvh.tri9.shape[0]
    _eq(tg.bvh.tri_m12.numpy(), np.asarray(jg.bvh.tri_m12)[:n], "tri_m12")
    assert tg.bvh.stack_depth == jg.bvh.stack_hint.shape[0]


def test_group_tables_match_jax(scene7):
    """The port's default build bit for bit against the JAX package's
    default (native) build, and under TPT_NO_NATIVE against its numpy
    build (the two builders order this mesh's soup differently: they
    round the SAH costs of its float64 boxes differently)."""
    (js, _, _), _, (own, own_numpy), native = scene7
    ts, tn = own[0], own_numpy[0]
    assert len(ts.instanced) == len(tn.instanced) == len(js.instanced) == 1
    _group_eq(ts.instanced[0], native)
    _group_eq(tn.instanced[0], js.instanced[0])
    for t in (ts, tn):
        _eq(t.world_radius.numpy(), js.world_radius, "world_radius")
    assert not np.array_equal(native.bvh.tri9, js.instanced[0].bvh.tri9)


def _rays(n, seed, cam_pos):
    """Render-space rays from inside the box, half of them aimed at points
    inside the instances' boxes."""
    rng = np.random.default_rng(seed)
    o = rng.uniform([-1.9, 0.1, -1.9], [1.9, 3.9, 1.9], (n, 3)) - cam_pos
    d = rng.normal(size=(n, 3))
    aim = rng.uniform([-1.6, 0.0, -1.0], [1.6, 1.2, 0.0], (n, 3)) - cam_pos
    half = np.arange(n) < n // 2
    d[half] = aim[half] - o[half]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _jv3(a):
    return jvec.v3_unstack(jnp.asarray(a))


def _pallas_fast(bvh, o, d, t_max=3e38, active=None, method=None):
    return pallas_trace.traverse(bvh, o, d, t_max, active=active,
                                 interpret=True, precise=False)


def _pallas_fast_p(bvh, o, d, t_max, active=None, method=None):
    return pallas_trace.traverse(bvh, o, d, t_max, active=active,
                                 any_hit=True, interpret=True, precise=False)


@pytest.fixture(scope="module")
def traced(scene7):
    """Closest hits and occlusion of the same rays through both packages,
    precise (the JAX BVH walk) and fast (the JAX Pallas fast kernel in
    interpret mode)."""
    (js, _, jc), (ts, _, _), _, _ = scene7
    o, d = _rays(N_RAYS, 11, np.asarray(jc.position))
    act = np.random.default_rng(12).uniform(size=N_RAYS) < 0.9
    tmax = np.random.default_rng(13).uniform(0.5, 6.0, N_RAYS).astype(
        np.float32)
    jargs = (js, _jv3(o), _jv3(d))
    targs = (ts, _v3(o), _v3(d))
    out = {}
    for precise in (True, False):
        with pytest.MonkeyPatch.context() as mp:
            if not precise:
                mp.setattr(jtrace, "intersect", _pallas_fast)
                mp.setattr(jtrace, "intersect_p", _pallas_fast_p)
            jh = jtrace.intersect_scene(*jargs, jnp.asarray(3e38),
                                        active=jnp.asarray(act))
            jo = jtrace.intersect_p_scene(*jargs, jnp.asarray(tmax),
                                          active=jnp.asarray(act))
        th = ttrace.intersect_scene(*targs, 3e38, active=torch.from_numpy(act),
                                    precise=precise)
        to = ttrace.intersect_p_scene(*targs, torch.from_numpy(tmax),
                                      active=torch.from_numpy(act),
                                      precise=precise)
        out[precise] = (jh, jo, th, to)
    return out, (o, d)


@pytest.mark.parametrize("precise", [True, False])
def test_intersect_scene_matches_jax(scene7, traced, precise):
    (js, _, _), _, _, _ = scene7
    jh, _, th, _ = traced[0][precise]
    hit = np.asarray(jh.hit)
    assert np.array_equal(th.hit.numpy(), hit)
    assert np.array_equal(th.tri.numpy(), np.asarray(jh.tri))
    n_main = js.bvh.tri9.shape[0]
    in_groups = hit & (th.tri.numpy() >= n_main)
    # the rays reach every instance, and the main soup too
    tc = js.instanced[0].bvh.tri9.shape[0]
    inst = (th.tri.numpy()[in_groups] - n_main) // tc
    assert set(inst.tolist()) == {0, 1, 2, 3}
    assert in_groups.sum() > N_RAYS // 8 and (hit & ~in_groups).any()
    np.testing.assert_allclose(th.t.numpy()[hit], np.asarray(jh.t)[hit],
                               rtol=1e-6)
    assert (th.tri.numpy()[~hit] == -1).all()
    if not precise:
        for k in ("b1", "b2"):
            np.testing.assert_allclose(getattr(th, k).numpy()[hit],
                                       np.asarray(getattr(jh, k))[hit],
                                       rtol=0, atol=4e-6)
        return
    # precise: t, b1, b2 bit for bit against the JAX ``intersect_triangle``
    # of the hit triangle evaluated op by op, on the hit instance's
    # object-space ray from the JAX ``_inst_rays`` (the jitted walk differs
    # from its own op-by-op values by up to 4.5e-5 on b1, b2 here)
    o, d = traced[1]
    g = js.instanced[0]
    tri = th.tri.numpy()
    jo_all, jd_all = (np.asarray(v) for v in
                      jtrace._inst_rays(g, _jv3(o), _jv3(d)))
    lane = np.nonzero(hit)[0]
    local = tri[lane] - n_main
    grp = local >= 0
    inst_lane = (local // tc) * N_RAYS + lane
    ro = np.where(grp[:, None], jo_all[np.where(grp, inst_lane, 0)], o[lane])
    rd = np.where(grp[:, None], jd_all[np.where(grp, inst_lane, 0)], d[lane])
    rows = np.where(grp[:, None],
                    np.asarray(g.bvh.tri9)[np.where(grp, local % tc, 0)],
                    np.asarray(js.bvh.tri9)[np.where(grp, 0, tri[lane])])
    ref = jmath.intersect_triangle(
        jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(rows[:, 0:3]),
        jnp.asarray(rows[:, 3:6]), jnp.asarray(rows[:, 6:9]),
        jnp.float32(3e38))
    assert np.asarray(ref[3]).all()
    for k, r in zip(("t", "b1", "b2"), ref[:3]):
        assert np.array_equal(getattr(th, k).numpy()[hit], np.asarray(r)), k


@pytest.mark.parametrize("precise", [True, False])
def test_intersect_p_scene_matches_jax(traced, precise):
    _, jo, _, to = traced[0][precise]
    occ = to.numpy()
    assert np.array_equal(occ, np.asarray(jo))
    assert occ.any() and not occ.all()


def test_make_interaction_on_instanced_hits_matches_jax(scene7, traced):
    """Both packages decode the same JAX hits (main soup and instances)."""
    (js, _, _), (ts, _, _), _, _ = scene7
    jh, _, _, _ = traced[0][True]
    o, d = traced[1]
    it_j = jsurf.make_interaction(js, jh, _jv3(o), _jv3(d))
    th = ttrace.Hit(*(torch.tensor(np.asarray(v)) for v in jh))
    it_t = tsurf.make_interaction(ts, th, _v3(o), _v3(d))
    n_main = js.bvh.tri9.shape[0]
    assert (np.asarray(jh.hit) & (np.asarray(jh.tri) >= n_main)).any()
    for name in it_j._fields:
        a, b = getattr(it_t, name), getattr(it_j, name)
        if isinstance(a, (V3, tsurf.V2)):
            pairs = zip(dataclasses.astuple(a), dataclasses.astuple(b))
        else:
            pairs = ((a, b),)
        for x, y in pairs:
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-5,
                                       atol=1e-5, err_msg=name)


def test_inst_active_nan_on_axis_parallel_rays_matches_jax(scene7):
    """Axis-parallel rays whose origin lies on an instance box's plane:
    0 * inf gives NaN in the slab test of both packages, which drops the
    lane; the masks are equal lane for lane."""
    (js, _, _), (ts, _, _), _, _ = scene7
    jg, tg = js.instanced[0], ts.instanced[0]
    lo = np.asarray(jg.aabb_min)
    hi = np.asarray(jg.aabb_max)
    rng = np.random.default_rng(21)
    rows = []
    for i in range(lo.shape[0]):
        for a in range(3):
            for plane in (lo[i, a], hi[i, a]):
                p = rng.uniform(lo[i], hi[i], (8, 3))
                p[:, a] = plane                    # origin on the plane
                rows.append(p)
    o = np.concatenate(rows).astype(np.float32)
    n = len(o)
    d = np.zeros((n, 3), np.float32)
    # parallel to the plane the origin lies on: along the next axis
    axis = np.repeat(np.arange(3).repeat(2), 8)
    axis = np.tile(axis, lo.shape[0])
    d[np.arange(n), (axis + 1) % 3] = np.where(np.arange(n) % 2, 1.0, -1.0)
    jm = np.asarray(jtrace._inst_active(jg, _jv3(o), _jv3(d),
                                        jnp.float32(3e38), None))
    tm = ttrace._inst_active(tg, _v3(o), _v3(d), 3e38, None).numpy()
    assert np.array_equal(tm, jm)
    # the NaN drops the lane of an origin that lies on a box plane
    own = np.repeat(np.arange(lo.shape[0]), 48)
    self_lane = tm.reshape(lo.shape[0], n)[own, np.arange(n)]
    assert not self_lane.any()
