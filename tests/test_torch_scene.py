"""The port's scene build vs the JAX package's, import hygiene, the device
rule, the NotImplementedError fences around what is not ported, and the
differentiable pass's lockstep film against the wavefront's.

Both packages build every scene with the pure-numpy SAH builder (both
with TPT_NO_NATIVE=1), so every table must come out the same,
the instanced groups' included: integer and BVH tables exactly, float
tables (textures and the environment's CDFs included) within 1e-6
relative (the rgb2spec coefficient lookup runs in float32 on both sides).
The SAH build is a pure function of the triangle boxes, so each package's
build is computed once per distinct geometry in this module (ten scenes
share the Cornell box with the bunny, three the instanced bunny) and its
tables are still compared for every scene.
"""
import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import tpu_pathtracer.scene.builder as jbuilder
from tpu_pathtracer.scenes import load_scene as jload
from tpu_pathtracer_torch import resolve_device
from tpu_pathtracer_torch.bridge import as_numpy_tree, scene_from_numpy
from tpu_pathtracer_torch.render import integrator as tint
from tpu_pathtracer_torch.render.sampler import make_sampler
from tpu_pathtracer_torch.scene import builder as tbuilder
from tpu_pathtracer_torch.scene.types import SceneMeta, check_ported
from tpu_pathtracer_torch.scenes import load_scene as tload

PKG = pathlib.Path(__file__).resolve().parents[1] / "tpu_pathtracer_torch"


@pytest.fixture(scope="module", autouse=True)
def bvh_once_per_geometry():
    """Each package's SAH build, computed once per set of triangle boxes."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jbuilder, tbuilder):
            cache = {}

            def build(lo, hi, _real=mod.build_bvh, _cache=cache):
                key = (lo.tobytes(), hi.tobytes())
                if key not in _cache:
                    _cache[key] = _real(lo, hi)
                return _cache[key]
            mp.setattr(mod, "build_bvh", build)
        yield


@pytest.fixture(scope="module")
def scenes():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPT_NO_NATIVE", "1")
        j = jload(17, 32, 24, table_res=16)
        t = tload(17, 32, 24, table_res=16, device="cpu")
    return j, t


def _eq(t, j, name):
    j = np.asarray(j)
    t = t.numpy()
    assert t.shape == j.shape, name
    if np.issubdtype(j.dtype, np.floating):
        np.testing.assert_allclose(t, j, rtol=1e-6, atol=0, err_msg=name)
    else:
        assert np.array_equal(t, j), name


def test_scene17_tables_match_jax(scenes):
    _tables_match(*scenes)


@pytest.mark.parametrize("n", [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12,
                               13, 14, 15, 16, 18, 19])
def test_scene_tables_match_jax(n):
    """Every other scene, built by both packages: the metal's eta and k
    bank rows (6), the glass's Sellmeier row (8, 11), plastics (9, 10,
    13), point lights (1, 2), textures and normal maps (3, 4, 5, 15, 18),
    the environment map and its CDFs (19), the instanced groups of gold,
    BK7 glass and plastic bunnies (7, 12, 14)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPT_NO_NATIVE", "1")
        j = jload(n, 32, 24, table_res=16)
        t = tload(n, 32, 24, table_res=16, device="cpu")
    _tables_match(j, t)


def _bvh_match(tb, jb, name):
    n = jb.tri9.shape[0]
    for f in ("nodes_f", "nodes_i", "tri9"):
        _eq(getattr(tb, f), getattr(jb, f), f"{name}.{f}")
    _eq(tb.tri_m12, np.asarray(jb.tri_m12)[:n], f"{name}.tri_m12")
    assert tb.stack_depth == jb.stack_hint.shape[0]


def _tables_match(j, t):
    (js, jm, jc), (ts, tm, tc) = j, t
    _bvh_match(ts.bvh, js.bvh, "bvh")
    assert len(ts.instanced) == len(js.instanced)
    for k, (tg, jg) in enumerate(zip(ts.instanced, js.instanced)):
        _bvh_match(tg.bvh, jg.bvh, f"instanced[{k}].bvh")
        for f in ("tri_attr", "fwd", "inv", "mat_id", "aabb_min",
                  "aabb_max"):
            _eq(getattr(tg, f), getattr(jg, f), f"instanced[{k}].{f}")
    for f in ("tri_attr", "tri_mat", "tri_light", "spectra", "area_tri",
              "area_tri_area", "area_tri_cdf", "world_radius", "rs_zn",
              "rs_coeffs"):
        _eq(getattr(ts, f), getattr(js, f), f)
    for table in ("materials", "lights"):
        tt, jt = getattr(ts, table), getattr(js, table)
        for f in dataclasses.fields(tt):
            _eq(getattr(tt, f.name), getattr(jt, f.name), f"{table}.{f.name}")
    assert len(ts.textures) == len(js.textures)
    for k, (a, b) in enumerate(zip(ts.textures, js.textures)):
        _eq(a, b, f"textures[{k}]")
    assert (ts.env is None) == (js.env is None)
    if ts.env is not None:
        for f in dataclasses.fields(ts.env):
            _eq(getattr(ts.env, f.name), getattr(js.env, f.name),
                f"env.{f.name}")
    assert tuple(tm) == tuple(jm)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_import_no_jax():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "tpu_pathtracer"), (f, mod)


def test_importing_port_loads_no_jax():
    code = (
        "import sys\n"
        "import tpu_pathtracer_torch, tpu_pathtracer_torch.bridge\n"
        "import tpu_pathtracer_torch.render.integrator\n"
        "import tpu_pathtracer_torch.scenes\n"
        "import tpu_pathtracer_torch.ops.cuda_trace\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'tpu_pathtracer')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(PKG.parent))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_default_device_rule():
    """No device given: the GPU, or an error where there is none."""
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            resolve_device(None)
        with pytest.raises(RuntimeError):
            tload(17, 8, 8)
        with pytest.raises(RuntimeError):
            tint.render(None, None, None, tint.RenderConfig(8, 8))
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("change,error", [
    (dict(strategy="albedo"), ValueError),     # an AOV: not a wavefront strategy
    (dict(strategy="normal"), ValueError),
    (dict(strategy="bdpt"), ValueError),
    (dict(sampler="halton"), ValueError)])
def test_outside_slice_config_raises(change, error):
    cfg = dataclasses.replace(tint.RenderConfig(8, 8, spp=1), **change)
    with pytest.raises(error):
        tint.render_wavefront(None, None, None, cfg)


def test_every_bounce_lockstep_film_equals_the_wavefront_film(scenes):
    """The differentiable pass's bounce loop (``trace_sample``: every
    bounce runs, no host read of the alive flags) renders the wavefront's
    film: the bounces after a lane died add nothing."""
    _, (ts, tm, tc) = scenes
    cfg = tint.RenderConfig(8, 6, spp=2, max_depth=5, precise=True)
    wf = tint.render_wavefront(ts, tm, tc, cfg)
    sampler = make_sampler(cfg.sampler, cfg.seed, cfg.spp, (8, 6))
    px = tint._pixel_grid(8, 6, "cpu")
    film = tint._accum_chunk(ts, tm, tc, cfg, sampler, cfg.spp, px, 0,
                             torch.zeros((48, 3)))
    np.testing.assert_allclose(film.numpy(), wf.numpy(), rtol=2e-5,
                               atol=2e-6)
    assert float(wf.mean()) > 0


def test_outside_slice_scene_raises():
    """What is not ported or does not exist raises: a scene number past
    the 20, an unknown sampler, a material or light kind the port does not
    know, an unknown material descriptor.  (The instanced scenes and
    groups, refused here before they were ported, are held to the JAX
    package in tests/test_torch_instancing.py.)"""
    with pytest.raises(ValueError):
        tload(20, 8, 8, device="cpu")
    with pytest.raises(ValueError):
        make_sampler("halton", 0, 1, (8, 8))
    with pytest.raises(NotImplementedError):
        check_ported(SceneMeta(mat_types=(7,), light_types=(0,),
                               n_tris=2, has_env=False, texture_shapes=()))
    with pytest.raises(NotImplementedError):
        check_ported(SceneMeta(mat_types=(0,), light_types=(5,), n_tris=2,
                               has_env=False, texture_shapes=()))
    with pytest.raises(NotImplementedError):
        tbuilder.SceneBuilder(table_res=16).add_material(object())


@pytest.mark.parametrize("n", [7, 15, 19])
def test_bridge_round_trip_textures_and_env(n):
    """A JAX-built scene carried over by the bridge has the tables of the
    port's own build: an instanced group (7), textures (15), the
    environment map (19)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPT_NO_NATIVE", "1")
        j = jload(n, 32, 24, table_res=16)
        t = tload(n, 32, 24, table_res=16, device="cpu")
    js, jm, jc = j
    bridged = scene_from_numpy(as_numpy_tree(js), jm._asdict(),
                               dataclasses.asdict(jc), device="cpu")
    _tables_match(j, bridged)
    _tables_match(j, t)
