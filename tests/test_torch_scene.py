"""The port's scene build vs the JAX package's, import hygiene, the device
rule, and the NotImplementedError fences around the slice.

Both packages build scenes 0, 6, 16 and 17 with the pure-numpy SAH builder
(the JAX one with TPT_NO_NATIVE=1), so every table must come out the same:
integer and
BVH tables exactly, float tables within 1e-6 relative (the rgb2spec
coefficient lookup runs in float32 on both sides).
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

from tpu_pathtracer.scenes import load_scene as jload
from tpu_pathtracer_torch import resolve_device
from tpu_pathtracer_torch.render import integrator as tint
from tpu_pathtracer_torch.render.sampler import make_sampler
from tpu_pathtracer_torch.scene import builder as tbuilder
from tpu_pathtracer_torch.scene.types import MAT_GLASS, SceneMeta, check_ported
from tpu_pathtracer_torch.scenes import load_scene as tload

PKG = pathlib.Path(__file__).resolve().parents[1] / "tpu_pathtracer_torch"


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


@pytest.mark.parametrize("n", [0, 6, 16])
def test_scene_tables_match_jax(n):
    """Scenes 0 (Lambert bunny), 6 (gold bunny: the eta and k bank rows)
    and 16 (clearcoat dragon) built by both packages."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPT_NO_NATIVE", "1")
        j = jload(n, 32, 24, table_res=16)
    _tables_match(j, tload(n, 32, 24, table_res=16, device="cpu"))


def _tables_match(j, t):
    (js, jm, jc), (ts, tm, tc) = j, t
    n = js.bvh.tri9.shape[0]
    for f in ("nodes_f", "nodes_i", "tri9"):
        _eq(getattr(ts.bvh, f), getattr(js.bvh, f), f)
    _eq(ts.bvh.tri_m12, np.asarray(js.bvh.tri_m12)[:n], "tri_m12")
    assert ts.bvh.stack_depth == js.bvh.stack_hint.shape[0]
    for f in ("tri_attr", "tri_mat", "tri_light", "spectra", "area_tri",
              "area_tri_area", "area_tri_cdf", "world_radius", "rs_zn",
              "rs_coeffs"):
        _eq(getattr(ts, f), getattr(js, f), f)
    for table in ("materials", "lights"):
        tt, jt = getattr(ts, table), getattr(js, table)
        for f in dataclasses.fields(tt):
            _eq(getattr(tt, f.name), getattr(jt, f.name), f"{table}.{f.name}")
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
    (dict(early_exit=False), NotImplementedError),
    (dict(strategy="albedo"), ValueError),     # an AOV: not a wavefront strategy
    (dict(strategy="normal"), ValueError),
    (dict(strategy="bdpt"), ValueError),
    (dict(sampler="halton"), ValueError)])
def test_outside_slice_config_raises(change, error):
    cfg = dataclasses.replace(tint.RenderConfig(8, 8, spp=1), **change)
    with pytest.raises(error):
        tint.render_wavefront(None, None, None, cfg)


def test_outside_slice_scene_raises():
    for n in (1, 3, 7, 19):     # point lights, textures, instances
        with pytest.raises(NotImplementedError):
            tload(n, 8, 8, device="cpu")
    with pytest.raises(ValueError):
        make_sampler("halton", 0, 1, (8, 8))
    with pytest.raises(NotImplementedError):
        check_ported(SceneMeta(mat_types=(MAT_GLASS,), light_types=(0,),
                               n_tris=2, has_env=False, texture_shapes=()))
    with pytest.raises(NotImplementedError):
        check_ported(SceneMeta(mat_types=(0,), light_types=(1,), n_tris=2,
                               has_env=False, texture_shapes=()))
    with pytest.raises(NotImplementedError):
        tbuilder.SceneBuilder(table_res=16).add_material(object())
