"""Which path the material layer takes, on the CPU: ``bsdf.uses_kernel``
sends an untextured scene's lanes on a CUDA device, with no gradient to
take through the material table, to the two kernels of
``ops.bsdf_kernels``, and everything else to the torch ops; the torch
ops' ``bsdf_lanes`` and launch counts are unchanged; and the kernels'
source agrees with the torch path on the constants it rounds and with its
wrapper on the columns it reads.  The kernels themselves run on the card
(``tests/test_torch_cuda.py -k material_kernels``)."""
import dataclasses
import math
import re

import numpy as np
import pytest
import torch

from tpu_pathtracer_torch.ops import bsdf_kernels, cuda_trace
from tpu_pathtracer_torch.render import bsdf
from tpu_pathtracer_torch.render import integrator as tint
from tpu_pathtracer_torch.scenes import load_scene

from test_torch_slice_scene0 import two_torch_threads  # noqa: F401

CUDA = torch.device("cuda", 0)


@pytest.fixture(scope="module")
def scene17():
    return load_scene(17, 16, 12, table_res=16, device="cpu")


@pytest.fixture(scope="module")
def source():
    with open(bsdf_kernels.KERNEL_SOURCE) as f:
        return f.read()


def test_cpu_lanes_take_the_torch_ops(scene17):
    s, _, _ = scene17
    assert not bsdf.uses_kernel(s, torch.device("cpu"))
    assert not bsdf.uses_kernel(s, "cpu")


def test_untextured_cuda_lanes_take_the_kernels(scene17):
    s, _, _ = scene17
    assert not s.textures
    assert bsdf.uses_kernel(s, CUDA)
    assert bsdf.uses_kernel(s, "cuda")


def test_a_gradient_through_the_materials_takes_the_torch_ops(scene17):
    s, _, _ = scene17
    column = s.materials.roughness.clone().requires_grad_(True)
    trained = dataclasses.replace(
        s, materials=dataclasses.replace(s.materials, roughness=column))
    assert not bsdf.uses_kernel(trained, CUDA)
    with torch.no_grad():
        assert bsdf.uses_kernel(trained, CUDA)
    with torch.enable_grad():
        assert bsdf.uses_kernel(s, CUDA)


def test_a_textured_scene_takes_the_torch_ops():
    s, _, _ = load_scene(3, 8, 8, table_res=16, device="cpu")
    assert s.textures
    assert not bsdf.uses_kernel(s, CUDA)
    with torch.no_grad():
        assert not bsdf.uses_kernel(s, CUDA)


def test_torch_ops_count_their_kinds_and_launch_no_kernel(scene17):
    """On the CPU ``bsdf_lanes`` is kinds x tile lanes x steps, as before
    the kernels, and neither material kernel is launched or counted."""
    s, m, c = scene17
    cfg = tint.RenderConfig(width=16, height=12, spp=1, max_depth=3,
                            tile_rays=256)
    cuda_trace.reset_launch_counts()
    _, stats = tint._wavefront_film(s, m, c, cfg, 0, None, None,
                                    graphed=False)
    assert bsdf.n_sampled_kinds(m) == 2
    assert stats.bsdf_lanes == 2 * 16 * 12 * stats.n_steps > 0
    for name in (bsdf_kernels.SAMPLE_NAME, bsdf_kernels.EVAL_NAME):
        assert cuda_trace.LAUNCHES[name] == cuda_trace.LANES[name] == 0


def _constant(source, name):
    m = re.search(rf"constexpr (?:float|double) {name} = (.+?);", source)
    assert m, name
    return m.group(1)


def _f32(x):
    return float(np.float32(x))


@pytest.mark.parametrize("name,want", [
    ("INV_PI", _f32(1.0 / math.pi)), ("PI_F", _f32(math.pi)),
    ("TWO_PI", _f32(2.0 * math.pi)), ("SMOOTH_ALPHA", _f32(bsdf.SMOOTH_ALPHA)),
    ("EPS_NORM", _f32(1e-20 * 1e-20)), ("LAMBDA_MIN", 360.0),
    ("LAMBDA_SCALE", _f32(1.0 / (830.0 - 360.0))),
    ("SCHLICK_FMAX_POW", _f32((1.0 - 1.0 / 7.0) ** 5.0)),
    ("SCHLICK_DIP", _f32(1.0 / ((1.0 / 7.0) * (1.0 - 1.0 / 7.0) ** 6))),
    ("MM", _f32(0.001)), ("PER_MM", _f32(1.0 / 0.001))])
def test_kernel_constants_are_the_torch_paths(source, name, want):
    """Each python float of the torch path that the kernels hold, rounded
    to float32 as a tensor operand is (``x / 0.001`` on a CUDA tensor is x
    times the reciprocal taken in double)."""
    text = _constant(source, name).replace("(float)", "")
    text = re.sub(r"(\d)f\b", r"\1", text)
    value = float.fromhex(text) if "0x" in text else eval(
        text, {"__builtins__": {}})
    assert _f32(value) == want


def test_kernel_reads_the_wrappers_columns(source, scene17, monkeypatch):
    """The material table's columns in the order of the source's Table,
    and as many lane columns as its IN_SAMPLE / IN_EVAL."""
    table = re.search(r"struct Table \{(.*?)\};", source, re.S).group(1)
    fields = re.findall(r"const (?:int|float)\* (\w+);", table)
    assert fields == [name for name, _, _ in bsdf_kernels.TABLE_COLUMNS]
    n_sample = int(re.search(r"IN_SAMPLE = (\d+)", source).group(1))
    n_eval = int(re.search(r"IN_EVAL = (\d+)", source).group(1))

    s, m, c = scene17
    seen = []
    monkeypatch.setattr(bsdf_kernels, "_launch",
                        lambda eval_, *a: seen.append((eval_, len(a[3]))))
    recorded = {}
    real = bsdf._sample_material_ops

    def record(*args):
        recorded["sample"] = args
        return real(*args)
    monkeypatch.setattr(bsdf, "_sample_material_ops", record)
    cfg = tint.RenderConfig(width=16, height=12, spp=1, max_depth=1,
                            tile_rays=256)
    tint._wavefront_film(s, m, c, cfg, 0, None, None, graphed=False)
    scene, meta, it, frame, wo_t, uc, uv2, wl, uc2, uc3 = recorded["sample"]
    bsdf_kernels.sample(scene, meta, it, frame, wo_t, uc, uv2, wl, uc2, uc3)
    bsdf_kernels.evaluate(scene, meta, it, frame, wo_t, wo_t, wl)
    assert seen == [(False, n_sample), (True, n_eval)]
