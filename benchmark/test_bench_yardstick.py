"""CPU tests of the yardstick's frozen copies and its trace reduction."""
from __future__ import annotations

import numpy as np
import pytest

from benchmark import yardstick


def test_dragon_sweep_is_the_programs_sweep(tmp_path, monkeypatch):
    from tpu_pathtracer_torch.scene import mesh
    monkeypatch.setattr(mesh, "ASSET_DIR", str(tmp_path))   # no scan there
    pos, uvs, idx = yardstick.dragon_sweep(64, 8)
    m = mesh.dragon(n_u=64, n_v=8)
    assert np.array_equal(m.positions, pos.astype(np.float32))
    assert np.array_equal(m.indices, idx)
    assert np.array_equal(m.uvs, uvs.astype(np.float32))
    assert len(yardstick.dragon_sweep(2304, 192)[2]) == 884736


def test_obj_round_trip(tmp_path):
    from tpu_pathtracer_torch.scene import mesh
    pos, uvs, idx = yardstick.dragon_sweep(16, 4)
    path = str(tmp_path / "dragon.obj")
    yardstick.write_obj(path, pos, uvs, idx)
    m = mesh.load_obj(path)
    assert np.array_equal(m.positions[m.indices],
                          pos.astype(np.float32)[idx])
    assert np.array_equal(m.uvs[m.indices], uvs.astype(np.float32)[idx])


def test_procedural_sky_is_the_programs_sky(tmp_path):
    from tpu_pathtracer_torch import scenes
    from tpu_pathtracer_torch.scene import image_io
    from benchmark.reference.tpt.utils.exr import write_exr
    assert np.array_equal(yardstick.procedural_sky(), scenes._procedural_sky())
    sky = yardstick.procedural_sky(64, 128)
    write_exr(str(tmp_path / "sky.exr"), sky)
    assert np.array_equal(image_io.load_env(str(tmp_path / "sky.exr")), sky)


def test_traversal_bound_counts_rows_and_results():
    lanes = 262144
    k1 = yardstick.traversal_bound_s("void team_kernel<false, false>(...)",
                                     lanes)
    k2 = yardstick.traversal_bound_s(
        "void binary_any_hit_kernel<false>(...)", lanes)
    k2p = yardstick.traversal_bound_s("void team_kernel<true, true>(...)",
                                      lanes)
    assert not yardstick.is_traversal("void at::native::elementwise_kernel")
    assert k1 == lanes * (28 + 17) / 3.35e12
    assert k2 == k2p == lanes * (28 + 1) / 3.35e12


def _trace():
    ops = [("a", 0, 100), ("b", 50, 150), ("a", 400, 500),
           ("void team_kernel<false, false>(float const*)", 900, 1000)]
    spans = [("bench.pass", 0, 1000), ("bench.film", 150, 400)]
    return yardstick.DeviceTrace(ops, spans, window_s=1000e-9)


def test_trace_busy_union_idle_and_gaps():
    t = _trace()
    assert t.busy_intervals() == [[0, 150], [400, 500], [900, 1000]]
    assert t.busy_s() == pytest.approx(350e-9)
    assert t.device_s() == pytest.approx(400e-9)
    assert t.idle_share() == pytest.approx(0.65)
    assert t.idle_gaps() == [["bench.pass", pytest.approx(400e-9)],
                             ["bench.film", pytest.approx(250e-9)]]
    assert t.top_ops(2) == [["a", pytest.approx(200e-9)],
                            ["b", pytest.approx(100e-9)]]
    assert t.traversal() == [("void team_kernel<false, false>(float const*)",
                              pytest.approx(100e-9))]


def test_metric_readers_return_nothing_without_a_trace():
    import json
    import os
    from benchmark import harness
    bench = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))

    class Empty:
        device_trace, counts, layer = None, {}, {}
    for m in bench["per_layer"]:
        assert harness.reader(m["name"])(Empty()) is None


def test_device_readers_per_step_and_roofline():
    from benchmark import harness

    class Ctx:
        device_trace = _trace()
        counts = {"steps": 2, "traversal_lanes": 1000}
        layer = {}
    assert harness.reader("step.ops")(Ctx()) == 2.0
    assert harness.reader("step.device_ms")(Ctx()) == pytest.approx(2e-4)
    assert harness.reader("kernels.trace_share")(Ctx()) == pytest.approx(
        0.25)
    want = 100 * 1000 * 45 / 3.35e12 / 100e-9
    assert harness.reader("traversal_roofline")(Ctx()) == pytest.approx(want)
