"""CPU tests of what the ``env_sky.render`` cell brings: its check fails
a broken render as the scan's does, the readers of the environment
light's and the BSDF kinds' live lanes read the ``wavefront.film``
spans and give None without them, and each configuration entry lists
the cuts its file lists."""
from __future__ import annotations

import json
import os
import sys

import pytest

from benchmark import harness, program_spans
from benchmark.test_bench_check import RENDER_FAULTS, _patched, _run
from benchmark.test_bench_program_spans import FILM, RENDER, _ctx, _span

SHARES = ("env.live_share_escape", "env.live_share_nee", "bsdf.live_share")


@pytest.mark.parametrize("fault", sorted(RENDER_FAULTS))
def test_a_broken_sky_render_is_not_correct(fault, tmp_path, monkeypatch):
    from tpu_pathtracer_torch.render import progressive
    _patched(monkeypatch, progressive, "render_accum", RENDER_FAULTS[fault])
    assert not _run("env_sky.render", tmp_path).correct


def test_env_and_bsdf_live_shares(monkeypatch):
    """The sky's escapes and NEE lanes over its lookups' lanes, the shaded
    lanes over the kinds' lanes, summed over the segment's films; a film
    without the sky's lanes (a scene without one, or an older program)
    gives no env share."""
    sky = dict(FILM, n_shaded=20, bsdf_lanes=400, n_escape=15,
               n_env_nee=5, env_lanes=100)
    films = [_span("progressive.pass", 1, 50, 1000),
             _span("wavefront.film", 2, 60, 500, 1, **sky),
             _span("wavefront.film", 3, 500, 990, 1,
                   **dict(sky, n_shaded=60, n_escape=25, n_env_nee=35))]
    ctx = _ctx(films, monkeypatch)
    assert harness.reader("env.live_share_escape")(ctx) == pytest.approx(0.2)
    assert harness.reader("env.live_share_nee")(ctx) == pytest.approx(0.2)
    assert harness.reader("bsdf.live_share")(ctx) == pytest.approx(0.1)
    ctx = _ctx(RENDER, monkeypatch)
    assert [harness.reader(m)(ctx) for m in SHARES] == [None] * 3
    ctx = _ctx(films[:1] + [_span("wavefront.film", 2, 60, 990, 1,
                                  **dict(FILM, n_shaded=10,
                                         bsdf_lanes=200))], monkeypatch)
    assert harness.reader("bsdf.live_share")(ctx) == pytest.approx(0.05)
    assert harness.reader("env.live_share_escape")(ctx) is None


def test_no_share_without_the_programs_telemetry(monkeypatch):
    """A program without the telemetry module (an older checkout) gives
    no value, and raises nothing."""
    import tpu_pathtracer_torch
    ctx = _ctx(RENDER, monkeypatch)
    monkeypatch.delattr(tpu_pathtracer_torch, "telemetry")
    monkeypatch.setitem(sys.modules, "tpu_pathtracer_torch.telemetry", None)
    assert program_spans.in_segment(ctx) is None
    assert [harness.reader(m)(ctx) for m in SHARES] == [None] * 3


def test_configs_give_their_files_cuts():
    """An entry of ``configs`` lists the cuts its file lists."""
    bench = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
    for c in bench["configs"]:
        conf = json.load(open(os.path.join(harness.ROOT, c["file"])))
        assert c["reduced"] == conf["reduced"], c["name"]
