"""CPU tests of the readers of the program's own spans and counters
(``program_spans.py`` and the metrics that use it), on a synthetic
``DeviceTrace`` and synthetic spans; without the program's telemetry
module each gives None."""
from __future__ import annotations

import random
import sys

import pytest

from benchmark import harness, program_spans, yardstick


def _span(name, i, start, end, parent=None, **attrs):
    from tpu_pathtracer_torch import telemetry
    return telemetry.Span(name, i, parent, 1, start, end, attrs)


def _ctx(spans, monkeypatch):
    from tpu_pathtracer_torch import telemetry
    monkeypatch.setattr(telemetry, "spans", lambda: list(spans))

    class Ctx:
        device_trace = yardstick.DeviceTrace(
            [("a", 100, 200), ("b", 300, 400), ("c", 700, 800),
             ("d", 900, 1000)], [], 1000e-9)
        counts, layer = {}, {}
    return Ctx()


FILM = dict(n_closest=30, n_shadow=10, n_steps=2, closest_lanes=100,
            any_hit_lanes=100)
RENDER = [
    _span("progressive.pass", 1, 50, 1000, spp_start=0, spp_end=16),
    _span("wavefront.film", 2, 60, 990, 1, **FILM),
    _span("wavefront.tile", 3, 150, 850, 2, k=0),
    _span("wavefront.replay", 4, 150, 160, 3),
    # outside the segment (first to last device op: 100 to 1000)
    _span("progressive.pass", 5, 1100, 1200),
    _span("wavefront.film", 6, 1110, 1190, 5, **FILM),
]


def test_spans_of_the_segment(monkeypatch):
    ctx = _ctx(RENDER, monkeypatch)
    assert [s.id for s in program_spans.in_segment(ctx)] == [1, 2, 3, 4]


def test_idle_under_tiles_and_at_the_pass_boundary(monkeypatch):
    """Busy [100, 200], [300, 400], [700, 800], [900, 1000]: the tile
    [150, 850] is idle 100 + 300 + 50 ns; the pass outside it, cut to the
    segment [100, 1000], is [100, 150] and [850, 1000], idle 0 + 50 ns;
    both within the window's idle."""
    ctx = _ctx(RENDER, monkeypatch)
    tiles = harness.reader("wavefront.idle_share.tiles")(ctx)
    boundary = harness.reader("progressive.idle_share.boundary")(ctx)
    assert tiles == pytest.approx(0.45)
    assert boundary == pytest.approx(0.05)
    assert tiles + boundary <= ctx.device_trace.idle_share()
    assert harness.reader("train.idle_share.in_step")(ctx) is None


def test_idle_in_the_fit_step(monkeypatch):
    """Two steps over [100, 1000], 400 ns of it busy."""
    steps = [_span("train.step", 1, 100, 450),
             _span("grad.replay", 2, 120, 300, 1),
             _span("train.step", 3, 450, 1000)]
    ctx = _ctx(steps, monkeypatch)
    assert harness.reader("train.idle_share.in_step")(ctx) == pytest.approx(
        0.5)
    assert harness.reader("wavefront.idle_share.tiles")(ctx) is None


def test_idle_is_cut_to_the_segment(monkeypatch):
    """A span that opens before the first op and closes after the last
    counts only the segment's idle: [100, 1000] less 400 ns busy."""
    steps = [_span("train.step", 1, 0, 2000),
             _span("wavefront.tile", 2, 1050, 3000)]
    ctx = _ctx(steps, monkeypatch)
    assert harness.reader("train.idle_share.in_step")(ctx) == pytest.approx(
        0.5)
    assert program_spans.idle_s(ctx.device_trace, steps,
                                {"wavefront.tile"}) == 0.0


def test_live_shares_sum_over_the_films(monkeypatch):
    films = RENDER[:2] + [_span("wavefront.film", 7, 500, 600, 1,
                                n_closest=50, n_shadow=70, n_steps=1,
                                closest_lanes=100, any_hit_lanes=100)]
    ctx = _ctx(films, monkeypatch)
    assert harness.reader("traversal.live_share_closest")(ctx) == \
        pytest.approx(0.4)
    assert harness.reader("traversal.live_share_shadow")(ctx) == \
        pytest.approx(0.4)
    ctx = _ctx(RENDER[:1], monkeypatch)
    assert harness.reader("traversal.live_share_closest")(ctx) is None


def test_captures_read_the_programs_counter(monkeypatch):
    from tpu_pathtracer_torch.render import graphs
    monkeypatch.setattr(graphs, "CAPTURES", {"wavefront": 1, "grad": 2})
    ctx = _ctx([], monkeypatch)
    assert harness.reader("graphs.captures")(ctx) == 3
    ctx.device_trace = None
    assert harness.reader("graphs.captures")(ctx) is None


NEW = ("traversal.live_share_closest", "traversal.live_share_shadow",
       "wavefront.idle_share.tiles", "progressive.idle_share.boundary",
       "train.idle_share.in_step", "graphs.captures")


def test_nothing_without_the_programs_telemetry(monkeypatch):
    """A program without the telemetry module (an older checkout) gives
    no value, and raises nothing."""
    import tpu_pathtracer_torch
    from tpu_pathtracer_torch.render import graphs
    ctx = _ctx(RENDER, monkeypatch)
    monkeypatch.delattr(tpu_pathtracer_torch, "telemetry")
    monkeypatch.setitem(sys.modules, "tpu_pathtracer_torch.telemetry", None)
    monkeypatch.delattr(graphs, "CAPTURES")
    assert program_spans.in_segment(ctx) is None
    assert [harness.reader(m)(ctx) for m in NEW] == [None] * len(NEW)


def test_interval_difference_against_a_count_of_points():
    rng = random.Random(7)
    for _ in range(200):
        def draw():
            out = []
            for _ in range(rng.randrange(5)):
                s = rng.randrange(40)
                out.append([s, s + rng.randrange(1, 12)])
            return program_spans._union(out)
        a, b = draw(), draw()
        got = program_spans._minus(a, b)
        points = {x for s, e in a for x in range(s, e)} - {
            x for s, e in b for x in range(s, e)}
        assert {x for s, e in got for x in range(s, e)} == points
        assert all(s < e for s, e in got)
