"""The program's spans and counters (``tpu_pathtracer_torch.telemetry``,
``RenderStats``' ray split, ``cuda_trace.LANES``, ``graphs.CAPTURES``) on
the CPU, at toy sizes: nothing is recorded with recording off; a
progressive render and a fit step give the span tree of their layers;
spans share the profiler's clock; the counters add up, replays of a
(faked) captured graph included."""
import collections
import dataclasses
import types

import pytest
import torch

from tpu_pathtracer_torch import parallel as tpar
from tpu_pathtracer_torch import telemetry
from tpu_pathtracer_torch.ops import cuda_trace, trace
from tpu_pathtracer_torch.render import graphs
from tpu_pathtracer_torch.render import integrator as tint
from tpu_pathtracer_torch.render import progressive
from tpu_pathtracer_torch.scenes import load_scene

from test_torch_slice_scene0 import two_torch_threads  # noqa: F401
from test_torch_wavefront_graph import _FakeCUDAGraph
from test_torch_wavefront_graph import fake_cuda_graphs  # noqa: F401

SIZE = 8


@pytest.fixture(scope="module")
def scene():
    """Scene 2, a Cornell box and a bunny under a point light: shadow
    rays, and a cheap brute-force plain hit test."""
    return load_scene(2, SIZE, SIZE, table_res=16, device="cpu")


def _cfg(**kw):
    return tint.RenderConfig(**{"width": SIZE, "height": SIZE, "spp": 2,
                                "max_depth": 2, **kw})


def _recorded(fn):
    """The spans ``fn()`` records under ``recording()``, and its result."""
    telemetry.clear()
    with telemetry.recording():
        out = fn()
    return telemetry.spans(), out


def _children(spans, parent):
    return [s for s in spans if s.parent == parent.id]


def _inside(child, parent) -> bool:
    return (parent.start_ns <= child.start_ns <= child.end_ns
            <= parent.end_ns)


def test_nothing_is_recorded_with_recording_off():
    assert not torch._C._autograd._profiler_enabled()
    telemetry.clear()
    sp = telemetry.span("wavefront.film", k=1)
    assert sp is telemetry.NO_SPAN
    with sp as entered:
        entered.set(n=1)
    assert telemetry.spans() == []


def test_progressive_render_gives_the_span_tree(scene):
    """One root ``progressive.pass`` per pass, with its sample range; its
    film, the film's tile and the tile's steps and done reads below it,
    each inside its parent and of the pass's request; and the spans close
    when ``on_chunk`` raises."""
    s, m, c = scene
    cfg = _cfg()
    spans, _ = _recorded(lambda: progressive.render_progressive(
        s, m, c, cfg, chunk_spp=1, device="cpu"))
    roots = [sp for sp in spans if sp.parent is None]
    assert [(r.name, r.attrs) for r in roots] == [
        ("progressive.pass", {"spp_start": 0, "spp_end": 1}),
        ("progressive.pass", {"spp_start": 1, "spp_end": 2})]
    for root in roots:
        mine = [sp for sp in spans if sp.root == root.id]
        (film,) = _children(spans, root)
        assert film.name == "wavefront.film"
        assert film.attrs["n_closest"] > 0 and film.attrs["n_shadow"] > 0
        assert film.attrs["closest_lanes"] == 0    # no kernel on the CPU
        (tile,) = _children(spans, film)
        assert (tile.name, tile.attrs) == ("wavefront.tile", {"k": 0})
        steps = [sp.name for sp in _children(spans, tile)]
        assert set(steps) == {"wavefront.replay", "wavefront.done_read"}
        assert steps.count("wavefront.replay") == film.attrs["n_steps"]
        assert steps.count("wavefront.replay") == (
            tint.SYNC_EVERY * steps.count("wavefront.done_read"))
        assert len(mine) == 3 + len(steps)
        by_id = {sp.id: sp for sp in spans}
        assert all(_inside(sp, by_id[sp.parent]) for sp in mine
                   if sp.parent is not None)

    class Stop(Exception):
        pass

    def stop(_):
        raise Stop

    def cut():
        with pytest.raises(Stop):
            progressive.render_progressive(s, m, c, cfg, chunk_spp=1,
                                           on_chunk=stop, device="cpu")
    spans, _ = _recorded(cut)
    assert [sp.name for sp in spans if sp.parent is None] == [
        "progressive.pass"]
    assert telemetry._stack() == []
    with telemetry.recording(), telemetry.span("next") as after:
        assert after.parent is None


class _FakeGradGraph(tpar._LossAndGradsGraph):
    """``_LossAndGradsGraph`` on the CPU: the program run eagerly at build
    time stands for the capture, a replay does nothing (the outputs stay
    the build's), and the first call already replays."""

    def __init__(self, params, scene, meta, camera, cfg, px, target,
                 n_total):
        self.params = {k: v.clone() for k, v in params.items()}
        self.scene = scene.map(torch.clone)
        self.px, self.target = px, target.clone()
        self.loss, self.grads = tpar._loss_program(
            {k: v.clone().requires_grad_(True) for k, v in params.items()},
            scene, meta, camera, cfg, px, target, n_total)
        self.graph = types.SimpleNamespace(replay=lambda: None,
                                           reset=lambda: None)
        self.recorded = cuda_trace.Recorded(collections.Counter(),
                                            collections.Counter())
        self.first = None


def test_fit_step_gives_its_spans(scene, monkeypatch):
    """``train_step_adam``: the eager CPU step is ``train.step`` over
    ``train.adam``; through the kept grad graph (faked), the step's lookup
    (capturing on the first call only), the copies in, the replay and the
    clones out."""
    s, m, c = scene
    cfg = _cfg(spp=1)
    target = torch.zeros((SIZE * SIZE, 3))
    state = tpar.make_train_state(s, device="cpu")
    spans, _ = _recorded(lambda: tpar.train_step_adam(
        state, s, m, c, cfg, target, device="cpu"))
    assert [(sp.name, sp.parent is None) for sp in spans] == [
        ("train.adam", False), ("train.step", True)]

    monkeypatch.setattr(tpar, "_LossAndGradsGraph", _FakeGradGraph)
    monkeypatch.setattr(tpar, "loss_and_grads", lambda p, *a, **kw: (
        tpar._loss_and_grads(p, *a, None, torch.device("cpu"),
                             graphed=True)))
    graphs.release_graphs()
    try:
        for capture in (True, False):
            spans, _ = _recorded(lambda: tpar.train_step_adam(
                state, s, m, c, cfg, target))
            root = spans[-1]
            assert root.name == "train.step" and root.parent is None
            assert [sp.name for sp in _children(spans, root)] == [
                "graphs.lookup", "grad.load", "grad.replay", "grad.outputs",
                "train.adam"]
            lookup = spans[1 if capture else 0]
            assert (lookup.name, lookup.attrs) == ("graphs.lookup",
                                                   {"slot": "grad"})
            captures = [sp for sp in spans if sp.name == "graphs.capture"]
            assert [(sp.attrs, sp.parent) for sp in captures] == (
                [({"slot": "grad"}, lookup.id)] if capture else [])
    finally:
        graphs.release_graphs()


def test_spans_share_the_profilers_clock():
    """Under ``torch.profiler`` spans record without ``recording()``, and a
    span's start lies within 200 us before a profiler range opened first
    thing inside it."""
    telemetry.clear()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("warm"):
            pass
        with telemetry.span("outer") as outer:
            with torch.profiler.record_function("probe"):
                pass
    (sp,) = telemetry.spans()
    assert sp.id == outer.id and sp.name == "outer"
    (probe,) = [e for e in prof.profiler.kineto_results.events()
                if e.name() == "probe"]
    assert 0 <= probe.start_ns() - sp.start_ns <= 200_000
    assert probe.end_ns() <= sp.end_ns
    assert telemetry.span("after") is telemetry.NO_SPAN


@pytest.mark.parametrize("strategy", tint.PATH_STRATEGIES)
def test_rays_split_into_closest_and_shadow(scene, strategy, monkeypatch):
    """The split equals the live rows of the traversal queries, counted
    at ``ops.trace``'s closest-hit and occlusion calls."""
    queried = {"intersect": 0, "intersect_p": 0}
    for name in queried:
        real = getattr(trace, name)

        def counted(bvh, ray_o, ray_d, t_max, active=None, _real=real,
                    _name=name, **kw):
            queried[_name] += int(active.sum())
            return _real(bvh, ray_o, ray_d, t_max, active=active, **kw)
        monkeypatch.setattr(trace, name, counted)
    s, m, c = scene
    cfg = _cfg(strategy=strategy)
    spans, (_, stats) = _recorded(lambda: tint.render_wavefront(
        s, m, c, cfg, with_stats=True))
    assert stats.n_closest + stats.n_shadow == stats.n_rays
    assert (stats.n_closest, stats.n_shadow) == (queried["intersect"],
                                                 queried["intersect_p"])
    assert stats.n_closest > 0
    assert (stats.n_shadow > 0) == (strategy != "pt")
    (film,) = [sp for sp in spans if sp.name == "wavefront.film"]
    assert (film.attrs["n_closest"], film.attrs["n_shadow"],
            film.attrs["n_steps"]) == (stats.n_closest, stats.n_shadow,
                                       stats.n_steps)


class _Graph:
    def release(self):
        pass


def test_keep_counts_one_capture_per_new_key():
    graphs.release_graphs()
    before = graphs.CAPTURES.copy()
    spans, _ = _recorded(lambda: [
        graphs.keep("wavefront", key, _Graph)
        for key in ("a", "a", "b", "b", "a")])
    graphs.keep("grad", "a", _Graph)
    assert graphs.CAPTURES - before == {"wavefront": 3, "grad": 1}
    assert [(sp.name, sp.attrs) for sp in spans] == [
        ("graphs.capture", {"slot": "wavefront"})] * 3
    graphs.release_graphs()


def test_captured_launches_take_lanes_out_and_replays_add_them():
    cuda_trace.reset_launch_counts()
    cuda_trace._count_launch("closest_hit", 100)
    with cuda_trace.captured_launches() as rec:
        cuda_trace._count_launch("closest_hit", 64)
        cuda_trace._count_launch("any_hit", 64)
    assert dict(rec.launches) == {"closest_hit": 1, "any_hit": 1}
    assert dict(rec.lanes) == {"closest_hit": 64, "any_hit": 64}
    assert cuda_trace.lanes_by_kind() == (100, 0)
    cuda_trace.count_replay(rec)
    cuda_trace.count_replay(rec)
    assert cuda_trace.LAUNCHES["closest_hit"] == 3
    assert cuda_trace.lanes_by_kind() == (228, 128)
    cuda_trace.reset_launch_counts()
    assert cuda_trace.lanes_by_kind() == (0, 0)


class _HeldCUDAGraph(_FakeCUDAGraph):
    """A faked replay that runs the step but, like a real replay, no
    wrapper: the launch and lane counts are held as they were."""

    def replay(self):
        held = cuda_trace.LAUNCHES.copy(), cuda_trace.LANES.copy()
        super().replay()
        for counter, value in zip((cuda_trace.LAUNCHES, cuda_trace.LANES),
                                  held):
            counter.clear()
            counter.update(value)


def test_lanes_of_replays_equal_the_eager_loops(scene, fake_cuda_graphs,
                                                monkeypatch):
    """With the plain versions counted as launches, the kept path's lanes
    (the eager warm-up step, the capture taken back out, the replays
    added) are the eager loop's: a tile's lanes a step for each kernel;
    the live rays no more than the lanes."""
    for plain, name in (("closest_hit_plain", "closest_hit"),
                        ("any_hit_plain", "any_hit")):
        real = getattr(cuda_trace, plain)

        def counted(tris, rays, _real=real, _name=name):
            cuda_trace._count_launch(_name, rays.shape[1])
            return _real(tris, rays)
        monkeypatch.setattr(cuda_trace, plain, counted)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _HeldCUDAGraph)
    s, m, c = scene
    cfg = dataclasses.replace(_cfg(), tile_rays=48)     # two tiles
    films = {}
    for graphed in (False, True):
        cuda_trace.reset_launch_counts()
        spans, out = _recorded(lambda: tint._wavefront_film(
            s, m, c, cfg, 0, None, None, graphed=graphed))
        (film,) = [sp for sp in spans if sp.name == "wavefront.film"]
        films[graphed] = (out[0], out[1], film.attrs,
                          dict(cuda_trace.LAUNCHES), dict(cuda_trace.LANES))
    assert len(fake_cuda_graphs) == 1
    eager, kept = films[False], films[True]
    assert torch.equal(eager[0], kept[0]) and eager[1] == kept[1]
    assert eager[2:] == kept[2:]
    attrs, stats = kept[2], kept[1]
    assert attrs["closest_lanes"] == attrs["any_hit_lanes"] == (
        stats.n_steps * 48)
    assert kept[3] == {"closest_hit": stats.n_steps,
                       "any_hit": stats.n_steps}
    assert 0 < stats.n_closest <= attrs["closest_lanes"]
    assert 0 < stats.n_shadow <= attrs["any_hit_lanes"]
