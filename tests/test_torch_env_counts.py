"""The wavefront's live-lane counts of the environment light and of the
material kinds on the CPU, at toy sizes (``RenderStats.n_escape``,
``n_env_nee``, ``env_lanes``, ``n_shaded``, ``bsdf_lanes`` and the same
attributes of the ``wavefront.film`` span): on scene 19, alone and with a
point light beside the sky, the escapes and the NEE lanes sent to the sky
equal a count made from the step's own queries; the lanes are the tile's
lanes a step; a scene without an environment light carries none of it,
and its step spends two ops (a sum and an add) on each count it has and
none on the sky's; the kept step graph (faked) counts as the eager loop."""
import dataclasses

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tpu_pathtracer_torch import scenes, telemetry
from tpu_pathtracer_torch.render import integrator as tint
from tpu_pathtracer_torch.render import lights
from tpu_pathtracer_torch.render.camera import default_camera
from tpu_pathtracer_torch.render.sampler import make_sampler
from tpu_pathtracer_torch.scene.builder import SceneBuilder
from tpu_pathtracer_torch.scene.types import LIGHT_ENV
from tpu_pathtracer_torch.spectrum.cie import illum_d6500

from test_torch_slice_scene0 import two_torch_threads  # noqa: F401
from test_torch_wavefront_graph import fake_cuda_graphs  # noqa: F401

SIZE = 8
ENV_KEYS = ("n_escape", "n_env_nee", "env_lanes")


def _sky_scene(point_light: bool):
    """Scene 19 (four material kinds under a sky), with a point light
    beside the sky when ``point_light``: then NEE picks either."""
    sb = SceneBuilder(table_res=16)
    cam = scenes.scene_19(sb, default_camera(SIZE, SIZE, fov=45.0))
    if point_light:
        sb.add_point_light((0.0, 2.0, 1.0), illum_d6500(), 4.0)
    scene, meta = sb.build(cam.position)
    return scene, meta, cam


@pytest.fixture(scope="module", params=[False, True],
                ids=["sky", "sky+point"])
def sky(request):
    return _sky_scene(request.param)


def _cfg(**kw):
    return tint.RenderConfig(**{"width": SIZE, "height": SIZE, "spp": 2,
                                "max_depth": 3, **kw})


def _film(scene, meta, cam, cfg, graphed=False):
    """(stats, the ``wavefront.film`` span's attributes) of one call."""
    telemetry.clear()
    with telemetry.recording():
        _, stats = tint._wavefront_film(scene, meta, cam, cfg, 0, None, None,
                                        graphed=graphed)
    (film,) = [sp for sp in telemetry.spans() if sp.name == "wavefront.film"]
    return stats, film.attrs


@pytest.mark.parametrize("strategy", ["pt", "mis"])
def test_env_counts_equal_a_brute_count(sky, strategy, monkeypatch):
    """Escapes: the lanes each closest-hit query traced whose interaction
    is not valid.  NEE to the sky: the lanes ``evaluate_nee`` shades whose
    light, picked again from its draws, is the sky and lit."""
    s, m, c = sky
    brute = {"n_escape": 0, "n_env_nee": 0, "steps": 0}
    real = {"intersect_scene": tint.trace.intersect_scene,
            "make_interaction": tint.make_interaction,
            "evaluate_nee": lights.evaluate_nee}
    traced = []

    def intersect_scene(*a, active=None, **kw):
        traced.append(active)
        return real["intersect_scene"](*a, active=active, **kw)

    def make_interaction(*a, **kw):
        it = real["make_interaction"](*a, **kw)
        brute["n_escape"] += int((traced.pop() & ~it.valid).sum())
        brute["steps"] += 1
        return it

    def evaluate_nee(scene, meta, it, frame, wo_t, wl, u_light, *a, **kw):
        row, _, any_l = lights.pick_light(scene, meta, wl, u_light)
        to_sky = scene.lights.light_type[row] == LIGHT_ENV
        brute["n_env_nee"] += int((to_sky & any_l & it.valid).sum())
        return real["evaluate_nee"](scene, meta, it, frame, wo_t, wl,
                                    u_light, *a, **kw)

    monkeypatch.setattr(tint.trace, "intersect_scene", intersect_scene)
    monkeypatch.setattr(tint, "make_interaction", make_interaction)
    monkeypatch.setattr(lights, "evaluate_nee", evaluate_nee)
    stats, attrs = _film(s, m, c, _cfg(strategy=strategy))
    assert brute["steps"] == stats.n_steps and traced == []
    assert stats.n_escape == attrs["n_escape"] == brute["n_escape"] > 0
    assert stats.env_lanes == attrs["env_lanes"] == SIZE * SIZE * (
        stats.n_steps)
    assert stats.n_escape <= stats.n_closest
    if strategy == "pt":
        assert stats.n_env_nee == brute["n_env_nee"] == 0
        assert "n_env_nee" not in attrs
    else:
        assert stats.n_env_nee == attrs["n_env_nee"] == brute["n_env_nee"]
        assert 0 < stats.n_env_nee <= stats.n_shadow
        point = len(m.light_types) > 1
        assert (stats.n_env_nee < stats.n_shadow) == point


def test_bsdf_lanes_are_kinds_by_tile_lanes(sky):
    """Scene 19 samples four kinds (Lambert, plastic, PBR, clearcoat);
    each lane it shades is a traced lane, one kind's."""
    s, m, c = sky
    stats, attrs = _film(s, m, c, _cfg())
    assert stats.bsdf_lanes == attrs["bsdf_lanes"] == 4 * SIZE * SIZE * (
        stats.n_steps)
    assert 0 < stats.n_shaded == attrs["n_shaded"] <= stats.bsdf_lanes
    assert stats.n_shaded <= stats.n_closest - stats.n_escape


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def _step_ops(s, m, c, cfg, counts) -> int:
    """Device ops of the second step of a tile whose state has
    ``counts``."""
    px = tint._pixel_grid(SIZE, SIZE, "cpu")
    smp = make_sampler(cfg.sampler, cfg.seed, cfg.spp, (SIZE, SIZE))
    table = tint._spectral_table(s)
    n = SIZE * SIZE
    state = tint._wavefront_init(n, 0, torch.zeros((n, 3)), counts)
    state = tint._wavefront_step(s, m, c, cfg, smp, px, cfg.spp, state,
                                 table)
    with _Ops() as ops:
        out = tint._wavefront_step(s, m, c, cfg, smp, px, cfg.spp, state,
                                   table)
    assert [k for k in out if k.startswith("n_")] == list(counts)
    return ops.n


@pytest.mark.parametrize("scene_id", [2, 17])
def test_scene_without_env_counts_nothing_of_it(scene_id, monkeypatch):
    """Scenes 2 (a point light, one kind) and 17 (an area light, two
    kinds), MIS: no count or lane of the sky in the state, the stats or
    the span; ``evaluate_nee`` marks no lane as sent to the sky; the
    step's ops are those of a state without counts plus a sum and an add
    for each of the three it has."""
    s, m, c = scenes.load_scene(scene_id, SIZE, SIZE, table_res=16,
                                device="cpu")
    cfg = _cfg(strategy="mis")
    counts = tint._counts_of(m, cfg)
    assert counts == ("n_closest", "n_shadow", "n_shaded")
    assert _step_ops(s, m, c, cfg, counts) == _step_ops(s, m, c, cfg,
                                                        ()) + 2 * 3
    real, marked = lights.evaluate_nee, []

    def evaluate_nee(*a, **kw):
        out = real(*a, **kw)
        marked.append(out.to_env)
        return out
    monkeypatch.setattr(lights, "evaluate_nee", evaluate_nee)
    stats, attrs = _film(s, m, c, cfg)
    assert marked and marked == [None] * stats.n_steps
    assert not set(ENV_KEYS) & set(attrs)
    assert (stats.n_escape, stats.n_env_nee, stats.env_lanes) == (0, 0, 0)
    kinds = {2: 1, 17: 2}[scene_id]
    assert stats.bsdf_lanes == kinds * SIZE * SIZE * stats.n_steps
    assert 0 < stats.n_shaded <= stats.bsdf_lanes


def test_env_step_counts_with_two_ops_each(sky):
    """On scene 19 under MIS the state has all five counts, each a sum and
    an add of a mask the step makes anyway."""
    s, m, c = sky
    cfg = _cfg(strategy="mis")
    counts = tint._counts_of(m, cfg)
    assert counts == tint.COUNTS
    assert _step_ops(s, m, c, cfg, counts) == _step_ops(s, m, c, cfg,
                                                        ()) + 2 * 5


def test_kept_graph_counts_equal_the_eager_loop(sky, fake_cuda_graphs):
    """Two tiles through the kept step graph (faked: a replay runs the
    step) count what the eager loop counts, and set the same span."""
    s, m, c = sky
    cfg = dataclasses.replace(_cfg(), tile_rays=48)
    eager = _film(s, m, c, cfg)
    kept = _film(s, m, c, cfg, graphed=True)
    assert len(fake_cuda_graphs) == 1
    assert kept == eager
    stats = kept[0]
    assert stats.env_lanes == 48 * stats.n_steps and stats.n_env_nee > 0
