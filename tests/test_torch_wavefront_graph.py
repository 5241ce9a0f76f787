"""The wavefront step can be captured as a CUDA graph: after one warm-up
step, ``_wavefront_step`` creates no tensor from host data and reads no
device value on the host, for every strategy, both samplers, the fast and
the precise hit test, textures, the environment light and an instanced
group.  A copy from the host or a read back either stalls the stream or
breaks a capture, so on the card ``render_wavefront`` captures the step
once and replays it.

On the CPU the guard is a ``TorchFunctionMode`` that records every call
that makes a tensor from host data (``torch.tensor``, ``as_tensor``) or
brings a value to the host (``item``, ``bool``, ``int``, ``float``,
``tolist``, ``cpu``, ``numpy``, ``nonzero``, a boolean mask index, a
one-argument ``where``).  The plain versions of the four traversal kernels
are exempt: they are the CPU's stand-in for the kernels, which launch on
the stream and read nothing back.  The CPU renders through the eager step
loop; its film still equals the JAX package's.

The captured step is kept from call to call (``integrator.
_WavefrontGraph`` in the "wavefront" slot of ``render/graphs.py``) with
``spp_end`` a 0-d int32 tensor: the tensor form gives the int form's
steps bit for bit, and the kept path -- a copy of the scene and of the
spectral table filled per call, one capture per configuration, any
sample range -- runs here with CUDA graphs faked (a replay re-runs the
captured step), against the eager loop.
"""
import contextlib
import dataclasses
import os
import sys
import traceback

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from tpu_pathtracer.render import film as jfilm
from tpu_pathtracer.render import integrator as jint
from tpu_pathtracer.scenes import load_scene as jload
from tpu_pathtracer_torch import parallel as tpar
from tpu_pathtracer_torch.bridge import as_numpy_tree, scene_from_numpy
from tpu_pathtracer_torch.ops import cuda_trace
from tpu_pathtracer_torch.render import film as tfilm
from tpu_pathtracer_torch.render import graphs
from tpu_pathtracer_torch.render import integrator as tint
from tpu_pathtracer_torch.render.sampler import make_sampler
from tpu_pathtracer_torch.scenes import load_scene

from test_torch_slice_scene0 import two_torch_threads  # noqa: F401

SIZE = 16
PLAIN = ("closest_hit_plain", "closest_hit_precise_plain", "any_hit_plain",
         "any_hit_precise_plain")
PORT_DIR = os.path.dirname(os.path.dirname(os.path.abspath(tint.__file__)))

_HOST_DATA = {torch.tensor, torch.as_tensor}
_READ_BACK = {torch.Tensor.item, torch.Tensor.__bool__, torch.Tensor.__int__,
              torch.Tensor.__float__, torch.Tensor.__index__,
              torch.Tensor.tolist, torch.Tensor.cpu, torch.Tensor.numpy,
              torch.nonzero, torch.Tensor.nonzero, torch.masked_select,
              torch.Tensor.masked_select}


def _bool_index(args) -> bool:
    """A boolean mask among the indices of __getitem__ / __setitem__ (its
    true count sets the shape: a read back)."""
    idx = args[1] if len(args) > 1 else None
    idx = idx if isinstance(idx, tuple) else (idx,)
    return any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
               for i in idx)


class HostTrafficGuard(TorchFunctionMode):
    """Records, with the port's line that made it, every call that copies
    host data to a tensor or brings a tensor's value to the host."""

    def __init__(self):
        super().__init__()
        self.exempt = 0
        self.found = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not self.exempt:
            bad = (func in _HOST_DATA or func in _READ_BACK
                   or (func in (torch.Tensor.__getitem__,
                                torch.Tensor.__setitem__)
                       and _bool_index(args))
                   or (func is torch.where and len(args) == 1
                       and not kwargs))
            if bad:
                where = [f"{os.path.relpath(f.filename, PORT_DIR)}:{f.lineno}"
                         for f in traceback.extract_stack()
                         if f.filename.startswith(PORT_DIR + os.sep)]
                self.found.append((getattr(func, "__name__", str(func)),
                                   where[-1] if where else "?"))
        return func(*args, **kwargs)


@pytest.fixture
def guard(monkeypatch):
    """The guard, with the kernels' plain versions exempt."""
    g = HostTrafficGuard()
    for name in PLAIN:
        real = getattr(cuda_trace, name)

        def exempt(*a, _real=real, **kw):
            g.exempt += 1
            try:
                return _real(*a, **kw)
            finally:
                g.exempt -= 1
        monkeypatch.setattr(cuda_trace, name, exempt)
    return g


CASES = [
    # scene, strategy, sampler, precise: what the case adds
    (17, "mis", "sobol", False),     # the main path, K1 + K2
    (17, "mis", "sobol", True),      # the watertight path, K3 + K2p
    (6, "nee", "random", True),      # threefry, metal
    (3, "pt", "random", False),      # textures and a normal map, no NEE
    (19, "mis", "sobol", False),     # the environment light
    (7, "mis", "sobol", False),      # an instanced group
]


@pytest.mark.parametrize("scene,strategy,sampler,precise", CASES,
                         ids=[f"s{c[0]}-{c[1]}-{c[2]}"
                              + ("-precise" if c[3] else "") for c in CASES])
def test_step_copies_nothing_from_the_host(guard, scene, strategy, sampler,
                                           precise):
    s, m, c = load_scene(scene, SIZE, SIZE, table_res=16, device="cpu")
    cfg = tint.RenderConfig(width=SIZE, height=SIZE, spp=4, max_depth=6,
                            strategy=strategy, sampler=sampler,
                            precise=precise)
    tile = tint.tile_lanes(cfg)
    assert tile == SIZE * SIZE                  # one tile
    px = tint._pixel_grid(SIZE, SIZE, "cpu")
    smp = make_sampler(sampler, cfg.seed, cfg.spp, (SIZE, SIZE))
    table = tint._spectral_table(s)
    state = tint._wavefront_init(tile, 0, torch.zeros((tile, 3)),
                                 tint._counts_of(m, cfg))
    # the warm-up step builds the per-device constant tables
    state = tint._wavefront_step(s, m, c, cfg, smp, px, cfg.spp, state,
                                 table)
    # spp_end as the captured step holds it: a 0-d int32 tensor
    spp_end = torch.full((), cfg.spp, dtype=torch.int32)
    with guard:
        out = tint._wavefront_step(s, m, c, cfg, smp, px, cfg.spp, state,
                                   table)
        tint._wavefront_step(s, m, c, cfg, smp, px, spp_end, state, table)
    assert not guard.found, guard.found
    # the guard changed nothing: the step is a pure function of its state
    again = tint._wavefront_step(s, m, c, cfg, smp, px, cfg.spp, state,
                                 table)
    assert int(out["n_closest"]) == int(again["n_closest"]) > 0
    assert all(int(out[k]) == int(again[k]) for k in tint._counts_of(m, cfg))
    assert torch.equal(out["accum"].x, again["accum"].x)


def test_guard_sees_a_host_copy(guard):
    """The guard is not blind: a step that copies a python value to the
    device, as the sampler once did on every draw, is caught."""
    with guard:
        x = torch.zeros(4)
        torch.as_tensor(3, device=x.device)
        bool(x.any())
        x[x > 0] = 1.0
    assert [f for f, _ in guard.found] == ["as_tensor", "__bool__",
                                           "__setitem__"]


def test_cpu_render_is_the_eager_loop_and_equals_jax(monkeypatch):
    """On the CPU ``render_wavefront`` runs the eager step loop (there are
    no CUDA graphs), and its film equals the JAX package's wavefront film
    on scene 17 at tests/test_torch_render.py's size and gates."""
    w, h, spp, depth = 32, 24, 4, 6
    tiles = []
    real = tint._render_tile_eager
    monkeypatch.setattr(tint, "_render_tile_eager",
                        lambda *a, **k: tiles.append(1) or real(*a, **k))
    js, jm, jc = jload(17, w, h, table_res=16)
    jcfg = jint.RenderConfig(width=w, height=h, spp=spp, max_depth=depth,
                             strategy="mis", sampler="sobol")
    jacc, jrays = jint.render_wavefront(js, jm, jc, jcfg, with_ray_count=True)
    jimg = np.asarray(jfilm.finalize(jacc, spp, tone_map="reinhard",
                                     eotf="srgb"))
    ts, tm, tc = scene_from_numpy(as_numpy_tree(js), jm._asdict(),
                                  dataclasses.asdict(jc), device="cpu")
    tcfg = tint.RenderConfig(width=w, height=h, spp=spp, max_depth=depth)
    tacc, stats = tint.render_wavefront(ts, tm, tc, tcfg, with_stats=True)
    assert tiles == [1]
    timg = tfilm.finalize(tacc, spp, tone_map="reinhard",
                          eotf="srgb").numpy()
    assert np.isfinite(timg).all()
    rmse = float(np.sqrt(np.mean((timg - jimg) ** 2)))
    assert rmse <= 0.01, rmse
    j_mean = np.asarray(jacc).mean(0)
    np.testing.assert_allclose(tacc.numpy().mean(0), j_mean, rtol=0.01)
    assert abs(stats.n_rays - jrays) <= 0.01 * jrays


def _leaves_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in
               zip(tint._state_leaves(a), tint._state_leaves(b), strict=True))


@pytest.mark.parametrize("strategy", tint.PATH_STRATEGIES)
def test_step_spp_end_tensor_equals_int(strategy):
    """``spp_end`` as a 0-d int32 tensor (the kept graph's, filled per
    call) gives the python int's state bit for bit at every step, through
    the tile's end (every lane out of samples) and past it."""
    s, m, c = load_scene(17, SIZE, SIZE, table_res=16, device="cpu")
    cfg = tint.RenderConfig(width=SIZE, height=SIZE, spp=2, max_depth=3,
                            strategy=strategy)
    tile = SIZE * SIZE
    px = tint._pixel_grid(SIZE, SIZE, "cpu")
    smp = make_sampler(cfg.sampler, cfg.seed, cfg.spp, (SIZE, SIZE))
    table = tint._spectral_table(s)
    end = torch.full((), cfg.spp, dtype=torch.int32)
    a = b = tint._wavefront_init(tile, 0, torch.zeros((tile, 3)))
    done = []
    for _ in range(24):
        a = tint._wavefront_step(s, m, c, cfg, smp, px, cfg.spp, a, table)
        b = tint._wavefront_step(s, m, c, cfg, smp, px, end, b, table)
        assert _leaves_equal(a, b)
        done.append(tint._tile_done(b, end))
        assert done[-1] == tint._tile_done(a, cfg.spp)
    assert done[-1] and not done[0]


class _Graph:
    def __init__(self, name):
        self.name, self.released = name, False

    def release(self):
        self.released = True


def test_kept_wavefront_graph_is_keyed_and_released():
    """The "wavefront" slot keeps one graph under its key beside the other
    slots, and ``_wavefront_graph`` keeps one copy of the scene and of its
    spectral table per configuration (key: meta, camera, cfg, device, the
    scene's shapes, the tile's lanes), copying each call's values in; another configuration
    releases it, and ``release_graphs`` frees it."""
    graphs.release_graphs()
    a = graphs.keep("wavefront", ("k", 1), lambda: _Graph("a"))
    assert graphs.keep("wavefront", ("k", 1), lambda: _Graph("no")) is a
    lock = graphs.keep("grad", ("k", 1), lambda: _Graph("l"))
    b = graphs.keep("wavefront", ("k", 2), lambda: _Graph("b"))
    assert a.released and not b.released and not lock.released
    assert graphs.kept("wavefront") is b and graphs.kept("grad") is lock
    graphs.release_graphs("wavefront")
    assert b.released and graphs.kept("wavefront") is None
    assert not lock.released
    graphs.release_graphs()
    assert lock.released

    s, m, c = load_scene(17, SIZE, SIZE, table_res=16, device="cpu")
    cfg = tint.RenderConfig(width=SIZE, height=SIZE, spp=2)
    kept = tint._wavefront_graph(s, m, c, cfg, SIZE * SIZE)
    assert torch.equal(kept.table, tint._spectral_table(s))
    brighter = dataclasses.replace(s, spectra=s.spectra * 2.0)
    brighter = tpar.merge_params(brighter, {
        "base_coeff": s.materials.base_coeff + 1.0})
    assert tint._wavefront_graph(brighter, m, c, cfg, SIZE * SIZE) is kept
    assert torch.equal(kept.scene.materials.base_coeff,
                       brighter.materials.base_coeff)
    assert torch.equal(kept.table, tint._spectral_table(brighter))
    other = tint._wavefront_graph(s, m, c, dataclasses.replace(cfg, spp=4),
                                  SIZE * SIZE)
    assert other is not kept and kept.scene is None and kept.table is None
    assert graphs.kept("wavefront") is other
    graphs.release_graphs()
    assert graphs.kept("wavefront") is None and other.scene is None


class _FakeCUDAGraph:
    """A CUDA graph on the CPU: the fake capture hands it the step it
    captures, and a replay runs that step."""

    def __init__(self):
        self.step = None

    def replay(self):
        self.step()

    def reset(self):
        self.step = None


class _FakeCapture:
    """``torch.cuda.graph`` on the CPU, entered by ``_StepGraph.__init__``:
    takes its ``step`` for the graph, and restores the state buffers on
    exit (a capture records the step, it does not run it)."""

    def __init__(self, graph, **_):
        self.graph = graph

    def __enter__(self):
        owner = sys._getframe(1).f_locals
        self.graph.step, self.obj = owner["step"], owner["self"]
        self.saved = [t.clone() for t in self.obj.leaves]

    def __exit__(self, *exc):
        for t, v in zip(self.obj.leaves, self.saved):
            t.copy_(v)


class _FakeStream:
    def wait_stream(self, other):
        pass


@pytest.fixture
def fake_cuda_graphs(monkeypatch):
    """CUDA graphs and streams faked on the CPU; yields the list of the
    ``_StepGraph``s built (one per capture)."""
    built = []
    real_init = tint._StepGraph.__init__

    def counted_init(self, *a, **k):
        built.append(self)
        real_init(self, *a, **k)
    monkeypatch.setattr(tint._StepGraph, "__init__", counted_init)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeCUDAGraph)
    monkeypatch.setattr(torch.cuda, "graph", _FakeCapture)
    monkeypatch.setattr(torch.cuda, "Stream", lambda **_: _FakeStream())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *_: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda *_: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda *_: contextlib.nullcontext())
    graphs.release_graphs()
    yield built
    graphs.release_graphs()


def test_kept_step_graph_equals_eager_loop(fake_cuda_graphs):
    """The kept path with faked graphs, scene 17 in two tiles (the last
    padded): the first call captures once, a second call and a
    progressive chunk (samples [2, 4) from the first chunk's film)
    capture nothing; every film and ``RenderStats`` equal the eager
    loop's bit for bit; a call with one material value changed, the scene
    passed as a new object, gives the eager film of the changed scene
    (the graph reads the call's values, not the first call's); another
    configuration captures anew, as does a block of pixels of another
    size; the ray count replays the render's graph."""
    built = fake_cuda_graphs
    w, h = 10, 10
    s, m, c = load_scene(17, w, h, table_res=16, device="cpu")
    cfg = tint.RenderConfig(width=w, height=h, spp=4, max_depth=3,
                            tile_rays=64)

    def film(scene, graphed, start=0, end=None, accum=None):
        return tint._wavefront_film(scene, m, c, cfg, start, end, accum,
                                    graphed=graphed)

    eager, eager_stats = film(s, False)
    first, first_stats = film(s, True)
    assert len(built) == 1
    assert torch.equal(first, eager) and first_stats == eager_stats
    assert eager_stats.n_steps >= 2 * tint.SYNC_EVERY
    again, again_stats = film(s, True)
    assert len(built) == 1
    assert torch.equal(again, eager) and again_stats == eager_stats

    half, _ = film(s, False, 0, 2)
    chunk_e, chunk_e_stats = film(s, False, 2, 4, half)
    chunk, chunk_stats = film(s, True, 2, 4, half)
    assert len(built) == 1
    assert torch.equal(chunk, chunk_e) and chunk_stats == chunk_e_stats

    coat = s.materials.coat_tint_coeff.clone()
    coat[-1] = coat[-1] + 0.5
    changed = tpar.merge_params(s.map(torch.clone),
                                {"coat_tint_coeff": coat})
    moved, _ = film(changed, True)
    assert len(built) == 1
    assert torch.equal(moved, film(changed, False)[0])
    assert not torch.equal(moved, first)

    # the ray count replays the render's graph (its padded rows run
    # eagerly); a block of pixels of another size captures its own
    assert tint._count_rays(s, m, c, cfg, graphed=True) == \
        tint._count_rays(s, m, c, cfg, graphed=False)
    assert len(built) == 1
    block = tint._pixel_grid(w, h, "cpu")[30:80]
    part, part_stats = tint._wavefront_film(s, m, c, cfg, 0, None, None,
                                            graphed=True, pixels=block)
    assert len(built) == 2 and built[1].px.shape[0] == 50
    # on the CPU a tensor's length moves the last bit of a few of its ops
    torch.testing.assert_close(part, eager[30:80], rtol=2e-5, atol=2e-6)
    part_e, part_e_stats = tint._wavefront_film(
        s, m, c, cfg, 0, None, None, graphed=False, pixels=block)
    assert torch.equal(part, part_e) and part_stats == part_e_stats

    tint._wavefront_film(s, m, c, dataclasses.replace(cfg, spp=2), 0, None,
                         None, graphed=True)
    assert len(built) == 3 and built[1].graph.step is None
