"""The lockstep sample and the differentiable step can be captured as CUDA
graphs.

On a CUDA device ``render_accum``'s AOVs, ``render_sharded`` and
``count_rays_one_spp`` replay one captured lockstep sample
(``integrator._SampleGraph``), whose sample index is a 0-d tensor and
which runs every ``max_depth`` bounce; ``loss_and_grads`` replays its
forward and backward captured as one graph
(``parallel._LossAndGradsGraph``).  Neither may copy host data to the
device or read a device value back: the forward is guarded by the
wavefront test's ``TorchFunctionMode``, the backward, whose ops autograd
issues below the Python layer, by a ``TorchDispatchMode`` that records
the ATen ops of a read back or a host copy.  The kernels' plain versions
are exempt, as there.

The captured sample runs every bounce where the eager loop stops once
every lane is dead, and must give the early-exit film bit for bit: a
bounce that no lane entered alive adds nothing and keeps the wavelengths.
That is held on tiles of 4 lanes, where the early exit fires, on scenes 8
(dispersive glass, whose ``terminate_secondary`` acts on a lane's last
hit) and 17.  The port's AOV and sharded films are
held to the JAX package's (AOVs within 1e-5, the sharded film's display
RMSE within 0.002, as tests/test_torch_slice_scene0.py gates them).
"""
import dataclasses
import os
import traceback

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tpu_pathtracer import parallel as jpar
from tpu_pathtracer.render import integrator as jint
from tpu_pathtracer.scenes import load_scene as jload
from tpu_pathtracer_torch import parallel as tpar
from tpu_pathtracer_torch.bridge import as_numpy_tree, scene_from_numpy
from tpu_pathtracer_torch.ops import cuda_trace
from tpu_pathtracer_torch.ops import trace as ttrace
from tpu_pathtracer_torch.render import graphs
from tpu_pathtracer_torch.render import integrator as tint
from tpu_pathtracer_torch.render.sampler import make_sampler
from tpu_pathtracer_torch.scene.types import tensors_of
from tpu_pathtracer_torch.scenes import load_scene

from test_torch_slice_scene0 import two_torch_threads  # noqa: F401
from test_torch_wavefront_graph import PLAIN, PORT_DIR, HostTrafficGuard

W, H = 16, 12

_aten = torch.ops.aten
# ATen ops that bring a device value to the host or make a tensor from
# host data
_DISPATCH_READS = {_aten._local_scalar_dense.default, _aten.nonzero.default,
                   _aten.masked_select.default, _aten.lift_fresh.default,
                   _aten.lift_fresh_copy.default}


class DispatchHostGuard(TorchDispatchMode):
    """Records, with the port's line that issued it (or "autograd" for a
    backward op), every ATen op that reads a value back, makes a tensor
    from host data, or copies a tensor across devices."""

    def __init__(self):
        super().__init__()
        self.exempt = 0
        self.found = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not self.exempt:
            bad = func in _DISPATCH_READS
            if func is _aten._to_copy.default and "device" in kwargs:
                src = args[0].device
                bad = kwargs["device"] is not None and \
                    torch.device(kwargs["device"]) != src
            if bad:
                where = [f"{os.path.relpath(f.filename, PORT_DIR)}:{f.lineno}"
                         for f in traceback.extract_stack()
                         if f.filename.startswith(PORT_DIR + os.sep)]
                self.found.append((str(func), where[-1] if where
                                   else "autograd"))
        return func(*args, **kwargs)


@pytest.fixture
def guards(monkeypatch):
    """Both guards, with the kernels' plain versions exempt."""
    gs = (HostTrafficGuard(), DispatchHostGuard())
    for name in PLAIN:
        real = getattr(cuda_trace, name)

        def exempt(*a, _real=real, **kw):
            for g in gs:
                g.exempt += 1
            try:
                return _real(*a, **kw)
            finally:
                for g in gs:
                    g.exempt -= 1
        monkeypatch.setattr(cuda_trace, name, exempt)
    return gs


_SCENES = {}


def _scene(n):
    if n not in _SCENES:
        _SCENES[n] = load_scene(n, W, H, table_res=16, device="cpu")
    return _SCENES[n]


CASES = [
    # scene, strategy, sampler, precise: what the case adds
    (8, "mis", "sobol", False),     # dispersive glass, K1 + K2
    (8, "pt", "random", True),      # no shadow rays, threefry, K3
    (19, "mis", "sobol", True),     # the environment light, K3 + K2p
    (19, "nee", "random", False),   # NEE under the sky
    (12, "mis", "sobol", True),     # an instanced group
    (7, "albedo", "sobol", False),  # the albedo AOV over instances
    (19, "normal", "random", True),  # the normal AOV
]


@pytest.mark.parametrize("scene,strategy,sampler,precise", CASES,
                         ids=[f"s{c[0]}-{c[1]}-{c[2]}"
                              + ("-precise" if c[3] else "") for c in CASES])
def test_lockstep_sample_copies_nothing_from_the_host(guards, scene, strategy,
                                                      sampler, precise):
    """``trace_sample`` as ``_SampleGraph`` captures it: the sample index
    a 0-d tensor, every bounce run (``host_exit=False``).  Its rgb and
    rays equal those of a python index and the early-exit loop."""
    s, m, c = _scene(scene)
    cfg = tint.RenderConfig(width=W, height=H, spp=4, max_depth=4,
                            strategy=strategy, sampler=sampler,
                            precise=precise)
    px = tint._pixel_grid(W, H, "cpu")
    smp = make_sampler(sampler, cfg.seed, cfg.spp, (W, H))
    counted = strategy in tint.PATH_STRATEGIES
    idx = torch.full((), 2, dtype=torch.int64)

    def sample():
        return tint.trace_sample(s, m, c, cfg, smp, px, idx,
                                 with_ray_count=counted, host_exit=False)
    sample()                # the warm-up builds the per-device tables
    with guards[0], guards[1]:
        out = sample()
    assert not guards[0].found, guards[0].found
    assert not guards[1].found, guards[1].found
    ref = tint.trace_sample(s, m, c, cfg, smp, px, 2, with_ray_count=counted)
    if counted:
        assert int(out[1]) == int(ref[1]) > W * H
        out, ref = out[0], ref[0]
    assert torch.equal(out, ref) and float(out.abs().sum()) > 0


@pytest.mark.parametrize("precise", [False, True], ids=["fast", "precise"])
def test_loss_program_reads_nothing_back(guards, precise):
    """The program ``_LossAndGradsGraph`` captures, forward (both guards)
    and backward (``torch.autograd.grad``: the dispatch guard), on scene
    17: no read back, no host copy.  Its loss and gradients equal
    ``loss_and_grads``'s."""
    s, m, c = _scene(17)
    cfg = tint.RenderConfig(width=W, height=H, spp=1, max_depth=2,
                            precise=precise, early_exit=False)
    px = tint._pixel_grid(W, H, "cpu")
    target = torch.full((W * H, 3), 0.25)

    def program():
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in tpar.extract_params(s).items()}
        return tpar._loss_program(params, s, m, c, cfg, px, target, W * H)
    program()
    with guards[0], guards[1]:
        loss, grads = program()
    assert not guards[0].found, guards[0].found
    assert not guards[1].found, guards[1].found
    ref_loss, ref_grads = tpar.loss_and_grads(tpar.extract_params(s), s, m,
                                              c, cfg, target, device="cpu")
    assert torch.equal(loss, ref_loss) and float(loss) > 0
    assert list(grads) == list(tpar.TRAINABLE_COLUMNS)
    for k, g in grads.items():
        assert torch.equal(g, ref_grads[k]), k
        assert torch.isfinite(g).all(), k
    assert float(grads["base_coeff"].abs().max()) > 0


class _ReadsInBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x * 2.0

    @staticmethod
    def backward(ctx, g):
        if bool(g.any()):           # a read back in the backward
            return g * 2.0
        return g


def test_dispatch_guard_sees_the_backward(guards):
    """The dispatch guard is not blind to autograd's backward ops."""
    x = torch.ones(4, requires_grad=True)
    with guards[1]:
        y = _ReadsInBackward.apply(x).sum()
        torch.autograd.grad(y, [x])
        torch.tensor([1.0, 2.0])
    assert [f for f, _ in guards[1].found] == [
        "aten._local_scalar_dense.default", "aten.lift_fresh.default"]


# pixels of a 16x12 film around the glass bunny (scene 8) and the dragon
# (scene 17): 8 tiles of 4 lanes
_CENTRE = [(x, y) for y in range(4, 8) for x in range(6, 14)]


@pytest.mark.parametrize("scene,strategy,sampler", [(8, "mis", "random"),
                                                    (17, "mis", "sobol")])
def test_captured_loop_gives_the_early_exit_film(monkeypatch, scene, strategy,
                                                 sampler):
    """On tiles of 4 lanes, where the early exit fires (fewer closest-hit
    queries), the loop a graph captures (``host_exit=False``: every bounce
    run, no host read) gives the early-exit film and rays bit for bit.
    Running every bounce with nothing kept back (``early_exit=False``, the
    differentiable pass's loop) gives the same rays but not the same film
    on scene 8: a lane that roulette kills on the dispersive glass has its
    wavelengths collapsed by the next bounce, which the early exit does
    not run when no lane is left."""
    s, m, c = _scene(scene)
    cfg = tint.RenderConfig(width=W, height=H, spp=2, max_depth=8,
                            strategy=strategy, sampler=sampler)
    smp = make_sampler(sampler, cfg.seed, cfg.spp, (W, H))
    px = torch.tensor(_CENTRE, dtype=torch.int32)
    calls = []
    real = ttrace.intersect_scene
    monkeypatch.setattr(ttrace, "intersect_scene",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    ways = {"early_exit": (True, True), "captured": (True, False),
            "every_bounce": (False, True)}
    films, rays, queries = {}, {}, {}
    for way, (early, host_exit) in ways.items():
        calls.clear()
        c_w = dataclasses.replace(cfg, early_exit=early)
        out = [tint.trace_sample(s, m, c, c_w, smp, px[k:k + 4], i,
                                 with_ray_count=True, host_exit=host_exit)
               for k in range(0, len(_CENTRE), 4) for i in range(cfg.spp)]
        films[way] = torch.cat([rgb for rgb, _ in out])
        rays[way] = sum(int(n) for _, n in out)
        queries[way] = len(calls)
    n_samples = len(_CENTRE) // 4 * cfg.spp
    assert queries["captured"] == n_samples * (1 + cfg.max_depth)
    assert queries["early_exit"] < queries["captured"]
    assert torch.equal(films["captured"], films["early_exit"])
    assert rays["captured"] == rays["early_exit"] == rays["every_bounce"]
    assert float(films["early_exit"].sum()) > 0
    if scene == 8:
        assert not torch.equal(films["every_bounce"], films["early_exit"])


@pytest.fixture(scope="module")
def scene19_both():
    js, jm, jc = jload(19, W, H, table_res=16)
    t = scene_from_numpy(as_numpy_tree(js), jm._asdict(),
                         dataclasses.asdict(jc), device="cpu")
    return (js, jm, jc), t


@pytest.mark.parametrize("strategy", ["albedo", "normal"])
def test_aov_film_matches_jax(scene19_both, strategy):
    """The AOVs of scene 19 (spheres under a sky) in two padded tiles
    against the JAX package's, within 1e-5."""
    (js, jm, jc), (ts, tm, tc) = scene19_both
    common = dict(width=W, height=H, spp=2, strategy=strategy,
                  sampler="sobol", tile_rays=100)
    jimg = np.asarray(jint.render(js, jm, jc, jint.RenderConfig(**common)))
    timg = tint.render(ts, tm, tc, tint.RenderConfig(**common),
                       device="cpu").numpy()
    np.testing.assert_allclose(timg, jimg, rtol=0, atol=1e-5)
    assert timg.std() > 0.05


def test_sharded_film_matches_jax(scene19_both):
    """``render_sharded`` (no group) of scene 19, pt + random against the
    JAX package's on a mesh of one device: display RMSE <= 0.002."""
    (js, jm, jc), (ts, tm, tc) = scene19_both
    common = dict(width=W, height=H, spp=2, max_depth=3, strategy="pt",
                  sampler="random")
    jimg = np.asarray(jpar.render_sharded(js, jm, jc,
                                          jint.RenderConfig(**common),
                                          mesh=jpar.make_mesh(1)))
    timg = tpar.render_sharded(ts, tm, tc, tint.RenderConfig(**common),
                               device="cpu").numpy()
    assert np.isfinite(timg).all()
    rmse = float(np.sqrt(np.mean((timg - jimg) ** 2)))
    assert rmse <= 0.002, rmse
    assert timg.mean() > 0


class _Graph:
    def __init__(self, name):
        self.name, self.released = name, False

    def release(self):
        self.released = True


def test_kept_graphs_are_keyed_and_released():
    """``graphs.keep``: the same key returns the kept graph without a
    build, another key releases it and keeps the new one, and
    ``release_graphs`` frees every slot (or the named ones)."""
    graphs.release_graphs()
    a = graphs.keep("lockstep", ("k", 1), lambda: _Graph("a"))
    assert graphs.keep("lockstep", ("k", 1), lambda: _Graph("no")) is a
    g = graphs.keep("grad", ("k", 1), lambda: _Graph("g"))
    b = graphs.keep("lockstep", ("k", 2), lambda: _Graph("b"))
    assert a.released and not b.released and not g.released
    assert graphs.kept("lockstep") is b and graphs.kept("grad") is g
    graphs.release_graphs("grad")
    assert g.released and graphs.kept("grad") is None
    assert graphs.kept("lockstep") is b
    tpar.release_graphs()
    assert b.released and graphs.kept("lockstep") is None


def test_scene_tree_map_and_copy_in():
    """``map_tensors`` reaches every tensor of a scene (tables, the BVH,
    the textures and instanced groups) in one order: a clone shares no
    storage and equals the scene, ``to`` keeps every value, and
    ``_sample_graphs`` keeps one copy of the scene per configuration,
    copying each call's values in, and releases it for another key."""
    s, m, c = _scene(12)
    ts = tensors_of(s)
    assert len(ts) > 40 and any(t is s.bvh.nodes_w for t in ts)
    assert any(t is s.instanced[0].fwd for t in ts)
    clone, moved = s.map(torch.clone), s.to("cpu")
    for a, b, d in zip(tensors_of(clone), ts, tensors_of(moved),
                       strict=True):
        assert a.data_ptr() != b.data_ptr()
        # the wide BVH rows pad with NaN
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
        torch.testing.assert_close(d, b, rtol=0, atol=0, equal_nan=True)
    assert graphs.shapes_of(clone) == graphs.shapes_of(s)

    graphs.release_graphs()
    cfg = tint.RenderConfig(width=W, height=H, spp=2, strategy="albedo")
    kept = tint._sample_graphs(s, m, c, cfg)
    brighter = tpar.merge_params(s, {
        "base_coeff": s.materials.base_coeff + 1.0})
    assert tint._sample_graphs(brighter, m, c, cfg) is kept
    assert torch.equal(kept.scene.materials.base_coeff,
                       brighter.materials.base_coeff)
    other = tint._sample_graphs(s, m, c, dataclasses.replace(cfg, spp=4))
    assert other is not kept and kept.scene is None
    assert torch.equal(other.scene.materials.base_coeff,
                       s.materials.base_coeff)
    graphs.release_graphs()
