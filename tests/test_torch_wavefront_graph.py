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
"""
import dataclasses
import os
import traceback

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from tpu_pathtracer.render import film as jfilm
from tpu_pathtracer.render import integrator as jint
from tpu_pathtracer.scenes import load_scene as jload
from tpu_pathtracer_torch.bridge import as_numpy_tree, scene_from_numpy
from tpu_pathtracer_torch.ops import cuda_trace
from tpu_pathtracer_torch.render import film as tfilm
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
    state = tint._wavefront_init(tile, 0, torch.zeros((tile, 3)))
    # the warm-up step builds the per-device constant tables
    state = tint._wavefront_step(s, m, c, cfg, smp, px, cfg.spp, state,
                                 table)
    with guard:
        out = tint._wavefront_step(s, m, c, cfg, smp, px, cfg.spp, state,
                                   table)
    assert not guard.found, guard.found
    # the guard changed nothing: the step is a pure function of its state
    again = tint._wavefront_step(s, m, c, cfg, smp, px, cfg.spp, state,
                                 table)
    assert int(out["n_rays"]) == int(again["n_rays"]) > 0
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
