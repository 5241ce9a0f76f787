"""The lockstep sample and the differentiable step read nothing back, so
the step can be captured as a CUDA graph.

``loss_and_grads`` replays its forward (the lockstep ``trace_sample``,
every ``max_depth`` bounce) and backward captured as one graph
(``parallel._LossAndGradsGraph``, slot "grad").  Neither may copy host
data to the device or read a device value back: the forward is guarded by
the wavefront test's ``TorchFunctionMode``, the backward, whose ops
autograd issues below the Python layer, by a ``TorchDispatchMode`` that
records the ATen ops of a read back or a host copy.  The kernels' plain
versions are exempt, as there.  ``trace_sample`` is held to that guard on
every strategy, the AOVs included.  The port's AOV and sharded films are
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
    """``trace_sample`` with the sample index a 0-d tensor, every bounce
    run, reads nothing back and copies nothing from the host.  Its rgb
    equals that of a python index."""
    s, m, c = _scene(scene)
    cfg = tint.RenderConfig(width=W, height=H, spp=4, max_depth=4,
                            strategy=strategy, sampler=sampler,
                            precise=precise)
    px = tint._pixel_grid(W, H, "cpu")
    smp = make_sampler(sampler, cfg.seed, cfg.spp, (W, H))
    idx = torch.full((), 2, dtype=torch.int64)

    def sample():
        return tint.trace_sample(s, m, c, cfg, smp, px, idx)
    sample()                # the warm-up builds the per-device tables
    with guards[0], guards[1]:
        out = sample()
    assert not guards[0].found, guards[0].found
    assert not guards[1].found, guards[1].found
    ref = tint.trace_sample(s, m, c, cfg, smp, px, 2)
    assert torch.equal(out, ref) and float(out.abs().sum()) > 0


@pytest.mark.parametrize("precise", [False, True], ids=["fast", "precise"])
def test_loss_program_reads_nothing_back(guards, precise):
    """The program ``_LossAndGradsGraph`` captures, forward (both guards)
    and backward (``torch.autograd.grad``: the dispatch guard), on scene
    17: no read back, no host copy.  Its loss and gradients equal
    ``loss_and_grads``'s."""
    s, m, c = _scene(17)
    cfg = tint.RenderConfig(width=W, height=H, spp=1, max_depth=2,
                            precise=precise)
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
    a = graphs.keep("wavefront", ("k", 1), lambda: _Graph("a"))
    assert graphs.keep("wavefront", ("k", 1), lambda: _Graph("no")) is a
    g = graphs.keep("grad", ("k", 1), lambda: _Graph("g"))
    b = graphs.keep("wavefront", ("k", 2), lambda: _Graph("b"))
    assert a.released and not b.released and not g.released
    assert graphs.kept("wavefront") is b and graphs.kept("grad") is g
    graphs.release_graphs("grad")
    assert g.released and graphs.kept("grad") is None
    assert graphs.kept("wavefront") is b
    tpar.release_graphs()
    assert b.released and graphs.kept("wavefront") is None


def test_scene_tree_map_and_copy_in():
    """``map_tensors`` reaches every tensor of a scene (tables, the BVH,
    the textures and instanced groups) in one order: a clone shares no
    storage and equals the scene, ``to`` keeps every value, and
    ``_wavefront_graph`` keeps one copy of the scene per configuration
    and tile size, copying each call's values in, and releases it for
    another key."""
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
    cfg = tint.RenderConfig(width=W, height=H, spp=2)
    kept = tint._wavefront_graph(s, m, c, cfg, W * H)
    brighter = tpar.merge_params(s, {
        "base_coeff": s.materials.base_coeff + 1.0})
    assert tint._wavefront_graph(brighter, m, c, cfg, W * H) is kept
    assert torch.equal(kept.scene.materials.base_coeff,
                       brighter.materials.base_coeff)
    other = tint._wavefront_graph(s, m, c, cfg, W * H // 2)
    assert other is not kept and kept.scene is None
    assert torch.equal(other.scene.materials.base_coeff,
                       s.materials.base_coeff)
    graphs.release_graphs()
