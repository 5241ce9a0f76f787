"""The port's differentiable pass against the JAX package's and against
finite differences: port copies of tests/test_grad.py, each also holding
the port's loss and gradients against ``tpu_pathtracer.parallel.
loss_and_grads`` (mesh of 1) on the same scene, built by the JAX package
and carried over with the bridge; Adam with a bit-exact resume and a
checkpoint that crosses between the packages; the detached traversal.
(The one-bounce microfacet scenes: tests/test_torch_grad_microfacet.py.)

Both packages run the watertight hit test on the CPU (the port with
``precise=True``) and the same draws, so the gates are tight: loss within
1e-5 relative, each gradient column within 1e-4 of its largest magnitude
(the JAX results are taken once per module fixture).  The finite-difference
gate keeps the JAX test's tolerance (0.05).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_grad import H, W, _cfg, _tiny_scene
from test_torch_slice_scene0 import two_torch_threads  # noqa: F401
from tpu_pathtracer import parallel as jpar
from tpu_pathtracer.render.integrator import render_accum as jrender_accum
from tpu_pathtracer_torch import parallel as tpar
from tpu_pathtracer_torch.bridge import (as_numpy_tree, params_from_numpy,
                                         scene_from_numpy)
from tpu_pathtracer_torch.ops import cuda_trace
from tpu_pathtracer_torch.ops import trace as ttrace
from tpu_pathtracer_torch.render import integrator as tint
from tpu_pathtracer_torch.utils.vec import V2, V3

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4     # of the column's largest |gradient|

def _port(jscene):
    js, jm, jc = jscene[:3]
    return scene_from_numpy(as_numpy_tree(js), jm._asdict(),
                            dataclasses.asdict(jc), device="cpu")


def _tcfg(jcfg):
    """The port's RenderConfig of a JAX one, with the watertight test: the
    fields the port has (its differentiable pass always runs every bounce,
    as the JAX package's ``loss_and_grads`` sets its loop to)."""
    ported = {f.name for f in dataclasses.fields(tint.RenderConfig)}
    return tint.RenderConfig(**{f.name: getattr(jcfg, f.name)
                                for f in dataclasses.fields(jcfg)
                                if f.name in ported - {"precise"}},
                             precise=True)


def _jax_loss_and_grads(jscene, jcfg):
    js, jm, jc = jscene[:3]
    loss, grads = jpar.loss_and_grads(jpar.extract_params(js), js, jm, jc,
                                      jcfg, jnp.zeros((W * H, 3)),
                                      mesh=jpar.make_mesh(1))
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}


def _port_loss(tscene, cfg, params):
    ts, tm, tc = tscene
    loss, grads = tpar.loss_and_grads(params, ts, tm, tc, cfg,
                                      torch.zeros(W * H, 3), device="cpu")
    return float(loss), {k: v.numpy() for k, v in grads.items()}


def assert_matches_jax(port, ref, loss_rtol=LOSS_RTOL, grad_rtol=GRAD_RTOL):
    """The port's (loss, grads) against the JAX package's.  Every port
    gradient is finite.  Where a JAX gradient is NaN (the backward of a
    discarded lane's infinite value, ROADMAP Queue 3) the port's finite
    value is not compared; returns {column: rows of those entries}."""
    (tl, tg), (jl, jg) = port, ref
    assert tl == pytest.approx(jl, rel=loss_rtol)
    assert set(tg) == set(tpar.TRAINABLE_COLUMNS) == set(jg)
    jax_nan = {}
    for k in tg:
        assert np.isfinite(tg[k]).all(), k
        fin = np.isfinite(jg[k])
        scale = float(np.abs(jg[k][fin]).max(initial=0.0))
        np.testing.assert_allclose(tg[k][fin], jg[k][fin], rtol=0,
                                   atol=grad_rtol * scale + 1e-12,
                                   err_msg=k)
        if not fin.all():
            rows = ~fin if fin.ndim == 1 else ~fin.all(axis=1)
            jax_nan[k] = sorted(np.nonzero(rows)[0].tolist())
    return jax_nan


def _fd_gate(tscene, cfg, grads, probes, tol):
    """Central differences of the port's loss at the probes against its
    autodiff gradient (test_grad.py's rule)."""
    params = tpar.extract_params(tscene[0])
    checked = {}
    for name, idx in probes:
        g_ad = float(grads[name][idx])
        eps = 2e-3 * max(1.0, abs(float(params[name][idx])))
        sides = []
        for sign in (1.0, -1.0):
            p = dict(params)
            p[name] = params[name].clone()
            p[name][idx] += sign * eps
            sides.append(_port_loss(tscene, cfg, p)[0])
        g_fd = (sides[0] - sides[1]) / (2 * eps)
        assert np.isfinite(g_ad), f"{name}{idx} non-finite AD grad"
        assert abs(g_ad - g_fd) <= tol * max(abs(g_fd), abs(g_ad)) + 1e-6, \
            f"{name}{idx}: ad={g_ad:.6g} fd={g_fd:.6g}"
        checked[(name, idx)] = (g_ad, g_fd)
    return checked


# ---------------------------------------------------------------------------
# Fixtures: each scene through both packages once
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    """test_grad.py's tiny scene at its default config (MIS + Sobol, 4 spp,
    depth 3): (port scene, port cfg, port result, JAX result)."""
    j = _tiny_scene()
    jcfg = _cfg()
    t, cfg = _port(j), _tcfg(jcfg)
    port = _port_loss(t, cfg, tpar.extract_params(t[0]))
    return t, cfg, port, _jax_loss_and_grads(j, jcfg)


# ---------------------------------------------------------------------------
# Port copies of tests/test_grad.py
# ---------------------------------------------------------------------------

def test_grads_match_finite_differences(tiny):
    t, cfg, port, ref = tiny
    assert assert_matches_jax(port, ref) == {}
    _fd_gate(t, cfg, port[1], [("base_coeff", (0, 0)),
                               ("base_coeff", (0, 2)),
                               ("emission_scale", (1,))], tol=0.05)


def test_emission_grad_sign_and_descent(tiny):
    """Darker target => emission gradient positive; an SGD step reduces
    the loss."""
    (ts, tm, tc), cfg, (loss0, grads), _ = tiny
    assert grads["emission_scale"][1] > 0.0
    params = tpar.extract_params(ts)
    new_params, loss = tpar.train_step(params, ts, tm, tc, cfg,
                                       torch.zeros(W * H, 3), lr=0.5,
                                       device="cpu")
    assert float(loss) == loss0
    assert _port_loss((ts, tm, tc), cfg, new_params)[0] < loss0


def test_grad_nonzero_through_nee_and_bsdf(tiny):
    _, _, (_, grads), (_, jgrads) = tiny
    assert np.abs(grads["base_coeff"][0]).max() > 0.0
    assert np.abs(jgrads["base_coeff"][0]).max() > 0.0


@pytest.fixture(scope="module")
def fit():
    """test_grad.py's Adam fit: the tiny scene's true linear render as the
    target (pt, 2 spp, depth 2), a darker floor to start from."""
    j_true = _tiny_scene(albedo=(0.85, 0.6, 0.4))
    jcfg = _cfg(strategy="pt", spp=2, max_depth=2)
    target = np.asarray(jrender_accum(*j_true, jcfg)) / jcfg.spp
    j0 = _tiny_scene(albedo=(0.3, 0.25, 0.2))
    return j0, _port(j0), jcfg, _tcfg(jcfg), target


def test_adam_fit_recovers_albedo_and_resumes_bitexact(fit, tmp_path):
    _, (ts, tm, tc), _, cfg, target = fit
    target_t = torch.from_numpy(target)
    n_steps = 20
    state = tpar.make_train_state(ts, lr=0.08, device="cpu")
    losses = []
    ckpt = str(tmp_path / "train.npz")
    for k in range(n_steps):
        state, loss = tpar.train_step_adam(state, ts, tm, tc, cfg, target_t,
                                           device="cpu")
        losses.append(float(loss))
        if k == 9:
            state.save(ckpt)
    assert np.isfinite(losses).all()
    assert losses[-1] < 0.4 * losses[0], losses
    drops = sum(b <= a for a, b in zip(losses, losses[1:]))
    assert drops >= int(0.7 * (n_steps - 1)), losses

    resumed = tpar.TrainState.load(ckpt, ts, device="cpu")
    assert resumed.step == 10
    for _ in range(n_steps - 10):
        resumed, _ = tpar.train_step_adam(resumed, ts, tm, tc, cfg, target_t,
                                          device="cpu")
    for k in resumed.params:
        assert torch.equal(resumed.params[k], state.params[k]), k
    assert torch.equal(resumed.count, state.count)


def test_adam_first_step_gradients_match_jax(fit):
    """The fit's first gradient against the JAX package's (a non-zero
    target: both halves of the squared difference count)."""
    j0, (ts, tm, tc), jcfg, cfg, target = fit
    js, jm, jc = j0
    jl, jg = jpar.loss_and_grads(jpar.extract_params(js), js, jm, jc, jcfg,
                                 jnp.asarray(target), mesh=jpar.make_mesh(1))
    tl, tg = tpar.loss_and_grads(tpar.extract_params(ts), ts, tm, tc, cfg,
                                 torch.from_numpy(target), device="cpu")
    assert assert_matches_jax(
        (float(tl), {k: v.numpy() for k, v in tg.items()}),
        (float(jl), {k: np.asarray(v) for k, v in jg.items()})) == {}


def test_checkpoint_crosses_between_packages(fit, tmp_path):
    """JAX runs three Adam steps and saves; the port loads the file and
    runs two more, against JAX's own two more: the same count and moments
    layout, params within 1e-6 + 1e-5 relative (the two packages' float32
    gradients differ in their last bits).  The port's checkpoint of the
    result loads in the JAX package leaf for leaf."""
    j0, (ts, tm, tc), jcfg, cfg, target = fit
    js, jm, jc = j0
    mesh1 = jpar.make_mesh(1)
    jtarget = jnp.asarray(target)
    jstate = jpar.make_train_state(js, lr=0.08)
    for _ in range(3):
        jstate, _ = jpar.train_step_adam(jstate, js, jm, jc, jcfg, jtarget,
                                         mesh=mesh1)
    ckpt = str(tmp_path / "jax.npz")
    jstate.save(ckpt)
    state = tpar.TrainState.load(ckpt, ts, device="cpu")
    assert state.step == 3 and state.lr == pytest.approx(0.08)
    assert state.count.dtype == torch.int32 and int(state.count) == 3
    target_t = torch.from_numpy(target)
    jlosses, tlosses = [], []
    for _ in range(2):
        jstate, jl = jpar.train_step_adam(jstate, js, jm, jc, jcfg, jtarget,
                                          mesh=mesh1)
        state, tl = tpar.train_step_adam(state, ts, tm, tc, cfg, target_t,
                                         device="cpu")
        jlosses.append(float(jl))
        tlosses.append(float(tl))
    np.testing.assert_allclose(tlosses, jlosses, rtol=LOSS_RTOL)
    for k in state.params:
        np.testing.assert_allclose(state.params[k].numpy(),
                                   np.asarray(jstate.params[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)

    back = str(tmp_path / "port.npz")
    state.save(back)
    jback = jpar.TrainState.load(back, js)
    assert jback.step == 5
    import jax
    for a, b in zip(jax.tree.leaves((jback.params, jback.opt_state)),
                    state.leaves()):
        assert np.asarray(a).dtype == b.numpy().dtype
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


# ---------------------------------------------------------------------------
# Detached traversal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precise", [False, True], ids=["fast", "precise"])
def test_no_gradient_through_traversal(tiny, precise):
    """intersect and intersect_p are cut out of autograd, as the JAX
    package's zero-cotangent VJPs: their outputs carry no gradient even
    where the plain versions write attached values in place."""
    (ts, _, tc), *_ = tiny
    px = tint._pixel_grid(W, H, "cpu")
    cam_o, cam_d, _ = tc.generate_rays(px, V2(torch.full((W * H,), 0.5),
                                              torch.full((W * H,), 0.5)))
    o = torch.stack([cam_o.x, cam_o.y, cam_o.z], 1).requires_grad_(True)
    d = torch.stack([cam_d.x, cam_d.y, cam_d.z], 1).requires_grad_(True)
    ro, rd = V3(o[:, 0], o[:, 1], o[:, 2]), V3(d[:, 0], d[:, 1], d[:, 2])
    hit = ttrace.intersect(ts.bvh, ro, rd, precise=precise)
    occ = ttrace.intersect_p(ts.bvh, ro, rd, 10.0, precise=precise)
    assert hit.hit.any() and occ.any() and not occ.all()
    for x in (*hit, occ):
        assert not x.requires_grad
    # the plain version alone would attach t to the rays
    rays = ttrace.pack_rays(ro, rd, ttrace.BIG_T)
    raw = (cuda_trace.closest_hit_precise_plain(ts.bvh.tri9, rays)
           if precise else cuda_trace.closest_hit_plain(ts.bvh.tri_m12, rays))
    assert raw[0].requires_grad
    # a hit position still depends on the direction through o + t d
    pos = ro + rd * hit.t
    g_o, g_d = torch.autograd.grad((pos.x + pos.y + pos.z)[hit.hit].sum(),
                                   (o, d))
    assert torch.equal(g_o[hit.hit], torch.ones_like(g_o[hit.hit]))
    assert torch.equal(g_d[hit.hit][:, 0], hit.t[hit.hit])


def test_backward_launches_no_traversal(tiny, monkeypatch):
    """A loss_and_grads call runs each traversal wrapper exactly as its
    forward does: spp x (1 + depth) closest hits and spp x depth
    occlusion queries (MIS), none in the backward."""
    (ts, tm, tc), cfg, *_ = tiny
    calls = {k: 0 for k in ("closest_hit_precise", "any_hit_precise")}
    for k in calls:
        real = getattr(cuda_trace, k)

        def counted(*a, _real=real, _k=k, **kw):
            calls[_k] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(cuda_trace, k, counted)
    tpar.loss_and_grads(tpar.extract_params(ts), ts, tm, tc, cfg,
                        torch.zeros(W * H, 3), device="cpu")
    assert calls == {"closest_hit_precise": cfg.spp * (1 + cfg.max_depth),
                     "any_hit_precise": cfg.spp * cfg.max_depth}


def test_params_from_numpy_carries_jax_params(tiny):
    (ts, _, _), *_ = tiny
    js, _, _ = _tiny_scene()
    p = params_from_numpy({k: np.asarray(v)
                           for k, v in jpar.extract_params(js).items()},
                          device="cpu")
    assert list(p) == list(tpar.TRAINABLE_COLUMNS)
    for k, v in tpar.extract_params(ts).items():
        assert torch.equal(p[k], v), k
