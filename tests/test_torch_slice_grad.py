"""The differentiable pass on the slice's scene: scene 17 (Cornell box
with an area light and a rough clearcoat dragon) at 16x12, 1 spp, depth 2,
MIS + Z-Sobol, the port's ``loss_and_grads`` with ``precise=True`` against
the JAX package's (mesh of 1) on the scene the JAX package built, carried
over with the bridge.

Gates: loss within 1e-5 relative; each gradient column within 1e-3 of its
largest magnitude (the 12,300-triangle walk of the JAX package rounds hits
in their last bits apart from its op-by-op arithmetic, which the port
follows; measured about 1e-4).  The JAX gradient is NaN for the Lambert
and emitter rows, which run the clearcoat's code on their lanes at
roughness 0 and discard it (ROADMAP Queue 3); the port's is finite there,
exactly 0 for the roughness columns those kinds do not read, and its
albedo gradient of a wall matches finite differences.

With every trainable column moved to 0.9 x itself + 0.05 (the values
chip_smoke.py uses to check that the grad graph bakes no parameter in)
the JAX gradient is NaN in ``roughness`` and ``coat_roughness`` too; the
port's is finite there (before the repair of ``microfacet.lambda_`` it was
NaN: a grazing direction's infinite tan^2 times alpha^2 gave 0 x inf in
the backward) and equal to JAX's wherever JAX's is finite.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_grad import (_jax_loss_and_grads, _port, _port_loss, _tcfg,
                             assert_matches_jax)
from test_torch_slice_scene0 import two_torch_threads  # noqa: F401
from tpu_pathtracer import parallel as jpar
from tpu_pathtracer.render.integrator import RenderConfig as JConfig
from tpu_pathtracer.scenes import load_scene as jload
from tpu_pathtracer_torch import parallel as tpar
from tpu_pathtracer_torch.render import integrator as tint
from tpu_pathtracer_torch.scene.types import MAT_CLEARCOAT
from tpu_pathtracer_torch.scenes import load_scene

W, H = 16, 12


def _other(params):
    """Other values of every trainable column (chip_smoke.py's)."""
    return {k: v * 0.9 + 0.05 for k, v in params.items()}


@pytest.fixture(scope="module")
def jax17():
    return jload(17, W, H, table_res=16), JConfig(
        width=W, height=H, spp=1, max_depth=2, strategy="mis",
        sampler="sobol")


@pytest.fixture(scope="module")
def scene17(jax17):
    j, jcfg = jax17
    t, cfg = _port(j), _tcfg(jcfg)
    port = _port_loss(t, cfg, tpar.extract_params(t[0]))
    return t, cfg, port, _jax_loss_and_grads(j, jcfg)


def test_slice_scene17_grads_match_jax(scene17):
    (ts, _, _), _, port, ref = scene17
    jax_nan = assert_matches_jax(port, ref, grad_rtol=1e-3)
    kinds = ts.materials.mat_type.numpy()
    coat_rows = np.nonzero(kinds == MAT_CLEARCOAT)[0].tolist()
    # JAX's NaN entries are rows of other kinds, or spread from them
    assert jax_nan and set(jax_nan) <= {"base_coeff", "roughness",
                                        "coat_roughness"}, jax_nan
    grads = port[1]
    for col in ("roughness", "coat_roughness"):
        others = [r for r in range(len(kinds)) if r not in coat_rows]
        assert (grads[col][others] == 0.0).all(), col
        assert (grads[col][coat_rows] != 0.0).all(), col
    assert (np.abs(grads["coat_tint_coeff"][coat_rows]) > 0).all()


def test_slice_scene17_wall_albedo_grad_matches_fd(scene17):
    """A gradient the JAX package leaves NaN, held against central
    differences of the port's loss (tests/test_grad.py's rule, 0.05)."""
    t, cfg, (_, grads), _ = scene17
    params = tpar.extract_params(t[0])
    for idx in ((0, 0), (1, 1)):
        eps = 2e-3 * max(1.0, abs(float(params["base_coeff"][idx])))
        sides = []
        for sign in (1.0, -1.0):
            p = dict(params)
            p["base_coeff"] = params["base_coeff"].clone()
            p["base_coeff"][idx] += sign * eps
            sides.append(_port_loss(t, cfg, p)[0])
        g_fd = (sides[0] - sides[1]) / (2 * eps)
        g_ad = float(grads["base_coeff"][idx])
        assert g_ad != 0.0
        assert abs(g_ad - g_fd) <= 0.05 * max(abs(g_fd), abs(g_ad)) + 1e-6, \
            (idx, g_ad, g_fd)


def test_slice_scene17_fast_close_to_precise(scene17):
    """The fast hit test (K1/K2's arithmetic) on the same inputs: loss
    within 1e-3 relative, gradients within 1e-2 of each column's largest
    magnitude (a few lanes may take another path)."""
    (ts, tm, tc), cfg, (pl, pg), _ = scene17
    fl, fg = _port_loss((ts, tm, tc), dataclasses.replace(cfg, precise=False),
                        tpar.extract_params(ts))
    assert fl == pytest.approx(pl, rel=1e-3)
    for k in pg:
        assert np.isfinite(fg[k]).all()
        np.testing.assert_allclose(fg[k], pg[k], rtol=0,
                                   atol=1e-2 * float(np.abs(pg[k]).max()),
                                   err_msg=k)


def test_slice_scene17_other_values_grads_finite_and_match_jax(jax17,
                                                               scene17):
    """At the other values every one of the 50 gradient values is finite,
    and each column equals JAX's (the same jitted program, other
    arguments) within 1e-3 of its largest magnitude wherever JAX's is
    finite; JAX's own roughness columns hold NaN there."""
    (js, jm, jc), jcfg = jax17
    (ts, tm, tc), cfg, _, _ = scene17
    loss, grads = jpar.loss_and_grads(
        _other(jpar.extract_params(js)), js, jm, jc, jcfg,
        jnp.zeros((W * H, 3)), mesh=jpar.make_mesh(1))
    ref = float(loss), {k: np.asarray(v) for k, v in grads.items()}
    port = _port_loss((ts, tm, tc), cfg, _other(tpar.extract_params(ts)))
    assert sum(v.size for v in port[1].values()) == 50
    jax_nan = assert_matches_jax(port, ref, grad_rtol=1e-3)
    assert {"roughness", "coat_roughness"} <= set(jax_nan), jax_nan


@pytest.mark.parametrize("precise", [False, True], ids=["fast", "precise"])
def test_scene17_grads_finite_at_both_parameter_sets(precise):
    """Scene 17 at 12^2, 2 spp, depth 3 (where chip_smoke.py's other
    values first gave NaN roughness gradients on the card and here): all
    50 gradient values finite at the scene's values and at the other
    values, and the two losses differ."""
    s, m, c = load_scene(17, 12, 12, table_res=16, device="cpu")
    cfg = tint.RenderConfig(width=12, height=12, spp=2, max_depth=3,
                            precise=precise)
    params = tpar.extract_params(s)
    losses = []
    for p in (params, _other(params)):
        loss, grads = tpar.loss_and_grads(p, s, m, c, cfg,
                                          torch.zeros(144, 3), device="cpu")
        assert sum(g.numel() for g in grads.values()) == 50
        bad = {k: int((~torch.isfinite(g)).sum()) for k, g in grads.items()
               if not torch.isfinite(g).all()}
        assert not bad, bad
        losses.append(float(loss))
    assert losses[0] != losses[1] and min(losses) > 0
