"""The port's differentiable pass on test_grad.py's one-bounce microfacet
scenes (rough gold, PBR, clearcoat floor under a ceiling emitter; NEE, one
bounce, where the loss is a smooth function of the floor's parameters):
finite differences against autodiff at the JAX test's tolerance (0.06),
and the loss and every gradient against ``tpu_pathtracer.parallel.
loss_and_grads`` (mesh of 1) at tests/test_torch_grad.py's tolerances.

The three scenes carry one four-row material table (metal, PBR,
clearcoat, the emitter), the floor taking one of the first three: the
loss and the floor's derivative chain are those of test_grad.py's scenes,
and the JAX package traces its gradient once for all three instead of
once each.  The rows of the two kinds not on the floor run through those
kinds' code on every lane and are discarded; where such a row holds a zero
roughness (the coat roughness of the metal and PBR rows) the JAX package's
gradient of that entry is NaN, the port's finite (ROADMAP Queue 3), so the
comparison skips JAX's NaN entries and asserts that none lies in a column
the floor's own kind reads.
"""
import pytest

from test_grad import H, W, _cfg
from test_torch_grad import (_fd_gate, _jax_loss_and_grads, _port,
                             _port_loss, _tcfg, assert_matches_jax)
from test_torch_slice_scene0 import two_torch_threads  # noqa: F401
from tpu_pathtracer.render.camera import default_camera
from tpu_pathtracer.scene import mesh
from tpu_pathtracer.scene.builder import (Clearcoat, Emissive, Metal, Pbr,
                                          SceneBuilder)
from tpu_pathtracer.spectrum import illum_d6500
from tpu_pathtracer_torch import parallel as tpar

# the floors of test_grad.py's one-bounce scenes
FLOORS = {
    "metal": Metal(kind="gold", roughness=0.45),
    "pbr": Pbr(base_color=(0.7, 0.4, 0.3), metallic=0.5, roughness=0.5),
    "clearcoat": Clearcoat(base_color=(0.6, 0.5, 0.4), metallic=1.0,
                           roughness=0.3, coat_tint=(0.4, 0.5, 0.9),
                           coat_thickness=0.8, coat_roughness=0.3),
}


def _one_bounce_scene(floor: str, intensity=8.0):
    """test_grad.py's one-bounce scene (floor + ceiling emitter) with the
    floor of kind ``floor``; every scene has the material rows metal, PBR,
    clearcoat, emitter."""
    sb = SceneBuilder(table_res=16)
    rows = {k: sb.add_material(d) for k, d in FLOORS.items()}
    m_light = sb.add_material(Emissive(spectrum=illum_d6500(),
                                       intensity=intensity))
    s = 2.0
    sb.add_mesh(mesh.quad([-s, 0, s], [s, 0, s], [s, 0, -s], [-s, 0, -s]),
                rows[floor])
    e = 1.0
    sb.add_mesh(mesh.quad([-e, 3.98, e], [e, 3.98, e], [e, 3.98, -e],
                          [-e, 3.98, -e]), m_light)
    cam = default_camera(W, H).look_to((0.0, 2.0, 5.0), (0.0, -0.3, -1.0))
    data, meta = sb.build(cam.position)
    return data, meta, cam, rows[floor]


@pytest.fixture(scope="module")
def one_bounce():
    """{floor: (port scene, floor row, port result, JAX result)} at NEE,
    8 spp, depth 1."""
    jcfg = _cfg(strategy="nee", spp=8, max_depth=1)
    out = {}
    for floor in FLOORS:
        j = _one_bounce_scene(floor)
        t = _port(j)
        port = _port_loss(t, _tcfg(jcfg), tpar.extract_params(t[0]))
        out[floor] = t, j[3], port, _jax_loss_and_grads(j, jcfg)
    return _tcfg(jcfg), out


# the columns each floor's derivative chain reads
READS = {"metal": ("roughness",),
         "pbr": ("base_coeff", "roughness", "metallic"),
         "clearcoat": tuple(c for c in tpar.TRAINABLE_COLUMNS
                            if c != "emission_scale")}


def _matches_jax(scenes, floor):
    """The comparison with the JAX package; its NaN entries (if any) lie
    outside the floor's own chain."""
    t, row, port, ref = scenes[floor]
    jax_nan = assert_matches_jax(port, ref)
    assert all(row not in jax_nan.get(c, ()) for c in READS[floor]), jax_nan
    return t, row, port


def test_rough_conductor_roughness_grad_matches_fd(one_bounce):
    cfg, scenes = one_bounce
    t, row, port = _matches_jax(scenes, "metal")
    got = _fd_gate(t, cfg, port[1], [("roughness", (row,))], tol=0.06)
    assert abs(got[("roughness", (row,))][0]) > 1e-6


def test_pbr_metallic_and_roughness_grads_match_fd(one_bounce):
    cfg, scenes = one_bounce
    t, row, port = _matches_jax(scenes, "pbr")
    got = _fd_gate(t, cfg, port[1],
                   [("metallic", (row,)), ("roughness", (row,))], tol=0.06)
    assert abs(got[("metallic", (row,))][0]) > 1e-6
    assert abs(got[("roughness", (row,))][0]) > 1e-6


def test_clearcoat_grads_match_fd(one_bounce):
    cfg, scenes = one_bounce
    t, row, port = _matches_jax(scenes, "clearcoat")
    got = _fd_gate(t, cfg, port[1],
                   [("coat_tint_coeff", (row, 0)),
                    ("coat_tint_coeff", (row, 2)),
                    ("coat_roughness", (row,))], tol=0.06)
    assert abs(got[("coat_tint_coeff", (row, 2))][0]) > 1e-7
    assert abs(got[("coat_roughness", (row,))][0]) > 1e-7
