"""The JAX package's independent checks, on the port (the parts that run on
the CPU; the consistency renders and the PT-mean anchors run on the card:
``chip_smoke.py``'s phase ``consistency`` and the ``cuda`` + ``slow``
matrix of ``tests/test_torch_cuda.py``).

The NumPy oracle's third case, ``test_oracle.py``'s quad area light over
a Lambert floor (NEE, one bounce, 24x18, 256 spp), rendered by the port
and held to the reference's gates: the median relative error per pixel
under 3 % and each channel of the mean within 2 %.  (Its point-light and
constant-environment cases: ``tests/test_torch_lights_env.py``.)  Then the
helpers of ``tpu_pathtracer_torch.consistency``: its median filter
against SciPy's, and its anchors file, a byte-for-byte copy of the JAX
package's.
"""
import math
import os

import numpy as np
import pytest
import torch
from scipy.ndimage import median_filter

from test_oracle import (TABLE_RES, _pixel_rays, _plane_hit,
                         _sigmoid_spectrum, _spectral_to_rgb)
from test_torch_lights_env import _port_floor_builder, _port_render_mean
from tpu_pathtracer_torch import consistency
from tpu_pathtracer_torch.render import camera as tcamera
from tpu_pathtracer_torch.scene import builder as tbuilder
from tpu_pathtracer_torch.scene import mesh as tmesh

from test_oracle import H as OH
from test_oracle import W as OW

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_oracle_area_light_direct_on_port():
    """Quad light above a Lambert floor: the port (NEE, 1 bounce) against
    a NumPy quadrature of the direct-lighting integral per pixel, the
    reference's scene, sampler, spp and gates."""
    le_scale = 6.0
    sb = _port_floor_builder()
    m_e = sb.add_material(tbuilder.Emissive(spectrum=(1.0, 1.0, 1.0),
                                            intensity=le_scale))
    e, ly = 0.8, 3.0
    sb.add_mesh(tmesh.quad([-e, ly, e], [e, ly, e], [e, ly, -e],
                           [-e, ly, -e]), m_e)
    cam = tcamera.default_camera(OW, OH).look_to((0.0, 1.5, 6.0),
                                                 (0.0, -0.25, -1.0))
    scene, meta = sb.build(cam.position)
    assert TABLE_RES == 16
    img = _port_render_mean(scene, meta, cam, "nee", spp=256)

    # the oracle: the spectra from the built scene's data, the integral
    # by quadrature over the light (test_oracle.py's)
    alb_spd = _sigmoid_spectrum(scene.materials.base_coeff.numpy()[0])
    le_row = int(scene.materials.emission_row[1])
    le_spd = scene.spectra.numpy()[le_row] * le_scale
    alb_rgb = _spectral_to_rgb(alb_spd / math.pi * le_spd)
    le_rgb = _spectral_to_rgb(le_spd)

    o, dirs = _pixel_rays((0.0, 1.5, 6.0), (0.0, -0.25, -1.0))
    t, p = _plane_hit(o, dirs, y=0.0)
    floor_hit = (t > 0) & (dirs[..., 1] < 0)
    t_l = (ly - o[1]) / dirs[..., 1]
    sees_light = (t_l > 0) & (np.abs(o[0] + dirs[..., 0] * t_l) <= e) \
        & (np.abs(o[2] + dirs[..., 2] * t_l) <= e)
    nq = 48
    qs = (np.arange(nq) + 0.5) / nq * 2 * e - e
    qx, qz = np.meshgrid(qs, qs)
    d_a = (2.0 * e / nq) ** 2
    expect = np.zeros((OH, OW, 3))
    for j in range(OH):
        for i in range(OW):
            if sees_light[j, i]:
                expect[j, i] = le_rgb
                continue
            if not floor_hit[j, i]:
                continue
            hp = p[j, i]
            dx, dy, dz = qx - hp[0], ly - hp[1], qz - hp[2]
            d2 = dx * dx + dy * dy + dz * dz
            cos_s = cos_l = dy / np.sqrt(d2)
            expect[j, i] = alb_rgb * np.sum(cos_s * cos_l / d2) * d_a

    sel = expect[..., 1] > 1e-4
    rel = np.abs(img[sel] - expect[sel]) / np.maximum(expect[sel], 1e-4)
    assert np.median(rel) < 0.03, np.median(rel)
    assert (np.abs(img[sel].mean(0) - expect[sel].mean(0))
            / expect[sel].mean(0)).max() < 0.02


@pytest.mark.parametrize("shape", [(36, 48, 3), (5, 7, 3), (3, 3, 1)])
def test_median3_equals_scipy(shape):
    """The consistency check's median filter is the reference's
    ``median_filter(img, size=(3, 3, 1))``, borders included."""
    img = np.random.default_rng(0).random(shape).astype(np.float32)
    got = consistency._median3(torch.from_numpy(img)).numpy()
    assert np.array_equal(got, median_filter(img, size=(3, 3, 1)))


def test_anchors_are_a_copy_of_the_reference_data():
    """The port's anchors file is the JAX package's, byte for byte, and
    names every matrix scene."""
    with open(consistency.ANCHORS_PATH, "rb") as f:
        ours = f.read()
    with open(os.path.join(REPO, "tpu_pathtracer", "data",
                           "pt_mean_anchors.json"), "rb") as f:
        assert ours == f.read()
    anchors = consistency.load_anchors()
    assert sorted(map(int, anchors)) == list(consistency.MATRIX_SCENES)
