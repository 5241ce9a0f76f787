"""The rest of the spectrum API in the port against the JAX package:
measured data, the CIE functions and illuminants, ``safe_div`` /
``average``, the rgb2spec fitter and the public names.

Tolerances:
  * the measured tables, every dense curve (analytic CMFs, black body,
    illuminants A, D, D50, D60, F1-F12, the metal presets with MgO and
    TiO2), ``z_nodes`` and the public names: equal, bit for bit (the same
    float64 numpy arithmetic);
  * ``safe_div``, ``average``, ``sigmoid_poly_max_value``, ``albedo_eval``:
    1e-6 relative (float32 on both sides; exp and pow may round their last
    bits differently in XLA and PyTorch);
  * the fit: the port's ``fit_table(rec709, 8)`` against the JAX package's,
    the CIELAB difference of the two tables' spectra cell by cell: p99
    <= 1e-3 and max <= 1e-2 (the same Gauss-Newton steps in float32, where
    a last-bit difference of a cube root can flip a cell's accept-or-keep
    decision and send it down another path to about the same optimum;
    measured p99 5.0e-4 and max 2.4e-3 at res 8, 1.0e-4 and 4.4e-4 at res
    16, a delta E of 1 being just noticeable);
  * the port's ``fit_table(srgb, 16)`` against the committed
    ``srgb_16_v2.npz`` (which neither package's CPU fit reproduces
    coefficient for coefficient at res 16): on the 9^3 sweep of the JAX
    package's delta-E tests, p99 delta E between the two tables' spectra
    <= 1.0 (measured 0.50) and the round trip's p99 delta E no more than
    0.1 above the committed table's own (measured 3.09 against 3.27).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_pathtracer
import tpu_pathtracer_torch
from tpu_pathtracer import color as jcolor
from tpu_pathtracer import spectrum as jspectrum
from tpu_pathtracer.color.gamut import by_name as jby
from tpu_pathtracer.spectrum import cie as jcie
from tpu_pathtracer.spectrum import measured_data as jmd
from tpu_pathtracer.spectrum import rgb2spec as jr2s
from tpu_pathtracer.spectrum import sampled as jswl
from tpu_pathtracer.utils.vec import S4 as JS4
from tpu_pathtracer_torch import color as tcolor
from tpu_pathtracer_torch import spectrum as tspectrum
from tpu_pathtracer_torch.color.gamut import by_name as tby
from tpu_pathtracer_torch.spectrum import cie as tcie
from tpu_pathtracer_torch.spectrum import grid as tgrid
from tpu_pathtracer_torch.spectrum import measured_data as tmd
from tpu_pathtracer_torch.spectrum import rgb2spec as tr2s
from tpu_pathtracer_torch.spectrum import sampled as tswl
from tpu_pathtracer_torch.utils.vec import S4 as TS4

from test_torch_slice_scene0 import two_torch_threads  # noqa: F401

RTOL = 1e-6


def test_measured_data_equal():
    names = sorted(k for k in dir(jmd) if k.isupper())
    assert names == sorted(k for k in dir(tmd) if k.isupper())
    assert {"CIE_ILLUM_F1", "CIE_ILLUM_F12", "ACES_ILLUM_D60", "MG_O_ETA",
            "MG_O_K", "TI_O2_ETA", "TI_O2_K"} <= set(names)
    for k in names:
        assert getattr(tmd, k) == getattr(jmd, k), k


@pytest.mark.parametrize("name", ["cie_x_analytic", "cie_y_analytic",
                                  "cie_z_analytic", "illum_a", "illum_d5000",
                                  "illum_d60", "illum_d6500"])
def test_dense_curves_equal(name):
    t, j = getattr(tcie, name)(), getattr(jcie, name)()
    assert t.dtype == j.dtype and np.array_equal(t, j)


def test_cie_y_integral_and_illum_f_equal():
    assert tcie.cie_y_integral() == jcie.cie_y_integral()
    assert abs(tcie.cie_y_integral() - 106.857) < 0.01
    for i in range(1, 13):
        assert np.array_equal(tcie.illum_f(i), jcie.illum_f(i)), i


@pytest.mark.parametrize("temperature", [1500.0, 2856.0, 3900.0, 5000.0,
                                         6504.0, 7500.0, 12000.0])
def test_blackbody_and_cie_d_equal(temperature):
    for normalize in (True, False):
        assert np.array_equal(tcie.blackbody(temperature, normalize),
                              jcie.blackbody(temperature, normalize))
        assert np.array_equal(tcie.cie_d(temperature, normalize),
                              jcie.cie_d(temperature, normalize))


def test_illum_f_chromaticity():
    """Port copy of tests/test_spectrum.py's: F2 (cool white) and F7 (D65
    simulator) land on their published CIE chromaticities."""
    xbar, ybar, zbar = tcie.cie_x(), tcie.cie_y(), tcie.cie_z()

    def xy(spd):
        x = tgrid.inner_product(spd, xbar)
        y = tgrid.inner_product(spd, ybar)
        z = tgrid.inner_product(spd, zbar)
        return x / (x + y + z), y / (x + y + z)

    x2, y2 = xy(tcie.illum_f(2))
    assert abs(x2 - 0.3721) < 0.01 and abs(y2 - 0.3751) < 0.01
    x7, y7 = xy(tcie.illum_f(7))
    assert abs(x7 - 0.3129) < 0.01 and abs(y7 - 0.3292) < 0.01


def test_illuminants_normalized():
    ybar = tcie.cie_y()
    for illum in (tcie.illum_a(), tcie.illum_d5000(), tcie.illum_d60(),
                  tcie.illum_f(2), tcie.illum_f(11)):
        assert abs(tgrid.inner_product(illum, ybar) - 1.0) < 1e-6


def test_metal_presets_equal_with_mgo_and_tio2():
    assert tcie.METALS == jcie.METALS
    assert {"mgo", "tio2"} <= set(tcie.METALS)
    for name in tcie.METALS:
        for t, j in zip(tcie.metal_eta_k(name), jcie.metal_eta_k(name)):
            assert np.array_equal(t, j), name
    # knots of the measured tables (the dense grid is 1nm)
    anchors = {"mgo": (457.829, 1.7512, 0.0), "tio2": (499.919, 3.03, 0.0)}
    for name, (lam, eta_ref, k_ref) in anchors.items():
        eta, k = tcie.metal_eta_k(name)
        i = int(round(lam - 360.0))
        assert abs(eta[i] - eta_ref) < 0.02, (name, eta[i])
        assert abs(k[i] - k_ref) < 0.05, (name, k[i])


def test_safe_div_and_average_match():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(4, 256)).astype(np.float32)
    b = rng.normal(size=(4, 256)).astype(np.float32)
    b[:, ::5] = 0.0
    ta = TS4(*map(torch.from_numpy, a))
    tb = TS4(*map(torch.from_numpy, b))
    ja = JS4(*map(jnp.asarray, a))
    jb = JS4(*map(jnp.asarray, b))
    out = tswl.safe_div(ta, tb)
    for x, y in zip(out.lanes, jswl.safe_div(ja, jb).lanes):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=RTOL)
    assert all(bool((x[::5] == 0).all()) for x in out.lanes)
    np.testing.assert_allclose(tswl.average(ta).numpy(),
                               np.asarray(jswl.average(ja)), rtol=RTOL)


def test_sigmoid_poly_max_value():
    """Port copy of tests/test_spectrum.py's, and the JAX values on random
    coefficients (vertex inside and outside the range)."""
    c = torch.tensor([[0.0, 0.0, 0.3], [-40.0, 40.0, -5.0]])
    mv = tr2s.sigmoid_poly_max_value(c)
    lam = torch.tensor(tgrid.DENSE_LAMBDA, dtype=torch.float32)
    dense = tr2s.sigmoid_poly(c, lam.expand(2, tgrid.N_DENSE))
    assert bool((mv >= dense.amax(-1) - 1e-4).all())
    rc = np.random.default_rng(4).normal(scale=20.0, size=(512, 3)).astype(
        np.float32)
    np.testing.assert_allclose(
        tr2s.sigmoid_poly_max_value(torch.from_numpy(rc)).numpy(),
        np.asarray(jr2s.sigmoid_poly_max_value(jnp.asarray(rc))), rtol=RTOL)


def test_albedo_eval_and_z_nodes_match():
    for res in (8, 16, 64):
        assert np.array_equal(tr2s.z_nodes(res), jr2s.z_nodes(res))
    zn, coeffs = jr2s.get_table("srgb", 16)
    rgb = np.random.default_rng(5).uniform(size=(256, 3)).astype(np.float32)
    lam = np.random.default_rng(6).uniform(360.0, 830.0, (256, 4)).astype(
        np.float32)
    np.testing.assert_allclose(
        tr2s.albedo_eval(torch.from_numpy(rgb), torch.from_numpy(lam), zn,
                         coeffs).numpy(),
        np.asarray(jr2s.albedo_eval(jnp.asarray(rgb), jnp.asarray(lam), zn,
                                    coeffs)), rtol=RTOL, atol=1e-7)


def test_lab_from_xyz_matches():
    g = tby("srgb")
    white = g.rgb_to_xyz @ np.ones(3)
    xyz = np.random.default_rng(7).uniform(0.0, 1.2, (512, 3))
    xyz[:8] *= 1e-4                     # the linear segment below eps
    xyz = xyz.astype(np.float32)
    np.testing.assert_allclose(
        tr2s._lab_from_xyz(torch.from_numpy(xyz),
                           torch.tensor(white, dtype=torch.float32)).numpy(),
        np.asarray(jr2s._lab_from_xyz(jnp.asarray(xyz),
                                      jnp.asarray(white, jnp.float32))),
        rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------------
# The fitter
# ---------------------------------------------------------------------------

def _cmf_d65():
    return np.stack([tcie.cie_x(), tcie.cie_y(), tcie.cie_z()], -1) \
        * tcie.illum_d6500()[:, None]


def _lab(xyz, white):
    r = xyz / white
    eps = (6 / 29) ** 3
    f = np.where(r > eps, np.cbrt(np.maximum(r, 1e-12)),
                 r * (29 / 6) ** 2 / 3 + 4 / 29)
    return np.stack([116 * f[..., 1] - 16, 500 * (f[..., 0] - f[..., 1]),
                     200 * (f[..., 1] - f[..., 2])], -1)


def _cell_lab(coeffs, white):
    """CIELAB of every table cell's spectrum (albedo under D65)."""
    c = torch.tensor(np.asarray(coeffs, np.float32).reshape(-1, 3))
    lam = torch.tensor(tgrid.DENSE_LAMBDA, dtype=torch.float32)
    s = tr2s.sigmoid_poly(c, lam.expand(len(c), -1)).double().numpy()
    return _lab(s @ _cmf_d65(), white)


def _sweep_delta_e(gamut, tables, n):
    """tests/test_spectrum.py's sweep: for each table, delta E of the
    spectrum of each of n^3 rgb values against the target, and between
    the first two tables' spectra."""
    r = np.linspace(0.02, 0.98, n)
    rgb = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
    rgb = rgb.astype(np.float32)
    white = gamut.rgb_to_xyz @ np.ones(3)
    lam = torch.tensor(tgrid.DENSE_LAMBDA, dtype=torch.float32).expand(
        len(rgb), -1)
    labs = [_lab(tr2s.albedo_eval(torch.from_numpy(rgb), lam, zn, co)
                 .double().numpy() @ _cmf_d65(), white) for zn, co in tables]
    target = _lab(rgb @ gamut.rgb_to_xyz.T, white)
    round_trip = [np.linalg.norm(x - target, axis=-1) for x in labs]
    return round_trip, np.linalg.norm(labs[0] - labs[1], axis=-1)


def test_fit_table_matches_jax_fit():
    """The port's fit of rec709 at res 8 (not committed) against the JAX
    package's, on the CPU."""
    zn, co = tr2s.fit_table(tby("rec709"), 8, device="cpu")
    jzn, jco = jr2s.fit_table(jby("rec709"), 8)
    assert zn.dtype == co.dtype == np.float32 and co.shape == (3, 8, 8, 8, 3)
    assert np.array_equal(zn, jzn)
    white = tby("rec709").rgb_to_xyz @ np.ones(3)
    de = np.linalg.norm(_cell_lab(co, white) - _cell_lab(jco, white), axis=-1)
    assert np.percentile(de, 99) <= 1e-3 and de.max() <= 1e-2, de.max()


def test_fit_table_srgb16_against_committed():
    zn, co = tr2s.fit_table(tby("srgb"), 16, device="cpu")
    path = f"{tr2s.TABLE_DIR}/srgb_16_v2.npz"
    with np.load(path) as ref:
        committed = ref["z_nodes"], ref["coeffs"]
    assert np.array_equal(zn, committed[0])
    (rt_port, rt_committed), between = _sweep_delta_e(
        tby("srgb"), [(zn, co), committed], 9)
    assert np.percentile(between, 99) <= 1.0, np.percentile(between, 99)
    assert np.percentile(rt_port, 99) <= np.percentile(rt_committed, 99) \
        + 0.1, (np.percentile(rt_port, 99), np.percentile(rt_committed, 99))


def test_get_table_fits_and_caches(tmp_path, monkeypatch):
    """A table that is not committed is fitted once, written to the port's
    cache and read back from it."""
    monkeypatch.setattr(tr2s, "CACHE_DIR", str(tmp_path))
    tr2s.get_table.cache_clear()
    try:
        zn, co = tr2s.get_table("rec709", 6)
        path = tmp_path / "rec709_6_v2.npz"
        assert path.exists()
        assert not zn.flags.writeable and not co.flags.writeable
        calls = []
        monkeypatch.setattr(tr2s, "fit_table",
                            lambda *a, **k: calls.append(1))
        tr2s.get_table.cache_clear()
        zn2, co2 = tr2s.get_table("rec709", 6)
        assert not calls
        assert np.array_equal(zn2, zn) and np.array_equal(co2, co)
        monkeypatch.undo()
        assert np.array_equal(co, tr2s.fit_table(tby("rec709"), 6,
                                                 device="cpu")[1])
    finally:
        tr2s.get_table.cache_clear()


# ---------------------------------------------------------------------------
# Public names
# ---------------------------------------------------------------------------

def test_public_names_match():
    for k in ("N_SPECTRUM_SAMPLES", "LAMBDA_MIN", "LAMBDA_MAX"):
        assert getattr(tpu_pathtracer_torch, k) == getattr(tpu_pathtracer, k)
    assert sorted(tspectrum.__all__) == sorted(jspectrum.__all__)
    for k in jspectrum.__all__:
        assert hasattr(tspectrum, k), k
    assert tcolor.eotf.EOTF_NAMES == jcolor.eotf.EOTF_NAMES
    assert tcolor.tone_map.TONE_MAP_NAMES == jcolor.tone_map.TONE_MAP_NAMES
    for name in tcolor.eotf.EOTF_NAMES:
        x = torch.linspace(0.0, 1.0, 11)
        assert torch.allclose(tcolor.eotf.decode(tcolor.eotf.encode(x, name),
                                                 name), x, atol=1e-5)
    for name in tcolor.tone_map.TONE_MAP_NAMES:
        tcolor.tone_map.apply(torch.ones(3), name)
