"""CIE colorimetric data and physical spectra presets.

Counterpart of ``tpu_pathtracer/spectrum/cie.py``: the CIE 1931 CMFs (the
standard 1nm tables, with the Wyman-Sloan-Shirley analytic fit as a
cross-check), Planck's black body, illuminant A, the CIE daylight model
(``cie_d``, D50, D65), ACES D60, the measured F1-F12 fluorescents, the
measured complex IOR of the metal presets and the Sellmeier dispersion of
the glass presets.  Every function returns a dense (470,) float64 numpy
array on the grid of ``spectrum.grid`` unless noted (read-only where
cached).  Illuminants marked normalized are divided by their inner product
with ybar.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

from . import measured_data as _md
from .cie_cmf_data import CIE_X_1NM, CIE_Y_1NM, CIE_Z_1NM
from .grid import DENSE_LAMBDA, bake_piecewise, inner_product

__all__ = [
    "cie_x", "cie_y", "cie_z", "cie_y_integral", "blackbody",
    "illum_a", "illum_d5000", "illum_d60", "illum_d6500", "cie_d",
]

_CMF_LAMBDA = 360.0 + np.arange(471.0)


def _readonly(a: np.ndarray) -> np.ndarray:
    a.setflags(write=False)
    return a


@lru_cache(maxsize=None)
def cie_x() -> np.ndarray:
    return _readonly(np.interp(DENSE_LAMBDA, _CMF_LAMBDA, CIE_X_1NM))


@lru_cache(maxsize=None)
def cie_y() -> np.ndarray:
    return _readonly(np.interp(DENSE_LAMBDA, _CMF_LAMBDA, CIE_Y_1NM))


@lru_cache(maxsize=None)
def cie_z() -> np.ndarray:
    return _readonly(np.interp(DENSE_LAMBDA, _CMF_LAMBDA, CIE_Z_1NM))


def _pw_gauss(lam, alpha, mu, s1, s2):
    """Piecewise Gaussian with split std-dev (Wyman et al. eq. 2)."""
    t = (lam - mu) * np.where(lam < mu, s1, s2)
    return alpha * np.exp(-0.5 * t * t)


def cie_x_analytic() -> np.ndarray:
    """Wyman-Sloan-Shirley multi-Gaussian xbar fit (<1% error), an
    independent cross-check of the standard table."""
    lam = DENSE_LAMBDA
    return (_pw_gauss(lam, 0.362, 442.0, 0.0624, 0.0374)
            + _pw_gauss(lam, 1.056, 599.8, 0.0264, 0.0323)
            + _pw_gauss(lam, -0.065, 501.1, 0.0490, 0.0382))


def cie_y_analytic() -> np.ndarray:
    lam = DENSE_LAMBDA
    return (_pw_gauss(lam, 0.821, 568.8, 0.0213, 0.0247)
            + _pw_gauss(lam, 0.286, 530.9, 0.0613, 0.0322))


def cie_z_analytic() -> np.ndarray:
    lam = DENSE_LAMBDA
    return (_pw_gauss(lam, 1.217, 437.0, 0.0845, 0.0278)
            + _pw_gauss(lam, 0.681, 459.0, 0.0385, 0.0725))


@lru_cache(maxsize=None)
def cie_y_integral() -> float:
    """1nm Riemann sum of ybar over the grid (~106.9 for the true CMF)."""
    return float(np.sum(cie_y()))


_H = 6.62607015e-34
_C = 2.99792458e8
_KB = 1.380649e-23


def blackbody(temperature_k: float, normalize: bool = True) -> np.ndarray:
    """Planck spectral radiance on the dense grid; when ``normalize`` the
    curve is scaled so that its peak (Wien) value is 1."""
    lam_m = DENSE_LAMBDA * 1e-9
    le = (2.0 * _H * _C * _C) / (lam_m ** 5 * (np.exp(_H * _C / (lam_m * _KB * temperature_k)) - 1.0))
    if normalize:
        lam_max = 2.8977721e-3 / temperature_k
        peak = (2.0 * _H * _C * _C) / (lam_max ** 5 * (np.exp(_H * _C / (lam_max * _KB * temperature_k)) - 1.0))
        le = le / peak
    return le


def _normalize_illum(dense: np.ndarray) -> np.ndarray:
    """Divide by <illum, ybar>."""
    y_self = inner_product(dense, cie_y())
    if y_self == 0.0:
        return np.zeros_like(dense)
    return dense / y_self


@lru_cache(maxsize=None)
def illum_a() -> np.ndarray:
    """CIE standard illuminant A: Planck at 2856 K (normalized)."""
    return _readonly(_normalize_illum(blackbody(2856.0, normalize=False)))


# Standard CIE daylight components at 10nm from 300 to 830 nm.
_S_LAMBDA = np.arange(300.0, 840.0, 10.0)
_S0 = np.array([
    0.04, 6.0, 29.6, 55.3, 57.3, 61.8, 61.5, 68.8, 63.4, 65.8,
    94.8, 104.8, 105.9, 96.8, 113.9, 125.6, 125.5, 121.3, 121.3, 113.5,
    113.1, 110.8, 106.5, 108.8, 105.3, 104.4, 100.0, 96.0, 95.1, 89.1,
    90.5, 90.3, 88.4, 84.0, 85.1, 81.9, 82.6, 84.9, 81.3, 71.9,
    74.3, 76.4, 63.3, 71.7, 77.0, 65.2, 47.7, 68.6, 65.0, 66.0,
    61.0, 53.3, 58.9, 61.9])
_S1 = np.array([
    0.02, 4.5, 22.4, 42.0, 40.6, 41.6, 38.0, 42.4, 38.5, 35.0,
    43.4, 46.3, 43.9, 37.1, 36.7, 35.9, 32.6, 27.9, 24.3, 20.1,
    16.2, 13.2, 8.6, 6.1, 4.2, 1.9, 0.0, -1.6, -3.5, -3.5,
    -5.8, -7.2, -8.6, -9.5, -10.9, -10.7, -12.0, -14.0, -13.6, -12.0,
    -13.3, -12.9, -10.6, -11.6, -12.2, -10.2, -7.8, -11.2, -10.4, -10.6,
    -9.7, -8.3, -9.3, -9.8])
_S2 = np.array([
    0.0, 2.0, 4.0, 8.5, 7.8, 6.7, 5.3, 6.1, 3.0, 1.2,
    -1.1, -0.5, -0.7, -1.2, -2.6, -2.9, -2.8, -2.6, -2.6, -1.8,
    -1.5, -1.3, -1.2, -1.0, -0.5, -0.3, 0.0, 0.2, 0.5, 2.1,
    3.2, 4.1, 4.7, 5.1, 6.7, 7.3, 8.6, 9.8, 10.2, 8.3,
    9.6, 8.5, 7.0, 7.6, 8.0, 6.7, 5.2, 7.4, 6.8, 7.0,
    6.4, 5.5, 6.1, 6.5])


def cie_d(temperature: float, normalized: bool = True) -> np.ndarray:
    """CIE D-series daylight at the given nominal temperature, with the
    reference's 1.4388/1.4380 CCT rescale and its black-body fallback
    below 4000 K."""
    cct = temperature / 1.4388 * 1.4380
    if cct < 4000.0:
        dense = blackbody(cct)
        return _normalize_illum(dense) if normalized else dense
    if cct < 7000.0:
        x = -4.607e9 / cct**3 + 2.9678e6 / cct**2 + 0.09911e3 / cct + 0.244063
    else:
        x = -2.0064e9 / cct**3 + 1.9018e6 / cct**2 + 0.24748e3 / cct + 0.23704
    y = -3.0 * x * x + 2.870 * x - 0.275
    m = 0.0241 + 0.2562 * x - 0.7341 * y
    m1 = (-1.3515 - 1.7703 * x + 5.9114 * y) / m
    m2 = (0.0300 - 31.4424 * x + 30.0717 * y) / m
    spd = (_S0 + m1 * _S1 + m2 * _S2) * 0.01
    dense = bake_piecewise(_S_LAMBDA, spd)
    return _normalize_illum(dense) if normalized else dense


# CIE D65 standard relative SPD, 5nm anchors 300-830 nm (standard table).
_D65_LAMBDA = np.arange(300.0, 835.0, 5.0)
_D65 = np.array([
    0.0341, 1.6643, 3.2945, 11.7652, 20.2360, 28.6447, 37.0535, 38.5011,
    39.9488, 42.4302, 44.9117, 45.7750, 46.6383, 49.3637, 52.0891, 51.0323,
    49.9755, 52.3118, 54.6482, 68.7015, 82.7549, 87.1204, 91.4860, 92.4589,
    93.4318, 90.0570, 86.6823, 95.7736, 104.8650, 110.9360, 117.0080, 117.4100,
    117.8120, 116.3360, 114.8610, 115.3920, 115.9230, 112.3670, 108.8110,
    109.0820, 109.3540, 108.5780, 107.8020, 106.2960, 104.7900, 106.2390,
    107.6890, 106.0470, 104.4050, 104.2250, 104.0460, 102.0230, 100.0000,
    98.1671, 96.3342, 96.0611, 95.7880, 92.2368, 88.6856, 89.3459, 90.0062,
    89.8026, 89.5991, 88.6489, 87.6987, 85.4936, 83.2886, 83.4939, 83.6992,
    81.8630, 80.0268, 80.1207, 80.2146, 81.2462, 82.2778, 80.2810, 78.2842,
    74.0027, 69.7213, 70.6652, 71.6091, 72.9790, 74.3490, 67.9765, 61.6040,
    65.7448, 69.8856, 72.4863, 75.0870, 69.3398, 63.5927, 55.0054, 46.4182,
    56.6118, 66.8054, 65.0941, 63.3828, 63.8434, 64.3040, 61.8779, 59.4519,
    55.7054, 51.9590, 54.6998, 57.4406, 58.8765, 60.3125])


@lru_cache(maxsize=None)
def illum_d6500() -> np.ndarray:
    """CIE D65 from the standard anchor table (normalized)."""
    return _readonly(_normalize_illum(bake_piecewise(_D65_LAMBDA, _D65)))


@lru_cache(maxsize=None)
def illum_d5000() -> np.ndarray:
    """CIE D50 (``cie_d(5000)``, normalized)."""
    return _readonly(cie_d(5000.0))


def _bake_interleaved(flat) -> np.ndarray:
    """Bake an interleaved (lam0, v0, lam1, v1, ...) table onto the dense
    grid."""
    arr = np.asarray(flat, dtype=np.float64)
    return bake_piecewise(arr[0::2], arr[1::2])


@lru_cache(maxsize=None)
def illum_d60() -> np.ndarray:
    """ACES nominal white: the measured ACES_ILLUM_D60 table
    (normalized)."""
    return _readonly(_normalize_illum(_bake_interleaved(_md.ACES_ILLUM_D60)))
