"""The spectral data the ported path needs: the CIE 1931 CMFs, the D65
illuminant and the measured complex IOR of the metal presets.

Counterpart of the matching parts of ``tpu_pathtracer/spectrum/cie.py``;
every function returns a dense (470,) float64 numpy array.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

from . import measured_data as _md
from .cie_cmf_data import CIE_X_1NM, CIE_Y_1NM, CIE_Z_1NM
from .grid import DENSE_LAMBDA, bake_piecewise, inner_product

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


def _normalize_illum(dense: np.ndarray) -> np.ndarray:
    """Divide by <illum, ybar>."""
    y_self = inner_product(dense, cie_y())
    if y_self == 0.0:
        return np.zeros_like(dense)
    return dense / y_self


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


# metal presets -> (eta, k) table names in measured_data
_METAL_TABLES = {
    "au": ("AU_ETA", "AU_K"),
    "ag": ("AG_ETA", "AG_K"),
    "cu": ("CU_ETA", "CU_K"),
    "al": ("AL_ETA", "AL_K"),
    "cuzn": ("CU_ZN_ETA", "CU_ZN_K"),
}

METALS = tuple(_METAL_TABLES)


def _bake_interleaved(flat) -> np.ndarray:
    """Bake an interleaved (lam0, v0, lam1, v1, ...) table onto the dense
    grid."""
    arr = np.asarray(flat, dtype=np.float64)
    return bake_piecewise(arr[0::2], arr[1::2])


@lru_cache(maxsize=None)
def metal_eta_k(name: str):
    """(eta_dense, k_dense) of a metal preset from the measured tables."""
    eta_name, k_name = _METAL_TABLES[name]
    return (_readonly(_bake_interleaved(getattr(_md, eta_name))),
            _readonly(_bake_interleaved(getattr(_md, k_name))))
