"""The 1nm dense spectral grid and spectrum evaluation at wavelengths.

Counterpart of ``tpu_pathtracer/spectrum/grid.py``: a dense spectrum is a
``(470,)`` array over [360, 830) nm with floor-index lookup (no
interpolation inside a bin, zero outside the range).
"""
from __future__ import annotations

import numpy as np
import torch

LAMBDA_MIN = 360.0
LAMBDA_MAX = 830.0
N_DENSE = int(LAMBDA_MAX - LAMBDA_MIN)  # 470

DENSE_LAMBDA = np.arange(N_DENSE, dtype=np.float64) + LAMBDA_MIN


def _lam_index(lam):
    idx = torch.floor(lam - LAMBDA_MIN).to(torch.int64)
    in_range = (lam >= LAMBDA_MIN) & (lam <= LAMBDA_MAX)
    return idx.clamp(0, N_DENSE - 1), in_range


def eval_dense(values, lam):
    """A (470,) spectrum at wavelengths ``lam`` (any shape)."""
    idx, in_range = _lam_index(lam)
    return torch.where(in_range, values[idx], 0.0)


def lambda_slice_bank(table, lam):
    """Every column of a stacked (470, 3+K) table at S4 wavelengths.

    Columns 0..2 are the CIE CMFs, the scene spectra follow.  Returns a
    ``sampled.Bank`` whose columns are S4s of (R,) components."""
    from ..utils.vec import S4
    from .sampled import Bank

    k = table.shape[-1]
    per_lane = []
    for lane in lam.lanes:
        idx, in_range = _lam_index(lane)
        per_lane.append(torch.where(in_range[:, None], table[idx], 0.0))

    def col(c):
        return S4(*(rows[:, c] for rows in per_lane))
    return Bank(cmf_x=col(0), cmf_y=col(1), cmf_z=col(2),
                spectra=tuple(col(3 + i) for i in range(k - 3)))


def bank_pick(bank, row):
    """Select one pre-evaluated scene spectrum per ray -> S4.

    bank: ``sampled.Bank``; row: (R,) integer scene-spectra row."""
    from ..utils.vec import S4
    spectra = bank.spectra
    if not spectra:
        z = torch.zeros_like(bank.cmf_x.a)
        return S4(z, z, z, z)
    out = [torch.where(row == 0, s, 0.0) for s in spectra[0].lanes]
    for i in range(1, len(spectra)):
        out = [torch.where(row == i, lane_v, o)
               for lane_v, o in zip(spectra[i].lanes, out)]
    return S4(*out)


def eval_dense_s4(values, lam):
    """``eval_dense`` for a single (470,) spectrum at S4 wavelengths."""
    from ..utils.vec import S4
    return S4(*(eval_dense(values, lane) for lane in lam.lanes))


def bake_piecewise(lambdas, values) -> np.ndarray:
    """Bake a piecewise-linear (lambda, value) spectrum onto the dense grid
    (host-side numpy; clamp-to-end-values outside the knot range)."""
    lambdas = np.asarray(lambdas, dtype=np.float64)
    values = np.asarray(values, dtype=np.float64)
    order = np.argsort(lambdas)
    return np.interp(DENSE_LAMBDA, lambdas[order], values[order])


def inner_product(a: np.ndarray, b: np.ndarray) -> float:
    """1nm Riemann inner product of two dense spectra."""
    return float(np.sum(np.asarray(a, np.float64) * np.asarray(b, np.float64)))
