"""Hero-wavelength sampling on S4 lanes.

Counterpart of ``tpu_pathtracer/spectrum/sampled.py``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..utils.vec import S4, s4_max, s4_mean, smap
from .grid import LAMBDA_MAX, LAMBDA_MIN

N_SPECTRUM_SAMPLES = 4


class Bank(NamedTuple):
    """Every scene spectrum (CIE x/y/z CMFs + the scene's dense bank)
    evaluated once at a path's 4 wavelengths."""
    cmf_x: S4
    cmf_y: S4
    cmf_z: S4
    spectra: Tuple[S4, ...]     # scene spectra bank columns (row 0 = D65)


class SampledWavelengths(NamedTuple):
    """Per-path hero wavelength state."""
    lam: S4
    pdf: S4
    bank: Optional[Bank] = None

    @property
    def secondary_terminated(self):
        p = self.pdf
        return (p.b == 0.0) & (p.c == 0.0) & (p.d == 0.0)


def sample_uniform(u, lambda_min: float = LAMBDA_MIN,
                   lambda_max: float = LAMBDA_MAX) -> SampledWavelengths:
    """Stratified hero wavelengths with wraparound; pdf = 1/range."""
    span = lambda_max - lambda_min
    lam0 = lambda_min + u * span
    step = span / N_SPECTRUM_SAMPLES

    def lane(k):
        lk = lam0 + k * step
        return torch.where(lk >= lambda_max, lk - span, lk)

    lam = S4(lam0, lane(1), lane(2), lane(3))
    p = torch.full_like(lam0, 1.0 / span)
    return SampledWavelengths(lam=lam, pdf=S4(p, p, p, p))


def terminate_secondary(wl: SampledWavelengths,
                        do_terminate) -> SampledWavelengths:
    """Collapse to the hero wavelength where ``do_terminate`` is True."""
    fire = do_terminate & ~wl.secondary_terminated
    p = wl.pdf
    zero = torch.zeros_like(p.a)
    pdf = S4(torch.where(fire, p.a * (1.0 / N_SPECTRUM_SAMPLES), p.a),
             torch.where(fire, zero, p.b),
             torch.where(fire, zero, p.c),
             torch.where(fire, zero, p.d))
    return SampledWavelengths(lam=wl.lam, pdf=pdf, bank=wl.bank)


def safe_div(a: S4, b: S4) -> S4:
    """Elementwise a/b with 0 where b == 0."""
    return smap(lambda x, y: torch.where(
        y == 0.0, 0.0, x / torch.where(y == 0.0, 1.0, y)), a, b)


def average(s: S4):
    """Mean over the 4 lanes."""
    return s4_mean(s)


def max_value(s: S4):
    """Max over the 4 lanes."""
    return s4_max(s)
