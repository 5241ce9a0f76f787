"""Film / sensor: spectral sample -> XYZ -> RGB, and the display encode.

Counterpart of ``tpu_pathtracer/render/film.py``: a sample's S4 spectral
contribution becomes XYZ through the CIE CMFs at its wavelengths, each
lane weighted by 1/(pdf * 4); terminated lanes carry pdf = 0 and add
nothing.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import color
from ..color import eotf as eotf_mod
from ..color import tone_map as tm_mod
from ..spectrum import cie
from ..utils.vec import V3, s4_dot, smap


@lru_cache(maxsize=None)
def _cmf_stack() -> np.ndarray:
    a = np.stack([cie.cie_x(), cie.cie_y(), cie.cie_z()], axis=-1).astype(np.float32)
    a.setflags(write=False)
    return a


def cmf_table(device) -> torch.Tensor:
    """(470, 3) CIE x/y/z CMFs as float32 on ``device``: one tensor per
    device, copied there once (every step and sample asks for it, and a
    captured step copies nothing from the host)."""
    return _cmf_on(torch.device(device))


@lru_cache(maxsize=None)
def _cmf_on(device: torch.device) -> torch.Tensor:
    return torch.tensor(_cmf_stack(), device=device)


def spectral_to_rgb(contribution, wl, gamut=color.SRGB, exposure: float = 1.0):
    """One sample's S4 contribution -> linear RGB as a V3 of (R,).

    wl must carry its wavelength bank (the CMFs at its wavelengths)."""
    cx, cy, cz = wl.bank.cmf_x, wl.bank.cmf_y, wl.bank.cmf_z
    inv_pdf = smap(
        lambda p: torch.where(p > 0.0, 1.0 / torch.where(p > 0.0, p, 1.0), 0.0),
        wl.pdf)
    w = contribution * inv_pdf * 0.25
    x = s4_dot(w, cx)
    y = s4_dot(w, cy)
    z = s4_dot(w, cz)
    m = [[float(v) for v in row]
         for row in np.asarray(gamut.xyz_to_rgb, np.float32)]
    e = float(exposure)
    return V3(
        (m[0][0] * x + m[0][1] * y + m[0][2] * z) * e,
        (m[1][0] * x + m[1][1] * y + m[1][2] * z) * e,
        (m[2][0] * x + m[2][1] * y + m[2][2] * z) * e)


def finalize(accum_rgb, spp: int, tone_map: str = "none", eotf: str = "srgb"):
    """Accumulated RGB -> display-encoded image: average, clamp >= 0, tone
    map, EOTF encode."""
    avg = torch.clamp(accum_rgb / float(spp), min=0.0)
    return eotf_mod.encode(tm_mod.apply(avg, tone_map), eotf)
