"""Color subsystem: gamuts, transfer functions, tone maps, XYZ conversions."""
from __future__ import annotations

import torch

from . import eotf, tone_map
from .gamut import GAMUTS, SRGB, Gamut, by_name

__all__ = ["Gamut", "SRGB", "GAMUTS", "by_name", "eotf", "tone_map",
           "xyz_to_rgb", "rgb_to_xyz", "convert_gamut"]


def _apply(m, v):
    v = torch.as_tensor(v)
    return v @ torch.as_tensor(m, dtype=v.dtype, device=v.device).T


def xyz_to_rgb(xyz, gamut: Gamut):
    """XYZ -> linear RGB in ``gamut``; (..., 3) tensors."""
    return _apply(gamut.xyz_to_rgb, xyz)


def rgb_to_xyz(rgb, gamut: Gamut):
    """Linear RGB in ``gamut`` -> XYZ."""
    return _apply(gamut.rgb_to_xyz, rgb)


def convert_gamut(rgb, src: Gamut, dst: Gamut):
    """Linear RGB from one gamut to another, through XYZ (one 3x3 matrix)."""
    if src is dst:
        return torch.as_tensor(rgb)
    return _apply(dst.xyz_to_rgb @ src.rgb_to_xyz, rgb)
