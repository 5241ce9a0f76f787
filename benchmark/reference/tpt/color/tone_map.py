"""Tone mapping operators (counterpart of ``tpu_pathtracer/color/tone_map.py``)."""
from __future__ import annotations

import torch

__all__ = ["apply", "invert", "TONE_MAP_NAMES"]

TONE_MAP_NAMES = ("none", "reinhard")


def apply(rgb, tone_map: str):
    """Apply a named tone map to linear RGB."""
    if tone_map == "none":
        return rgb
    if tone_map == "reinhard":
        return rgb / (1.0 + rgb)
    raise ValueError(f"unknown tone map {tone_map!r}")


def invert(rgb, tone_map: str):
    """Inverse tone map."""
    if tone_map == "none":
        return rgb
    if tone_map == "reinhard":
        return rgb / torch.clamp(1.0 - rgb, min=1e-7)
    raise ValueError(f"unknown tone map {tone_map!r}")
