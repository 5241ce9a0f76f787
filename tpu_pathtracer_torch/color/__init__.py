"""Color subsystem: gamuts, transfer functions, tone maps."""
from . import eotf, tone_map
from .gamut import GAMUTS, SRGB, Gamut, by_name

__all__ = ["Gamut", "SRGB", "GAMUTS", "by_name", "eotf", "tone_map"]
