"""EOTF / inverse-EOTF transfer functions on tensors.

Counterpart of ``tpu_pathtracer/color/eotf.py``: ``encode`` maps linear ->
display encoded, ``decode`` the reverse.
"""
from __future__ import annotations

import torch

__all__ = ["encode", "decode", "EOTF_NAMES"]

EOTF_NAMES = (
    "linear", "gamma2_2", "gamma2_4", "gamma2_6", "srgb", "adobe_rgb", "rec709",
)


def _safe_pow(x, p):
    return torch.pow(torch.clamp(x, min=0.0), p)


def encode(x, eotf: str):
    """linear -> encoded."""
    if eotf == "linear":
        return x
    if eotf == "gamma2_2":
        return _safe_pow(x, 1.0 / 2.2)
    if eotf == "gamma2_4":
        return _safe_pow(x, 1.0 / 2.4)
    if eotf == "gamma2_6":
        return _safe_pow(x, 1.0 / 2.6)
    if eotf == "srgb":
        return torch.where(x <= 0.0031308, 12.92 * x,
                           1.055 * _safe_pow(x, 1.0 / 2.4) - 0.055)
    if eotf == "adobe_rgb":
        return _safe_pow(x, 256.0 / 563.0)
    if eotf == "rec709":
        return torch.where(x < 0.018, 4.5 * x, 1.099 * _safe_pow(x, 0.45) - 0.099)
    raise ValueError(f"unknown eotf {eotf!r}")


def decode(x, eotf: str):
    """encoded -> linear."""
    if eotf == "linear":
        return x
    if eotf == "gamma2_2":
        return _safe_pow(x, 2.2)
    if eotf == "gamma2_4":
        return _safe_pow(x, 2.4)
    if eotf == "gamma2_6":
        return _safe_pow(x, 2.6)
    if eotf == "srgb":
        return torch.where(x <= 0.04045, x / 12.92,
                           _safe_pow((x + 0.055) / 1.055, 2.4))
    if eotf == "adobe_rgb":
        return _safe_pow(x, 563.0 / 256.0)
    if eotf == "rec709":
        return torch.where(x < 0.081, x / 4.5,
                           _safe_pow((x + 0.099) / 1.099, 1.0 / 0.45))
    raise ValueError(f"unknown eotf {eotf!r}")
