"""Texture sampling: bilinear, UV-wrapped, batched over rays.

Counterpart of ``tpu_pathtracer/render/texture.py``: fract-wrapped UVs
with v flipped (1 - fract(v)), a flat-row gather of the (H*W, C) view.
Textures have different shapes, so the per-ray texture choice is a Python
loop over the scene's textures with masked merges.
"""
from __future__ import annotations

from functools import lru_cache

import torch

from ..utils.vec import V2


def sample_bilinear(tex, uv: V2):
    """tex: (H, W, C); uv: V2 of (R,) -> (R, C)."""
    h, w = tex.shape[0], tex.shape[1]
    # float and integer % are floor-mods, as in the JAX package
    u = uv.x % 1.0
    v = (1.0 - (uv.y % 1.0)) % 1.0
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    x0i = x0.to(torch.int64) % w
    x1i = (x0i + 1) % w
    y0i = y0.to(torch.int64) % h
    y1i = (y0i + 1) % h
    texf = tex.reshape(h * w, tex.shape[2])
    c00 = texf[y0i * w + x0i]
    c10 = texf[y0i * w + x1i]
    c01 = texf[y1i * w + x0i]
    c11 = texf[y1i * w + x1i]
    top = c00 + (c10 - c00) * fx
    bot = c01 + (c11 - c01) * fx
    return top + (bot - top) * fy


@lru_cache(maxsize=None)
def _default_row(values: tuple, device: torch.device) -> torch.Tensor:
    """A fetch's default values on ``device``, copied there once: a fetch
    copies nothing from the host, so a CUDA graph can capture it."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def sample_indexed(textures, tex_ids, uv: V2, n_channels: int, default):
    """Masked multi-texture fetch -> (R, n_channels).

    textures: tuple of (H, W, C) tensors; tex_ids: (R,) with -1 meaning
    ``default`` (a sequence of n_channels values).  A texture with fewer
    channels is broadcast, one with more is cut to n_channels."""
    r = uv.x.shape[0]
    out = _default_row(tuple(float(d) for d in default),
                       uv.x.device).expand(r, n_channels)
    for tid, tex in enumerate(textures):
        if tex.shape[-1] < n_channels:
            tex = tex.expand(tex.shape[0], tex.shape[1], n_channels)
        vals = sample_bilinear(tex[..., :n_channels], uv)
        out = torch.where((tex_ids == tid)[:, None], vals, out)
    return out
