"""Environment map loading.

Counterpart of ``tpu_pathtracer/scene/image_io.py``'s ``load_env``, cut to
the one format the benchmark writes: a float32 EXR, decoded with the
frozen copy's own codec (``utils/exr.py``) into a numpy float array once,
at scene-build time.
"""
from __future__ import annotations

import numpy as np

__all__ = ["load_env"]


def load_env(path: str) -> np.ndarray:
    """Equirect environment map (EXR) -> (H, W, 3) f32 linear radiance,
    ready for ``SceneBuilder.add_env_light``."""
    if not path.lower().endswith(".exr"):
        raise ValueError(f"{path}: the benchmark's reference reads EXR only")
    from ..utils.exr import read_exr

    img = np.asarray(read_exr(path), np.float32)
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, -1)
    return np.ascontiguousarray(img[..., :3])
