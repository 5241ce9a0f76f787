"""Carry a scene built by the JAX package over to the port, as plain data.

``scene_from_numpy(arrays, meta, camera)`` takes the JAX package's
``SceneData`` / ``SceneMeta`` / ``Camera`` as numpy arrays and dicts with
the same field names (``tpu_pathtracer/scene/types.py``,
``tpu_pathtracer/render/camera.py``), so that both packages render the
identical scene.  It imports nothing of the JAX package: the caller does
the conversion (e.g. ``{k: np.asarray(v) for k, v in scene._asdict()}``,
nested for ``bvh``, ``materials`` and ``lights``).
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .ops.trace import BVHArrays
from .render.camera import Camera
from .scene.types import (LightTable, MaterialTable, SceneData, SceneMeta,
                          check_ported)


def as_numpy_tree(obj):
    """NamedTuples / dataclasses of array-likes -> nested dicts of numpy
    arrays (tuples stay tuples, None stays None), the form
    ``scene_from_numpy`` takes.  Needs no import of the producing library:
    each leaf goes through ``np.asarray``."""
    import dataclasses
    if hasattr(obj, "_asdict"):
        return {k: as_numpy_tree(v) for k, v in obj._asdict().items()}
    if dataclasses.is_dataclass(obj):
        return {f.name: as_numpy_tree(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, tuple):
        return tuple(as_numpy_tree(v) for v in obj)
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    return np.asarray(obj)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _fields(cls, table) -> dict:
    import dataclasses
    return {f.name: _t(table[f.name]) for f in dataclasses.fields(cls)}


def scene_from_numpy(arrays: dict, meta: dict, camera: dict, device=None):
    """-> (SceneData, SceneMeta, Camera) of the port on ``device``.

    arrays: SceneData fields; ``bvh``, ``materials`` and ``lights`` are
    dicts of their own fields.  The BVH's traversal stack depth is the
    length of ``bvh["stack_hint"]`` (the JAX package carries it in that
    array's shape).  meta / camera: the SceneMeta / Camera fields."""
    dev = resolve_device(device)
    m = SceneMeta(**{k: (tuple(tuple(s) for s in v)
                         if k == "texture_shapes" else
                         tuple(v) if isinstance(v, (list, tuple)) else v)
                     for k, v in meta.items()})
    check_ported(m)
    if len(arrays.get("textures", ())) or arrays.get("env") is not None \
            or len(arrays.get("instanced", ())):
        raise NotImplementedError(
            "textures, environment maps and instanced groups are not "
            "ported yet")
    b = arrays["bvh"]
    bvh = BVHArrays.from_binary(
        np.array(b["nodes_f"], np.float32), np.array(b["nodes_i"], np.int32),
        np.array(b["tri9"], np.float32),
        np.array(np.asarray(b["tri_m12"], np.float32)[:len(b["tri9"])]),
        stack_depth=int(np.asarray(b["stack_hint"]).shape[0]))
    data = SceneData(
        bvh=bvh,
        tri_attr=_t(arrays["tri_attr"]),
        tri_mat=_t(arrays["tri_mat"]),
        tri_light=_t(arrays["tri_light"]),
        materials=MaterialTable(**_fields(MaterialTable, arrays["materials"])),
        lights=LightTable(**_fields(LightTable, arrays["lights"])),
        spectra=_t(arrays["spectra"]),
        area_tri=_t(arrays["area_tri"]),
        area_tri_area=_t(arrays["area_tri_area"]),
        area_tri_cdf=_t(arrays["area_tri_cdf"]),
        world_radius=_t(arrays["world_radius"]),
        rs_zn=_t(arrays["rs_zn"]),
        rs_coeffs=_t(arrays["rs_coeffs"]),
    )
    cam = Camera(position=tuple(float(x) for x in camera["position"]),
                 direction=tuple(float(x) for x in camera["direction"]),
                 up=tuple(float(x) for x in camera["up"]),
                 fov=float(camera["fov"]), width=int(camera["width"]),
                 height=int(camera["height"]))
    return data.to(dev), m, cam
