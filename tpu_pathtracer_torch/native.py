"""The native SAH BVH builder (``csrc/bvh_builder.cpp``), bound with ctypes.

Counterpart of ``tpu_pathtracer/native.py``.  The library is built at first
use with ``g++`` (or ``$CXX``) and the flags of ``native/Makefile``, into
``build/tpu_pathtracer_torch/`` under a name keyed on a hash of the source,
the flags and the compiler's resolved target options (``-march=native``
differs between machines).  Without a C++ compiler ``build_bvh_native``
returns None and the scene builder falls back to the numpy builder
(``scene/bvh.py``), as the JAX package does; a compiler that fails on the
source raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import numpy as np

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_PKG_DIR, "csrc", "bvh_builder.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "tpu_pathtracer_torch")
# native/Makefile's CXXFLAGS and LDFLAGS
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall",
             "-shared")

_lock = threading.Lock()
_lib = None
_tried = False


def compiler():
    """Path of the C++ compiler, or None when there is none."""
    return shutil.which(os.environ.get("CXX", "g++"))


def library_path(cxx: str) -> str:
    """Where the library built by ``cxx`` from this source lives."""
    target = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                            capture_output=True, timeout=60).stdout
    with open(SOURCE, "rb") as f:
        src = f.read()
    key = hashlib.sha256(src + " ".join(CXX_FLAGS).encode() + target)
    return os.path.join(BUILD_DIR, f"libbvh_builder_{key.hexdigest()[:16]}.so")


def build():
    """Compile the builder if its library is missing.  Returns the library
    path, or None when no compiler is found."""
    cxx = compiler()
    if cxx is None:
        return None
    path = library_path(cxx)
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed ({proc.returncode}) on "
                               f"{SOURCE}:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, path)   # atomic: a reader never sees a partial file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def _load():
    global _lib, _tried
    with _lock:
        if not _tried:
            path = build()
            _tried = True
            if path is not None:
                lib = ctypes.CDLL(path)
                f, i = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(
                    ctypes.c_int32)
                lib.tpt_build_bvh.restype = ctypes.c_int
                lib.tpt_build_bvh.argtypes = [f, f, ctypes.c_int, f, f,
                                              i, i, i, i, i, ctypes.c_int]
                _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def build_bvh_native(tri_min: np.ndarray, tri_max: np.ndarray):
    """Native SAH build over the (T, 3) triangle boxes (taken as float32);
    returns a ``scene.bvh.FlatBVH``, or None without a compiler."""
    lib = _load()
    if lib is None:
        return None
    from .scene.bvh import FlatBVH

    n = len(tri_min)
    tri_min = np.ascontiguousarray(tri_min, np.float32)
    tri_max = np.ascontiguousarray(tri_max, np.float32)
    if tri_min.shape != (n, 3) or tri_max.shape != (n, 3):
        raise ValueError(f"triangle boxes must be (T, 3), got "
                         f"{tri_min.shape} and {tri_max.shape}")
    if n >= 2 ** 30:
        raise ValueError(f"{n} triangles exceed the builder's int32 nodes")
    max_nodes = max(2 * n, 1)
    bounds_min = np.empty((max_nodes, 3), np.float32)
    bounds_max = np.empty((max_nodes, 3), np.float32)
    left = np.empty(max_nodes, np.int32)
    right = np.empty(max_nodes, np.int32)
    count = np.empty(max_nodes, np.int32)
    order = np.empty(max(n, 1), np.int32)
    depth = np.zeros(1, np.int32)

    def ptr(a, ty):
        return a.ctypes.data_as(ctypes.POINTER(ty))

    n_nodes = lib.tpt_build_bvh(
        ptr(tri_min, ctypes.c_float), ptr(tri_max, ctypes.c_float), n,
        ptr(bounds_min, ctypes.c_float), ptr(bounds_max, ctypes.c_float),
        ptr(left, ctypes.c_int32), ptr(right, ctypes.c_int32),
        ptr(count, ctypes.c_int32), ptr(order, ctypes.c_int32),
        ptr(depth, ctypes.c_int32), max_nodes)
    if n_nodes < 0:
        raise RuntimeError(f"the native BVH builder needs more than "
                           f"{max_nodes} nodes for {n} triangles")
    return FlatBVH(bounds_min=bounds_min[:n_nodes].copy(),
                   bounds_max=bounds_max[:n_nodes].copy(),
                   left=left[:n_nodes].copy(), right=right[:n_nodes].copy(),
                   count=count[:n_nodes].copy(), order=order,
                   depth=int(depth[0]))
