"""Closest-hit (K1) and any-hit (K2) traversal: CUDA kernels and their
plain PyTorch versions.

The kernels (``csrc/trace_kernels.cu``, see its header for the design)
replace ``_kernel_closest_fast`` and ``_kernel_anyhit`` of
``tpu_pathtracer/ops/pallas_trace.py``.  They are compiled with ``nvcc``
for ``sm_90a`` on first use, into ``build/tpu_pathtracer_torch/`` under a
name keyed on a hash of the source and flags, and bound with ``ctypes``.

Each wrapper takes the rays as one (7, R) float32 tensor
[ox oy oz dx dy dz t_max] (``ops.trace.pack_rays``).  For a CPU tensor it
runs the plain version; for a CUDA tensor it launches the kernel or
raises.  ``LAUNCHES`` counts kernel launches per kernel name.

The plain versions are brute force: every ray against every triangle
(chunked over rays), with the same hit-test arithmetic as the kernels.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

BIG_T = 3.0e38
MAX_STACK = 64          # must match MAX_STACK in csrc/trace_kernels.cu

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL_SOURCE = os.path.join(_PKG_DIR, "csrc", "trace_kernels.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "tpu_pathtracer_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# kernel launches per kernel name; chip_smoke.py resets and reads these
LAUNCHES = collections.Counter()

_LIB = None


def reset_launch_counts() -> None:
    LAUNCHES.clear()


# ---------------------------------------------------------------------------
# Build and bind
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit")


def library_path() -> str:
    with open(KERNEL_SOURCE, "rb") as f:
        src = f.read()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libtrace_kernels_{key}.so")


def build() -> tuple[str, str]:
    """Compile the kernels if the library for this source is missing.

    Returns (library path, compiler output; empty when already built)."""
    path = library_path()
    if os.path.exists(path):
        return path, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, KERNEL_SOURCE],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, path)   # atomic: a reader never sees a partial file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path, proc.stdout + proc.stderr


def _library():
    global _LIB
    if _LIB is None:
        path, _ = build()
        lib = ctypes.CDLL(path)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.launch_closest_hit.argtypes = [i, p, p, p, p, i, p, p, p, p, p, p, p]
        lib.launch_closest_hit.restype = i
        lib.launch_any_hit.argtypes = [i, p, p, p, p, i, p, p, p]
        lib.launch_any_hit.restype = i
        lib.trace_kernels_max_stack.argtypes = []
        lib.trace_kernels_max_stack.restype = i
        if lib.trace_kernels_max_stack() != MAX_STACK:
            raise RuntimeError("MAX_STACK differs between Python and CUDA")
        _LIB = lib
    return _LIB


def _check_inputs(nodes_f, nodes_i, tri_m12, stack_depth, rays, counters):
    dev = rays.device

    def need(t, name, dtype, ncols):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, rays on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.dim() != 2 or t.shape[1] != ncols:
            raise ValueError(f"{name} must be (N, {ncols}), got {tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")

    need(nodes_f, "nodes_f", torch.float32, 12)
    need(nodes_i, "nodes_i", torch.int32, 2)
    need(tri_m12, "tri_m12", torch.float32, 12)
    if nodes_f.shape[0] != nodes_i.shape[0]:
        raise ValueError("nodes_f and nodes_i row counts differ")
    if rays.dtype != torch.float32 or rays.dim() != 2 or rays.shape[0] != 7:
        raise ValueError(f"rays must be float32 (7, R), got {rays.dtype} "
                         f"{tuple(rays.shape)}")
    if not rays.is_contiguous():
        raise ValueError("rays must be contiguous")
    if rays.shape[1] >= 2 ** 31 or tri_m12.shape[0] >= 2 ** 31:
        raise ValueError("ray or triangle count exceeds int32")
    if stack_depth > MAX_STACK:
        raise ValueError(f"BVH needs {stack_depth} stack slots, the kernels "
                         f"have {MAX_STACK}")
    if counters is not None and (counters.device != dev
                                 or counters.dtype != torch.int64
                                 or counters.numel() != 2
                                 or not counters.is_contiguous()):
        raise ValueError("counters must be a contiguous (2,) int64 tensor "
                         "on the rays' device")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _plain_or_kernel(rays):
    if rays.device.type == "cpu":
        return True
    if rays.device.type != "cuda":
        raise ValueError(f"unsupported device {rays.device}")
    return False


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def closest_hit(nodes_f, nodes_i, tri_m12, stack_depth, rays, counters=None):
    """K1: closest hit per ray -> (t, tri i32, b1, b2, hit bool), each (R,).

    Misses give t = BIG_T, tri = -1, b1 = b2 = 0; rays with t_max <= 0 are
    dead.  ``counters``: optional (2,) int64 CUDA tensor that the kernel
    adds its node visits and triangle tests to."""
    if _plain_or_kernel(rays):
        return closest_hit_plain(tri_m12, rays)
    _check_inputs(nodes_f, nodes_i, tri_m12, stack_depth, rays, counters)
    n = rays.shape[1]
    dev = rays.device
    t = torch.empty(n, dtype=torch.float32, device=dev)
    tri = torch.empty(n, dtype=torch.int32, device=dev)
    b1 = torch.empty(n, dtype=torch.float32, device=dev)
    b2 = torch.empty(n, dtype=torch.float32, device=dev)
    hit = torch.empty(n, dtype=torch.bool, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.launch_closest_hit(
            n, rays.data_ptr(), nodes_f.data_ptr(), nodes_i.data_ptr(),
            tri_m12.data_ptr(), tri_m12.shape[0], t.data_ptr(),
            tri.data_ptr(), b1.data_ptr(), b2.data_ptr(), hit.data_ptr(),
            _ptr(counters), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"closest_hit launch failed: cudaError {rc}")
    LAUNCHES["closest_hit"] += 1
    return t, tri, b1, b2, hit


def any_hit(nodes_f, nodes_i, tri_m12, stack_depth, rays, counters=None):
    """K2: occlusion per ray -> (R,) bool: any hit in (1e-6, t_max); rays
    with t_max < 0 are inactive and report False."""
    if _plain_or_kernel(rays):
        return any_hit_plain(tri_m12, rays)
    _check_inputs(nodes_f, nodes_i, tri_m12, stack_depth, rays, counters)
    n = rays.shape[1]
    dev = rays.device
    occ = torch.empty(n, dtype=torch.bool, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.launch_any_hit(
            n, rays.data_ptr(), nodes_f.data_ptr(), nodes_i.data_ptr(),
            tri_m12.data_ptr(), tri_m12.shape[0], occ.data_ptr(),
            _ptr(counters), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"any_hit launch failed: cudaError {rc}")
    LAUNCHES["any_hit"] += 1
    return occ


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _chunk_rows(n_tri: int, device) -> int:
    budget = (1 << 24) if device.type == "cuda" else (1 << 21)
    return max(1, budget // max(n_tri, 1))


def _pair_test(tri_m12, rays_chunk):
    """(C, T) t, u, v, hit for C rays against all T triangles."""
    m = [tri_m12[:, k] for k in range(12)]
    ox, oy, oz, dx, dy, dz, tmax = (rays_chunk[k][:, None] for k in range(7))
    ou = ox * m[0] + oy * m[1] + oz * m[2] + m[3]
    ov = ox * m[4] + oy * m[5] + oz * m[6] + m[7]
    ow = ox * m[8] + oy * m[9] + oz * m[10] + m[11]
    du = dx * m[0] + dy * m[1] + dz * m[2]
    dv = dx * m[4] + dy * m[5] + dz * m[6]
    dw = dx * m[8] + dy * m[9] + dz * m[10]
    t = -ow / dw
    u = ou + t * du
    v = ov + t * dv
    hit = ((u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 1e-6)
           & (t < tmax))
    return t, u, v, hit


def closest_hit_plain(tri_m12, rays):
    """Plain version of K1: brute force with a first-index argmin, so an
    exact tie in t keeps the lower triangle id."""
    n = rays.shape[1]
    step = _chunk_rows(tri_m12.shape[0], rays.device)
    outs = []
    for s in range(0, n, step):
        t, u, v, hit = _pair_test(tri_m12, rays[:, s:s + step])
        tm = torch.where(hit, t, float("inf"))
        j = torch.argmin(tm, dim=1, keepdim=True)
        tj = tm.gather(1, j)[:, 0]
        found = tj < float("inf")
        outs.append((torch.where(found, tj, BIG_T),
                     torch.where(found, j[:, 0], -1).to(torch.int32),
                     torch.where(found, u.gather(1, j)[:, 0], 0.0),
                     torch.where(found, v.gather(1, j)[:, 0], 0.0),
                     found))
    if not outs:
        e = rays.new_empty(0)
        return e, e.to(torch.int32), e, e, e.to(torch.bool)
    return tuple(torch.cat(parts) for parts in zip(*outs))


def any_hit_plain(tri_m12, rays):
    """Plain version of K2: brute force, any hit in (1e-6, t_max)."""
    n = rays.shape[1]
    step = _chunk_rows(tri_m12.shape[0], rays.device)
    outs = [_pair_test(tri_m12, rays[:, s:s + step])[3].any(dim=1)
            for s in range(0, n, step)]
    if not outs:
        return rays.new_empty(0, dtype=torch.bool)
    return torch.cat(outs)
