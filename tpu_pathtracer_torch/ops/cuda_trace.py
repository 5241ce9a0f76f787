"""Closest-hit and any-hit traversal, each with the fast unit-triangle
test (K1, K2) and with the precise watertight test (K3, K2p): CUDA kernels
and their plain PyTorch versions.

The kernels (``csrc/trace_kernels.cu``, see its header for the design)
replace ``_kernel_closest_fast``, ``_kernel_closest`` and both forms of
``_kernel_anyhit`` of ``tpu_pathtracer/ops/pallas_trace.py``.  They are
compiled with ``nvcc`` for ``sm_90a`` on first use, into
``build/tpu_pathtracer_torch/`` under a name keyed on a hash of the source
and flags, and bound with ``ctypes``.

Each wrapper takes the rays as one (7, R) float32 tensor
[ox oy oz dx dy dz t_max] (``ops.trace.pack_rays``).  The closest-hit
wrappers take the ``BVHArrays`` and read its 4-wide rows ``nodes_w`` with
``tri_m12`` (fast) or ``tri9p`` (precise); the any-hit wrappers take the
binary tree's arrays and the triangle table of their test, ``tri_m12`` or
``tri9``.  For a CPU tensor a wrapper runs the plain version; for a CUDA
tensor it launches the kernel or raises.  ``LAUNCHES`` counts kernel
launches per kernel name.  ``closest_hit_v1`` and ``closest_hit_precise_v1``
launch the binary closest-hit walk that the wide kernels replaced: the
yardstick of their times, called by no render path.

The plain versions are brute force: every live ray against every
triangle (chunked over rays), with the same hit-test arithmetic as the
kernels.  ``walk_wide_plain`` is the wide kernels' walk as vectorised
PyTorch, for the tests of the wide layout.
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

from ..utils.math import shear_test

BIG_T = 3.0e38
MAX_STACK = 64          # must match MAX_STACK in csrc/trace_kernels.cu
WIDE_MAX_STACK = 64     # must match WIDE_MAX_STACK there
T_SLACK = 1.001         # the box cull's relative slack, T_SLACK there
FAR_PAD = 1.00000036    # the slab test's padding of the far distance

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
    flags = " ".join(NVCC_FLAGS)
    key = hashlib.sha256(src + flags.encode()).hexdigest()[:16]
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


def _load_library():
    """Build (if missing) and bind the kernels' library."""
    path, _ = build()
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    signatures = {
        "launch_closest_hit": [i, p, p, p, i, p, p, p, p, p, p, p],
        "launch_closest_hit_v1": [i, p, p, p, p, i, p, p, p, p, p, p, p],
        "launch_any_hit": [i, p, p, p, p, i, p, p, p],
        "closest_hit_launch_info": [i, i, ctypes.POINTER(i)],
        "trace_kernels_max_stack": [],
        "trace_kernels_wide_max_stack": [],
    }
    signatures["launch_closest_hit_precise"] = signatures["launch_closest_hit"]
    signatures["launch_closest_hit_precise_v1"] = \
        signatures["launch_closest_hit_v1"]
    signatures["launch_any_hit_precise"] = signatures["launch_any_hit"]
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = i
    if (lib.trace_kernels_max_stack() != MAX_STACK
            or lib.trace_kernels_wide_max_stack() != WIDE_MAX_STACK):
        raise RuntimeError("a stack limit differs between Python and CUDA")
    return lib


def _library():
    global _LIB
    if _LIB is None:
        _LIB = _load_library()
    return _LIB


def _need(t, name, dev, dtype, ncols, align=16):
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, rays on {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != 2 or t.shape[1] != ncols:
        raise ValueError(f"{name} must be (N, {ncols}), got {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % align:
        raise ValueError(f"{name} must be contiguous and {align}-byte aligned")


def _check_rays(rays, n_tri, counters, n_counters):
    if rays.dtype != torch.float32 or rays.dim() != 2 or rays.shape[0] != 7:
        raise ValueError(f"rays must be float32 (7, R), got {rays.dtype} "
                         f"{tuple(rays.shape)}")
    if not rays.is_contiguous():
        raise ValueError("rays must be contiguous")
    if rays.shape[1] >= 2 ** 31 or n_tri >= 2 ** 28:
        raise ValueError("ray count exceeds int32 or triangle count the "
                         "leaf payload")
    if counters is not None and (counters.device != rays.device
                                 or counters.dtype != torch.int64
                                 or counters.numel() != n_counters
                                 or not counters.is_contiguous()):
        raise ValueError(f"counters must be a contiguous ({n_counters},) "
                         "int64 tensor on the rays' device")


def _check_binary(nodes_f, nodes_i, tris, stack_depth, rays, counters,
                  tri_cols, n_counters):
    """tris: the (T, 12) tri_m12 of the fast kernels or, with tri_cols=9,
    the (T, 9) tri9 of the precise ones."""
    dev = rays.device
    _need(nodes_f, "nodes_f", dev, torch.float32, 12)
    _need(nodes_i, "nodes_i", dev, torch.int32, 2)
    _need(tris, "tri_m12" if tri_cols == 12 else "tri9", dev, torch.float32,
          tri_cols)
    if nodes_f.shape[0] != nodes_i.shape[0]:
        raise ValueError("nodes_f and nodes_i row counts differ")
    _check_rays(rays, tris.shape[0], counters, n_counters)
    if stack_depth > MAX_STACK:
        raise ValueError(f"BVH needs {stack_depth} stack slots, the kernels "
                         f"have {MAX_STACK}")


def wide_stack_slots(wide_depth: int) -> int:
    """Stack entries a walk of the wide tree can need: three pushed
    siblings a level (the fourth child is visited from its register)."""
    return 3 * wide_depth + 1


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

def _closest_outputs(rays):
    n, dev = rays.shape[1], rays.device
    return (torch.empty(n, dtype=torch.float32, device=dev),
            torch.empty(n, dtype=torch.int32, device=dev),
            torch.empty(n, dtype=torch.float32, device=dev),
            torch.empty(n, dtype=torch.float32, device=dev),
            torch.empty(n, dtype=torch.bool, device=dev))


def _launch_closest(name, bvh, precise, rays, counters):
    """The wide closest-hit kernels: nodes_w with tri_m12 or tri9p."""
    dev = rays.device
    tris = bvh.tri9p if precise else bvh.tri_m12
    _need(bvh.nodes_w, "nodes_w", dev, torch.float32, 32, align=128)
    _need(tris, "tri9p" if precise else "tri_m12", dev, torch.float32, 12)
    _check_rays(rays, tris.shape[0], counters, 4)
    slots = wide_stack_slots(bvh.wide_depth)
    if slots > WIDE_MAX_STACK:
        raise ValueError(f"the wide BVH needs {slots} stack slots, the "
                         f"kernels have {WIDE_MAX_STACK}")
    out = _closest_outputs(rays)
    launch = getattr(_library(), "launch_" + name)
    with torch.cuda.device(dev):
        rc = launch(
            rays.shape[1], rays.data_ptr(), bvh.nodes_w.data_ptr(),
            tris.data_ptr(), tris.shape[0], *(o.data_ptr() for o in out),
            _ptr(counters),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    LAUNCHES[name] += 1
    return out


def _launch_closest_v1(name, bvh, precise, rays, counters):
    tris = bvh.tri9 if precise else bvh.tri_m12
    _check_binary(bvh.nodes_f, bvh.nodes_i, tris, bvh.stack_depth, rays,
                  counters, 9 if precise else 12, 4)
    out = _closest_outputs(rays)
    launch = getattr(_library(), "launch_" + name)
    with torch.cuda.device(rays.device):
        rc = launch(
            rays.shape[1], rays.data_ptr(), bvh.nodes_f.data_ptr(),
            bvh.nodes_i.data_ptr(), tris.data_ptr(), tris.shape[0],
            *(o.data_ptr() for o in out), _ptr(counters),
            torch.cuda.current_stream(rays.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    LAUNCHES[name] += 1
    return out


def _launch_any(name, nodes_f, nodes_i, tris, tri_cols, stack_depth, rays,
                counters):
    _check_binary(nodes_f, nodes_i, tris, stack_depth, rays, counters,
                  tri_cols, 2)
    n = rays.shape[1]
    dev = rays.device
    occ = torch.empty(n, dtype=torch.bool, device=dev)
    launch = getattr(_library(), "launch_" + name)
    with torch.cuda.device(dev):
        rc = launch(
            n, rays.data_ptr(), nodes_f.data_ptr(), nodes_i.data_ptr(),
            tris.data_ptr(), tris.shape[0], occ.data_ptr(),
            _ptr(counters), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    LAUNCHES[name] += 1
    return occ


def closest_hit(bvh, rays, counters=None):
    """K1: closest hit per ray -> (t, tri i32, b1, b2, hit bool), each (R,).

    ``bvh``: the ``BVHArrays`` (its ``nodes_w`` and ``tri_m12`` are read).
    Misses give t = BIG_T, tri = -1, b1 = b2 = 0; rays with t_max <= 0 are
    dead.  ``counters``: optional (4,) int64 CUDA tensor; the kernel adds
    its node visits and triangle tests to [0] and [1] and raises [2] and
    [3] to the largest visits and tests of any one ray."""
    if _plain_or_kernel(rays):
        return closest_hit_plain(bvh.tri_m12, rays)
    return _launch_closest("closest_hit", bvh, False, rays, counters)


def closest_hit_precise(bvh, rays, counters=None):
    """K3: closest hit with the watertight shear test (``nodes_w`` and
    ``tri9p`` are read); the outputs, the dead-ray rule and ``counters``
    are those of ``closest_hit``."""
    if _plain_or_kernel(rays):
        return closest_hit_precise_plain(bvh.tri9, rays)
    return _launch_closest("closest_hit_precise", bvh, True, rays, counters)


def closest_hit_v1(bvh, rays, counters=None):
    """K1's binary predecessor (``nodes_f``, ``nodes_i``, ``tri_m12``): the
    same function, kept to time ``closest_hit`` against."""
    if _plain_or_kernel(rays):
        return closest_hit_plain(bvh.tri_m12, rays)
    return _launch_closest_v1("closest_hit_v1", bvh, False, rays, counters)


def closest_hit_precise_v1(bvh, rays, counters=None):
    """K3's binary predecessor (``nodes_f``, ``nodes_i``, ``tri9``)."""
    if _plain_or_kernel(rays):
        return closest_hit_precise_plain(bvh.tri9, rays)
    return _launch_closest_v1("closest_hit_precise_v1", bvh, True, rays,
                              counters)


def closest_hit_launch_info(n_rays: int, precise: bool) -> dict:
    """Registers and local bytes a thread, resident blocks an SM and the
    grid of a ``closest_hit`` (or, precise, ``closest_hit_precise``) launch
    of ``n_rays`` rays on the current card; the kernels use no shared
    memory."""
    out = (ctypes.c_int * 4)()
    rc = _library().closest_hit_launch_info(int(precise), n_rays, out)
    if rc != 0:
        raise RuntimeError(f"closest_hit_launch_info: cudaError {rc}")
    return dict(zip(("registers", "local_bytes", "blocks_per_sm", "grid"),
                    out))


def any_hit(nodes_f, nodes_i, tri_m12, stack_depth, rays, counters=None):
    """K2: occlusion per ray -> (R,) bool: any hit in (1e-6, t_max); rays
    with t_max < 0 are inactive and report False.  ``counters``: optional
    (2,) int64 CUDA tensor that the kernel adds its node visits and
    triangle tests to."""
    if _plain_or_kernel(rays):
        return any_hit_plain(tri_m12, rays)
    return _launch_any("any_hit", nodes_f, nodes_i, tri_m12, 12, stack_depth,
                       rays, counters)


def any_hit_precise(nodes_f, nodes_i, tri9, stack_depth, rays, counters=None):
    """K2p: occlusion with the watertight shear test; outputs, the
    inactive-ray rule and ``counters`` are those of ``any_hit``."""
    if _plain_or_kernel(rays):
        return any_hit_precise_plain(tri9, rays)
    return _launch_any("any_hit_precise", nodes_f, nodes_i, tri9, 9,
                       stack_depth, rays, counters)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _chunk_rows(n_tri: int, device) -> int:
    # ray x triangle pairs per chunk; on the CPU a chunk's temporaries
    # should stay in cache
    budget = (1 << 24) if device.type == "cuda" else (1 << 19)
    return max(1, budget // max(n_tri, 1))


def _fast_test(m, ray):
    """The unit-triangle test on broadcastable tensors: m the 12 columns of
    tri_m12 rows, ray the 7 components of rays.  -> t, u, v, hit."""
    ox, oy, oz, dx, dy, dz, tmax = ray
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


def _precise_test(p, ray):
    """The watertight shear test on broadcastable tensors: p the 9 columns
    of tri9 rows, ray the 7 components of rays; the axis choice on ties is
    that of the kernel (x wins over z, y over x and z).
    -> t, b1, b2, hit."""
    ox, oy, oz, dx, dy, dz, tmax = ray
    adx, ady, adz = dx.abs(), dy.abs(), dz.abs()
    kz = torch.where(adx > ady, torch.where(adx >= adz, 0, 2),
                     torch.where(ady >= adz, 1, 2))
    verts = tuple(tuple(p[3 * v + c] for c in range(3)) for v in range(3))
    return shear_test(ox, oy, oz, dx, dy, dz, kz, verts, tmax)


def _pair_test(tri_m12, rays_chunk):
    """(C, T) t, u, v, hit for C rays against all T triangles."""
    return _fast_test([tri_m12[:, k] for k in range(12)],
                      [rays_chunk[k][:, None] for k in range(7)])


def _pair_test_precise(tri9, rays_chunk):
    """(C, T) t, b1, b2, hit of the watertight shear test for C rays
    against all T triangles."""
    return _precise_test([tri9[None, :, k] for k in range(9)],
                         [rays_chunk[k][:, None] for k in range(7)])


def _closest_plain(pair_test, tris, rays):
    n = rays.shape[1]
    dev = rays.device
    t = torch.full((n,), BIG_T, dtype=torch.float32, device=dev)
    tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    b1 = torch.zeros(n, dtype=torch.float32, device=dev)
    b2 = torch.zeros(n, dtype=torch.float32, device=dev)
    live = torch.nonzero(rays[6] > 0.0)[:, 0]       # t_max <= 0: dead ray
    step = _chunk_rows(tris.shape[0], dev)
    for s in range(0, live.shape[0], step):
        rows = live[s:s + step]
        tc, u, v, hit = pair_test(tris, rays[:, rows])
        tm = torch.where(hit, tc, float("inf"))
        j = torch.argmin(tm, dim=1, keepdim=True)
        tj = tm.gather(1, j)[:, 0]
        found = tj < float("inf")
        t[rows] = torch.where(found, tj, BIG_T)
        tri[rows] = torch.where(found, j[:, 0], -1).to(torch.int32)
        b1[rows] = torch.where(found, u.gather(1, j)[:, 0], 0.0)
        b2[rows] = torch.where(found, v.gather(1, j)[:, 0], 0.0)
    return t, tri, b1, b2, tri >= 0


def _any_plain(pair_test, tris, rays):
    occ = torch.zeros(rays.shape[1], dtype=torch.bool, device=rays.device)
    live = torch.nonzero(rays[6] >= 0.0)[:, 0]      # t_max < 0: inactive ray
    step = _chunk_rows(tris.shape[0], rays.device)
    for s in range(0, live.shape[0], step):
        rows = live[s:s + step]
        occ[rows] = pair_test(tris, rays[:, rows])[3].any(dim=1)
    return occ


def closest_hit_plain(tri_m12, rays):
    """Plain version of K1: brute force with a first-index argmin, so an
    exact tie in t keeps the lower triangle id."""
    return _closest_plain(_pair_test, tri_m12, rays)


def any_hit_plain(tri_m12, rays):
    """Plain version of K2: brute force, any hit in (1e-6, t_max)."""
    return _any_plain(_pair_test, tri_m12, rays)


def closest_hit_precise_plain(tri9, rays):
    """Plain version of K3: brute force, the smallest t among the
    watertight hits below the ray's t_max, the lower id on an exact tie."""
    return _closest_plain(_pair_test_precise, tri9, rays)


def any_hit_precise_plain(tri9, rays):
    """Plain version of K2p: brute force, any watertight hit in
    (1e-6, t_max)."""
    return _any_plain(_pair_test_precise, tri9, rays)


# ---------------------------------------------------------------------------
# The wide walk in PyTorch (tests of the wide layout only)
# ---------------------------------------------------------------------------

_DONE = -2 ** 31        # WIDE_DONE of the kernels: no leaf ref


def walk_wide_plain(bvh, rays, precise: bool = False):
    """Closest hit by the wide kernels' walk, all rays in lockstep: per ray
    a stack of refs into ``bvh.nodes_w``; a node visit tests its four
    child boxes with the kernels' slab test (padded far distance, slack on
    the bound), goes on with the nearest hit child and pushes the others
    far-first; a leaf tests its triangles in order with the kernels' rule
    for the better hit.  Reads ``nodes_w`` and ``tri_m12`` or ``tri9``
    (whose floats ``tri9p`` repeats); returns what ``closest_hit`` does."""
    n, dev = rays.shape[1], rays.device
    nodes = bvh.nodes_w
    refs_w = nodes[:, 24:28].contiguous().view(torch.int32).to(torch.int64)
    tris = bvh.tri9 if precise else bvh.tri_m12
    test = _precise_test if precise else _fast_test
    n_tri = tris.shape[0]
    tmax = rays[6]
    best_t = tmax.clone()
    best_tri = torch.full((n,), -1, dtype=torch.int64, device=dev)
    b1 = torch.zeros(n, dtype=torch.float32, device=dev)
    b2 = torch.zeros(n, dtype=torch.float32, device=dev)
    # slot 0 holds the end marker, so that a pop always finds an entry
    stack = torch.full((n, wide_stack_slots(bvh.wide_depth) + 1), _DONE,
                       dtype=torch.int64, device=dev)
    sp = torch.ones(n, dtype=torch.int64, device=dev)
    cur = torch.where(tmax > 0.0, 0, _DONE)          # t_max <= 0: dead ray
    inv = [1.0 / rays[3 + a] for a in range(3)]

    def pop(rows):
        sp[rows] -= 1
        return stack[rows, sp[rows]]

    while True:
        at_node = torch.nonzero(cur >= 0)[:, 0]
        at_leaf = torch.nonzero((cur < 0) & (cur != _DONE))[:, 0]
        if at_node.numel() == 0 and at_leaf.numel() == 0:
            break
        if at_node.numel():
            row = nodes[cur[at_node]]
            t0 = [(row[:, 4 * a:4 * a + 4] - rays[a][at_node, None])
                  * inv[a][at_node, None] for a in range(3)]
            t1 = [(row[:, 12 + 4 * a:16 + 4 * a] - rays[a][at_node, None])
                  * inv[a][at_node, None] for a in range(3)]
            # fmin / fmax: a NaN (0 * inf) gives way to the other operand,
            # as fminf / fmaxf do in the kernels
            lo = [torch.fmin(x, y) for x, y in zip(t0, t1)]
            hi = [torch.fmax(x, y) for x, y in zip(t0, t1)]
            tn = torch.fmax(torch.fmax(lo[0], lo[1]), lo[2])
            tf = torch.fmin(torch.fmin(hi[0], hi[1]), hi[2])
            tf = tf * torch.tensor(FAR_PAD, dtype=torch.float32, device=dev)
            lim = best_t[at_node, None] * torch.tensor(
                T_SLACK, dtype=torch.float32, device=dev)
            hit = (tn <= tf) & (tf > 0.0) & (tn <= lim)
            key = torch.where(hit, tn.clamp(min=0.0), float("inf"))
            order = torch.argsort(key, dim=1, stable=True)
            child = refs_w[cur[at_node]].gather(1, order)
            n_hit = hit.sum(dim=1)
            for k in (3, 2, 1):                       # far ones go down first
                rows = at_node[n_hit > k]
                stack[rows, sp[rows]] = child[n_hit > k, k]
                sp[rows] += 1
            none = n_hit == 0
            cur[at_node[~none]] = child[~none, 0]
            cur[at_node[none]] = pop(at_node[none])
        if at_leaf.numel():
            payload = -(cur[at_leaf] + 1)
            start, count = payload >> 3, payload & 7
            count = torch.minimum(count, n_tri - start)
            for k in range(int(count.max())):
                sel = count > k
                rows, tri = at_leaf[sel], start[sel] + k
                t, u, v, ok = test(list(tris[tri].unbind(1)),
                                   list(rays[:, rows].unbind(0)))
                lower = (t < best_t[rows]) | ((t == best_t[rows])
                                              & (tri < best_tri[rows]))
                if precise:
                    lower = lower | (best_tri[rows] < 0)
                better = ok & lower
                rows, tri = rows[better], tri[better]
                best_t[rows], best_tri[rows] = t[better], tri
                b1[rows], b2[rows] = u[better], v[better]
            cur[at_leaf] = pop(at_leaf)
    found = best_tri >= 0
    return (torch.where(found, best_t, BIG_T), best_tri.to(torch.int32),
            torch.where(found, b1, 0.0), torch.where(found, b2, 0.0), found)
