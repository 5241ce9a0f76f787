"""The material layer's two CUDA kernels: a lane's material sample and its
value and pdf, each lane of its own BSDF kind alone.

``sample`` and ``evaluate`` are ``render.bsdf.sample_material`` and
``evaluate_material`` of an untextured scene on a CUDA device, bit for bit,
as one launch each of ``bsdf_sample_kernel`` and ``bsdf_eval_kernel``
(``csrc/bsdf.cu``, see its header): the torch ops evaluate every kind the
scene holds over every lane and merge them by ``mat_type`` masks.
``render.bsdf.uses_kernel`` decides which a call takes.

The kernels are built from their source like the traversal kernels
(``cuda_trace.build``) and counted in ``cuda_trace.LAUNCHES`` and
``LANES`` under ``bsdf_sample`` and ``bsdf_eval``, the lanes being the
call's.  A wrapper takes float32 columns of any stride and the scene's
material table and spectra as they are laid out (``_table``, ``_bank``);
it raises on a CUDA input it does not take.
"""
from __future__ import annotations

import ctypes
import os

import torch

from ..utils.vec import S4, V3
from . import cuda_trace

KERNEL_SOURCE = os.path.join(os.path.dirname(cuda_trace.KERNEL_SOURCE),
                             "bsdf.cu")
SAMPLE_NAME = "bsdf_sample"
EVAL_NAME = "bsdf_eval"
# the material columns the kernels read, in the order of Table in
# csrc/bsdf.cu: (name, dtype, channels)
TABLE_COLUMNS = (
    ("mat_type", torch.int32, 1), ("base_coeff", torch.float32, 3),
    ("roughness", torch.float32, 1), ("metallic", torch.float32, 1),
    ("eta_row", torch.int32, 1), ("k_row", torch.int32, 1),
    ("const_eta", torch.float32, 1), ("thin", torch.int32, 1),
    ("coat_tint_coeff", torch.float32, 3),
    ("coat_thickness", torch.float32, 1),
    ("coat_roughness", torch.float32, 1), ("coat_eta", torch.float32, 1))
# rows of a sample's float output: f (4), wi_t (3), pdf, wavelength pdfs
# (4); of an eval's: f (4), pdf
SAMPLE_ROWS = 12
EVAL_ROWS = 5

_LIB = None


def _library():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(cuda_trace.build(KERNEL_SOURCE)[0])
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        llp = ctypes.POINTER(ll)
        lib.launch_bsdf.argtypes = [i, i, p, ll, i, i, llp, i, llp, llp, i,
                                    p, p, p]
        lib.launch_bsdf.restype = i
        lib.bsdf_launch_info.argtypes = [i, i, ctypes.POINTER(i)]
        lib.bsdf_launch_info.restype = i
        _LIB = lib
    return _LIB


def _longs(values):
    return (ctypes.c_longlong * max(len(values), 1))(*values)


def _columns(parts, n: int, dev) -> list:
    """(pointer, stride) of each (n,) float32 column in ``parts``."""
    out = []
    for t in parts:
        if t.device != dev or t.dtype != torch.float32 or t.dim() != 1 \
                or t.shape[0] != n:
            raise ValueError(f"the material kernels take ({n},) float32 "
                             f"columns on {dev}, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
        out += [t.data_ptr(), t.stride(0)]
    return out


def _table(materials, dev) -> list:
    """The pointers of the material columns the kernels read."""
    ptrs = []
    m = materials.mat_type.shape[0]
    for name, dtype, channels in TABLE_COLUMNS:
        t = getattr(materials, name)
        shape = (m,) if channels == 1 else (m, channels)
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"material column {name} must be a contiguous "
                             f"{shape} {dtype} tensor on {dev}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
        ptrs.append(t.data_ptr())
    return ptrs


def _bank(spectra, n: int, dev) -> list:
    """(base pointer, row stride, column step) of each wavelength lane of
    the spectra at the lanes' wavelengths (``wl.bank.spectra``, S4s): the
    columns of one (n, K) matrix a wavelength, as
    ``grid.lambda_slice_bank`` makes them."""
    out = []
    for lane in range(4):
        cols = [s.lanes[lane] for s in spectra]
        if not cols:
            out += [0, 0, 0]
            continue
        first = cols[0]
        step = 0
        if len(cols) > 1:
            step, rem = divmod(cols[1].data_ptr() - first.data_ptr(), 4)
            if rem:
                raise ValueError("spectra columns not 4-byte apart")
        _columns(cols, n, dev)
        for k, c in enumerate(cols):
            if c.stride(0) != first.stride(0) \
                    or c.data_ptr() != first.data_ptr() + 4 * k * step:
                raise ValueError("the material kernels take the spectra as "
                                 "columns of one matrix a wavelength")
        out += [first.data_ptr(), first.stride(0), step]
    return out


def _mat_ids(mat_id, n: int, dev):
    if mat_id.device != dev or mat_id.dim() != 1 or mat_id.shape[0] != n \
            or mat_id.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"mat_id must be ({n},) int32 or int64 on {dev}")
    return mat_id.data_ptr(), mat_id.stride(0), \
        int(mat_id.dtype == torch.int64)


def _common(it, frame, wo_t) -> list:
    """The columns both kernels read first: the geometric normal, wo, the
    shading frame (t, b, n) and the tangent-space wo."""
    return [it.geo_n.x, it.geo_n.y, it.geo_n.z, it.wo.x, it.wo.y, it.wo.z,
            frame.t.x, frame.t.y, frame.t.z, frame.b.x, frame.b.y, frame.b.z,
            frame.n.x, frame.n.y, frame.n.z, wo_t.x, wo_t.y, wo_t.z]


def _launch(eval_: bool, scene, meta, it, cols, wl, out, flags):
    n, dev = out.shape[1], out.device
    if n >= 2 ** 31:
        raise ValueError("lane count exceeds int32")
    mat = _mat_ids(it.mat_id, n, dev)
    kinds = sum(1 << k for k in meta.present_mat_kinds if 0 <= k < 31)
    col_args = _columns(cols, n, dev)
    table = _table(scene.materials, dev)
    bank = _bank(wl.bank.spectra, n, dev)
    with torch.cuda.device(dev):
        rc = _library().launch_bsdf(
            int(eval_), n, *mat, kinds, _longs(col_args), len(cols),
            _longs(table), _longs(bank), len(wl.bank.spectra),
            out.data_ptr(), None if flags is None else flags.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    name = EVAL_NAME if eval_ else SAMPLE_NAME
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    cuda_trace._count_launch(name, n)


def sample(scene, meta, it, frame, wo_t: V3, uc, uv2, wl, uc2, uc3):
    """``sample_material``'s result on the kernel: (f S4, wi_t V3, pdf,
    sampled, specular, the wavelength pdfs S4 after a dispersive
    transmission's termination)."""
    n, dev = uc.shape[0], uc.device
    out = torch.empty((SAMPLE_ROWS, n), dtype=torch.float32, device=dev)
    flags = torch.empty((2, n), dtype=torch.bool, device=dev)
    if n:
        cols = _common(it, frame, wo_t) + [uc, uv2.x, uv2.y, uc2, uc3,
                                           *wl.lam.lanes, *wl.pdf.lanes]
        _launch(False, scene, meta, it, cols, wl, out, flags)
    return (S4(*out[0:4]), V3(*out[4:7]), out[7], flags[0], flags[1],
            S4(*out[8:12]))


def evaluate(scene, meta, it, frame, wo_t: V3, wi_t: V3, wl):
    """``evaluate_material``'s result on the kernel: (f S4, pdf)."""
    n, dev = wo_t.x.shape[0], wo_t.x.device
    out = torch.empty((EVAL_ROWS, n), dtype=torch.float32, device=dev)
    if n:
        cols = _common(it, frame, wo_t) + [wi_t.x, wi_t.y, wi_t.z,
                                           *wl.lam.lanes]
        _launch(True, scene, meta, it, cols, wl, out, None)
    return S4(*out[0:4]), out[4]


def launch_info(eval_: bool, n: int) -> dict:
    """Registers and local bytes a thread, resident blocks an SM and the
    grid of a launch of the sample or the eval kernel over n lanes on the
    current card."""
    out = (ctypes.c_int * 4)()
    rc = _library().bsdf_launch_info(int(eval_), n, out)
    if rc != 0:
        raise RuntimeError(f"bsdf_launch_info: cudaError {rc}")
    return dict(zip(("registers", "local_bytes", "blocks_per_sm", "grid"),
                    out))
