"""Gathers from a small table whose gradient is a CUDA kernel.

``gather_rows(table, idx)`` is ``table[idx]``: each lane reads one row of
an (M,) or (M, C) float table, as the material parameters are read per
hit.  Where autograd would take the table's gradient, it is a
``torch.autograd.Function`` whose backward sums each row's lanes: on a CUDA
tensor the kernel of ``csrc/table_grad.cu`` (see its header: a fixed order
of sums, no float atomics, so the same bits on every call and every
replay of a captured graph), on a CPU tensor the plain version
``gather_rows_grad_plain``.  Autograd's own backward of ``table[idx]`` on
the card is an ``index_put_`` with accumulate, which sorts the indices and
then adds each row's lanes in one warp.

The kernel is built from its own source like the traversal kernels
(``cuda_trace.build``) and counted in ``cuda_trace.LAUNCHES`` and
``LANES`` under ``gather_rows_grad``, the lanes being the gather's.
"""
from __future__ import annotations

import ctypes
import os

import torch

from . import cuda_trace

KERNEL_SOURCE = os.path.join(os.path.dirname(cuda_trace.KERNEL_SOURCE),
                             "table_grad.cu")
KERNEL_NAME = "gather_rows_grad"

_LIB = None


def _library():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(cuda_trace.build(KERNEL_SOURCE)[0])
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.launch_gather_rows_grad.argtypes = [i, i, i, p, p, p, p, p, p]
        lib.launch_gather_rows_grad.restype = i
        lib.gather_rows_grad_blocks.argtypes = [i]
        lib.gather_rows_grad_blocks.restype = i
        _LIB = lib
    return _LIB


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for an (M,) or (M, C) ``table`` and an (N,) int64
    ``idx``; its gradient with respect to ``table``, where autograd takes
    one, is ``gather_rows_grad``."""
    if not (torch.is_grad_enabled() and table.requires_grad):
        return table[idx]
    return _GatherRows.apply(table, idx)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return table[idx]

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        (idx,) = ctx.saved_tensors
        return gather_rows_grad(grad_out, idx, ctx.rows), None


def gather_rows_grad(grad_out: torch.Tensor, idx: torch.Tensor,
                     rows: int) -> torch.Tensor:
    """The (rows,) or (rows, C) sum, per row m, of ``grad_out``'s lanes
    whose ``idx`` is m: the plain version for a CPU tensor, else the
    kernel (float32, C of 1 or 3)."""
    if grad_out.device.type == "cpu":
        return gather_rows_grad_plain(grad_out, idx, rows)
    if grad_out.device.type != "cuda":
        raise ValueError(f"unsupported device {grad_out.device}")
    return _launch(grad_out, idx, rows)


def gather_rows_grad_plain(grad_out, idx, rows):
    """``index_add_`` of the lanes into zeros, in lane order; a negative
    index counts from the end, as ``table[idx]`` reads it."""
    idx = torch.where(idx < 0, idx + rows, idx)
    return torch.zeros((rows, *grad_out.shape[1:]), dtype=grad_out.dtype,
                       device=grad_out.device).index_add_(0, idx, grad_out)


def _launch(grad_out, idx, rows):
    channels = 1 if grad_out.dim() == 1 else grad_out.shape[1]
    if grad_out.dtype != torch.float32 or idx.dtype != torch.int64:
        raise TypeError(f"the kernel takes float32 gradients and int64 rows, "
                        f"got {grad_out.dtype} and {idx.dtype}")
    if grad_out.dim() > 2 or channels not in (1, 3):
        raise ValueError(f"the kernel takes (N,) or (N, 1 or 3) gradients, "
                         f"got {tuple(grad_out.shape)}")
    if idx.dim() != 1 or idx.shape[0] != grad_out.shape[0] \
            or idx.device != grad_out.device:
        raise ValueError("idx must be (N,) on the gradients' device")
    n, dev = idx.shape[0], grad_out.device
    if n >= 2 ** 31 or rows * channels >= 2 ** 31:
        raise ValueError("lane or row count exceeds int32")
    out = torch.empty((rows, *grad_out.shape[1:]), dtype=torch.float32,
                      device=dev)
    lib = _library()
    blocks = lib.gather_rows_grad_blocks(n)
    if blocks == 0 or rows == 0:
        return out.zero_()
    grad_out, idx = grad_out.contiguous(), idx.contiguous()
    partials = torch.empty(rows * channels * blocks, dtype=torch.float32,
                           device=dev)
    ticket = torch.zeros(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.launch_gather_rows_grad(
            n, rows, channels, idx.data_ptr(), grad_out.data_ptr(),
            partials.data_ptr(), ticket.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{KERNEL_NAME} launch failed: cudaError {rc}")
    cuda_trace._count_launch(KERNEL_NAME, n)
    return out
