"""The parts of ``tpu_pathtracer/utils/math.py`` the ported path uses
(the box test lives in the CUDA kernels; their plain versions need none).

Unsigned 32-bit integers are emulated in int64 tensors: every value is
kept in [0, 2^32) by masking with ``M32`` after each multiply, add and
left shift.
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF


def select_lane(values, idx):
    """values (..., K) indexed per element by idx (...) -> (...)."""
    return torch.gather(values, -1, idx.long().unsqueeze(-1)).squeeze(-1)


def morton2(x, y):
    """Interleave 16-bit x, y into a 32-bit Morton code (int64 tensors)."""
    def spread(v):
        v = v.long() & 0x0000FFFF
        v = (v ^ (v << 8)) & 0x00FF00FF
        v = (v ^ (v << 4)) & 0x0F0F0F0F
        v = (v ^ (v << 2)) & 0x33333333
        v = (v ^ (v << 1)) & 0x55555555
        return v
    return ((spread(y) << 1) | spread(x)) & M32
