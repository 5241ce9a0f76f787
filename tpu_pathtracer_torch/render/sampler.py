"""The Z-order Sobol and the random (threefry) samplers, bit-exact with
``tpu_pathtracer/render/sampler.py``.

Every draw is a pure function of (pixel, sample index, dimension).  The
JAX package computes in uint32; PyTorch has no unsigned 32-bit arithmetic,
so values live in int64 tensors and are masked to 32 bits (``M32``) after
every multiply, add and left shift.  A 32x32-bit product can wrap the
int64, but its low 32 bits are still right once masked.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from ..utils.math import M32, morton2

# ---------------------------------------------------------------------------
# 32-bit mixers
# ---------------------------------------------------------------------------


def _fmix32(h):
    """MurmurHash3 finalizer on [0, 2^32) int64 values."""
    h = h & M32
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & M32
    h = h ^ (h >> 16)
    return h


def _hash2(dimension, seed: int):
    """Two 32-bit scrambler seeds from (dimension, seed)."""
    base = _fmix32(((dimension * 0x9E3779B9) & M32) + (seed & M32))
    return base, _fmix32(base + 0x632BE59B)


def _reverse_bits32(n):
    n = ((n << 16) | (n >> 16)) & M32
    n = ((n & 0x00FF00FF) << 8) | ((n & 0xFF00FF00) >> 8)
    n = ((n & 0x0F0F0F0F) << 4) | ((n & 0xF0F0F0F0) >> 4)
    n = ((n & 0x33333333) << 2) | ((n & 0xCCCCCCCC) >> 2)
    n = ((n & 0x55555555) << 1) | ((n & 0xAAAAAAAA) >> 1)
    return n


def _fast_owen(v, scramble_seed):
    """FastOwenScrambler::randomize, exact."""
    v = _reverse_bits32(v)
    v = v ^ ((v * 0x3D20ADEA) & M32)
    v = (v + scramble_seed) & M32
    v = (v * ((scramble_seed >> 16) | 1)) & M32
    v = v ^ ((v * 0x05526C56) & M32)
    v = v ^ ((v * 0x53A22864) & M32)
    return _reverse_bits32(v)


# ---------------------------------------------------------------------------
# Sobol matrices (dims 0 and 1, the only ones the scheme uses)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _sobol_matrices() -> np.ndarray:
    dim0 = np.array([0x80000000 >> k for k in range(32)], np.int64)
    dim1 = np.zeros(32, np.int64)
    v = 0x80000000
    for k in range(32):
        dim1[k] = v
        v = v ^ (v >> 1)
    return np.stack([dim0, dim1])


@lru_cache(maxsize=None)
def _sobol_byte_tables() -> np.ndarray:
    """(2, 4, 256): for matrix m and index byte b, the XOR of the matrix
    columns selected by that byte's bits -- the 32-step XOR loop of the
    JAX package as four table lookups (same bits)."""
    mats = _sobol_matrices()
    out = np.zeros((2, 4, 256), np.int64)
    for m in range(2):
        for b in range(4):
            for val in range(256):
                acc = 0
                for bit in range(8):
                    if (val >> bit) & 1:
                        acc ^= int(mats[m, 8 * b + bit])
                out[m, b, val] = acc
    return out


# base-4 digit permutations, PBRT's fixed order, each packed as an 8-bit
# code (digit d at bits 2d..2d+1)
_PERMUTATIONS = np.array([
    [0, 1, 2, 3], [0, 1, 3, 2], [0, 2, 1, 3], [0, 2, 3, 1],
    [0, 3, 2, 1], [0, 3, 1, 2], [1, 0, 2, 3], [1, 0, 3, 2],
    [1, 2, 0, 3], [1, 2, 3, 0], [1, 3, 2, 0], [1, 3, 0, 2],
    [2, 1, 0, 3], [2, 1, 3, 0], [2, 0, 1, 3], [2, 0, 3, 1],
    [2, 3, 0, 1], [2, 3, 1, 0], [3, 1, 2, 0], [3, 1, 0, 2],
    [3, 2, 1, 0], [3, 2, 0, 1], [3, 0, 2, 1], [3, 0, 1, 2]], np.int64)
_PERM_CODES = np.sum(_PERMUTATIONS << (2 * np.arange(4, dtype=np.int64))[None, :],
                     axis=1)

_ONE_MINUS_EPS = float(np.nextafter(np.float32(1.0), np.float32(0.0)))


def _u32_to_unit_float(v):
    return torch.clamp(v.to(torch.float32) * (2.0 ** -32), max=_ONE_MINUS_EPS)


# ---------------------------------------------------------------------------
# Sampler
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ZSobolSampler:
    """PBRT-v4 Z-order Sobol over (R,) lanes."""
    seed: int
    spp: int
    resolution: tuple  # (w, h)

    @property
    def log2_spp(self) -> int:
        return max(int(self.spp - 1).bit_length(), 0)

    @property
    def n_base4_digits(self) -> int:
        res = max(self.resolution)
        log2_res = max(int(res - 1).bit_length(), 0)
        return log2_res + (self.log2_spp + 1) // 2

    @staticmethod
    def _lanes(v, like):
        """Scalar or per-lane (R,) integer -> int64 (R,) on ``like``'s device."""
        v = torch.as_tensor(v, device=like.device).to(torch.int64)
        return torch.broadcast_to(v, like.shape) & M32

    def _morton(self, pixel_xy, sample_idx):
        m = morton2(pixel_xy[:, 0], pixel_xy[:, 1])
        s = self._lanes(sample_idx, m)
        return ((m << self.log2_spp) & M32) | s

    def _sample_index(self, morton_index, dim):
        """Permuted base-4 digit scramble."""
        codes = torch.as_tensor(_PERM_CODES, device=morton_index.device)
        pow2 = (self.log2_spp & 1) == 1
        last_digit = 1 if pow2 else 0
        dim_hash = (dim * 0x55555555) & M32
        sample_index = torch.zeros_like(morton_index)
        for i in range(self.n_base4_digits - 1, last_digit - 1, -1):
            digit_shift = 2 * i - (1 if pow2 else 0)
            digit = (morton_index >> digit_shift) & 3
            higher = morton_index >> (digit_shift + 2)
            p = (_fmix32(higher ^ dim_hash) >> 24) % 24
            permuted = (codes[p] >> (2 * digit)) & 3
            sample_index = sample_index | (permuted << digit_shift)
        if pow2:
            digit = morton_index & 1
            flip = _fmix32((morton_index >> 1) ^ dim_hash) & 1
            sample_index = sample_index | (digit ^ flip)
        return sample_index

    @staticmethod
    def _sobol_u32(index, matrix: int):
        tables = torch.as_tensor(_sobol_byte_tables()[matrix],
                                 device=index.device)
        v = tables[0][index & 0xFF]
        for b in range(1, 4):
            v = v ^ tables[b][(index >> (8 * b)) & 0xFF]
        return v

    def get_1d(self, pixel_xy, sample_idx, dim):
        """pixel_xy: (R, 2) integer pixel coords; sample_idx, dim: scalars
        or (R,) integers.  Returns (R,) float32 in [0, 1)."""
        morton = self._morton(pixel_xy, sample_idx)
        dim = self._lanes(dim, morton)
        idx = self._sample_index(morton, dim)
        # permutation uses dim, the scrambler hash dim + 1
        s0, _ = _hash2(dim + 1, self.seed)
        return _u32_to_unit_float(_fast_owen(self._sobol_u32(idx, 0), s0))

    def get_2d(self, pixel_xy, sample_idx, dim):
        from ..utils.vec import V2
        morton = self._morton(pixel_xy, sample_idx)
        dim = self._lanes(dim, morton)
        idx = self._sample_index(morton, dim)
        s0, s1 = _hash2(dim + 2, self.seed)
        u = _u32_to_unit_float(_fast_owen(self._sobol_u32(idx, 0), s0))
        v = _u32_to_unit_float(_fast_owen(self._sobol_u32(idx, 1), s1))
        return V2(u, v)


# ---------------------------------------------------------------------------
# Random sampler: threefry-2x32 keyed on (seed, dim, sample, pixel)
# ---------------------------------------------------------------------------

_THREEFRY_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 block function (20 rounds) on [0, 2^32) int64
    values: key (k0, k1), counter (x0, x1) -> two 32-bit words."""
    def rotl(v, r):
        return ((v << r) & M32) | (v >> (32 - r))

    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _THREEFRY_ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = x0 ^ rotl(x1, r)
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def _bits_to_unit_float(bits):
    """32 random bits -> float32 in [0, 1): the top 23 bits become the
    mantissa of a float in [1, 2), minus 1."""
    word = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return word.view(torch.float32) - 1.0


@dataclasses.dataclass(frozen=True)
class RandomSampler:
    """Counter-based uniform sampler over (R,) lanes.

    The key starts as (0, seed) and folds in the dimension, the sample
    index and the pixel's Morton code, each fold being one threefry block
    with the counter (0, value); a draw is the XOR of the two output words
    of one more block with the counter (0, j), j the draw's position
    (0 for a 1-D draw, 0 and 1 for a 2-D one)."""
    seed: int
    spp: int
    resolution: tuple  # (w, h); unused, kept for parity with ZSobolSampler

    def _keys(self, pixel_xy, sample_idx, dim):
        m = morton2(pixel_xy[:, 0], pixel_xy[:, 1])
        zero = torch.zeros_like(m)
        k0, k1 = zero + ((self.seed >> 32) & M32), zero + (self.seed & M32)
        for v in (dim, sample_idx, m):
            v = torch.broadcast_to(
                torch.as_tensor(v, device=m.device).to(torch.int64), m.shape)
            k0, k1 = _threefry2x32(k0, k1, zero, v & M32)
        return k0, k1

    @staticmethod
    def _draw(k0, k1, j: int):
        zero = torch.zeros_like(k0)
        b0, b1 = _threefry2x32(k0, k1, zero, zero + j)
        return _bits_to_unit_float(b0 ^ b1)

    def get_1d(self, pixel_xy, sample_idx, dim):
        """pixel_xy: (R, 2) integer pixel coords; sample_idx, dim: scalars
        or (R,) integers.  Returns (R,) float32 in [0, 1)."""
        return self._draw(*self._keys(pixel_xy, sample_idx, dim), 0)

    def get_2d(self, pixel_xy, sample_idx, dim):
        from ..utils.vec import V2
        k0, k1 = self._keys(pixel_xy, sample_idx, dim)
        return V2(self._draw(k0, k1, 0), self._draw(k0, k1, 1))


def make_sampler(kind: str, seed: int, spp: int, resolution):
    if kind == "sobol":
        return ZSobolSampler(seed=seed, spp=spp, resolution=tuple(resolution))
    if kind == "random":
        return RandomSampler(seed=seed, spp=spp, resolution=tuple(resolution))
    raise ValueError(f"unknown sampler {kind!r}")
