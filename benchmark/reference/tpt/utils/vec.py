"""SoA value types for the shading hot path: V2 / V3 / S4 / Frame.

Counterpart of ``tpu_pathtracer/utils/vec.py``: each component is its own
``(R,)`` tensor, so the port's public functions take and return the same
layout as the JAX package and the tests compare like with like.  Frozen
dataclasses (not tuples) so that a stray ``torch.as_tensor`` fails loudly.
Put the SoA value on the LEFT of mixed arithmetic (``v * s``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

__all__ = [
    "V2", "V3", "S4", "Frame", "sel", "smap",
    "dot3", "cross3", "normalize3",
    "orthogonalize3", "generate_tangent3",
    "make_frame", "to_frame", "from_frame",
    "v3_unstack", "s4_mean", "s4_max", "s4_dot",
]


def _parts(v):
    """The component fields, as they are (``dataclasses.astuple`` would
    deep-copy each tensor: a device copy per component, and an error on a
    tensor that carries a gradient)."""
    return tuple(getattr(v, f.name) for f in dataclasses.fields(v))


def _binop(op):
    def f(self, other):
        cls = type(self)
        if isinstance(other, cls):
            return cls(*(op(a, b) for a, b in zip(_parts(self),
                                                  _parts(other))))
        return cls(*(op(a, other) for a in _parts(self)))
    return f


def _rbinop(op):
    def f(self, other):
        cls = type(self)
        return cls(*(op(other, a) for a in _parts(self)))
    return f


class _Ops:
    """Elementwise arithmetic over the component fields; scalar operands
    ((R,) tensors or python floats) broadcast to every component."""
    __add__ = _binop(lambda a, b: a + b)
    __sub__ = _binop(lambda a, b: a - b)
    __mul__ = _binop(lambda a, b: a * b)
    __truediv__ = _binop(lambda a, b: a / b)
    __pow__ = _binop(lambda a, b: a ** b)
    __radd__ = _rbinop(lambda b, a: b + a)
    __rsub__ = _rbinop(lambda b, a: b - a)
    __rmul__ = _rbinop(lambda b, a: b * a)
    __rtruediv__ = _rbinop(lambda b, a: b / a)

    def __neg__(self):
        return type(self)(*(-a for a in _parts(self)))


@dataclasses.dataclass(frozen=True)
class V2(_Ops):
    x: Any
    y: Any


@dataclasses.dataclass(frozen=True)
class V3(_Ops):
    x: Any
    y: Any
    z: Any


@dataclasses.dataclass(frozen=True)
class S4(_Ops):
    """4-lane hero-wavelength spectral value."""
    a: Any
    b: Any
    c: Any
    d: Any

    @property
    def lanes(self):
        return (self.a, self.b, self.c, self.d)


@dataclasses.dataclass(frozen=True)
class Frame:
    """Orthonormal rotation render<->tangent; rows (t, b, n), +Z = normal."""
    t: V3
    b: V3
    n: V3


# ---------------------------------------------------------------------------
# Generic helpers
# ---------------------------------------------------------------------------

def smap(f, *xs):
    """Componentwise map over matching SoA structures (nested dataclasses
    and tuples); leaves are tensors."""
    x0 = xs[0]
    if dataclasses.is_dataclass(x0):
        return type(x0)(*(smap(f, *(getattr(x, fl.name) for x in xs))
                          for fl in dataclasses.fields(x0)))
    if isinstance(x0, tuple):
        vals = [smap(f, *parts) for parts in zip(*xs)]
        return type(x0)(*vals) if hasattr(x0, "_fields") else tuple(vals)
    return f(*xs)


def sel(mask, a, b):
    """``torch.where`` lifted over any SoA structure (mask: (R,))."""
    return smap(lambda x, y: torch.where(mask, x, y), a, b)


# ---------------------------------------------------------------------------
# V3 math
# ---------------------------------------------------------------------------

def dot3(a: V3, b: V3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross3(a: V3, b: V3) -> V3:
    return V3(a.y * b.z - a.z * b.y,
              a.z * b.x - a.x * b.z,
              a.x * b.y - a.y * b.x)


def normalize3(v: V3, eps: float = 1e-20) -> V3:
    return v * torch.rsqrt(torch.clamp(dot3(v, v), min=eps * eps))


def orthogonalize3(v: V3, n: V3) -> V3:
    """Gram-Schmidt v against unit n, normalized."""
    return normalize3(v - n * dot3(v, n))


def generate_tangent3(n: V3) -> V3:
    """Branchless Frisvad tangent for unit n."""
    sign = torch.where(n.z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n.z)
    b = n.x * n.y * a
    return V3(1.0 + sign * n.x * n.x * a, sign * b, -sign * n.x)


# ---------------------------------------------------------------------------
# Frames
# ---------------------------------------------------------------------------

def make_frame(n: V3, t: V3) -> Frame:
    """Orthonormal frame from unit normal + raw tangent."""
    t = orthogonalize3(t, n)
    return Frame(t=t, b=cross3(n, t), n=n)


def to_frame(f: Frame, v: V3) -> V3:
    """Render -> tangent (rows-as-basis)."""
    return V3(dot3(f.t, v), dot3(f.b, v), dot3(f.n, v))


def from_frame(f: Frame, v: V3) -> V3:
    """Tangent -> render (transpose = inverse for rotations)."""
    return f.t * v.x + f.b * v.y + f.n * v.z


# ---------------------------------------------------------------------------
# S4 reductions and the AoS -> SoA boundary
# ---------------------------------------------------------------------------

def s4_mean(s: S4):
    return (s.a + s.b + s.c + s.d) * 0.25


def s4_max(s: S4):
    return torch.maximum(torch.maximum(s.a, s.b), torch.maximum(s.c, s.d))


def s4_dot(a: S4, b: S4):
    return a.a * b.a + a.b * b.b + a.c * b.c + a.d * b.d


def v3_unstack(arr) -> V3:
    return V3(arr[..., 0], arr[..., 1], arr[..., 2])
