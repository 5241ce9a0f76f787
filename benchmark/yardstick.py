"""The benchmark's fixed arithmetic: inputs, peaks, bounds and the
reduction of a profiler trace to device numbers.

Frozen here so that a change to the program cannot move the yardstick:

* ``dragon_sweep``: the procedural stand-in for the scanned dragon (a
  (2, 3) torus knot swept with a tube of varying radius), the sweep of
  ``tpu_pathtracer_torch/scene/mesh.py``'s ``dragon``; at 2304 x 192 it has
  884,736 triangles, about the scan's 871,414.  ``write_obj`` writes it as
  ``chip_smoke.py`` does (``%.9g``: float32 values survive the text).
* ``procedural_sky``: the sky of ``tpu_pathtracer_torch/scenes``, at any
  size; ``write_exr`` (the reference copy's writer) stores it as float32.
* ``traversal_bound_s``: ``chip_smoke.py``'s byte bound of a traversal
  launch, counting every lane of the launch as live (a replayed graph
  tells live from dead lanes apart nowhere): each ray row of seven floats
  read once, each result written once, at the H100's 3.35 TB/s.
* ``DeviceTrace``: ``profile_step.py``'s reduction (device time and device
  ops per step), the union of device-op intervals (busy time), the
  longest idle gaps named by the benchmark's own spans, and the device ops
  with the most time.
"""
from __future__ import annotations

import bisect
import collections

import numpy as np

# NVIDIA H100 SXM (data sheet, 700 W): HBM3 bandwidth
PEAK_BYTES_PER_S = 3.35e12
# a ray row [ox oy oz dx dy dz t_max]; a closest hit writes t, tri, b1,
# b2 and the hit flag, an any hit the flag
RAY_ROW_BYTES = 7 * 4
CLOSEST_OUT_BYTES = 4 + 4 + 4 + 4 + 1
ANY_OUT_BYTES = 1
# the traversal kernels of csrc/trace_kernels.cu, by their names in a trace
CLOSEST_KERNEL = "team_kernel"
ANY_KERNEL = "binary_any_hit_kernel"


def is_traversal(name: str) -> bool:
    """A traversal launch, by its (demangled) kernel name in a trace."""
    return CLOSEST_KERNEL in name or ANY_KERNEL in name


def is_any_hit(name: str) -> bool:
    """An any-hit launch: K2's binary walk, or K2p's team kernel
    (``team_kernel<true, true>``)."""
    return ANY_KERNEL in name or CLOSEST_KERNEL + "<true, true>" in name


def traversal_bound_s(name: str, lanes: int) -> float:
    """The least time a traversal launch over ``lanes`` rays can take: its
    bytes (each ray row read once, each result written once) at peak
    bandwidth.  Its operations depend on the walk and are not counted, so
    the bytes bind."""
    out = ANY_OUT_BYTES if is_any_hit(name) else CLOSEST_OUT_BYTES
    return lanes * (RAY_ROW_BYTES + out) / PEAK_BYTES_PER_S


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------

def dragon_sweep(n_u: int = 2304, n_v: int = 192):
    """(positions (V, 3), uvs (V, 2), indices (T, 3)) of the swept torus
    knot, 2 n_u n_v triangles, float64 positions as the sweep computes
    them."""
    u = np.linspace(0.0, 2.0 * np.pi, n_u, endpoint=False)
    cx = np.cos(2 * u) * (2.0 + np.cos(3 * u))
    cy = np.sin(3 * u) * 0.6
    cz = np.sin(2 * u) * (2.0 + np.cos(3 * u))
    c = np.stack([cx, cy, cz], -1) * 0.28
    t = np.roll(c, -1, 0) - np.roll(c, 1, 0)
    t /= np.maximum(np.linalg.norm(t, axis=-1, keepdims=True), 1e-12)
    b = np.cross(t, np.array([0.0, 1.0, 0.0]))
    b /= np.maximum(np.linalg.norm(b, axis=-1, keepdims=True), 1e-12)
    nrm = np.cross(b, t)
    radius = 0.09 * (1.0 + 0.35 * np.cos(5 * u))[:, None]
    v = np.linspace(0.0, 2.0 * np.pi, n_v, endpoint=False)
    circ = np.stack([np.cos(v), np.sin(v)], -1)
    pos = (c[:, None, :]
           + radius[:, :, None] * (circ[None, :, 0:1] * nrm[:, None, :]
                                   + circ[None, :, 1:2] * b[:, None, :]))
    pos = pos.reshape(-1, 3)
    uvs = np.stack(np.meshgrid(u / (2 * np.pi), v / (2 * np.pi),
                               indexing="ij"), -1).reshape(-1, 2)
    i = np.arange(n_u)[:, None]
    j = np.arange(n_v)[None, :]
    a = i * n_v + j
    bq = i * n_v + (j + 1) % n_v
    cq = ((i + 1) % n_u) * n_v + j
    dq = ((i + 1) % n_u) * n_v + (j + 1) % n_v
    idx = np.stack([np.stack([a, cq, bq], -1), np.stack([bq, cq, dq], -1)],
                   axis=2).reshape(-1, 3)
    return pos, uvs, idx


def write_obj(path: str, positions, uvs, indices) -> None:
    """v / vt / f lines (``%.9g``: float32 values round-trip); no normals,
    so a reader computes them from the faces as it would for a scan."""
    with open(path, "w") as f:
        np.savetxt(f, np.asarray(positions, np.float32),
                   fmt="v %.9g %.9g %.9g")
        np.savetxt(f, np.asarray(uvs, np.float32), fmt="vt %.9g %.9g")
        np.savetxt(f, np.repeat(np.asarray(indices) + 1, 2, axis=1),
                   fmt="f %d/%d %d/%d %d/%d")


def procedural_sky(h: int = 128, w: int = 256, sun_dir=(0.4, 0.5, -0.3)):
    """Sky: a gradient, a sun disk, a glow around it and a dim ground ->
    (h, w, 3) float32 linear RGB."""
    v, u = np.mgrid[0:h, 0:w]
    theta = (v + 0.5) / h * np.pi
    phi = (u + 0.5) / w * 2 * np.pi
    d = np.stack([np.sin(theta) * np.cos(phi), np.cos(theta),
                  -np.sin(theta) * np.sin(phi)], -1)
    sun = np.asarray(sun_dir) / np.linalg.norm(sun_dir)
    cos_sun = (d @ sun).clip(-1, 1)
    sky = np.zeros((h, w, 3), np.float32)
    t = np.clip(d[..., 1], 0, 1)[..., None]
    sky += (1 - t) * np.asarray([0.9, 0.85, 0.8]) + t * np.asarray(
        [0.25, 0.45, 0.9])
    sky += np.exp((cos_sun - 1.0) / 0.0008)[..., None] * np.asarray(
        [80.0, 70.0, 55.0])
    sky += np.exp((cos_sun - 1.0) / 0.08)[..., None] * np.asarray(
        [1.2, 1.0, 0.7])
    ground = d[..., 1] < 0
    sky[ground] = sky[ground] * 0.0 + np.asarray([0.25, 0.22, 0.2]) * (
        0.3 + 0.7 * np.abs(d[ground][:, 1:2]))
    return sky.astype(np.float32)


# ---------------------------------------------------------------------------
# Statistics
# ---------------------------------------------------------------------------

def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between order
    statistics, as numpy's default."""
    return float(np.percentile(np.asarray(values, np.float64), q))


# ---------------------------------------------------------------------------
# The device trace
# ---------------------------------------------------------------------------

def _ns(event, what: str) -> int:
    fn = getattr(event, what + "_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(event, what + "_us")()) * 1000


class DeviceTrace:
    """Device ops and the benchmark's spans of one profiled segment.

    ``ops``: (name, start ns, end ns) of every kernel, copy and set on the
    card; ``spans``: (name, start ns, end ns) of the ``record_function``
    ranges whose name starts with ``span_prefix``; ``window_s``: the
    segment's wall time, measured by the caller."""

    def __init__(self, ops, spans, window_s: float):
        self.ops = sorted(ops, key=lambda o: o[1])
        self.spans = spans
        self.window_s = window_s

    @classmethod
    def from_profiler(cls, prof, window_s: float, span_prefix: str):
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        ops, spans = [], []
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            if name.startswith(span_prefix):
                # a span, and its copy on the device's timeline
                if e.device_type() != cuda:
                    spans.append((name, _ns(e, "start"), _ns(e, "end")))
            elif e.device_type() == cuda:
                ops.append((name, _ns(e, "start"), _ns(e, "end")))
        return cls(ops, spans, window_s)

    def device_s(self) -> float:
        """Summed device time of every op."""
        return sum(e - s for _, s, e in self.ops) / 1e9

    def busy_intervals(self):
        """The union of the ops' intervals, as sorted (start, end) ns."""
        out = []
        for _, s, e in self.ops:
            if out and s <= out[-1][1]:
                if e > out[-1][1]:
                    out[-1][1] = e
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def idle_share(self) -> float:
        return 1.0 - self.busy_s() / self.window_s

    def traversal(self):
        """(name, seconds) of each traversal launch."""
        return [(n, (e - s) / 1e9) for n, s, e in self.ops
                if is_traversal(n)]

    def top_ops(self, k: int = 10):
        """The k device ops (by name) with the most summed time, as
        [name, seconds]."""
        total = collections.Counter()
        for n, s, e in self.ops:
            total[n] += (e - s) / 1e9
        return [[n[:120], t] for n, t in total.most_common(k)]

    def idle_gaps(self, k: int = 10):
        """The k longest gaps between busy intervals, as [name, seconds],
        each named by the innermost span that holds the gap's start (the
        span that begins last among those that hold it), else
        "outside the spans"."""
        busy = self.busy_intervals()
        gaps = [(busy[i + 1][0] - busy[i][1], busy[i][1])
                for i in range(len(busy) - 1)]
        gaps.sort(reverse=True)
        spans = sorted(self.spans, key=lambda sp: sp[1])
        starts = [sp[1] for sp in spans]
        out = []
        for length, at in gaps[:k]:
            name = "outside the spans"
            for sp in reversed(spans[:bisect.bisect_right(starts, at)]):
                if sp[2] >= at:
                    name = sp[0]
                    break
            out.append([name, length / 1e9])
        return out
