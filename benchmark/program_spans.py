"""The program's own spans (``tpu_pathtracer_torch.telemetry``) in the
traced segment, and the device idle time under them.

The program records its spans while a torch profiler runs, stamped with
``time.time_ns()``, the Unix-epoch clock of the profiler's events, so they
line up with ``DeviceTrace.ops``.  A program without the telemetry module
gives None, and the metrics that read its spans are left out.
"""
from __future__ import annotations


def in_segment(ctx):
    """The program's spans that overlap the profiled segment (from the
    first to the last device op of ``ctx.device_trace``), or None without
    a segment or without the program's telemetry."""
    t = ctx.device_trace
    if t is None or not t.ops:
        return None
    try:
        from tpu_pathtracer_torch import telemetry
    except ImportError:
        return None
    lo, hi = segment(t)
    return [s for s in telemetry.spans()
            if s.start_ns <= hi and s.end_ns >= lo]


def segment(trace):
    """[first op's start, last op's end] ns of ``trace``."""
    return trace.ops[0][1], max(e for _, _, e in trace.ops)


def _union(intervals):
    """Sorted, merged [start, end] intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _minus(a, b):
    """The parts of the merged intervals ``a`` that the merged intervals
    ``b`` do not cover."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > s:
                out.append([s, b[k][0]])
            s = max(s, b[k][1])
            k += 1
        if s < e:
            out.append([s, e])
    return out


def idle_s(trace, spans, names, outside=()) -> float:
    """Seconds of the device idle under the spans named ``names``, less the
    intervals of the spans named ``outside``: the part of those intervals,
    cut to the profiled segment (``segment``), that no interval of
    ``trace.busy_intervals()`` covers."""
    lo, hi = segment(trace)
    named = _union([sp.start_ns, sp.end_ns] for sp in spans
                   if sp.name in names)
    under = [[max(a, lo), min(b, hi)] for a, b in named
             if min(b, hi) > max(a, lo)]
    if outside:
        under = _minus(under, _union([s.start_ns, s.end_ns] for s in spans
                                     if s.name in outside))
    idle = _minus(under, trace.busy_intervals())
    return sum(e - s for s, e in idle) / 1e9


def idle_share(ctx, names, outside=()):
    """``idle_s`` over the profiled window, or None without the spans."""
    spans = in_segment(ctx)
    if not spans or not any(s.name in names for s in spans):
        return None
    return idle_s(ctx.device_trace, spans, names, outside) / (
        ctx.device_trace.window_s)


def live_share(ctx, rays: str, lanes: str):
    """The rays ``rays`` over the launched lanes ``lanes``, summed over the
    ``wavefront.film`` spans of the segment, or None without them."""
    spans = in_segment(ctx)
    films = [s.attrs for s in spans or ()
             if s.name == "wavefront.film" and lanes in s.attrs]
    launched = sum(a[lanes] for a in films)
    if not launched:
        return None
    return sum(a[rays] for a in films) / launched
