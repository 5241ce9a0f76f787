"""The program's own spans: named intervals at its layer boundaries, kept
in memory.

``span(name, **attrs)`` is a context manager around one piece of work: a
progressive pass, a wavefront film, a tile, a replay.  Spans nest: a span
opened inside another names it as its parent, and every span names the
root of its tree, which identifies the request (one progressive pass, one
fit step).  A span is recorded when it closes, on an exception too, into a
buffer of the last ``MAX_SPANS`` spans that ``spans()`` returns.

Recording is on only inside ``recording()`` or while a torch profiler
runs.  Off, ``span`` returns one shared object that does nothing, after a
single check: it reads no clock and allocates nothing.  A span never
synchronises the card and is never emitted as a profiler range (a range
would add an op to the device's timeline).  Its times are
``time.time_ns()``, the Unix-epoch clock of the profiler's events, so a
span compares directly with the device ops of a profiler trace: the
device idle under a span is the host's work on that layer.

The counters stay where the work is counted: ``ops.cuda_trace.LAUNCHES``
and ``LANES`` (launches and lanes per kernel), ``render.graphs.CAPTURES``
(captures per kept-graph slot) and ``RenderStats`` (closest-hit and
shadow rays, lanes shaded, escapes to and NEE lanes sent to the
environment light); a ``wavefront.film`` span carries its call's totals.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import NamedTuple

import torch

# the recorded spans kept: the oldest are dropped first
MAX_SPANS = 1 << 16


class Span(NamedTuple):
    name: str
    id: int
    parent: int | None     # the enclosing span's id; None for a root
    root: int              # the root span's id: the request
    start_ns: int          # time.time_ns()
    end_ns: int
    attrs: dict


_SPANS: collections.deque = collections.deque(maxlen=MAX_SPANS)
_IDS = itertools.count(1)
_LOCAL = threading.local()
_recording = 0          # depth of open ``recording()`` blocks
_profiler_enabled = torch._C._autograd._profiler_enabled


class _NoSpan:
    """The span returned while nothing records: enters, sets and exits
    doing nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


NO_SPAN = _NoSpan()


class _OpenSpan:
    __slots__ = ("name", "attrs", "id", "parent", "root", "start_ns")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = _stack()
        outer = stack[-1] if stack else None
        self.id = next(_IDS)
        self.parent = None if outer is None else outer.id
        self.root = self.id if outer is None else outer.root
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        stack = _stack()
        # spans opened inside this one and left open go with it
        del stack[stack.index(self):]
        _SPANS.append(Span(self.name, self.id, self.parent, self.root,
                           self.start_ns, end, self.attrs))
        return False

    def set(self, **attrs) -> None:
        """Add attributes, such as counts known only at the span's end."""
        self.attrs.update(attrs)


def _stack() -> list:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


def span(name: str, **attrs):
    """A context manager recording ``name`` over its block, with
    ``attrs``; ``NO_SPAN`` while recording is off."""
    if not (_recording or _profiler_enabled()):
        return NO_SPAN
    return _OpenSpan(name, attrs)


@contextlib.contextmanager
def recording():
    """Record spans inside this block (they are recorded anyway while a
    torch profiler runs)."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


def spans() -> list:
    """The recorded spans, oldest first (at most ``MAX_SPANS``)."""
    return list(_SPANS)


def clear() -> None:
    """Forget the recorded spans."""
    _SPANS.clear()
