"""The CUDA graphs kept from call to call, as ``jax.jit`` keeps its
compiled programs.

One graph a slot, two slots: ``"wavefront"``
(``integrator._WavefrontGraph``, the wavefront step that every forward
path film replays -- ``render``, ``render_accum``'s pt, nee and mis,
every ``render_progressive`` chunk, ``count_rays_one_spp`` and a rank's
block of ``parallel.render_sharded``) and ``"grad"``
(``parallel._LossAndGradsGraph``, ``loss_and_grads``'s forward and
backward).  A slot's graph is kept under the key it was captured for --
the arguments a JAX program is specialised on (meta, camera, config,
device; for the wavefront also the tile's lane count) and the shape and
dtype of every tensor it reads -- and a call with another key releases
it before capturing its own.  A kept graph holds its static inputs and
its memory pool (the saved activations of the grad step, the step's
tensors) until ``release_graphs``.

``CAPTURES`` counts, per slot, the graphs ``keep`` built anew: a first
call of a configuration, or one whose key changed.  The wavefront graph
captures on its first tile inside its own ``graphs.capture`` span.
"""
from __future__ import annotations

import collections

from .. import telemetry
from ..scene.types import tensors_of

_KEPT: dict = {}    # slot -> (key, graph)
CAPTURES = collections.Counter()    # slot -> graphs built by ``keep``


def shapes_of(x) -> tuple:
    """What a kept graph is specialised on besides its static arguments:
    the shape and dtype of each of ``x``'s tensors."""
    return tuple((tuple(t.shape), t.dtype) for t in tensors_of(x))


def keep(slot: str, key, build):
    """The graph kept in ``slot`` if it was captured for ``key``; else the
    kept one is released and ``build()``'s graph kept instead."""
    kept = _KEPT.get(slot)
    if kept is not None and kept[0] == key:
        return kept[1]
    release_graphs(slot)
    CAPTURES[slot] += 1
    with telemetry.span("graphs.capture", slot=slot):
        graph = build()
    _KEPT[slot] = key, graph
    return graph


def kept(slot: str):
    """The graph kept in ``slot``, or None."""
    entry = _KEPT.get(slot)
    return None if entry is None else entry[1]


def release_graphs(*slots: str) -> None:
    """Free the kept graphs of ``slots`` (all of them if none is named),
    with their static inputs and memory pools."""
    for slot in slots or tuple(_KEPT):
        entry = _KEPT.pop(slot, None)
        if entry is not None:
            entry[1].release()
