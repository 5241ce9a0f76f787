"""Progressive rendering with checkpoint/resume.

Counterpart of ``tpu_pathtracer/render/progressive.py``.  A render runs in
spp chunks; after each chunk the film state (the linear-RGB sum over the
samples done and their count) is written to disk, so a long render
survives preemption and resumes exactly: the samplers are pure functions
of (pixel, sample, dim), so chunk k reproduces its samples bit for bit.
The sum lives on the host between chunks; each chunk runs on the render's
device.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from .. import telemetry
from ..device import resolve_device
from . import film as film_mod
from .integrator import RenderConfig, render_accum


@dataclasses.dataclass
class FilmState:
    """Resumable film: sum of per-sample linear RGB + samples completed."""
    accum: np.ndarray          # (H*W, 3) f32 linear
    spp_done: int
    cfg_key: str               # guards against resuming a different render

    def save(self, path: str) -> None:
        """Write to ``path`` atomically (a temporary file, then a rename)."""
        tmp = path + ".tmp.npz"
        np.savez(tmp, accum=self.accum, spp_done=self.spp_done,
                 cfg_key=self.cfg_key)
        os.replace(tmp, path)

    @staticmethod
    def load(path: str) -> "FilmState":
        z = np.load(path, allow_pickle=False)
        return FilmState(accum=z["accum"], spp_done=int(z["spp_done"]),
                         cfg_key=str(z["cfg_key"]))


def _cfg_key(cfg: RenderConfig) -> str:
    """The JSON of the port's ``RenderConfig``.  Its fields are not the JAX
    package's, so a checkpoint of one package never resumes in the other;
    none has to."""
    return json.dumps(dataclasses.asdict(cfg), sort_keys=True)


def render_progressive(scene, meta, camera, cfg: RenderConfig,
                       checkpoint_path: str | None = None,
                       chunk_spp: int = 16, on_chunk=None, device=None):
    """Render in spp chunks, checkpointing after each.

    Returns the display-encoded (H, W, 3) image as numpy.  If
    ``checkpoint_path`` exists and holds this render's config, resumes
    from it.  ``on_chunk(state)`` is called after each chunk.  device:
    None renders on the GPU (raising if there is none).  Each chunk, its
    film's copies and its checkpoint are one ``progressive.pass`` span."""
    dev = resolve_device(device)
    scene = scene.to(dev)
    key = _cfg_key(cfg)
    state = None
    if checkpoint_path and os.path.exists(checkpoint_path):
        loaded = FilmState.load(checkpoint_path)
        if loaded.cfg_key == key and loaded.spp_done <= cfg.spp:
            state = loaded
    if state is None:
        state = FilmState(
            accum=np.zeros((cfg.width * cfg.height, 3), np.float32),
            spp_done=0, cfg_key=key)

    while state.spp_done < cfg.spp:
        end = min(state.spp_done + chunk_spp, cfg.spp)
        with telemetry.span("progressive.pass", spp_start=state.spp_done,
                            spp_end=end):
            state.accum = render_accum(
                scene, meta, camera, cfg, spp_start=state.spp_done,
                spp_end=end,
                accum_init=torch.from_numpy(state.accum)).cpu().numpy()
            state.spp_done = end
            if checkpoint_path:
                state.save(checkpoint_path)
        if on_chunk:
            on_chunk(state)

    img = film_mod.finalize(torch.from_numpy(state.accum), cfg.spp,
                            tone_map=cfg.tone_map, eotf=cfg.eotf)
    return img.numpy().reshape(cfg.height, cfg.width, 3)
