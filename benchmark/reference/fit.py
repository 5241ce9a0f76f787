"""The reference's side of a fit: the target, the start, and the first
steps of Adam worked out with the frozen copy (``tpt.train``).

``make_target`` and ``start_params`` are the benchmark's inputs, handed to
the program and to the reference alike; ``gradients`` recovers the
gradients the optimizer got at steps 1 and 2 from its first moments.
"""
from __future__ import annotations

import torch

from .tpt import train

ADAM_B1 = train.ADAM_B1


def make_target(seed: int, n_pixels: int, device) -> torch.Tensor:
    """(n_pixels, 3) linear RGB in [0, 0.5), drawn on ``device`` from the
    seed."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return torch.rand((n_pixels, 3), generator=g, device=device) * 0.5


def start_params(columns: dict) -> dict:
    """0.9 x each trainable material column + 0.05."""
    return {k: (0.9 * v + 0.05).detach().clone() for k, v in columns.items()}


def gradients(mus: list) -> list:
    """The gradients the optimizer got at steps 1 and 2, from its first
    moments after them: mu_t = b1 mu_(t-1) + (1 - b1) g_t, mu_0 = 0."""
    out, prev = [], None
    for mu in mus[:2]:
        out.append({k: ((v - (ADAM_B1 * prev[k] if prev else 0.0))
                        / (1.0 - ADAM_B1)).detach().clone()
                    for k, v in mu.items()})
        prev = mu
    return out


def follow(scene, meta, camera, cfg, seed: int, lr: float, n_steps: int,
           lower=None, n_pixels=None):
    """``n_steps`` Adam steps from ``start_params`` of the scene's columns
    against ``make_target(seed)`` -> dict(losses, grads (of the first two
    steps), params (after each step), start).  For the controls: ``lower``, a dtype the scene,
    the parameters and the results are rounded to at each step;
    ``n_pixels``, the loss over the first pixels alone."""
    from .render import rounded
    dev = scene.device
    target = make_target(seed, cfg.width * cfg.height, dev)
    start = start_params(train.extract_params(scene))
    scene = rounded(scene, lower)
    params = {k: v.clone() for k, v in start.items()}
    count = torch.zeros((), dtype=torch.int32, device=dev)
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, grads_kept, after = [], [], []
    for i in range(n_steps):
        loss, grads = train.loss_and_grads(rounded(params, lower), scene,
                                           meta, camera, cfg, target,
                                           n_pixels)
        grads = rounded(grads, lower)
        losses.append(float(rounded(loss, lower)))
        if i < 2:
            grads_kept.append({k: g.detach().clone()
                               for k, g in grads.items()})
        params, count, mu, nu = train.adam_update(params, count, mu, nu,
                                                  grads, lr)
        params = {k: v.detach() for k, v in params.items()}
        after.append({k: v.clone() for k, v in params.items()})
    return dict(losses=losses, grads=grads_kept, params=after, start=start)
