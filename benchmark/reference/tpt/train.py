"""The differentiable pass of the reference: a frozen copy of the port's
plain path (``tpu_pathtracer_torch/parallel``) on one device.

The forward render of the trainable material columns (the lockstep
``trace_sample``, every ``max_depth`` bounce, every sample in one call),
the MSE against a target and
its gradients (``loss_and_grads``), and optax's Adam in its order of
operations (``adam_update``), as eager ops with the reference's own
traversal under them.
"""
from __future__ import annotations

import dataclasses

import torch

from .render.integrator import RenderConfig, _pixel_grid, trace_sample
from .render.sampler import make_sampler
from .scene.types import SceneData

# Material-table columns exposed to the differentiable pass; the order is
# the JAX package's.
TRAINABLE_COLUMNS = ("base_coeff", "roughness", "metallic",
                     "emission_scale", "coat_tint_coeff", "coat_roughness")


def extract_params(scene: SceneData) -> dict:
    """The trainable material columns of the scene."""
    return {c: getattr(scene.materials, c) for c in TRAINABLE_COLUMNS}


def merge_params(scene: SceneData, params: dict) -> SceneData:
    return dataclasses.replace(
        scene, materials=dataclasses.replace(scene.materials, **params))


def _pad_pixels(cfg: RenderConfig, n_shards: int, device):
    """The flat pixel grid padded with pixel (0, 0) so that it divides
    into ``n_shards`` blocks -> ((R', 2) i32, R)."""
    pixel_xy = _pixel_grid(cfg.width, cfg.height, device)
    r = pixel_xy.shape[0]
    pad = (-r) % n_shards
    if pad:
        pixel_xy = torch.cat([pixel_xy, torch.zeros(
            (pad, 2), dtype=torch.int32, device=device)], 0)
    return pixel_xy, r


def _accum_linear(scene, meta, camera, cfg, pixel_xy):
    """Mean linear-RGB estimate over the spp of a block of pixels -> (R, 3):
    the lockstep ``trace_sample`` over every (sample, pixel) lane at once
    (the program runs one sample a call), the samples then added in sample
    order, as the program adds them."""
    sampler = make_sampler(cfg.sampler, cfg.seed, cfg.spp,
                           (cfg.width, cfg.height))
    r = pixel_xy.shape[0]
    samples = torch.arange(cfg.spp, dtype=torch.int32,
                           device=pixel_xy.device).repeat_interleave(r)
    rgb = trace_sample(scene, meta, camera, cfg, sampler,
                       pixel_xy.repeat(cfg.spp, 1), samples)
    acc = torch.zeros((r, 3), device=pixel_xy.device)
    for i in range(cfg.spp):
        acc = acc + rgb[i * r:(i + 1) * r]
    return acc / cfg.spp


def loss_and_grads(params: dict, scene, meta, camera, cfg: RenderConfig,
                   target, n_pixels: int | None = None):
    """MSE(linear render, target) and its gradient w.r.t. ``params`` on the
    scene's device: the sum of squared differences over the pixel grid (or
    its first ``n_pixels``) divided by 3 x its length, every ``max_depth``
    bounce run (``early_exit=False``) -> (0-d loss, {column: gradient})."""
    cfg = dataclasses.replace(cfg, early_exit=False)
    dev = scene.device
    pixel_xy, _ = _pad_pixels(cfg, 1, dev)
    target = torch.as_tensor(target, dtype=torch.float32, device=dev)
    if n_pixels is not None:
        pixel_xy, target = pixel_xy[:n_pixels], target[:n_pixels]
    p = {k: torch.as_tensor(v, device=dev).detach().requires_grad_(True)
         for k, v in params.items()}
    return _loss_program(p, scene, meta, camera, cfg, pixel_xy, target,
                         pixel_xy.shape[0])


def _loss_program(params, scene, meta, camera, cfg, px, target, n_total):
    """What ``_loss_and_grads_jit`` computes on one block of pixels: the
    forward render with the trainable columns ``params`` (leaf tensors
    that require grad), the MSE against ``target`` and its gradients ->
    (0-d loss, {column: gradient}); a column the loss does not reach gets
    zeros.  Eager ops; ``_LossAndGradsGraph`` captures it."""
    with torch.enable_grad():
        rgb = _accum_linear(merge_params(scene, params), meta, camera, cfg,
                            px)
        loss = ((rgb - target) ** 2).sum() / (3.0 * n_total)
        keys = list(params)
        gs = torch.autograd.grad(loss, [params[k] for k in keys],
                                 allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(params[k]) if g is None
                           else g for k, g in zip(keys, gs)}


ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8


def adam_update(params: dict, count, mu: dict, nu: dict, grads: dict,
                lr: float):
    """optax.adam(lr) on ``grads``, in its order of operations:
    scale_by_adam (b1 0.9, b2 0.999, eps 1e-8, eps_root 0, bias
    correction by 1 - b**count) then scale_by_learning_rate (x -lr), then
    apply_updates (p + u) -> (params, count, mu, nu)."""
    count = count + 1
    c1 = 1 - ADAM_B1 ** count.to(torch.float32)
    c2 = 1 - ADAM_B2 ** count.to(torch.float32)
    new_p, new_mu, new_nu = {}, {}, {}
    for k, p in params.items():
        g = grads[k]
        new_mu[k] = (1 - ADAM_B1) * g + ADAM_B1 * mu[k]
        new_nu[k] = (1 - ADAM_B2) * g ** 2 + ADAM_B2 * nu[k]
        u = (new_mu[k] / c1) / (torch.sqrt(new_nu[k] / c2) + ADAM_EPS)
        new_p[k] = p + u * -lr
    return new_p, count, new_mu, new_nu
