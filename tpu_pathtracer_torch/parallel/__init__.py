"""The differentiable pass and the pixel-sharded render.

Counterpart of ``tpu_pathtracer/parallel/__init__.py``.  The JAX package
shards the flat pixel buffer over a 1-D device mesh; here an optional
``torch.distributed`` process group takes the mesh's place (``None``: one
device).  Each rank renders, or backpropagates, its block of the padded
pixel grid; the scene is whole on every rank, the film is all-gathered and
the loss and gradients are all-reduced (SUM), as the JAX package's
``psum`` does.

Provides:
  * ``render_sharded``   -- forward render, pixels split over the group
  * ``loss_and_grads``   -- MSE of the mean linear RGB against a target
                            image and its gradients w.r.t. the trainable
                            material columns (traversal detached, lobe,
                            light and roulette choices fixed)
  * ``release_graphs``   -- frees the CUDA graphs ``loss_and_grads`` and
                            the wavefront renders keep on a card
  * ``train_step``       -- one SGD step on those columns
  * ``TrainState``       -- Adam (optax's arithmetic) with checkpoint and
                            resume, in the JAX package's npz layout

A rank renders its block through the integrator's wavefront
(``integrator._film``, the AOVs through ``trace_sample``); the
differentiable pass runs the lockstep ``trace_sample``, every
``max_depth`` bounce, because autograd takes its backward in lockstep.
On a CUDA device the JAX package's compiled programs are CUDA graphs:
``render_sharded`` replays the kept wavefront step (slot "wavefront",
one capture per tile size), and ``loss_and_grads`` replays its forward
and backward captured as one graph (``_LossAndGradsGraph``, slot
"grad", the counterpart of ``_loss_and_grads_jit``).  Both are kept from
call to call as ``jax.jit`` keeps its programs (``render.graphs``),
until ``release_graphs``.  On the CPU both run as eager ops, the graphs'
plain versions.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from .. import telemetry
from ..device import resolve_device
from ..ops import cuda_trace
from ..render import film as film_mod
from ..render import graphs as graphs_mod
from ..render.graphs import release_graphs  # noqa: F401  (public)
from ..render.integrator import (CALL_PATH_BUDGET, PATH_STRATEGIES,
                                 RenderConfig, _accum_chunk, _check_config,
                                 _film, _pixel_grid)
from ..render.sampler import make_sampler
from ..scene.types import SceneData, SceneMeta, check_ported, tensors_of

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


def _world(group):
    """(world size, rank) of the group; (1, 0) for None."""
    if group is None:
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


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
    the lockstep ``trace_sample``, tiles of at most ``cfg.tile_rays`` lanes
    (and ``CALL_PATH_BUDGET``) one after another, as eager ops."""
    sampler = make_sampler(cfg.sampler, cfg.seed, cfg.spp,
                           (cfg.width, cfg.height))
    tile = max(1, min(cfg.tile_rays, CALL_PATH_BUDGET))
    tiles = []
    for k in range(0, pixel_xy.shape[0], tile):
        px = pixel_xy[k:k + tile]
        acc = torch.zeros((px.shape[0], 3), device=px.device)
        tiles.append(_accum_chunk(scene, meta, camera, cfg, sampler, cfg.spp,
                                  px, 0, acc))
    return torch.cat(tiles, 0) / cfg.spp


def _block(x, n, rank):
    per = x.shape[0] // n
    return x[rank * per:(rank + 1) * per]


def render_sharded(scene: SceneData, meta: SceneMeta, camera,
                   cfg: RenderConfig, group=None, device=None):
    """Full forward render with the pixels split over ``group`` ->
    (H, W, 3) display-encoded image on every rank.  Each rank renders its
    block as ``integrator.render`` renders the grid; each lane's path is a
    pure function of (pixel, sample), so the split changes no sample, and
    with no group the image is ``render``'s bit for bit.  On a CUDA device
    the block's tiles replay the kept wavefront step (``release_graphs``
    frees it)."""
    dev = resolve_device(device)
    return _render_sharded(scene, meta, camera, cfg, group, dev,
                           graphed=dev.type == "cuda")


def _render_sharded(scene, meta, camera, cfg, group, dev, graphed: bool):
    """``render_sharded`` through the kept step graph (``graphed``) or as
    eager ops (the CPU, and the graph's plain version on the card)."""
    _check_config(cfg)
    check_ported(meta)
    scene = scene.to(dev)
    n, rank = _world(group)
    pixel_xy, r = _pad_pixels(cfg, n, dev)
    with torch.no_grad():
        mine, _ = _film(scene, meta, camera, cfg, 0, cfg.spp, None, graphed,
                        pixels=_block(pixel_xy, n, rank))
    if n > 1:
        parts = [torch.empty_like(mine) for _ in range(n)]
        dist.all_gather(parts, mine, group=group)
        mine = torch.cat(parts, 0)
    is_path = cfg.strategy in PATH_STRATEGIES
    img = film_mod.finalize(
        mine[:r], cfg.spp,
        tone_map=cfg.tone_map if is_path else "none",
        eotf=cfg.eotf if is_path or cfg.strategy == "albedo" else "linear")
    return img.reshape(cfg.height, cfg.width, 3)


def loss_and_grads(params: dict, scene: SceneData, meta: SceneMeta, camera,
                   cfg: RenderConfig, target, group=None, device=None):
    """MSE(linear render, target) and its gradient w.r.t. ``params``.

    ``target``: (H*W, 3) linear RGB.  The loss is the sum of squared
    differences over the padded pixel grid (padding rows render pixel
    (0, 0) against a zero target, as in the JAX package) divided by
    3 x its length; the lockstep bounce loop runs all ``max_depth``
    bounces.  With a group each rank backpropagates its
    block and the loss and gradients are all-reduced, so every rank holds
    the full values.  On a CUDA device the forward and backward replay one
    captured CUDA graph, kept for the next call of the same configuration.
    Until ``release_graphs`` the kept graph holds a copy of the scene and
    its memory pool, which keeps the saved activations' blocks reserved:
    2.9 GB for scene 17 at 128^2, 2 spp, depth 8 on an H100, about 1.8x
    the eager step's peak.  Returns (0-d loss, {column: gradient}) on the
    device."""
    dev = resolve_device(device)
    return _loss_and_grads(params, scene, meta, camera, cfg, target, group,
                           dev, graphed=dev.type == "cuda")


def _loss_and_grads(params, scene, meta, camera, cfg, target, group, dev,
                    graphed: bool):
    """``loss_and_grads`` through the captured graph (``graphed``) or as
    eager ops (the CPU, and the graph's plain version on the card)."""
    _check_config(cfg)
    check_ported(meta)
    n, rank = _world(group)
    pixel_xy, r = _pad_pixels(cfg, n, dev)
    n_total = pixel_xy.shape[0]
    target = torch.as_tensor(target, dtype=torch.float32, device=dev)
    if n_total > r:
        target = torch.cat([target, torch.zeros((n_total - r, 3),
                                                device=dev)], 0)
    p = {k: torch.as_tensor(v, device=dev).detach()
         for k, v in params.items()}
    scene = scene.to(dev)
    px, tgt = _block(pixel_xy, n, rank), _block(target, n, rank)
    if graphed:
        with telemetry.span("graphs.lookup", slot="grad"):
            key = (meta, camera, cfg, group, n, rank, dev,
                   graphs_mod.shapes_of(scene), tuple(p),
                   graphs_mod.shapes_of((*p.values(), tgt)))
            graph = graphs_mod.keep("grad", key, lambda: _LossAndGradsGraph(
                p, scene, meta, camera, cfg, px, tgt, n_total))
        loss, grads = graph(p, scene, tgt)
    else:
        loss, grads = _loss_program(
            {k: v.requires_grad_(True) for k, v in p.items()}, scene, meta,
            camera, cfg, px, tgt, n_total)
    if n > 1:
        dist.all_reduce(loss, group=group)
        for g in grads.values():
            dist.all_reduce(g, group=group)
    return loss, grads


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


class _LossAndGradsGraph:
    """``_loss_program`` captured as one CUDA graph, forward and backward:
    the counterpart of ``_loss_and_grads_jit``.

    Its static inputs are the trainable columns (leaf tensors that
    require grad), a copy of the scene's tensors, the pixel block and the
    target block; a call copies its values into them, replays the graph
    and returns clones of the loss and gradients, so a value the caller
    holds survives the next replay.  Built on the first call: the program
    runs eagerly on a side stream (the warm-up, whose loss and gradients
    are that call's), then it is captured.  The capture launches nothing;
    each replay adds the wrappers' counts of the capture to
    ``cuda_trace.LAUNCHES`` and ``LANES``.  A call's copies in, replay and
    clones out are its spans ``grad.load``, ``grad.replay`` and
    ``grad.outputs``.  The graph's memory pool holds the saved
    activations between calls until ``release``."""

    def __init__(self, params, scene, meta, camera, cfg, px, target,
                 n_total):
        dev = px.device
        with torch.no_grad():
            self.params = {k: v.clone().requires_grad_(True)
                           for k, v in params.items()}
            self.scene = scene.map(torch.clone)
            self.px, self.target = px.clone(), target.clone()

        def program():
            return _loss_program(self.params, self.scene, meta, camera, cfg,
                                 self.px, self.target, n_total)

        with torch.cuda.device(dev):
            side = torch.cuda.Stream(device=dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self.first = program()
            torch.cuda.current_stream(dev).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with cuda_trace.captured_launches() as self.recorded:
                with torch.cuda.graph(self.graph):
                    self.loss, self.grads = program()

    def __call__(self, params, scene, target):
        """(loss, gradients) of these inputs: the warm-up's on the first
        call, a replay's after it."""
        if self.first is not None:
            out, self.first = self.first, None
            return out
        with torch.no_grad(), telemetry.span("grad.load"):
            for k, v in params.items():
                self.params[k].copy_(v)
            for dst, src in zip(tensors_of(self.scene), tensors_of(scene)):
                dst.copy_(src)
            self.target.copy_(target)
        with telemetry.span("grad.replay"):
            self.graph.replay()
        cuda_trace.count_replay(self.recorded)
        with telemetry.span("grad.outputs"):
            return self.loss.clone(), {k: g.clone()
                                       for k, g in self.grads.items()}

    def release(self) -> None:
        self.graph.reset()
        self.params = self.scene = self.px = self.target = None
        self.loss = self.grads = self.first = None


def train_step(params: dict, scene: SceneData, meta: SceneMeta, camera,
               cfg: RenderConfig, target, lr: float = 0.1, group=None,
               device=None):
    """One SGD step on the trainable material columns -> (new params,
    loss).  (``TrainState`` with Adam below is the optimizer a fit
    uses.)"""
    loss, grads = loss_and_grads(params, scene, meta, camera, cfg, target,
                                 group=group, device=device)
    return {k: params[k].to(grads[k].device) - lr * grads[k]
            for k in params}, loss


# ---------------------------------------------------------------------------
# Adam training state with checkpoint/resume
# ---------------------------------------------------------------------------

ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8


@dataclasses.dataclass
class TrainState:
    """Adam state of the differentiable pass: the params, optax's
    ``ScaleByAdamState`` (an int32 ``count`` and the moments ``mu`` and
    ``nu``, dicts like the params), the step and the learning rate.

    ``save`` writes the JAX package's layout (``step``, ``lr`` and
    ``leaf_0..leaf_18``: the params in sorted key order, the count, ``mu``
    and ``nu`` in the same order, as ``jax.tree.flatten`` orders
    ``(params, optax.adam(lr).init(params))``), so either package resumes
    the other's checkpoint; a resume lands on the uninterrupted
    trajectory."""
    params: dict
    count: torch.Tensor
    mu: dict
    nu: dict
    step: int
    lr: float

    def leaves(self) -> list:
        keys = sorted(self.params)
        return ([self.params[k] for k in keys] + [self.count]
                + [self.mu[k] for k in keys] + [self.nu[k] for k in keys])

    def save(self, path: str) -> None:
        arrs = {f"leaf_{i}": x.detach().cpu().numpy()
                for i, x in enumerate(self.leaves())}
        tmp = path + ".tmp.npz"
        np.savez(tmp, step=self.step, lr=self.lr, **arrs)
        os.replace(tmp, path)

    @staticmethod
    def load(path: str, scene: SceneData, lr: float | None = None,
             device=None) -> "TrainState":
        """The state saved at ``path``; ``scene`` gives the columns and
        their shapes, ``lr`` overrides the saved rate."""
        dev = resolve_device(device)
        with np.load(path, allow_pickle=False) as z:
            lr_ = float(z["lr"]) if lr is None else lr
            keys = sorted(TRAINABLE_COLUMNS)
            n = len(keys)
            if len(z.files) != 3 * n + 3:
                raise ValueError(f"{path}: expected {3 * n + 1} leaves")
            leaf = [torch.from_numpy(np.array(z[f"leaf_{i}"])).to(dev)
                    for i in range(3 * n + 1)]
            step = int(z["step"])
        template = extract_params(scene)
        for k, x in zip(keys, leaf[:n]):
            if x.shape != template[k].shape:
                raise ValueError(f"{path}: {k} has shape {tuple(x.shape)}, "
                                 f"the scene {tuple(template[k].shape)}")
        return TrainState(params=dict(zip(keys, leaf[:n])),
                          count=leaf[n].to(torch.int32),
                          mu=dict(zip(keys, leaf[n + 1:2 * n + 1])),
                          nu=dict(zip(keys, leaf[2 * n + 1:])),
                          step=step, lr=lr_)


def make_train_state(scene: SceneData, lr: float = 0.05,
                     device=None) -> TrainState:
    dev = resolve_device(device)
    params = {k: v.to(dev) for k, v in extract_params(scene).items()}
    return TrainState(
        params=params,
        count=torch.zeros((), dtype=torch.int32, device=dev),
        mu={k: torch.zeros_like(v) for k, v in params.items()},
        nu={k: torch.zeros_like(v) for k, v in params.items()},
        step=0, lr=lr)


def _adam_update(state: TrainState, grads: dict) -> TrainState:
    """optax.adam(lr) on ``grads``, in its order of operations:
    scale_by_adam (b1 0.9, b2 0.999, eps 1e-8, eps_root 0, bias
    correction by 1 - b**count) then scale_by_learning_rate (x -lr), then
    apply_updates (p + u).  Span ``train.adam``."""
    with telemetry.span("train.adam"):
        count = state.count + 1
        c1 = 1 - ADAM_B1 ** count.to(torch.float32)
        c2 = 1 - ADAM_B2 ** count.to(torch.float32)
        params, mu, nu = {}, {}, {}
        for k, p in state.params.items():
            g = grads[k]
            mu[k] = (1 - ADAM_B1) * g + ADAM_B1 * state.mu[k]
            nu[k] = (1 - ADAM_B2) * g ** 2 + ADAM_B2 * state.nu[k]
            u = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + ADAM_EPS)
            params[k] = p + u * -state.lr
        return TrainState(params=params, count=count, mu=mu, nu=nu,
                          step=state.step + 1, lr=state.lr)


def train_step_adam(state: TrainState, scene: SceneData, meta: SceneMeta,
                    camera, cfg: RenderConfig, target, group=None,
                    device=None):
    """One Adam step on the trainable material columns -> (new state,
    loss).  The gradients are all-reduced inside ``loss_and_grads``, so
    every rank applies the same update to the same state.  Span
    ``train.step``, the root of the step's spans."""
    with telemetry.span("train.step"):
        loss, grads = loss_and_grads(state.params, scene, meta, camera, cfg,
                                     target, group=group, device=device)
        return _adam_update(state, grads), loss
