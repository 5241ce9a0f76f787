"""Path-tracing integrators: PT / NEE / MIS and the albedo / normal AOVs.

Counterpart of ``tpu_pathtracer/render/integrator.py``.  The pt, nee and
mis strategies render through the regenerative wavefront
(``_wavefront_init``, ``_wavefront_step``, ``_wavefront_film``): each lane
(pixel) carries its own (sample, depth) cursor, and when a path dies the
lane starts its pixel's next sample in the next step, so lanes stay
occupied until the tail.  It renders every forward path film: the full
grid (``render_accum``), a rank's block of pixels
(``parallel.render_sharded``) and the rays of one sample
(``count_rays_one_spp``, from its own counts).  ``trace_sample`` is the
lockstep form (every lane on the same sample and depth, every
``max_depth`` bounce run): it renders the AOVs, which end at the first
hit, and the differentiable pass, whose backward autograd takes in
lockstep; its film equals the wavefront's up to rounding.  The per-sample
math and the sampler dimension layout are those of the JAX package:

  dim 0: hero-wavelength u;  dims 1-2: film uv;
  per bounce b: base = 3 + 10*b --
    +0 uc (lobe decision), +1..2 uv2 (lobe 2-D), +3 uc2 / +4 uc3 (further
    lobe decisions), +5 nee light u, +6 nee s, +7..8 nee uv,
    +9 russian roulette.

The JAX package runs the steps of a tile inside one device program
(``_wavefront_chunk``), compiled once per configuration.  Here, on a CUDA
device, ``_wavefront_film`` replays one step captured as a CUDA graph
(``_StepGraph``) over static buffers (the tile's pixels, the state and
the last sample ``spp_end``), a chunk of ``SYNC_EVERY`` steps at a time
(``_wavefront_chunk``); the host reads the tile's all-done flag after
each chunk and copies nothing to the device inside one.  The graph is
kept from call to call with a copy of the scene (``_WavefrontGraph``,
slot "wavefront" of ``graphs``, keyed on the configuration and the
tile's lane count), so a repeat render and every progressive chunk of a
configuration replay it.  On the CPU, which has no graphs, the steps run
as eager ops (``_render_tile_eager``, also the graph's plain version on
the card).  Steps after a tile is done change nothing (no lane
regenerates, traces or finalizes), so both give the same film, rays and
steps.  The AOVs run as eager ops on every device.

Strategy bookkeeping: pt counts every emissive hit; nee counts emissive
hits only after specular bounces (the camera ray counts as one) and adds
unweighted NEE; mis weights both by the balance heuristic.  A ray that
escapes picks up the environment's radiance: every escape under pt and
(MIS-weighted) mis, the camera ray's alone under nee.  With pt no shadow
ray is traced.  ``cfg.precise`` selects the watertight hit test
for every traced ray (None means False; no environment variable is read).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .. import telemetry
from ..device import resolve_device
from ..ops import cuda_trace, trace
from ..scene.types import LIGHT_ENV, check_ported, tensors_of
from ..spectrum import grid as sgrid
from ..spectrum import sampled as swl
from ..utils.vec import (S4, V3, dot3, from_frame, make_frame, sel, smap,
                         to_frame)
from . import bsdf as bsdf_mod
from . import env as env_mod
from . import film as film_mod
from . import graphs as graphs_mod
from . import lights as lights_mod
from .sampler import make_sampler
from .surface import make_interaction

RAY_EPS = 1.0e-5
DIMS_PER_BOUNCE = 10
BIG_T = 3.0e38
# wavefront steps between host reads of a tile's all-done flag
SYNC_EVERY = 8


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int
    height: int
    spp: int = 64
    max_depth: int = 16
    strategy: str = "mis"          # pt | nee | mis | albedo | normal
    sampler: str = "sobol"         # random | sobol
    seed: int = 0
    exposure: float = 1.0
    tone_map: str = "reinhard"
    eotf: str = "srgb"
    gamut: str = "srgb"
    tile_rays: int = 1 << 18       # lanes per wavefront tile
    # watertight (Dekker-compensated shear) hit test for every traced ray;
    # None means False
    precise: bool | None = None


class RenderStats(NamedTuple):
    n_rays: int      # traced rays: camera + continuation + NEE shadow rays
    n_steps: int     # wavefront steps run (each traces once, NEE once)
    n_closest: int   # of n_rays, the closest-hit (camera, continuation)
    n_shadow: int    # of n_rays, the NEE shadow rays (any hit)
    # lanes whose material sample the step uses, and the lanes the
    # material kinds' samples ran over (kinds x tile lanes x steps)
    n_shaded: int = 0
    bsdf_lanes: int = 0
    # with an environment light (0 without): traced rays that escaped to
    # it, NEE shadow rays sent to it, and the lanes each of its lookups
    # ran over (tile lanes x steps)
    n_escape: int = 0
    n_env_nee: int = 0
    env_lanes: int = 0


PATH_STRATEGIES = ("pt", "nee", "mis")
AOV_STRATEGIES = ("albedo", "normal")


def _check_config(cfg: RenderConfig) -> None:
    if cfg.strategy not in PATH_STRATEGIES + AOV_STRATEGIES:
        raise ValueError(f"unknown strategy {cfg.strategy!r}")
    if cfg.sampler not in ("random", "sobol"):
        raise ValueError(f"unknown sampler {cfg.sampler!r}")


def _out_gamut(cfg):
    from .. import color
    return color.by_name(cfg.gamut)


def _spectral_table(scene):
    """(470, 3+K): CIE CMFs (cols 0..2) + the scene's spectra bank."""
    return torch.cat([film_mod.cmf_table(scene.device),
                      scene.spectra.T.to(torch.float32)], dim=1)


def _pixel_grid(width, height, device):
    ys, xs = torch.meshgrid(torch.arange(height, device=device),
                            torch.arange(width, device=device), indexing="ij")
    return torch.stack([xs.reshape(-1), ys.reshape(-1)], -1).to(torch.int32)


def _offset_origin(position: V3, geo_n: V3, direction: V3) -> V3:
    """Signed-normal offset + forward epsilon."""
    sign = torch.where(dot3(geo_n, direction) < 0.0, -RAY_EPS, RAY_EPS)
    return position + geo_n * sign + direction * RAY_EPS


def _madd(acc: S4, mask, term: S4) -> S4:
    """acc + where(mask, term, 0) over S4 lanes."""
    return S4(*(a + torch.where(mask, t, 0.0)
                for a, t in zip(acc.lanes, term.lanes)))


def _s4_zeros(r, device):
    z = torch.zeros(r, device=device)
    return S4(z, z, z, z)


# lanes (pixel-samples) of a tile at most
CALL_PATH_BUDGET = 1 << 18


def tile_lanes(cfg: RenderConfig) -> int:
    """Lanes (pixels) per tile of the full grid."""
    return min(cfg.tile_rays, cfg.width * cfg.height, CALL_PATH_BUDGET)


def _tiles(cfg, pixels, accum_init, device):
    """``pixels`` (the full grid where None) and their film ``accum_init``
    (zeros where None) in tiles of min(``tile_lanes``, len(pixels)) lanes,
    the last padded with copies of pixel (0, 0) and zero film -> (tile
    lanes, len(pixels), padded pixels, padded film)."""
    if pixels is None:
        pixels = _pixel_grid(cfg.width, cfg.height, device)
    n_px = pixels.shape[0]
    tile = min(tile_lanes(cfg), n_px)
    pad = (-n_px) % tile
    film = torch.zeros((n_px + pad, 3), device=device)
    if accum_init is not None:
        film[:n_px] = torch.as_tensor(accum_init, dtype=torch.float32,
                                      device=device)
    if pad:
        pixels = torch.cat([pixels, pixels.new_zeros((pad, 2))], 0)
    return tile, n_px, pixels, film


def _v3_stack(v: V3):
    return torch.stack([v.x, v.y, v.z], -1)


def trace_sample(scene, meta, camera, cfg: RenderConfig, sampler, pixel_xy,
                 sample_idx):
    """Trace one spectral sample for every pixel in lockstep -> rgb (R, 3).

    The albedo and normal strategies return their AOV at the first hit;
    pt, nee and mis run all ``max_depth`` bounces (a lane that died adds
    nothing more), with no host read."""
    r = pixel_xy.shape[0]
    dev = pixel_xy.device
    strategy = cfg.strategy
    precise = bool(cfg.precise)

    u_l = sampler.get_1d(pixel_xy, sample_idx, 0)
    wl = swl.sample_uniform(u_l)
    wl = wl._replace(bank=sgrid.lambda_slice_bank(_spectral_table(scene),
                                                  wl.lam))
    uv_film = sampler.get_2d(pixel_xy, sample_idx, 1)
    ray_o, ray_d, weight = camera.generate_rays(pixel_xy, uv_film)
    throughput = S4(weight, weight, weight, weight)
    radiance = _s4_zeros(r, dev)

    ray_o = ray_o + ray_d * RAY_EPS
    hit = trace.intersect_scene(scene, ray_o, ray_d, BIG_T, precise=precise)
    it = make_interaction(scene, hit, ray_o, ray_d)

    # camera-ray miss -> environment radiance
    if meta.has_env:
        env_l = env_mod.env_radiance(scene, wl, ray_d)
        radiance = _madd(radiance, ~it.valid, throughput * env_l)

    # first-hit emissive
    le = bsdf_mod.emitted_radiance(scene, meta, it, wl)
    radiance = _madd(radiance, it.valid, throughput * le)

    if strategy == "albedo":
        # albedo AOV: reflectance x D65 white (spectra-bank row 0)
        alb = bsdf_mod.sample_albedo(scene, meta, it, wl)
        mask = it.valid & bsdf_mod.is_bsdf_material(scene, it)
        aov = smap(lambda x: torch.where(mask, x, 0.0),
                   alb * wl.bank.spectra[0])
        return _v3_stack(film_mod.spectral_to_rgb(
            aov, wl, gamut=_out_gamut(cfg), exposure=cfg.exposure))
    if strategy == "normal":
        return _v3_stack(smap(
            lambda x: torch.where(it.valid, x * 0.5 + 0.5, 0.0),
            it.shading_n))

    alive = it.valid & bsdf_mod.is_bsdf_material(scene, it)

    for depth in range(cfg.max_depth):
        base = 3 + DIMS_PER_BOUNCE * depth
        frame = make_frame(it.shading_n, it.tangent)
        wo_t = to_frame(frame, it.wo)

        uc = sampler.get_1d(pixel_xy, sample_idx, base)
        uv2 = sampler.get_2d(pixel_xy, sample_idx, base + 1)
        uc2 = sampler.get_1d(pixel_xy, sample_idx, base + 3)
        uc3 = sampler.get_1d(pixel_xy, sample_idx, base + 4)
        ms = bsdf_mod.sample_material(scene, meta, it, frame, wo_t, uc, uv2,
                                      wl, uc2=uc2, uc3=uc3)
        wl = ms.wl

        # NEE at non-specular vertices
        if strategy in ("nee", "mis"):
            u_light = sampler.get_1d(pixel_xy, sample_idx, base + 5)
            u_s = sampler.get_1d(pixel_xy, sample_idx, base + 6)
            u_uv = sampler.get_2d(pixel_xy, sample_idx, base + 7)
            nee_it = it._replace(valid=alive & ms.sampled & ~ms.specular)
            nee = lights_mod.evaluate_nee(scene, meta, nee_it, frame, wo_t,
                                          wl, u_light, u_s, u_uv,
                                          with_mis=(strategy == "mis"),
                                          precise=precise)
            radiance = _madd(radiance, nee_it.valid,
                             throughput * nee.contribution * nee.mis_weight)

        # BSDF-sampled continuation ray
        wi = from_frame(frame, ms.wi_t)
        next_o = _offset_origin(it.position, it.geo_n, wi)
        cont = alive & ms.sampled & (ms.pdf > 0.0)
        hit2 = trace.intersect_scene(scene, next_o, wi, BIG_T, active=cont,
                                     precise=precise)
        it2 = make_interaction(scene, hit2, next_o, wi)

        inv_pdf = torch.where(ms.pdf > 0.0,
                              1.0 / torch.where(ms.pdf > 0.0, ms.pdf, 1.0),
                              0.0)
        f_over_pdf = ms.f * inv_pdf

        # emissive radiance of the next hit
        le2 = bsdf_mod.emitted_radiance(scene, meta, it2, wl)
        emit_contrib = throughput * f_over_pdf * le2
        if strategy == "pt":
            w_emit = torch.ones_like(ms.pdf)
        elif strategy == "nee":
            w_emit = torch.where(ms.specular, 1.0, 0.0)
        else:
            pdf_light = lights_mod.pdf_light_for_hit_pos(
                scene, meta, it.position, it2, wl)
            w_emit = torch.where(ms.specular, 1.0,
                                 lights_mod._balance(ms.pdf, pdf_light))
        radiance = _madd(radiance, cont & it2.valid, emit_contrib * w_emit)

        # BSDF-sampled escape to the environment
        if meta.has_env and strategy in ("pt", "mis"):
            env_l = env_mod.env_radiance(scene, wl, wi)
            if strategy == "pt":
                w_env = torch.ones_like(ms.pdf)
            else:
                pdf_env = lights_mod.pdf_env_for_direction(scene, meta, wl,
                                                           wi)
                w_env = torch.where(ms.specular, 1.0,
                                    lights_mod._balance(ms.pdf, pdf_env))
            radiance = _madd(radiance, cont & ~it2.valid,
                             throughput * f_over_pdf * env_l * w_env)

        throughput = sel(cont, throughput * f_over_pdf, throughput)
        alive = cont & it2.valid & bsdf_mod.is_bsdf_material(scene, it2)

        # russian roulette
        p_rr = swl.max_value(throughput)
        u_rr = sampler.get_1d(pixel_xy, sample_idx, base + 9)
        survive = (p_rr >= 1.0) | (u_rr < p_rr)
        throughput = sel(p_rr < 1.0,
                         throughput * (1.0 / torch.clamp(p_rr, min=1e-12)),
                         throughput)
        alive = alive & survive
        it = it2

    return _v3_stack(film_mod.spectral_to_rgb(
        radiance, wl, gamut=_out_gamut(cfg), exposure=cfg.exposure))


def _accum_chunk(scene, meta, camera, cfg, sampler, chunk_spp, px_tile,
                 spp_base, accum):
    """accum + the linear-RGB estimates of chunk_spp samples of one tile,
    as eager ops."""
    for i in range(chunk_spp):
        accum = accum + trace_sample(scene, meta, camera, cfg, sampler,
                                     px_tile, spp_base + i)
    return accum


# the device counts a wavefront state carries, each summed over the lanes
# of every step: closest-hit rays, shadow rays, lanes shaded by a BSDF
# material; rays that escaped to the environment light and shadow rays
# sent to it (``_counts_of``: only where the scene has one)
COUNTS = ("n_closest", "n_shadow", "n_shaded", "n_escape", "n_env_nee")


def _counts_of(meta, cfg) -> tuple:
    """The counts the wavefront state carries for this scene and
    strategy: a scene without an environment light counts nothing of it."""
    counts = COUNTS[:3]
    if meta.has_env:
        counts += ("n_escape",)
        if cfg.strategy != "pt" and LIGHT_ENV in meta.light_types:
            counts += ("n_env_nee",)
    return counts


def _wavefront_init(r: int, spp_start: int, accum, counts=COUNTS[:3]):
    """A tile's state before its first step, with the device counts
    ``counts`` at 0 (the step adds to those the state has)."""
    dev = accum.device

    def zeros():
        return torch.zeros(r, device=dev)

    def s4z():
        return S4(zeros(), zeros(), zeros(), zeros())

    return dict(
        sample=torch.full((r,), spp_start - 1, dtype=torch.int32, device=dev),
        depth=torch.zeros(r, dtype=torch.int32, device=dev),
        tracing=torch.zeros(r, dtype=torch.bool, device=dev),
        last_seg=torch.zeros(r, dtype=torch.bool, device=dev),
        is_cam=torch.zeros(r, dtype=torch.bool, device=dev),
        prev_spec=torch.zeros(r, dtype=torch.bool, device=dev),
        prev_pdf=zeros(),
        prev_pos=V3(zeros(), zeros(), zeros()),
        ray_o=V3(zeros(), zeros(), zeros()),
        ray_d=V3(zeros() + 1.0, zeros() + 1.0, zeros() + 1.0),
        lam=S4(*(torch.full((r,), 550.0, device=dev) for _ in range(4))),
        pdf=s4z(),
        throughput=s4z(),
        thr_emit=s4z(),
        radiance=s4z(),
        accum=V3(accum[:, 0] + 0.0, accum[:, 1] + 0.0, accum[:, 2] + 0.0),
        **{k: torch.zeros((), dtype=torch.int64, device=dev)
           for k in counts},
    )


def _wavefront_step(scene, meta, camera, cfg, sampler, px, spp_end, s,
                    table):
    """One wavefront step of the pt / nee / mis integrator over a tile's
    lanes.  ``spp_end``: an int, or a 0-d int32 tensor (the captured
    step's, filled per call); either compares with the int32 sample
    counters in int32."""
    strategy = cfg.strategy
    precise = bool(cfg.precise)

    # ---- regenerate terminated lanes ------------------------------------
    regen = ~s["tracing"] & (s["sample"] + 1 < spp_end)
    sample = torch.where(regen, s["sample"] + 1, s["sample"])
    u_l = sampler.get_1d(px, sample, 0)
    wl_new = swl.sample_uniform(u_l)
    uv_film = sampler.get_2d(px, sample, 1)
    cam_o, cam_d, weight = camera.generate_rays(px, uv_film)
    cam_o = cam_o + cam_d * RAY_EPS

    lam = sel(regen, wl_new.lam, s["lam"])
    pdf_l = sel(regen, wl_new.pdf, s["pdf"])
    ray_o = sel(regen, cam_o, s["ray_o"])
    ray_d = sel(regen, cam_d, s["ray_d"])
    w4 = S4(weight, weight, weight, weight)
    throughput = sel(regen, w4, s["throughput"])
    thr_emit = sel(regen, w4, s["thr_emit"])
    radiance = sel(regen, _s4_zeros(px.shape[0], px.device), s["radiance"])
    depth = torch.where(regen, 0, s["depth"])
    is_cam = torch.where(regen, True, s["is_cam"])
    prev_spec = torch.where(regen, True, s["prev_spec"])
    prev_pdf = torch.where(regen, 0.0, s["prev_pdf"])
    prev_pos = sel(regen, cam_o, s["prev_pos"])
    last_seg = torch.where(regen, False, s["last_seg"])
    tracing = s["tracing"] | regen
    # per-step spectral slice: every later spectral lookup (film CMFs,
    # emission, light power) is a select over it
    wl = swl.SampledWavelengths(lam=lam, pdf=pdf_l,
                                bank=sgrid.lambda_slice_bank(table, lam))

    # ---- trace the in-flight rays (K1, or K3 when precise) --------------
    hit = trace.intersect_scene(scene, ray_o, ray_d, BIG_T, active=tracing,
                                precise=precise)
    it = make_interaction(scene, hit, ray_o, ray_d)
    valid = it.valid & tracing
    counted = {"n_closest": tracing}    # the lanes each count adds

    # ---- emissive radiance of this hit -----------------------------------
    le = bsdf_mod.emitted_radiance(scene, meta, it, wl)
    if strategy == "pt":
        w_emit = torch.ones_like(prev_pdf)
    elif strategy == "nee":
        # only after specular bounces; camera rays count as specular
        w_emit = torch.where(prev_spec, 1.0, 0.0)
    else:
        pdf_light = lights_mod.pdf_light_for_hit_pos(scene, meta, prev_pos,
                                                     it, wl)
        w_emit = torch.where(prev_spec, 1.0,
                             lights_mod._balance(prev_pdf, pdf_light))
    # the traced ray's Le uses the throughput before roulette's boost
    radiance = _madd(radiance, valid, thr_emit * le * w_emit)

    # ---- escape to the environment --------------------------------------
    if meta.has_env:
        env_l = env_mod.env_radiance(scene, wl, ray_d)
        if strategy == "pt":
            w_env = torch.ones_like(prev_pdf)
        elif strategy == "nee":
            # BSDF-sampled escapes are left to NEE; camera misses count
            w_env = torch.where(is_cam, 1.0, 0.0)
        else:
            pdf_env = lights_mod.pdf_env_for_direction(scene, meta, wl,
                                                       ray_d)
            w_env = torch.where(prev_spec, 1.0,
                                lights_mod._balance(prev_pdf, pdf_env))
        counted["n_escape"] = tracing & ~it.valid
        radiance = _madd(radiance, counted["n_escape"],
                         thr_emit * env_l * w_env)

    # ---- continue from this vertex? -------------------------------------
    alive = valid & bsdf_mod.is_bsdf_material(scene, it) & ~last_seg
    counted["n_shaded"] = alive

    frame = make_frame(it.shading_n, it.tangent)
    wo_t = to_frame(frame, it.wo)
    base = 3 + DIMS_PER_BOUNCE * depth                 # per-lane dim window
    uc = sampler.get_1d(px, sample, base)
    uv2 = sampler.get_2d(px, sample, base + 1)
    uc2 = sampler.get_1d(px, sample, base + 3)
    uc3 = sampler.get_1d(px, sample, base + 4)
    ms = bsdf_mod.sample_material(scene, meta, it, frame, wo_t, uc, uv2, wl,
                                  uc2=uc2, uc3=uc3)
    wl = ms.wl

    # ---- NEE at non-specular vertices (K2, or K2p when precise) ---------
    if strategy in ("nee", "mis"):
        u_light = sampler.get_1d(px, sample, base + 5)
        u_s = sampler.get_1d(px, sample, base + 6)
        u_uv = sampler.get_2d(px, sample, base + 7)
        nee_it = it._replace(valid=alive & ms.sampled & ~ms.specular)
        nee = lights_mod.evaluate_nee(scene, meta, nee_it, frame, wo_t, wl,
                                      u_light, u_s, u_uv,
                                      with_mis=(strategy == "mis"),
                                      precise=precise)
        radiance = _madd(radiance, nee_it.valid,
                         throughput * nee.contribution * nee.mis_weight)
        counted["n_shadow"] = nee_it.valid
        if nee.to_env is not None:
            counted["n_env_nee"] = nee.to_env

    # ---- BSDF-sampled continuation --------------------------------------
    wi = from_frame(frame, ms.wi_t)
    next_o = _offset_origin(it.position, it.geo_n, wi)
    cont = alive & ms.sampled & (ms.pdf > 0.0)
    inv_pdf = torch.where(ms.pdf > 0.0,
                          1.0 / torch.where(ms.pdf > 0.0, ms.pdf, 1.0), 0.0)
    new_thr_emit = sel(cont, throughput * ms.f * inv_pdf, throughput)

    # russian roulette decides whether the NEXT hit is the last contributing
    # segment; the 1/p boost applies to the carried throughput only
    p_rr = swl.max_value(new_thr_emit)
    u_rr = sampler.get_1d(px, sample, base + 9)
    survive = (p_rr >= 1.0) | (u_rr < p_rr)
    new_thr = sel(p_rr < 1.0,
                  new_thr_emit * (1.0 / torch.clamp(p_rr, min=1e-12)),
                  new_thr_emit)
    new_last = ~survive | (depth + 1 >= cfg.max_depth)

    # ---- lane bookkeeping -----------------------------------------------
    new_tracing = cont
    finalize = tracing & ~new_tracing
    rgb = film_mod.spectral_to_rgb(radiance, wl, gamut=_out_gamut(cfg),
                                   exposure=cfg.exposure)
    acc = s["accum"]
    accum = V3(acc.x + torch.where(finalize, rgb.x, 0.0),
               acc.y + torch.where(finalize, rgb.y, 0.0),
               acc.z + torch.where(finalize, rgb.z, 0.0))

    return dict(
        sample=sample,
        depth=torch.where(new_tracing, depth + 1, depth),
        tracing=new_tracing,
        last_seg=torch.where(new_tracing, new_last, last_seg),
        is_cam=torch.where(new_tracing, False, is_cam),
        prev_spec=torch.where(new_tracing, ms.specular, prev_spec),
        prev_pdf=torch.where(new_tracing, ms.pdf, prev_pdf),
        prev_pos=sel(new_tracing, it.position, prev_pos),
        ray_o=sel(new_tracing, next_o, ray_o),
        ray_d=sel(new_tracing, wi, ray_d),
        lam=wl.lam,
        pdf=wl.pdf,
        throughput=sel(new_tracing, new_thr, throughput),
        thr_emit=sel(new_tracing, new_thr_emit, thr_emit),
        radiance=radiance,
        accum=accum,
        **{k: s[k] + counted[k].sum() if k in counted else s[k]
           for k in COUNTS if k in s},
    )


def _state_leaves(state) -> list:
    """The tensors of a wavefront state, in the state's key order."""
    out = []
    for v in state.values():
        if isinstance(v, torch.Tensor):
            out.append(v)
        else:
            out.extend(getattr(v, f.name) for f in dataclasses.fields(v))
    return out


def _tile_done(state, spp_end) -> bool:
    """Every lane idle with no sample left: the one host read of a chunk
    (span ``wavefront.done_read``: the host waits for the card there)."""
    with telemetry.span("wavefront.done_read"):
        done = ~state["tracing"] & (state["sample"] + 1 >= spp_end)
        return bool(done.all())


def _render_tile_eager(scene, meta, camera, cfg, sampler, px, spp_start,
                       spp_end, accum, table):
    """One tile's steps as eager ops, the all-done flag read every
    ``SYNC_EVERY`` steps -> (final state, steps run).  The CPU's path, and
    on the card the plain version of the captured step's replays (each
    step in a ``wavefront.replay`` span, as a replay is)."""
    state = _wavefront_init(px.shape[0], spp_start, accum,
                            _counts_of(meta, cfg))
    n_steps = 0
    while spp_start < spp_end:
        for _ in range(SYNC_EVERY):
            with telemetry.span("wavefront.replay"):
                state = _wavefront_step(scene, meta, camera, cfg, sampler,
                                        px, spp_end, state, table)
            n_steps += 1
        if _tile_done(state, spp_end):
            break
    return state, n_steps


class _StepGraph:
    """One wavefront step captured as a CUDA graph.

    The graph reads its static buffers -- the tile's pixels ``px``, the
    state ``state`` and the end of the sample range ``spp_end``, a 0-d
    int32 tensor -- and its last ops copy the new state back into
    ``state``, so each replay is the tile's next step.  Built on the first
    tile: that tile's first step runs eagerly on a side stream (the
    warm-up: it builds the kernels and the sampler's device tables, and
    its launches count as any step's), then the step is captured.  The
    capture launches nothing; each replay adds the wrappers' counts of
    the capture to ``cuda_trace.LAUNCHES`` and ``LANES`` (span
    ``wavefront.replay``: the host's launch).  ``load`` starts another tile
    (of this call or a later one, any sample range); ``release`` frees the
    graph and its memory pool."""

    def __init__(self, scene, meta, camera, cfg, sampler, px, spp_start,
                 spp_end, accum, table):
        self.px = px.clone()
        self.spp_end = torch.full((), spp_end, dtype=torch.int32,
                                  device=px.device)
        self.counts = _counts_of(meta, cfg)
        self.state = _wavefront_init(px.shape[0], spp_start, accum,
                                     self.counts)
        self.leaves = _state_leaves(self.state)

        def step():
            new = _wavefront_step(scene, meta, camera, cfg, sampler, self.px,
                                  self.spp_end, self.state, table)
            for dst, src in zip(self.leaves, _state_leaves(new)):
                dst.copy_(src)

        side = torch.cuda.Stream(device=px.device)
        side.wait_stream(torch.cuda.current_stream(px.device))
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream(px.device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with cuda_trace.captured_launches() as self.recorded:
            with torch.cuda.graph(self.graph):
                step()
        self.steps = 1          # steps of the current tile run so far

    def load(self, px, accum, spp_start: int, spp_end: int) -> None:
        """Start a tile: its pixels, its samples [spp_start, spp_end), its
        initial state."""
        self.px.copy_(px)
        self.spp_end.fill_(spp_end)
        init = _wavefront_init(px.shape[0], spp_start, accum, self.counts)
        for dst, src in zip(self.leaves, _state_leaves(init)):
            dst.copy_(src)
        self.steps = 0

    def replay(self) -> None:
        with telemetry.span("wavefront.replay"):
            self.graph.replay()
        cuda_trace.count_replay(self.recorded)
        self.steps += 1

    def release(self) -> None:
        self.graph.reset()
        self.px = self.spp_end = self.state = self.leaves = None


class _WavefrontGraph:
    """The captured wavefront step of one configuration and tile size: a
    copy of the scene's tensors, whose addresses the capture bakes in and
    into which each call copies its scene's values (``load_scene``), the
    spectral table (a static buffer filled from the scene's spectra at
    each call), the sampler and one ``_StepGraph``, captured on the first
    tile the entry serves.  Kept from call to call in the "wavefront" slot
    of ``graphs`` (``_wavefront_graph``), as ``jax.jit`` keeps
    ``_wavefront_chunk``.  ``release`` frees the graph and the copy."""

    def __init__(self, scene, meta, camera, cfg):
        with torch.no_grad():
            self.scene = scene.map(torch.clone)
            self.table = _spectral_table(self.scene)
        self.args = (meta, camera, cfg, make_sampler(
            cfg.sampler, cfg.seed, cfg.spp, (cfg.width, cfg.height)))
        self.step = None

    def load_scene(self, scene) -> None:
        with torch.no_grad():
            for dst, src in zip(tensors_of(self.scene), tensors_of(scene)):
                dst.copy_(src)
            self.table.copy_(_spectral_table(scene))

    def run_tile(self, px, accum, spp_start: int, spp_end: int) -> _StepGraph:
        """The tile ``px``'s steps over samples [spp_start, spp_end), from
        ``accum``: the captured step replayed until the tile is done."""
        if self.step is None:
            meta, camera, cfg, sampler = self.args
            with telemetry.span("graphs.capture", slot="wavefront"):
                self.step = _StepGraph(self.scene, meta, camera, cfg,
                                       sampler, px, spp_start, spp_end,
                                       accum, self.table)
        else:
            self.step.load(px, accum, spp_start, spp_end)
        while not _wavefront_chunk(self.step):
            pass
        return self.step

    def release(self) -> None:
        if self.step is not None:
            self.step.release()
        self.step = self.scene = self.table = None


def _wavefront_graph(scene, meta, camera, cfg, lanes: int) -> _WavefrontGraph:
    """The kept wavefront step of this configuration and tile of ``lanes``
    lanes (captured anew, the one kept before released, for another), with
    ``scene``'s values copied in (span ``graphs.lookup``)."""
    with telemetry.span("graphs.lookup", slot="wavefront"):
        key = (meta, camera, cfg, scene.device, graphs_mod.shapes_of(scene),
               lanes)
        kept = graphs_mod.keep("wavefront", key, lambda: _WavefrontGraph(
            scene, meta, camera, cfg))
        kept.load_scene(scene)
        return kept


def _wavefront_chunk(graph: _StepGraph) -> bool:
    """Replays of the captured step up to the tile's next multiple of
    ``SYNC_EVERY`` steps (as many as the eager loop runs between its
    reads), then the tile's all-done flag."""
    while True:
        graph.replay()
        if graph.steps % SYNC_EVERY == 0:
            return _tile_done(graph.state, graph.spp_end)


def render_wavefront(scene, meta, camera, cfg: RenderConfig,
                     spp_start: int = 0, spp_end: int | None = None,
                     accum_init=None, with_stats: bool = False):
    """Linear-RGB film sum over samples [spp_start, spp_end) -> (H*W, 3)
    on the scene's device; with ``with_stats`` also a RenderStats.

    On a CUDA device each tile's steps are replays of one step captured
    as a CUDA graph (``_StepGraph``), kept with a copy of the scene for the
    next call of the same configuration, whatever its sample range
    (``graphs.release_graphs`` frees it); on the CPU they run as eager ops
    (``_render_tile_eager``).  The film, rays and steps are the same."""
    _check_config(cfg)
    if cfg.strategy not in PATH_STRATEGIES:
        raise ValueError("the wavefront renders pt, nee and mis; "
                         f"got {cfg.strategy!r}")
    return render_accum(scene, meta, camera, cfg, spp_start=spp_start,
                        spp_end=spp_end, accum_init=accum_init,
                        with_stats=with_stats)


def _wavefront_film(scene, meta, camera, cfg, spp_start, spp_end,
                    accum_init, graphed: bool, pixels=None):
    """The wavefront's tile loop over ``pixels`` (the full grid where None)
    -> (film, RenderStats): each tile's steps replayed from the kept
    captured graph of its lane count (``graphed``, on a CUDA device) or
    run as eager ops (the CPU, and the graph's plain version on the card).
    Span ``wavefront.film``, with the call's rays (``n_closest``,
    ``n_shadow``), steps and the lanes its traversal launches covered
    (``closest_lanes``, ``any_hit_lanes``), the lanes shaded by a BSDF
    material against the lanes the kinds' samples ran over (``n_shaded``,
    ``bsdf_lanes``) and, with an environment light, the escapes to it and
    the NEE lanes sent to it against the lanes its lookups ran over
    (``n_escape``, ``n_env_nee``, ``env_lanes``); a ``wavefront.tile`` span
    for each tile."""
    with telemetry.span("wavefront.film") as film_span:
        lanes0 = cuda_trace.lanes_by_kind()
        dev = scene.device
        spp_end = cfg.spp if spp_end is None else spp_end
        tile, n_px, pixel_xy, ai = _tiles(cfg, pixels, accum_init, dev)

        kept = None
        if graphed and spp_start < spp_end:
            kept = _wavefront_graph(scene, meta, camera, cfg, tile)
        else:
            sampler = make_sampler(cfg.sampler, cfg.seed, cfg.spp,
                                   (cfg.width, cfg.height))
            table = _spectral_table(scene)
        outs = []
        names = _counts_of(meta, cfg)
        sums = [torch.zeros((), dtype=torch.int64, device=dev)] * len(names)
        n_steps = 0
        for k in range(pixel_xy.shape[0] // tile):
            with telemetry.span("wavefront.tile", k=k):
                px_tile = pixel_xy[k * tile:(k + 1) * tile]
                ai_tile = ai[k * tile:(k + 1) * tile]
                if kept is None:
                    state, steps = _render_tile_eager(
                        scene, meta, camera, cfg, sampler, px_tile,
                        spp_start, spp_end, ai_tile, table)
                else:
                    with torch.no_grad(), torch.cuda.device(dev):
                        graph = kept.run_tile(px_tile, ai_tile, spp_start,
                                              spp_end)
                    state, steps = graph.state, graph.steps
                a = state["accum"]
                outs.append(torch.stack([a.x, a.y, a.z], -1))
            sums = [n + state[k] for n, k in zip(sums, names)]
            n_steps += steps
        accum = torch.cat(outs, 0)[:n_px]
        # the one host read of the call
        counts = dict(zip(names, torch.stack(sums).tolist()))
        counts["bsdf_lanes"] = bsdf_mod.n_sampled_kinds(meta) * tile * n_steps
        if meta.has_env:
            counts["env_lanes"] = tile * n_steps
        lanes = cuda_trace.lanes_by_kind()
        film_span.set(n_steps=n_steps, closest_lanes=lanes[0] - lanes0[0],
                      any_hit_lanes=lanes[1] - lanes0[1], **counts)
    return accum, RenderStats(
        n_rays=counts["n_closest"] + counts["n_shadow"], n_steps=n_steps,
        **counts)


def _aov_film(scene, meta, camera, cfg, spp_start, spp_end, accum_init,
              pixels=None):
    """The AOVs' film of ``pixels`` (the full grid where None):
    ``trace_sample`` per (tile, sample), in sample order, as eager ops on
    every device."""
    spp_end = cfg.spp if spp_end is None else spp_end
    tile, n_px, pixel_xy, ai = _tiles(cfg, pixels, accum_init, scene.device)
    sampler = make_sampler(cfg.sampler, cfg.seed, cfg.spp,
                           (cfg.width, cfg.height))
    films = [_accum_chunk(scene, meta, camera, cfg, sampler,
                          spp_end - spp_start, pixel_xy[k:k + tile],
                          spp_start, ai[k:k + tile])
             for k in range(0, pixel_xy.shape[0], tile)]
    return torch.cat(films, 0)[:n_px]


def _film(scene, meta, camera, cfg, spp_start, spp_end, accum_init,
          graphed: bool, pixels=None):
    """The linear-RGB film sum of ``pixels`` (the full grid where None)
    over samples [spp_start, spp_end) -> (film, RenderStats, or None for
    an AOV): pt, nee and mis through the wavefront (``_wavefront_film``),
    the AOVs through ``trace_sample`` (``_aov_film``)."""
    if cfg.strategy in PATH_STRATEGIES:
        return _wavefront_film(scene, meta, camera, cfg, spp_start, spp_end,
                               accum_init, graphed, pixels)
    return _aov_film(scene, meta, camera, cfg, spp_start, spp_end,
                     accum_init, pixels), None


def render_accum(scene, meta, camera, cfg: RenderConfig, spp_start: int = 0,
                 spp_end: int | None = None, accum_init=None,
                 with_stats: bool = False):
    """Linear-RGB film sum over samples [spp_start, spp_end) -> (H*W, 3).

    pt, nee and mis go through the regenerative wavefront (the identical
    film at fewer traced lanes), on a CUDA device as replays of the
    captured step, which is kept for the next call of the same
    configuration (``graphs.release_graphs`` frees it); the AOVs through
    ``trace_sample``.  ``with_stats`` needs a path strategy."""
    _check_config(cfg)
    check_ported(meta)
    if with_stats and cfg.strategy not in PATH_STRATEGIES:
        raise ValueError("ray statistics are kept for pt, nee and mis only")
    film, stats = _film(scene, meta, camera, cfg, spp_start, spp_end,
                        accum_init, graphed=scene.device.type == "cuda")
    return (film, stats) if with_stats else film


def render(scene, meta, camera, cfg: RenderConfig, device=None,
           with_stats: bool = False):
    """Full render -> (H, W, 3) display-encoded image.

    device: None renders on the GPU (raising if there is none); the scene
    is moved there.  With ``with_stats`` also returns a RenderStats.  The
    AOVs skip the tone map, and the normal AOV the EOTF as well."""
    dev = resolve_device(device)
    out = render_accum(scene.to(dev), meta, camera, cfg, with_stats=with_stats)
    accum, stats = out if with_stats else (out, None)
    is_path = cfg.strategy in PATH_STRATEGIES
    img = film_mod.finalize(
        accum, cfg.spp,
        tone_map=cfg.tone_map if is_path else "none",
        eotf=cfg.eotf if is_path or cfg.strategy == "albedo" else "linear")
    img = img.reshape(cfg.height, cfg.width, 3)
    return (img, stats) if with_stats else img


def count_rays_one_spp(scene, meta, camera, cfg: RenderConfig) -> int:
    """Rays traced for sample 0 of every pixel (camera + continuation +
    NEE shadow rays): the wavefront's own counts (``RenderStats.n_rays``)
    over samples [0, 1) with the render's tiling, on a CUDA device replays
    of the configuration's kept step graph; the padded rows (copies of
    pixel (0, 0)) are counted out by an eager run of their own, which
    captures no graph."""
    _check_config(cfg)
    if cfg.strategy not in PATH_STRATEGIES:
        raise ValueError(f"rays are counted for pt, nee and mis only; got "
                         f"{cfg.strategy!r}")
    check_ported(meta)
    return _count_rays(scene, meta, camera, cfg,
                       graphed=scene.device.type == "cuda")


def _count_rays(scene, meta, camera, cfg, graphed: bool) -> int:
    """``count_rays_one_spp`` through the kept step graph (``graphed``) or
    eager ops (the CPU, and the graph's plain version on the card)."""
    _, stats = _wavefront_film(scene, meta, camera, cfg, 0, 1, None, graphed)
    n_pad = -(cfg.width * cfg.height) % tile_lanes(cfg)
    if not n_pad:
        return stats.n_rays
    pad = torch.zeros((n_pad, 2), dtype=torch.int32, device=scene.device)
    _, pad_stats = _wavefront_film(scene, meta, camera, cfg, 0, 1, None,
                                   graphed=False, pixels=pad)
    return stats.n_rays - pad_stats.n_rays
