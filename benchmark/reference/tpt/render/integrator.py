"""The pt / nee / mis integrator: a frozen copy of the port's plain path.

Copied from ``tpu_pathtracer_torch/render/integrator.py`` when the
benchmark was defined, with the CUDA-graph classes and the render loops
that drive them left out: what is here is the per-sample math
(``trace_sample``, the lockstep form the differentiable pass runs) and one
regenerative wavefront step (``_wavefront_init``, ``_wavefront_step``)
exactly as the program runs them, with the sampler dimension layout

  dim 0: hero-wavelength u;  dims 1-2: film uv;
  per bounce b: base = 3 + 10*b --
    +0 uc (lobe decision), +1..2 uv2 (lobe 2-D), +3 uc2 / +4 uc3 (further
    lobe decisions), +5 nee light u, +6 nee s, +7..8 nee uv,
    +9 russian roulette.

The traversal under it is the reference's own (``ops/trace.py``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..ops import trace
from ..scene.types import check_ported
from ..spectrum import grid as sgrid
from ..spectrum import sampled as swl
from ..utils.vec import (S4, V3, dot3, from_frame, make_frame, sel, smap,
                         to_frame)
from . import bsdf as bsdf_mod
from . import env as env_mod
from . import film as film_mod
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
    # trace_sample stops bouncing once every lane is dead, a host read per
    # bounce (its captured form reads nothing: trace_sample's host_exit);
    # False runs all max_depth bounces (the differentiable pass).  The
    # wavefront ignores it
    early_exit: bool = True
    # watertight (Dekker-compensated shear) hit test for every traced ray;
    # None means False
    precise: bool | None = None


class RenderStats(NamedTuple):
    n_rays: int      # traced rays: camera + continuation + NEE shadow rays
    n_steps: int     # wavefront steps run (each traces once, NEE once)


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


def _v3_stack(v: V3):
    return torch.stack([v.x, v.y, v.z], -1)


def trace_sample(scene, meta, camera, cfg: RenderConfig, sampler, pixel_xy,
                 sample_idx, with_ray_count: bool = False,
                 host_exit: bool = True):
    """Trace one spectral sample for every pixel in lockstep -> rgb (R, 3).

    The albedo and normal strategies return their AOV at the first hit.
    with_ray_count: also return the number of rays traced (camera +
    continuation + NEE shadow rays), an int64 scalar tensor.
    With ``cfg.early_exit`` the bounce loop stops once every lane is dead,
    by a host read per bounce; ``host_exit=False`` (the form a CUDA graph
    captures) runs every bounce instead and keeps the wavelengths of a
    bounce that no lane entered alive (a dead lane's dispersive glass hit
    would collapse them), the one state of such a bounce that reaches the
    film: the film and rays are the early-exit loop's."""
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
    n_rays = torch.full((), r, dtype=torch.int64, device=dev)

    depth = 0
    while depth < cfg.max_depth and (not cfg.early_exit or not host_exit
                                     or bool(alive.any())):
        base = 3 + DIMS_PER_BOUNCE * depth
        frame = make_frame(it.shading_n, it.tangent)
        wo_t = to_frame(frame, it.wo)

        uc = sampler.get_1d(pixel_xy, sample_idx, base)
        uv2 = sampler.get_2d(pixel_xy, sample_idx, base + 1)
        uc2 = sampler.get_1d(pixel_xy, sample_idx, base + 3)
        uc3 = sampler.get_1d(pixel_xy, sample_idx, base + 4)
        ms = bsdf_mod.sample_material(scene, meta, it, frame, wo_t, uc, uv2,
                                      wl, uc2=uc2, uc3=uc3)
        if cfg.early_exit and not host_exit:
            wl = wl._replace(pdf=sel(alive.any(), ms.wl.pdf, wl.pdf))
        else:
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
            n_rays = n_rays + nee_it.valid.sum()

        # BSDF-sampled continuation ray
        wi = from_frame(frame, ms.wi_t)
        next_o = _offset_origin(it.position, it.geo_n, wi)
        cont = alive & ms.sampled & (ms.pdf > 0.0)
        n_rays = n_rays + cont.sum()
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
        depth += 1

    rgb = _v3_stack(film_mod.spectral_to_rgb(
        radiance, wl, gamut=_out_gamut(cfg), exposure=cfg.exposure))
    if with_ray_count:
        return rgb, n_rays
    return rgb


def _wavefront_init(r: int, spp_start: int, accum):
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
        n_rays=torch.zeros((), dtype=torch.int64, device=dev),
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
    n_rays = s["n_rays"] + tracing.sum()

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
        radiance = _madd(radiance, tracing & ~it.valid,
                         thr_emit * env_l * w_env)

    # ---- continue from this vertex? -------------------------------------
    alive = valid & bsdf_mod.is_bsdf_material(scene, it) & ~last_seg

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
        n_rays = n_rays + nee_it.valid.sum()

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
        n_rays=n_rays,
    )


def _tile_done(state, spp_end) -> bool:
    """Every lane idle with no sample left: the one host read of a chunk."""
    done = ~state["tracing"] & (state["sample"] + 1 >= spp_end)
    return bool(done.all())
