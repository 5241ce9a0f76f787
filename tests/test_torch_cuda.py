"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip where there is no GPU (a CUDA kernel has no CPU
mode).  Run them on a machine with an H100 and nvcc:
``python -m pytest tests/test_torch_cuda.py``.  chip_smoke.py holds the
same kernels against the plain versions at the main path's full size.
"""
import dataclasses

import numpy as np
import pytest
import torch

from tpu_pathtracer_torch.ops import cuda_trace
from tpu_pathtracer_torch.ops import trace as ttrace
from tpu_pathtracer_torch.render import sampler as tsam
from tpu_pathtracer_torch.scene import bvh as tbvh
from tpu_pathtracer_torch.scene import mesh as tmesh
from tpu_pathtracer_torch.utils.vec import V3

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def dragon(dev):
    m = tmesh.dragon(n_u=96, n_v=12)
    p = m.positions[m.indices]
    fb = tbvh.build_bvh(p.min(1), p.max(1))
    return ttrace.pack_bvh(fb, p[fb.order]).to(dev)


def _rays(n, seed, dev):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * 3.0
    d = rng.normal(size=(n, 3)) * 0.3 - o
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    act = rng.uniform(size=n) < 0.8
    tmax = rng.uniform(1.0, 5.0, n)

    def v3(a):
        t = torch.tensor(a, dtype=torch.float32, device=dev)
        return V3(t[:, 0], t[:, 1], t[:, 2])
    return (v3(o), v3(d), torch.tensor(act, device=dev),
            torch.tensor(tmax, dtype=torch.float32, device=dev))


def _assert_closest_equal(got, ref):
    """Every output of a closest-hit kernel equals the reference's on
    every ray, bit for bit."""
    for a, b, what in zip(got, ref, ("t", "tri", "b1", "b2", "hit")):
        assert torch.equal(a, b), what


def _assert_counts(counters, rays):
    """The (4,) counters of one launch: sums of node visits and triangle
    tests, each at least its per-ray maximum and at most that maximum
    times the live rays."""
    n_live = int((rays[6] > 0).sum())
    n_visits, tests, max_visits, max_tests = counters.tolist()
    assert 0 < max_visits <= n_visits <= max_visits * n_live
    assert 0 < max_tests <= tests <= max_tests * n_live


def test_closest_hit_kernel_matches_plain(dragon, dev):
    o, d, act, _ = _rays(8192, 0, dev)
    rays = ttrace.pack_rays(o, d, ttrace.BIG_T, act)
    before = cuda_trace.LAUNCHES["closest_hit"]
    counters = torch.zeros(4, dtype=torch.int64, device=dev)
    got = cuda_trace.closest_hit(dragon, rays, counters=counters)
    assert cuda_trace.LAUNCHES["closest_hit"] == before + 1
    ref = cuda_trace.closest_hit_plain(dragon.tri_m12, rays)
    torch.cuda.synchronize()
    _assert_closest_equal(got, ref)
    assert got[4].any() and not got[4][~act].any()
    _assert_counts(counters, rays)


def test_any_hit_kernel_matches_plain_and_counts(dragon, dev):
    o, d, act, tmax = _rays(8192, 1, dev)
    rays = ttrace.pack_rays(o, d, tmax, act)
    counters = torch.zeros(4, dtype=torch.int64, device=dev)
    before = cuda_trace.LAUNCHES["any_hit"]
    got = cuda_trace.any_hit(dragon, rays, counters=counters)
    assert cuda_trace.LAUNCHES["any_hit"] == before + 1
    ref = cuda_trace.any_hit_plain(dragon.tri_m12, rays)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert got.any() and not got[~act].any()
    assert min(counters.tolist()) > 0


def test_closest_hit_precise_kernel_matches_plain(dragon, dev):
    o, d, act, _ = _rays(8192, 3, dev)
    rays = ttrace.pack_rays(o, d, ttrace.BIG_T, act)
    before = cuda_trace.LAUNCHES["closest_hit_precise"]
    counters = torch.zeros(4, dtype=torch.int64, device=dev)
    got = cuda_trace.closest_hit_precise(dragon, rays, counters=counters)
    assert cuda_trace.LAUNCHES["closest_hit_precise"] == before + 1
    ref = cuda_trace.closest_hit_precise_plain(dragon.tri9, rays)
    torch.cuda.synchronize()
    _assert_closest_equal(got, ref)
    assert got[4].any() and not got[4][~act].any()
    _assert_counts(counters, rays)


@pytest.mark.parametrize("precise", [False, True], ids=["fast", "precise"])
def test_any_hit_kernels_on_mixed_rays_match_plain(dragon, dev, precise):
    """K2 (the binary walk) and K2p (the wide team walk) against their
    plain versions, with short, long, zero-length and inactive rays, one
    launch a call; the (4,) counters hold sums and per-ray maxima."""
    o, d, act, tmax = _rays(8192, 5, dev)
    k = torch.arange(8192, device=dev)
    tmax = torch.where(k % 3 == 0, tmax, torch.full_like(tmax, ttrace.BIG_T))
    tmax = torch.where(k % 97 == 0, torch.zeros_like(tmax), tmax)
    rays = ttrace.pack_rays(o, d, tmax, act)
    name = "any_hit_precise" if precise else "any_hit"
    plain, table = ((cuda_trace.any_hit_precise_plain, dragon.tri9)
                    if precise else (cuda_trace.any_hit_plain, dragon.tri_m12))
    want = plain(table, rays)
    assert want.any() and not want.all() and not want[tmax == 0].any()
    c = torch.zeros(4, dtype=torch.int64, device=dev)
    before = cuda_trace.LAUNCHES[name]
    got = getattr(cuda_trace, name)(dragon, rays, counters=c)
    assert cuda_trace.LAUNCHES[name] == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    _assert_counts(c, rays)
    # the team kernels: at most one block a 128 rays, and no more than the
    # card holds at once; the binary walk: one block a 128 rays
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    team = ("closest_hit_precise", "any_hit_precise") if precise \
        else ("closest_hit",)
    for kernel in team:
        info = cuda_trace.launch_info(kernel, 8192)
        assert info["registers"] > 0 and info["blocks_per_sm"] >= 1
        assert info["grid"] == min(8192 // 128, sms * info["blocks_per_sm"])
        assert cuda_trace.launch_info(kernel, 100)["grid"] == 1
    if not precise:
        info = cuda_trace.launch_info("any_hit", 8192)
        assert info["registers"] > 0 and info["grid"] == 8192 // 128


@pytest.mark.parametrize("kernel", ["closest_hit", "closest_hit_precise",
                                    "any_hit", "any_hit_precise"])
@pytest.mark.parametrize("n", [1, 31, 33, 129, 4097])
def test_kernels_small_and_sparse_launches(dragon, dev, kernel, n):
    """Launches smaller than a warp or a block, and ones whose lanes are
    mostly dead, as late wavefront steps make them."""
    o, d, act, tmax = _rays(n, 6 + n, dev)
    sparse = act & (torch.arange(n, device=dev) % 16 == 0)
    kern = getattr(cuda_trace, kernel)
    plain = getattr(cuda_trace, kernel + "_plain")
    table = dragon.tri9 if "precise" in kernel else dragon.tri_m12
    closest = kernel.startswith("closest")
    for active in (torch.ones_like(act), sparse, torch.zeros_like(act)):
        rays = ttrace.pack_rays(o, d, ttrace.BIG_T if closest else tmax,
                                active)
        got = kern(dragon, rays)
        ref = plain(table, rays)
        torch.cuda.synchronize()
        if closest:
            _assert_closest_equal(got, ref)
        else:
            assert torch.equal(got, ref)


@pytest.mark.parametrize("precise", [False, True], ids=["fast", "precise"])
def test_kernels_on_misses_and_axis_shadow_rays(dragon, dev, precise):
    """Traffic the environment-light scenes bring: closest-hit rays that
    miss everything (K1, K3), and shadow rays along the six axes with
    t_max = 3e38 (K2, K2p; zero direction components, an unbounded
    segment), each against its plain version."""
    rng = np.random.default_rng(9)
    n = 8192
    o = rng.normal(size=(n, 3))
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * 3.0
    away = o / np.linalg.norm(o, axis=-1, keepdims=True)

    def v3(a):
        t = torch.tensor(a, dtype=torch.float32, device=dev)
        return V3(t[:, 0], t[:, 1], t[:, 2])
    act = torch.ones(n, dtype=torch.bool, device=dev)
    rays = ttrace.pack_rays(v3(o), v3(away), ttrace.BIG_T, act)
    name = "closest_hit_precise" if precise else "closest_hit"
    table = dragon.tri9 if precise else dragon.tri_m12
    got = getattr(cuda_trace, name)(dragon, rays)
    ref = getattr(cuda_trace, name + "_plain")(table, rays)
    torch.cuda.synchronize()
    _assert_closest_equal(got, ref)
    assert not got[4].any()                       # every ray misses

    axes = np.concatenate([np.eye(3), -np.eye(3)])[rng.integers(0, 6, n)]
    start = rng.uniform(-1.5, 1.5, size=(n, 3)) - axes * 2.0
    rays = ttrace.pack_rays(v3(start), v3(axes), 3e38, act)
    assert float(rays[6].min()) > 1e38
    name = "any_hit_precise" if precise else "any_hit"
    got = getattr(cuda_trace, name)(dragon, rays)
    ref = getattr(cuda_trace, name + "_plain")(table, rays)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert 0 < int(got.sum()) < n


def test_any_hit_precise_kernel_matches_plain(dragon, dev):
    o, d, act, tmax = _rays(8192, 4, dev)
    rays = ttrace.pack_rays(o, d, tmax, act)
    before = cuda_trace.LAUNCHES["any_hit_precise"]
    got = cuda_trace.any_hit_precise(dragon, rays)
    assert cuda_trace.LAUNCHES["any_hit_precise"] == before + 1
    ref = cuda_trace.any_hit_precise_plain(dragon.tri9, rays)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert got.any() and not got[~act].any()


def test_precise_watertight_on_shared_diagonal(dev):
    """Axis-aligned rays onto the shared diagonal of a quad: the precise
    kernel hits on every ray."""
    quad = tmesh.quad([-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0])
    p = quad.positions[quad.indices]
    fb = tbvh.build_bvh(p.min(1), p.max(1))
    arrs = ttrace.pack_bvh(fb, p[fb.order]).to(dev)
    s = torch.linspace(-0.999, 0.999, 4096, device=dev)
    o = V3(s, s, torch.ones_like(s))
    d = V3(torch.zeros_like(s), torch.zeros_like(s), -torch.ones_like(s))
    h = ttrace.intersect(arrs, o, d, precise=True)
    assert h.hit.all()


def test_wrapper_checks_inputs(dragon, dev):
    o, d, act, _ = _rays(64, 2, dev)
    rays = ttrace.pack_rays(o, d, 1.0, act)
    replace = dataclasses.replace
    for fn in (cuda_trace.closest_hit, cuda_trace.closest_hit_precise,
               cuda_trace.any_hit_precise):
        with pytest.raises(ValueError):      # the wide rows on the CPU
            fn(replace(dragon, nodes_w=dragon.nodes_w.cpu()), rays)
        # contiguous and 16-byte aligned, but not on a 128-byte line
        flat = torch.zeros(dragon.nodes_w.numel() + 4, device=dev)
        shifted = flat[4:].view_as(dragon.nodes_w).copy_(dragon.nodes_w)
        assert shifted.is_contiguous() and shifted.data_ptr() % 128 == 16
        with pytest.raises(ValueError):
            fn(replace(dragon, nodes_w=shifted), rays)
        with pytest.raises(ValueError):      # more stack than compiled
            fn(replace(dragon, wide_depth=cuda_trace.WIDE_MAX_STACK), rays)
        with pytest.raises(ValueError):
            fn(dragon, rays[:, ::2])
        with pytest.raises(ValueError):      # counters are (4,)
            fn(dragon, rays,
               counters=torch.zeros(2, dtype=torch.int64, device=dev))
    for fn in (cuda_trace.closest_hit_precise, cuda_trace.any_hit_precise):
        with pytest.raises(ValueError):      # the precise kernels take tri9p
            fn(replace(dragon, tri9p=dragon.tri9), rays)
    with pytest.raises(ValueError):
        cuda_trace.any_hit(replace(dragon, nodes_f=dragon.nodes_f.cpu()),
                           rays)
    with pytest.raises(ValueError):
        cuda_trace.any_hit(replace(dragon,
                                   stack_depth=cuda_trace.MAX_STACK + 1), rays)
    with pytest.raises(ValueError):
        cuda_trace.any_hit(dragon, rays[:, ::2])


def _bits_equal(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


# (spp, resolution): the render cells' step, the fit's odd log2_spp, and
# digits whose shift passes 32 bits (a 70,000-pixel-wide film at 8 spp)
@pytest.mark.parametrize("spp,res", [(64, (800, 600)), (2, (128, 128)),
                                     (8, (70000, 3))],
                         ids=["render", "fit", "wide"])
def test_zsobol_draw_kernel_matches_plain(dev, spp, res):
    """The draw kernel against the int64 plain version on the card, bit for
    bit, on 262,144 lanes: per-lane int32 samples (some -1, a lane that
    never regenerated) and dims up to 3 + 10 x 15 + 9, int64 pixels, a 0-d
    int64 sample and python-int samples and dims,
    negative ones included; each call is one launch of its lanes."""
    n = 262_144
    gen = torch.Generator(device=dev).manual_seed(spp + res[0])
    px = torch.stack([torch.randint(0, res[0], (n,), generator=gen,
                                    device=dev),
                      torch.randint(0, res[1], (n,), generator=gen,
                                    device=dev)], 1).to(torch.int32)
    sample = torch.randint(-1, spp, (n,), generator=gen, device=dev,
                           dtype=torch.int32)
    dim = torch.randint(0, 3 + 10 * 15 + 10, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    sm = tsam.ZSobolSampler(seed=2 ** 31 + 17, spp=spp, resolution=res)
    cases = [(px, sample, dim), (px.long(), sample.long(), dim),
             (px, torch.tensor(spp - 1, device=dev), dim),
             (px, torch.tensor(-1, device=dev), 0), (px, -1, dim),
             (px, spp - 1, 1), (px, sample, -3)]
    cuda_trace.reset_launch_counts()
    for k, (p, s, d) in enumerate(cases):
        assert _bits_equal(sm.get_1d(p, s, d), sm.get_1d_plain(p, s, d)), k
        got, want = sm.get_2d(p, s, d), sm.get_2d_plain(p, s, d)
        assert _bits_equal(got.x, want.x) and _bits_equal(got.y, want.y), k
    torch.cuda.synchronize()
    assert cuda_trace.LAUNCHES[tsam.KERNEL_NAME] == 2 * len(cases)
    assert cuda_trace.LANES[tsam.KERNEL_NAME] == 2 * len(cases) * n
    with pytest.raises(ValueError):
        sm.get_1d(px, sample.cpu(), dim)


@pytest.mark.parametrize("precise", [False, True], ids=["fast", "precise"])
def test_loss_and_grads_on_card_match_cpu(dev, precise):
    """The differentiable pass on the card against the CPU's plain
    versions (scene 17, 16x12, 1 spp, depth 3): loss within 1e-3 relative,
    each gradient column within 1e-2 of its largest magnitude, every value
    finite; the call launches the closest-hit kernel 1 + depth times and
    the any-hit kernel depth times (none in the backward)."""
    from tpu_pathtracer_torch import parallel
    from tpu_pathtracer_torch.render.integrator import RenderConfig
    from tpu_pathtracer_torch.scenes import load_scene

    scene, meta, cam = load_scene(17, 16, 12, table_res=16, device="cpu")
    cfg = RenderConfig(width=16, height=12, spp=1, max_depth=3,
                       precise=precise)
    zero = torch.zeros(16 * 12, 3)
    l_cpu, g_cpu = parallel.loss_and_grads(parallel.extract_params(scene),
                                           scene, meta, cam, cfg, zero,
                                           device="cpu")
    names = (("closest_hit_precise", "any_hit_precise") if precise
             else ("closest_hit", "any_hit"))
    before = [cuda_trace.LAUNCHES[k] for k in names]
    on_card = scene.to(dev)
    l_gpu, g_gpu = parallel.loss_and_grads(parallel.extract_params(on_card),
                                           on_card, meta, cam, cfg, zero,
                                           device=dev)
    torch.cuda.synchronize()
    assert [cuda_trace.LAUNCHES[k] - b for k, b in zip(names, before)] == \
        [1 + cfg.max_depth, cfg.max_depth]
    assert float(l_gpu) == pytest.approx(float(l_cpu), rel=1e-3)
    for k, g in g_cpu.items():
        got = g_gpu[k].cpu()
        assert torch.isfinite(got).all(), k
        np.testing.assert_allclose(got.numpy(), g.numpy(), rtol=0,
                                   atol=1e-2 * float(g.abs().max()) + 1e-12,
                                   err_msg=k)


@pytest.mark.parametrize("precise", [False, True], ids=["fast", "precise"])
def test_graph_render_equals_eager_render(dev, precise, monkeypatch):
    """``render_wavefront`` on the card replays one captured step: scene 17
    at 64x48, 2 spp, depth 6, in three tiles of 1,024 lanes (the last one
    padded).  Its film equals the eager step loop's bit for bit, with the
    same rays, steps and kernel launches (each traversal kernel once a
    step, the Z-Sobol draw kernel ten times: MIS makes ten draw calls a
    step); it never runs the eager loop; a second call replays the kept graph and
    does not raise the peak device memory, and after ``release_graphs()``
    the memory in use is what it was before the first call."""
    from tpu_pathtracer_torch.render import graphs
    from tpu_pathtracer_torch.render import integrator as tint
    from tpu_pathtracer_torch.scenes import load_scene

    s, m, c = load_scene(17, 64, 48, table_res=16, device=dev)
    cfg = tint.RenderConfig(width=64, height=48, spp=2, max_depth=6,
                            precise=precise, tile_rays=1024)
    runs = {}
    for graphed in (False, True):
        cuda_trace.reset_launch_counts()
        film, stats = tint._wavefront_film(s, m, c, cfg, 0, None, None,
                                           graphed=graphed)
        torch.cuda.synchronize()
        runs[graphed] = film, stats, {k: v for k, v in
                                      cuda_trace.LAUNCHES.items() if v}
    (f0, st0, l0), (f1, st1, l1) = runs[False], runs[True]
    assert torch.equal(f1, f0)
    assert st1 == st0 and st0.n_steps >= 3 * tint.SYNC_EVERY
    names = (("closest_hit_precise", "any_hit_precise") if precise
             else ("closest_hit", "any_hit"))
    assert l1 == l0 == {**{k: st0.n_steps for k in names},
                        tsam.KERNEL_NAME: 10 * st0.n_steps}

    def no_eager(*a, **k):
        raise AssertionError("the card ran the eager step loop")
    monkeypatch.setattr(tint, "_render_tile_eager", no_eager)
    del runs, f0, f1, film
    graphs.release_graphs()
    torch.cuda.synchronize()
    in_use = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    film = tint.render_wavefront(s, m, c, cfg).cpu()
    torch.cuda.synchronize()
    first = torch.cuda.max_memory_allocated()
    kept = graphs.kept("wavefront")
    again = tint.render_wavefront(s, m, c, cfg).cpu()
    torch.cuda.synchronize()
    assert graphs.kept("wavefront") is kept is not None
    assert torch.cuda.max_memory_allocated() <= first
    assert torch.equal(again, film)
    del kept
    graphs.release_graphs()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == in_use


@pytest.mark.parametrize("precise", [False, True], ids=["fast", "precise"])
def test_kept_wavefront_graph_equals_eager(dev, precise, monkeypatch):
    """The wavefront step graph kept between calls, scene 17 at 64x48,
    4 spp, depth 6, tiles of 1,024 lanes: the first call captures once; a
    second call, a progressive chunk (samples [2, 4) from the eager film
    of [0, 2)) and ``render_progressive`` with chunks of 2 capture
    nothing; every film and ``RenderStats`` equals the eager loop's bit
    for bit, with each kernel launched once a step; a call with the
    dragon's coat tint moved, the scene a new object, gives the eager
    film of the changed scene; ``release_graphs()`` returns the memory in
    use to its level before the first call."""
    from tpu_pathtracer_torch import parallel
    from tpu_pathtracer_torch.render import graphs
    from tpu_pathtracer_torch.render import integrator as tint
    from tpu_pathtracer_torch.render.progressive import render_progressive
    from tpu_pathtracer_torch.scene.types import MAT_CLEARCOAT
    from tpu_pathtracer_torch.scenes import load_scene

    s, m, c = load_scene(17, 64, 48, table_res=16, device=dev)
    cfg = tint.RenderConfig(width=64, height=48, spp=4, max_depth=6,
                            precise=precise, tile_rays=1024)
    names = (("closest_hit_precise", "any_hit_precise") if precise
             else ("closest_hit", "any_hit"))
    captures = []
    real_init = tint._StepGraph.__init__

    def counted_init(self, *a, **k):
        captures.append(1)
        real_init(self, *a, **k)
    monkeypatch.setattr(tint._StepGraph, "__init__", counted_init)

    def film(scene, graphed, start=0, end=None, accum=None):
        return _launched(lambda: tint._wavefront_film(
            scene, m, c, cfg, start, end, accum, graphed=graphed), names)

    (eager, st_e), n_e = film(s, False)
    (half, _), _ = film(s, False, 0, 2)
    (chunk_e, st_ce), n_ce = film(s, False, 2, 4, half)
    assert n_e == [st_e.n_steps] * 2 and n_ce == [st_ce.n_steps] * 2
    graphs.release_graphs()
    torch.cuda.synchronize()
    in_use = torch.cuda.memory_allocated()
    for label, run, ref, n_ref, want in (
            ("first", lambda: film(s, True), (eager, st_e), n_e, 1),
            ("kept", lambda: film(s, True), (eager, st_e), n_e, 0),
            ("chunk", lambda: film(s, True, 2, 4, half), (chunk_e, st_ce),
             n_ce, 0)):
        captures.clear()
        (got, st), n = run()
        assert len(captures) == want, label
        assert torch.equal(got, ref[0]) and st == ref[1], label
        assert n == n_ref, label
    captures.clear()
    img = render_progressive(s, m, c, cfg, chunk_spp=2, device=dev)
    assert captures == []
    ref = tint.render(s, m, c, cfg, device=dev).cpu().numpy()
    np.testing.assert_allclose(img, ref, rtol=1e-4, atol=2e-5)

    row = int(torch.nonzero(s.materials.mat_type == MAT_CLEARCOAT)[0])
    coat = s.materials.coat_tint_coeff.clone()
    coat[row] += 0.5
    changed = parallel.merge_params(s.map(torch.clone),
                                    {"coat_tint_coeff": coat})
    (moved, _), _ = film(changed, True)
    assert captures == []
    assert torch.equal(moved, film(changed, False)[0][0])
    assert not torch.equal(moved, eager)
    del got, moved, changed, coat
    graphs.release_graphs()
    torch.cuda.synchronize()
    assert graphs.kept("wavefront") is None
    assert torch.cuda.memory_allocated() == in_use


def test_env_counts_of_the_kept_graph_equal_the_eager_loops(dev):
    """Scene 19 (four material kinds under a sky) at 64x48, MIS, 2 spp,
    depth 6, tiles of 1,024 lanes: the kept step graph's replays give the
    eager loop's film and every count of ``RenderStats`` (the sky's
    escapes and NEE lanes, the lanes shaded) and of the ``wavefront.film``
    span, the traversal launches' lanes included."""
    from tpu_pathtracer_torch import telemetry
    from tpu_pathtracer_torch.render import graphs
    from tpu_pathtracer_torch.render import integrator as tint
    from tpu_pathtracer_torch.scenes import load_scene

    s, m, c = load_scene(19, 64, 48, table_res=16, device=dev)
    cfg = tint.RenderConfig(width=64, height=48, spp=2, max_depth=6,
                            tile_rays=1024)
    runs = {}
    graphs.release_graphs()
    for graphed in (False, True):
        telemetry.clear()
        with telemetry.recording():
            film, stats = tint._wavefront_film(s, m, c, cfg, 0, None, None,
                                               graphed=graphed)
        (span,) = [sp for sp in telemetry.spans()
                   if sp.name == "wavefront.film"]
        runs[graphed] = film.cpu(), stats, span.attrs
    graphs.release_graphs()
    (f0, st0, a0), (f1, st1, a1) = runs[False], runs[True]
    assert torch.equal(f1, f0) and st1 == st0 and a1 == a0
    assert 0 < st0.n_escape <= st0.n_closest
    assert 0 < st0.n_env_nee == st0.n_shadow       # the sky is the one light
    assert st0.env_lanes == 1024 * st0.n_steps
    assert 0 < st0.n_shaded <= st0.bsdf_lanes == 4 * st0.env_lanes


def _grad_case(dev, precise):
    """Scene 17 at the graph test's size, 2 spp, depth 6: the scene, its
    config, an all-zero target, the parameters, other values of every
    column, and the two kernels a call launches."""
    from tpu_pathtracer_torch import parallel
    from tpu_pathtracer_torch.render.integrator import RenderConfig
    from tpu_pathtracer_torch.scenes import load_scene

    s, m, c = load_scene(17, 64, 48, table_res=16, device=dev)
    cfg = RenderConfig(width=64, height=48, spp=2, max_depth=6,
                       precise=precise)
    params = parallel.extract_params(s)
    other = {k: v * 0.9 + 0.05 for k, v in params.items()}
    names = (("closest_hit_precise", "any_hit_precise") if precise
             else ("closest_hit", "any_hit"))
    return (s, m, c), cfg, torch.zeros(64 * 48, 3, device=dev), params, \
        other, names


def _launched(fn, names):
    cuda_trace.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, [cuda_trace.LAUNCHES[k] for k in names]


@pytest.mark.parametrize("precise", [False, True], ids=["fast", "precise"])
def test_grad_graph_equals_eager(dev, precise):
    """``loss_and_grads`` on the card captures its forward and backward as
    one CUDA graph on the first call (its warm-up is that call's result)
    and replays it after: each call's loss and gradients equal the eager
    program's bit for bit (the gathers' backward sums in a fixed order);
    the launches are exact both ways; a call with other parameter values
    gives that call's eager values, from the same graph; every gradient
    value is finite at both sets of values."""
    from tpu_pathtracer_torch import parallel
    from tpu_pathtracer_torch.render import graphs

    (s, m, c), cfg, zero, params, other, names = _grad_case(dev, precise)
    want = [cfg.spp * (1 + cfg.max_depth), cfg.spp * cfg.max_depth]
    parallel.release_graphs()
    losses, graph = [], None
    for p in (params, params, other):
        (l_e, g_e), n_e = _launched(lambda: parallel._loss_and_grads(
            p, s, m, c, cfg, zero, None, dev, graphed=False), names)
        (l_g, g_g), n_g = _launched(lambda: parallel.loss_and_grads(
            p, s, m, c, cfg, zero, device=dev), names)
        assert n_e == n_g == want
        assert graph is None or graphs.kept("grad") is graph
        graph = graphs.kept("grad")
        assert torch.equal(l_g, l_e) and float(l_g) > 0
        for k, g in g_e.items():
            assert torch.isfinite(g).all(), k
            assert torch.equal(g_g[k], g), k
        losses.append(float(l_g))
    assert losses[0] == losses[1] != losses[2]
    parallel.release_graphs()


def test_grad_graph_cache_and_release(dev):
    """The kept graph: the same configuration is a hit (other parameter
    values too), another ``cfg`` a new capture; ``release_graphs()``
    returns the memory in use to its level before the first call."""
    from tpu_pathtracer_torch import parallel
    from tpu_pathtracer_torch.render import graphs

    (s, m, c), cfg, zero, params, other, _ = _grad_case(dev, False)
    parallel.release_graphs()
    # the eager program builds the per-device tables first
    parallel._loss_and_grads(params, s, m, c, cfg, zero, None, dev,
                             graphed=False)
    torch.cuda.synchronize()
    in_use = torch.cuda.memory_allocated()
    parallel.loss_and_grads(params, s, m, c, cfg, zero, device=dev)
    first = graphs.kept("grad")
    parallel.loss_and_grads(params, s, m, c, cfg, zero, device=dev)
    parallel.loss_and_grads(other, s, m, c, cfg, zero, device=dev)
    assert graphs.kept("grad") is first
    parallel.loss_and_grads(params, s, m, c,
                            dataclasses.replace(cfg, max_depth=5), zero,
                            device=dev)
    assert graphs.kept("grad") is not first
    del first
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() > in_use      # the graph's buffers
    parallel.release_graphs()
    torch.cuda.synchronize()
    assert graphs.kept("grad") is None
    assert torch.cuda.memory_allocated() == in_use


@pytest.mark.parametrize("precise", [False, True], ids=["fast", "precise"])
def test_lockstep_graphs_equal_eager(dev, precise, monkeypatch):
    """The forward films the lockstep sample no longer renders, called as a
    user calls them: scene 17 at 64x40 in tiles of 1,024 lanes.
    ``count_rays_one_spp`` and ``render_sharded``'s image replay the kept
    wavefront step and equal their eager wavefront forms bit for bit, with
    the same launches: the count captures the configuration's step once
    (its 512 padded rows run eagerly), a second count replays it, and the
    sharded film (with no group its block is the grid) replays it too; a
    block of 640 pixels captures its own step in the one slot; the AOVs
    run eagerly and capture nothing; ``release_graphs()`` returns the
    memory in use to its level before the first call."""
    from tpu_pathtracer_torch import parallel
    from tpu_pathtracer_torch.render import graphs
    from tpu_pathtracer_torch.render import integrator as tint
    from tpu_pathtracer_torch.scenes import load_scene

    s, m, c = load_scene(17, 64, 40, table_res=16, device=dev)
    cfg = tint.RenderConfig(width=64, height=40, spp=2, max_depth=6,
                            precise=precise, tile_rays=1024)
    names = (("closest_hit_precise", "any_hit_precise") if precise
             else ("closest_hit", "any_hit"))
    captures = []
    real_init = tint._StepGraph.__init__

    def counted_init(self, scene, meta, camera, cfg, sampler, px, *rest):
        captures.append(px.shape[0])
        real_init(self, scene, meta, camera, cfg, sampler, px, *rest)
    monkeypatch.setattr(tint._StepGraph, "__init__", counted_init)

    block = tint._pixel_grid(64, 40, dev)[:640]
    runs = [
        ("count", lambda g: (tint.count_rays_one_spp(s, m, c, cfg) if g else
                             tint._count_rays(s, m, c, cfg, False)), [1024]),
        ("sharded", lambda g: (
            parallel.render_sharded(s, m, c, cfg, device=dev) if g else
            parallel._render_sharded(s, m, c, cfg, None, dev, graphed=False)),
         []),
        ("block", lambda g: tint._wavefront_film(
            s, m, c, cfg, 0, None, None, graphed=g, pixels=block)[0], [640])]
    albedo = dataclasses.replace(cfg, strategy="albedo")
    # eager calls build the per-device tables first
    tint._count_rays(s, m, c, cfg, False)
    aov = tint._aov_film(s, m, c, albedo, 0, None, None)
    graphs.release_graphs()
    torch.cuda.synchronize()
    in_use = torch.cuda.memory_allocated()
    for label, run, lanes in runs:
        eager, n_e = _launched(lambda: run(False), names)
        captures.clear()
        graph, n_g = _launched(lambda: run(True), names)
        assert captures == lanes, label
        captures.clear()
        again, n_a = _launched(lambda: run(True), names)
        assert captures == [], label
        assert n_g == n_a == n_e and n_e[0] > 0, label
        if label == "count":
            assert graph == again == eager > 64 * 40
        else:
            assert torch.equal(graph, eager), label
            assert torch.equal(again, eager), label
        del graph, again, eager
    assert graphs.kept("wavefront").step.px.shape[0] == 640
    film, n_aov = _launched(lambda: tint.render_accum(s, m, c, albedo), names)
    assert captures == [] and n_aov == [3 * 2, 0]
    assert torch.equal(film, aov)
    del film
    graphs.release_graphs()
    torch.cuda.synchronize()
    assert graphs.kept("wavefront") is None
    assert torch.cuda.memory_allocated() == in_use


@pytest.mark.slow
@pytest.mark.parametrize("sampler", ["random", "sobol"])
@pytest.mark.parametrize("scene_id", [3, 6, 8, 9, 10, 17])
def test_consistency_matrix_on_card(dev, scene_id, sampler):
    """The reference's slow consistency matrix
    (tests/test_consistency_matrix.py's ``test_consistency_matrix``) on
    the port: pt vs nee vs mis at 64x48, 64 spp, depth 8, table_res 32,
    abs_floor 0.035 on scenes 8 and 10, 0.025 on the others, the
    self-calibrated noise gate of a second pt seed (101).  Prints each
    pair's RMSE and the gates (run with ``-s``)."""
    import json

    from tpu_pathtracer_torch import consistency as cons

    abs_floor = 0.035 if scene_id in (8, 10) else 0.025
    rec = cons.check_consistency(scene_id, sampler, *cons.MATRIX_SIZE,
                                 cons.MATRIX_SPP, abs_floor=abs_floor,
                                 device=dev)
    print("consistency_matrix", json.dumps(rec))
    assert not rec["misses"], rec


@pytest.mark.slow
@pytest.mark.parametrize("scene_id", [6, 9, 10])
def test_pt_mean_anchor_on_card(dev, scene_id):
    """The reference's PT-mean anchors (tests/test_consistency_matrix.py's
    ``test_pt_mean_anchors``) of the scenes chip_smoke.py leaves to the
    slow tier: the port's PT mean at 64x48, 128 spp, Sobol, seed 7, depth
    8 within 0.08 + 2 x the anchor's two-seed spread scaled to 128 spp.
    Prints the mean, the anchor and the gate (run with ``-s``)."""
    import json

    from tpu_pathtracer_torch import consistency as cons

    assert scene_id in cons.SLOW_ANCHOR_SCENES
    rec = cons.check_pt_mean_anchor(
        scene_id, cons.load_anchors()[str(scene_id)], device=dev)
    print("pt_mean_anchor", json.dumps(rec))
    assert not rec["misses"], rec
