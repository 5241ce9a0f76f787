"""Port vs JAX: Z-Sobol and random (threefry) draws (bit-exact) and camera
rays.

The same (pixel, sample, dim) inputs, made with numpy from a seed, go
through ``tpu_pathtracer.render.sampler.ZSobolSampler`` / ``RandomSampler``
and their ports; draws must match bit for bit, including per-lane sample
and dim arrays as the regenerative wavefront uses them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pathtracer.render import camera as jcam
from tpu_pathtracer.render import sampler as jsam
from tpu_pathtracer.utils.vec import V2 as JV2
from tpu_pathtracer_torch.render import camera as tcam
from tpu_pathtracer_torch.render import sampler as tsam
from tpu_pathtracer_torch.utils.vec import V2 as TV2


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _inputs(seed, n, res, max_sample, max_dim):
    rng = np.random.default_rng(seed)
    px = np.stack([rng.integers(0, res[0], n), rng.integers(0, res[1], n)],
                  -1).astype(np.int32)
    sample = rng.integers(0, max_sample, n).astype(np.int32)
    dim = rng.integers(0, max_dim, n).astype(np.int32)
    return px, sample, dim


@pytest.mark.parametrize("spp,res", [(4, (1024, 1024)), (2, (32, 24)),
                                     (1, (64, 48)), (64, (1024, 1024)),
                                     (64, (800, 600)), (2, (128, 128))])
def test_zsobol_per_lane_bit_exact(spp, res):
    """get_1d / get_2d with per-lane sample and dim arrays."""
    px, sample, dim = _inputs(spp, 4096, res, spp, 170)
    js = jsam.ZSobolSampler(seed=0, spp=spp, resolution=res)
    ts = tsam.ZSobolSampler(seed=0, spp=spp, resolution=res)
    jpx = jnp.asarray(px)
    tpx = torch.from_numpy(px)
    j1 = js.get_1d(jpx, jnp.asarray(sample), jnp.asarray(dim))
    t1 = ts.get_1d(tpx, torch.from_numpy(sample), torch.from_numpy(dim))
    assert np.array_equal(_bits(j1), _bits(t1.numpy()))
    j2 = js.get_2d(jpx, jnp.asarray(sample), jnp.asarray(dim))
    t2 = ts.get_2d(tpx, torch.from_numpy(sample), torch.from_numpy(dim))
    assert np.array_equal(_bits(j2.x), _bits(t2.x.numpy()))
    assert np.array_equal(_bits(j2.y), _bits(t2.y.numpy()))


@pytest.mark.parametrize("seed", [0, 7])
def test_zsobol_scalar_grid_bit_exact(seed):
    """Scalar (sample, dim) over a (pixel, sample, dim) grid, nonzero seed."""
    res = (32, 24)
    xs, ys = np.meshgrid(np.arange(res[0]), np.arange(res[1]))
    px = np.stack([xs.reshape(-1), ys.reshape(-1)], -1).astype(np.int32)
    js = jsam.ZSobolSampler(seed=seed, spp=8, resolution=res)
    ts = tsam.ZSobolSampler(seed=seed, spp=8, resolution=res)
    for sample in (0, 5):
        for dim in (0, 1, 3, 12, 59):
            j = js.get_1d(jnp.asarray(px), sample, dim)
            t = ts.get_1d(torch.from_numpy(px), sample, dim)
            assert np.array_equal(_bits(j), _bits(t.numpy())), (sample, dim)
            j2 = js.get_2d(jnp.asarray(px), sample, dim)
            t2 = ts.get_2d(torch.from_numpy(px), sample, dim)
            assert np.array_equal(_bits(j2.x), _bits(t2.x.numpy()))
            assert np.array_equal(_bits(j2.y), _bits(t2.y.numpy()))


def test_zsobol_negative_sample_index_matches():
    """Lanes that never regenerate carry sample -1 (uint32 0xFFFFFFFF)."""
    px, _, dim = _inputs(3, 256, (64, 64), 4, 40)
    sample = np.full(256, -1, np.int32)
    js = jsam.ZSobolSampler(seed=0, spp=4, resolution=(64, 64))
    ts = tsam.ZSobolSampler(seed=0, spp=4, resolution=(64, 64))
    j = js.get_1d(jnp.asarray(px), jnp.asarray(sample), jnp.asarray(dim))
    t = ts.get_1d(torch.from_numpy(px), torch.from_numpy(sample),
                  torch.from_numpy(dim))
    assert np.array_equal(_bits(j), _bits(t.numpy()))


def _kernel_reads(op, n):
    """The uint32 words lanes 0..n-1 read from the draw kernel's operand
    ``op``: its pointer arithmetic (the tensor's first element, a stride in
    32-bit words) done on the CPU tensor's storage."""
    if op.tensor is None:
        return torch.full((n,), op.value, dtype=torch.int64)
    words = torch.empty(0, dtype=torch.int32).set_(op.tensor.untyped_storage())
    first = op.tensor.storage_offset() * op.tensor.element_size() // 4
    return words[first + torch.arange(n) * op.stride].long() & 0xFFFFFFFF


def _operand_form(form, values):
    """``values`` ((n,) int64) in one of the forms the call sites pass."""
    n = values.shape[0]
    scalar = int(values[0])
    return {
        "int": scalar,
        "negative_int": -scalar - 1,
        "0d_int32": torch.tensor(scalar, dtype=torch.int32),
        "0d_int64": torch.tensor(-scalar - 1, dtype=torch.int64),
        "one_int64": torch.tensor([scalar], dtype=torch.int64),
        "lanes_int32": values.to(torch.int32),
        "lanes_int64": values,
        "lanes_negative": -values - 1,
        "lanes_strided_int64": torch.stack([values, -values], 1)[:, 0],
        "lanes_sliced_int32": torch.cat([values, values]).to(
            torch.int32)[n // 2:n // 2 + n],
    }[form]


_OPERAND_FORMS = ("int", "negative_int", "0d_int32", "0d_int64", "one_int64",
                  "lanes_int32", "lanes_int64", "lanes_negative",
                  "lanes_strided_int64", "lanes_sliced_int32")


@pytest.mark.parametrize("form", _OPERAND_FORMS)
def test_zsobol_kernel_operands_read_the_plain_lanes(form):
    """Every form of sample index and dimension the call sites pass, and
    int32 / int64 / strided pixels, as the draw kernel's operands: read
    with the kernel's pointer arithmetic they are the plain version's
    32-bit lanes, and the draws of those lanes are the draws of the form,
    at log2_spp even and odd (64 and 2 spp, 800x600 and 128x128).  A CPU
    call launches nothing."""
    from tpu_pathtracer_torch.ops import cuda_trace
    cuda_trace.reset_launch_counts()
    for spp, res in ((64, (800, 600)), (2, (128, 128)), (2, (800, 600)),
                     (64, (128, 128))):
        px, sample, dim = _inputs(spp + res[0], 2048, res, spp, 163)
        n = px.shape[0]
        ts = tsam.ZSobolSampler(seed=2 ** 33 + 5, spp=spp, resolution=res)
        s = _operand_form(form, torch.from_numpy(sample).long())
        d = _operand_form(form, torch.from_numpy(dim).long())
        like = torch.zeros(n, dtype=torch.int64)
        s_op, d_op = tsam.operand(s, n, like.device), tsam.operand(d, n,
                                                                    like.device)
        s_lanes, d_lanes = _kernel_reads(s_op, n), _kernel_reads(d_op, n)
        assert torch.equal(s_lanes, ts._lanes(s, like))
        assert torch.equal(d_lanes, ts._lanes(d, like))
        for pix in (torch.from_numpy(px), torch.from_numpy(px).long(),
                    torch.from_numpy(px).T.contiguous().T,
                    torch.from_numpy(np.repeat(px, 2, 0)).long()[::2]):
            row, col = tsam.pixel_strides(pix)
            x = _kernel_reads(tsam.Operand(pix, row, 0), n)
            y = _kernel_reads(tsam.Operand(pix[:, 1:], row, 0), n)
            assert col == (pix[:, 1:].storage_offset()
                           - pix.storage_offset()) * pix.element_size() // 4
            assert torch.equal(x, pix[:, 0].long() & 0xFFFFFFFF)
            assert torch.equal(y, pix[:, 1].long() & 0xFFFFFFFF)
            a = ts.get_1d(pix, s, d)
            b = ts.get_1d_plain(torch.stack([x, y], 1), s_lanes, d_lanes)
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
            a2 = ts.get_2d(pix, s, d)
            b2 = ts.get_2d_plain(torch.stack([x, y], 1), s_lanes, d_lanes)
            assert torch.equal(a2.x.view(torch.int32), b2.x.view(torch.int32))
            assert torch.equal(a2.y.view(torch.int32), b2.y.view(torch.int32))
    assert cuda_trace.LAUNCHES[tsam.KERNEL_NAME] == 0
    assert cuda_trace.LANES[tsam.KERNEL_NAME] == 0


def test_zsobol_kernel_arguments():
    """The packed permutation codes unpack to the 24 permutations; operands
    of another dtype, shape or device, and pixels not (R, 2), are refused."""
    for p in range(24):
        code = (tsam.PACKED_PERM_CODES[p // 8] >> (8 * (p % 8))) & 0xFF
        assert [(code >> (2 * d)) & 3 for d in range(4)] == \
            list(tsam._PERMUTATIONS[p])
    cpu = torch.device("cpu")
    with pytest.raises(TypeError):
        tsam.operand(torch.zeros(4, dtype=torch.float32), 4, cpu)
    with pytest.raises(TypeError):
        tsam.operand(torch.zeros(4, dtype=torch.int16), 4, cpu)
    with pytest.raises(ValueError):
        tsam.operand(torch.zeros(3, dtype=torch.int32), 4, cpu)
    with pytest.raises(ValueError):
        tsam.operand(torch.zeros(4, dtype=torch.int32), 4, torch.device("meta"))
    with pytest.raises(ValueError):
        tsam.pixel_strides(torch.zeros(4, 3, dtype=torch.int32))
    with pytest.raises(TypeError):
        tsam.pixel_strides(torch.zeros(4, 2, dtype=torch.float32))


@pytest.mark.parametrize("seed", [0, 7])
def test_random_per_lane_bit_exact(seed):
    """get_1d / get_2d with per-lane sample and dim arrays."""
    px, sample, dim = _inputs(seed + 20, 2048, (1024, 1024), 64, 170)
    js = jsam.RandomSampler(seed=seed, spp=64, resolution=(1024, 1024))
    ts = tsam.make_sampler("random", seed, 64, (1024, 1024))
    assert isinstance(ts, tsam.RandomSampler)
    jpx, tpx = jnp.asarray(px), torch.from_numpy(px)
    j1 = js.get_1d(jpx, jnp.asarray(sample), jnp.asarray(dim))
    t1 = ts.get_1d(tpx, torch.from_numpy(sample), torch.from_numpy(dim))
    assert np.array_equal(_bits(j1), _bits(t1.numpy()))
    assert 0.0 <= float(t1.min()) and float(t1.max()) < 1.0
    j2 = js.get_2d(jpx, jnp.asarray(sample), jnp.asarray(dim))
    t2 = ts.get_2d(tpx, torch.from_numpy(sample), torch.from_numpy(dim))
    assert np.array_equal(_bits(j2.x), _bits(t2.x.numpy()))
    assert np.array_equal(_bits(j2.y), _bits(t2.y.numpy()))


@pytest.mark.parametrize("seed", [0, 7])
def test_random_scalar_grid_bit_exact(seed):
    """Scalar (sample, dim) over a (pixel, sample, dim) grid."""
    res = (32, 24)
    xs, ys = np.meshgrid(np.arange(res[0]), np.arange(res[1]))
    px = np.stack([xs.reshape(-1), ys.reshape(-1)], -1).astype(np.int32)
    js = jsam.RandomSampler(seed=seed, spp=8, resolution=res)
    ts = tsam.RandomSampler(seed=seed, spp=8, resolution=res)
    for sample in (0, 5):
        for dim in (0, 1, 12, 59):
            j = js.get_1d(jnp.asarray(px), sample, dim)
            t = ts.get_1d(torch.from_numpy(px), sample, dim)
            assert np.array_equal(_bits(j), _bits(t.numpy())), (sample, dim)
            j2 = js.get_2d(jnp.asarray(px), sample, dim)
            t2 = ts.get_2d(torch.from_numpy(px), sample, dim)
            assert np.array_equal(_bits(j2.x), _bits(t2.x.numpy()))
            assert np.array_equal(_bits(j2.y), _bits(t2.y.numpy()))


def test_threefry_block_known_answer():
    """Threefry-2x32, 20 rounds: the Random123 known-answer vectors."""
    def block(k0, k1, x0, x1):
        t = [torch.tensor([v], dtype=torch.int64) for v in (k0, k1, x0, x1)]
        a, b = tsam._threefry2x32(*t)
        return int(a), int(b)
    assert block(0, 0, 0, 0) == (0x6B200159, 0x99BA4EFE)
    assert block(0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF) == \
        (0x1CB996FC, 0xBB002BE7)
    assert block(0x13198A2E, 0x03707344, 0x243F6A88, 0x85A308D3) == \
        (0xC4923A9C, 0x483DF7A0)


def test_fmix32_and_owen_match():
    rng = np.random.default_rng(11)
    v = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    s = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    tv = torch.from_numpy(v.astype(np.int64))
    ts = torch.from_numpy(s.astype(np.int64))
    assert np.array_equal(np.asarray(jsam._fmix32(jnp.asarray(v))),
                          tsam._fmix32(tv).numpy().astype(np.uint32))
    assert np.array_equal(
        np.asarray(jsam._fast_owen(jnp.asarray(v), jnp.asarray(s))),
        tsam._fast_owen(tv, ts).numpy().astype(np.uint32))


@pytest.mark.parametrize("w,h", [(32, 24), (1024, 1024)])
def test_generate_rays_matches(w, h):
    rng = np.random.default_rng(w)
    n = 2048
    px = np.stack([rng.integers(0, w, n), rng.integers(0, h, n)],
                  -1).astype(np.int32)
    uv = rng.uniform(size=(2, n)).astype(np.float32)
    jc = jcam.default_camera(w, h).look_to((0.0, 3.5, 6.0), (0.0, -1.0, -3.0))
    tc = tcam.default_camera(w, h).look_to((0.0, 3.5, 6.0), (0.0, -1.0, -3.0))
    jo, jd, jw = jc.generate_rays(jnp.asarray(px),
                                  JV2(jnp.asarray(uv[0]), jnp.asarray(uv[1])))
    to, td, tw = tc.generate_rays(torch.from_numpy(px),
                                  TV2(torch.from_numpy(uv[0]),
                                      torch.from_numpy(uv[1])))
    for a, b in ((jd.x, td.x), (jd.y, td.y), (jd.z, td.z), (jo.x, to.x),
                 (jw, tw)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-6)
