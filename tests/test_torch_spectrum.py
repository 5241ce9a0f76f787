"""Port vs JAX: spectral data, rgb2spec lookup, wavelength bank, film, color.

Inputs are made with numpy from a seed and fed to both packages; float
results must agree within 1e-6 relative (both run float32; the tolerance
covers last-bit differences of exp/log/pow between XLA and PyTorch).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pathtracer import color as jcolor
from tpu_pathtracer.render import film as jfilm
from tpu_pathtracer.spectrum import cie as jcie
from tpu_pathtracer.spectrum import grid as jgrid
from tpu_pathtracer.spectrum import rgb2spec as jr2s
from tpu_pathtracer.spectrum import sampled as jswl
from tpu_pathtracer.utils.vec import S4 as JS4
from tpu_pathtracer_torch import color as tcolor
from tpu_pathtracer_torch.render import film as tfilm
from tpu_pathtracer_torch.spectrum import cie as tcie
from tpu_pathtracer_torch.spectrum import grid as tgrid
from tpu_pathtracer_torch.spectrum import rgb2spec as tr2s
from tpu_pathtracer_torch.spectrum import sampled as tswl
from tpu_pathtracer_torch.utils.vec import S4 as TS4

RTOL = 1e-6


def _close(t, j, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(t.detach().cpu() if
                                          isinstance(t, torch.Tensor) else t),
                               np.asarray(j), rtol=rtol, atol=atol)


def _s4_close(t, j, **kw):
    for a, b in zip(t.lanes, j.lanes):
        _close(a, b, **kw)


def _rgb(seed, n=2048):
    rng = np.random.default_rng(seed)
    rgb = rng.uniform(-0.1, 1.1, (n, 3)).astype(np.float32)
    rgb[:8] = [[0, 0, 0], [1, 1, 1], [0.5, 0.5, 0.5], [1, 0, 0],
               [0, 1, 0], [0, 0, 1], [0.7, 0.8, 1.0], [0.9, 0.0, 0.0]]
    return rgb


def _lam(seed, n=2048):
    u = np.random.default_rng(seed).uniform(size=n).astype(np.float32)
    return u, jswl.sample_uniform(jnp.asarray(u)), \
        tswl.sample_uniform(torch.from_numpy(u))


def test_cie_tables_equal():
    for name in ("cie_x", "cie_y", "cie_z", "illum_d6500"):
        assert np.array_equal(getattr(tcie, name)(), getattr(jcie, name)())


@pytest.mark.parametrize("res", [16, 64])
def test_lookup_coeffs_matches(res):
    zn, coeffs = jr2s.get_table("srgb", res)
    tzn, tco = tr2s.get_table("srgb", res)
    assert np.array_equal(zn, tzn) and np.array_equal(coeffs, tco)
    rgb = _rgb(res)
    j = jr2s.lookup_coeffs(jnp.asarray(rgb), zn, coeffs)
    t = tr2s.lookup_coeffs(torch.from_numpy(rgb), torch.tensor(tzn),
                           torch.tensor(tco))
    _close(t, j, rtol=RTOL, atol=1e-6)


def test_missing_table_raises():
    """A table that is not committed is fitted (tests/
    test_torch_spectrum_api.py); one of a gamut that does not exist has
    nothing to be fitted to, and raises."""
    with pytest.raises(KeyError):
        tr2s.get_table("no_such_gamut", 7)


def test_sigmoid_unbounded_illuminant_s4_match():
    zn, coeffs = jr2s.get_table("srgb", 16)
    tzn, tco = torch.tensor(zn), torch.tensor(coeffs)
    rgb = np.abs(_rgb(3, 1024))
    _, jwl, twl = _lam(4, 1024)
    c = jr2s.lookup_coeffs(jnp.asarray(rgb), zn, coeffs)
    _s4_close(tr2s.sigmoid_poly_s4(torch.tensor(np.asarray(c)), twl.lam),
              jr2s.sigmoid_poly_s4(c, jwl.lam))
    _s4_close(tr2s.unbounded_eval_s4(torch.from_numpy(rgb), twl.lam, tzn, tco),
              jr2s.unbounded_eval_s4(jnp.asarray(rgb), jwl.lam, zn, coeffs))
    d65 = jcie.illum_d6500()
    _s4_close(tr2s.illuminant_eval_s4(torch.from_numpy(rgb), twl.lam, tzn,
                                      tco, torch.from_numpy(d65)),
              jr2s.illuminant_eval_s4(jnp.asarray(rgb), jwl.lam, zn, coeffs,
                                      d65))


def test_sample_uniform_and_terminate_match():
    _, jwl, twl = _lam(5)
    _s4_close(twl.lam, jwl.lam)
    _s4_close(twl.pdf, jwl.pdf)
    mask = np.random.default_rng(6).uniform(size=2048) < 0.5
    _s4_close(tswl.terminate_secondary(twl, torch.from_numpy(mask)).pdf,
              jswl.terminate_secondary(jwl, jnp.asarray(mask)).pdf)
    v = np.random.default_rng(7).uniform(size=(4, 64)).astype(np.float32)
    _close(tswl.max_value(TS4(*map(torch.from_numpy, v))),
           jswl.max_value(JS4(*map(jnp.asarray, v))))


def _tables():
    """(470, 3+K) CMFs + a spectra bank: D65 and two random spectra."""
    rng = np.random.default_rng(8)
    spectra = np.stack([jcie.illum_d6500(), rng.uniform(size=470),
                        rng.uniform(size=470)]).astype(np.float32)
    cmf = jfilm._cmf_stack()
    table = np.concatenate([cmf, spectra.T], axis=1).astype(np.float32)
    return spectra, table


def test_lambda_slice_bank_and_pick_match():
    spectra, table = _tables()
    assert np.array_equal(tfilm._cmf_stack(), jfilm._cmf_stack())
    _, jwl, twl = _lam(9)
    jb = jgrid.lambda_slice_bank(jnp.asarray(table), jwl.lam)
    tb = tgrid.lambda_slice_bank(torch.from_numpy(table), twl.lam)
    for a, b in zip((tb.cmf_x, tb.cmf_y, tb.cmf_z) + tb.spectra,
                    (jb.cmf_x, jb.cmf_y, jb.cmf_z) + jb.spectra):
        _s4_close(a, b)
    row = np.random.default_rng(10).integers(0, 3, 2048).astype(np.int32)
    _s4_close(tgrid.bank_pick(tb, torch.from_numpy(row)),
              jgrid.bank_pick(jb, jnp.asarray(row)))
    _s4_close(tgrid.eval_dense_s4(torch.from_numpy(spectra[1]), twl.lam),
              jgrid.eval_dense_s4(jnp.asarray(spectra[1]), jwl.lam))


def test_film_spectral_to_rgb_and_finalize_match():
    _, table = _tables()
    _, jwl, twl = _lam(11)
    jwl = jwl._replace(bank=jgrid.lambda_slice_bank(jnp.asarray(table),
                                                    jwl.lam))
    twl = twl._replace(bank=tgrid.lambda_slice_bank(torch.from_numpy(table),
                                                    twl.lam))
    # terminated lanes (pdf 0) must add nothing on both sides
    mask = np.random.default_rng(12).uniform(size=2048) < 0.3
    jwl = jswl.terminate_secondary(jwl, jnp.asarray(mask))
    twl = tswl.terminate_secondary(twl, torch.from_numpy(mask))
    c = np.random.default_rng(13).uniform(0, 5, (4, 2048)).astype(np.float32)
    j = jfilm.spectral_to_rgb(JS4(*map(jnp.asarray, c)), jwl)
    t = tfilm.spectral_to_rgb(TS4(*map(torch.from_numpy, c)), twl)
    for a, b in ((t.x, j.x), (t.y, j.y), (t.z, j.z)):
        _close(a, b, atol=1e-6)
    acc = np.random.default_rng(14).uniform(-0.5, 30, (512, 3)).astype(np.float32)
    for tm in ("none", "reinhard"):
        _close(tfilm.finalize(torch.from_numpy(acc), 4, tone_map=tm),
               jfilm.finalize(jnp.asarray(acc), 4, tone_map=tm), atol=1e-6)


@pytest.mark.parametrize("name", ["linear", "gamma2_2", "srgb", "adobe_rgb",
                                  "rec709"])
def test_eotf_and_tone_map_match(name):
    x = np.random.default_rng(15).uniform(-0.2, 2.0, 4096).astype(np.float32)
    _close(tcolor.eotf.encode(torch.from_numpy(x), name),
           jcolor.eotf.encode(jnp.asarray(x), name), atol=1e-6)
    _close(tcolor.eotf.decode(torch.from_numpy(x), name),
           jcolor.eotf.decode(jnp.asarray(x), name), atol=1e-6)
    y = np.abs(x) * 0.9
    _close(tcolor.tone_map.invert(torch.from_numpy(y), "reinhard"),
           jcolor.tone_map.invert(jnp.asarray(y), "reinhard"), atol=1e-6)
    assert np.array_equal(tcolor.by_name("srgb").xyz_to_rgb,
                          jcolor.by_name("srgb").xyz_to_rgb)
