"""Spectral subsystem: dense-grid spectra, CIE data, hero-wavelength
sampling and the RGB->spectrum sigmoid-polynomial tables (lookup and
fitter)."""
from .cie import (blackbody, cie_d, cie_x, cie_y, cie_y_integral, cie_z,
                  illum_a, illum_d60, illum_d5000, illum_d6500)
from .grid import (DENSE_LAMBDA, LAMBDA_MAX, LAMBDA_MIN, N_DENSE,
                   bake_piecewise, eval_dense, inner_product)
from .rgb2spec import (albedo_eval, get_table, illuminant_eval,
                       lookup_coeffs, sigmoid_poly, sigmoid_poly_max_value,
                       unbounded_eval)
from .sampled import (N_SPECTRUM_SAMPLES, SampledWavelengths, average,
                      max_value, safe_div, sample_uniform, terminate_secondary)

__all__ = [
    "DENSE_LAMBDA", "LAMBDA_MAX", "LAMBDA_MIN", "N_DENSE", "N_SPECTRUM_SAMPLES",
    "SampledWavelengths", "albedo_eval", "average", "bake_piecewise",
    "blackbody", "cie_d", "cie_x", "cie_y", "cie_y_integral", "cie_z",
    "eval_dense", "get_table", "illum_a", "illum_d60", "illum_d5000",
    "illum_d6500", "illuminant_eval", "inner_product", "lookup_coeffs",
    "max_value", "safe_div", "sample_uniform", "sigmoid_poly",
    "sigmoid_poly_max_value", "terminate_secondary", "unbounded_eval",
]
