"""Spectral subsystem: dense-grid spectra, CIE data, hero-wavelength
sampling and the RGB->spectrum table lookup."""
from .cie import (GLASSES, METALS, cie_x, cie_y, cie_z, glass_eta,
                  illum_d6500, metal_eta_k)
from .grid import (DENSE_LAMBDA, LAMBDA_MAX, LAMBDA_MIN, N_DENSE,
                   bake_piecewise, eval_dense, inner_product)
from .rgb2spec import get_table, lookup_coeffs
from .sampled import (N_SPECTRUM_SAMPLES, SampledWavelengths, max_value,
                      sample_uniform, terminate_secondary)

__all__ = [
    "DENSE_LAMBDA", "GLASSES", "LAMBDA_MAX", "LAMBDA_MIN", "METALS",
    "N_DENSE", "N_SPECTRUM_SAMPLES", "SampledWavelengths", "bake_piecewise",
    "cie_x", "cie_y", "cie_z", "eval_dense", "get_table", "glass_eta",
    "illum_d6500", "inner_product", "lookup_coeffs", "max_value",
    "metal_eta_k", "sample_uniform", "terminate_secondary",
]
