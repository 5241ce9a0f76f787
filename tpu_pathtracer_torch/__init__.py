"""PyTorch/CUDA port of the spectral path tracer in ``tpu_pathtracer``.

The JAX package stays the reference; this package mirrors its module
layout (``utils``, ``spectrum``, ``color``, ``scene``, ``scenes``, ``ops``,
``render``) so each module's counterpart is found under the same name.
It imports ``torch`` and ``numpy`` only, never ``jax`` and nothing of
``tpu_pathtracer``.

What is ported so far is the forward render of all 20 scenes and the
differentiable pass (``parallel``: loss and material gradients, Adam with
checkpoint/resume, the pixel-sharded render over a ``torch.distributed``
group): every material (Lambert, metal, dispersive glass, plastic, PBR,
clearcoat, emission), textures and normal maps, area, point, spot,
directional and environment lights, two-level instancing (scenes 7, 12,
14); the pt, nee
and mis strategies and the albedo and normal AOVs, the random and Z-Sobol
samplers, progressive rendering with checkpoint/resume
(``render.progressive``), the CLI (``python -m tpu_pathtracer_torch.cli``),
and the traversal kernels (closest hit and any hit, each with the fast and
with the precise watertight hit test) hand-written in CUDA C++ for Hopper
(``csrc/trace_kernels.cu``; detached from autograd, as the JAX package's
zero-cotangent VJPs).  ``RenderConfig.precise`` selects the hit test.
What is not ported raises ``NotImplementedError``.

Entry points take ``device=None`` and then run on ``cuda``; with no GPU
present they raise instead of falling back.  Pass ``device="cpu"`` to run
the plain PyTorch versions of the kernels on the CPU.
"""
from .device import resolve_device

__all__ = ["resolve_device", "N_SPECTRUM_SAMPLES", "LAMBDA_MIN", "LAMBDA_MAX"]

N_SPECTRUM_SAMPLES = 4  # hero wavelengths per path
LAMBDA_MIN = 360.0      # nm
LAMBDA_MAX = 830.0
