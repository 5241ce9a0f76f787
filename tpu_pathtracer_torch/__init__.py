"""PyTorch/CUDA port of the spectral path tracer in ``tpu_pathtracer``.

The JAX package stays the reference; this package mirrors its module
layout (``utils``, ``spectrum``, ``color``, ``scene``, ``scenes``, ``ops``,
``render``) so each module's counterpart is found under the same name.
It imports ``torch`` and ``numpy`` only, never ``jax`` and nothing of
``tpu_pathtracer``.

What is ported so far is the forward render of scenes 0, 6, 16 and 17
(Cornell box with a Lambert or gold bunny or a clearcoat dragon): the pt,
nee and mis strategies and the albedo and normal AOVs, the random and
Z-Sobol samplers, and the traversal kernels (closest hit and any hit, each
with the fast and with the precise watertight hit test) hand-written in
CUDA C++ for Hopper (``csrc/trace_kernels.cu``).  ``RenderConfig.precise``
selects the hit test.  Anything else raises
``NotImplementedError``.

Entry points take ``device=None`` and then run on ``cuda``; with no GPU
present they raise instead of falling back.  Pass ``device="cpu"`` to run
the plain PyTorch versions of the kernels on the CPU.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
