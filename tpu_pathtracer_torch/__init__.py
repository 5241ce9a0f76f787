"""PyTorch/CUDA port of the spectral path tracer in ``tpu_pathtracer``.

The JAX package stays the reference; this package mirrors its module
layout (``utils``, ``spectrum``, ``color``, ``scene``, ``scenes``, ``ops``,
``render``) so each module's counterpart is found under the same name.
It imports ``torch`` and ``numpy`` only, never ``jax`` and nothing of
``tpu_pathtracer``.

What is ported so far is the flagship forward render: scene 17 (Cornell
box + rough clearcoat dragon), MIS strategy, Z-Sobol sampler, with the two
traversal kernels (closest hit, any hit) hand-written in CUDA C++ for
Hopper (``csrc/trace_kernels.cu``).  Anything outside that slice raises
``NotImplementedError``.

Entry points take ``device=None`` and then run on ``cuda``; with no GPU
present they raise instead of falling back.  Pass ``device="cpu"`` to run
the plain PyTorch versions of the kernels on the CPU.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
