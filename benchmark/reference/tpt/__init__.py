"""A frozen copy of the port's plain path, the benchmark's reference.

Copied from ``tpu_pathtracer_torch`` when the benchmark was defined, with
the module layout kept (``utils``, ``spectrum``, ``color``, ``scene``,
``scenes``, ``ops``, ``render``) and these changes: no CUDA kernel, no
CUDA graph and no native builder (``ops/bvh_ref.py`` builds and walks the
reference's own tree), the integrator cut to its per-sample math, the
differentiable pass cut to one device (``train.py``).  Later changes to
the program do not reach it, so a run is held to the program's results as
they were when the benchmark was defined.
"""
