"""The benchmark's plain reference: what decides a run's ``correct``.

``tpt`` is a frozen copy of the port's plain path (the per-sample math of
``tpu_pathtracer_torch``: sampler, camera, spectra, materials, lights,
film, scene build and the differentiable pass) with the reference's own
BVH build and walk in place of the CUDA kernels and the native builder.
It imports nothing of the program, builds its own scene from the
benchmark's inputs, and runs as eager ops.  ``render`` and ``fit`` drive
it over what a run's window produced.
"""
