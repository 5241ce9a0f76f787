"""The benchmark of ``tpu_pathtracer_torch`` on one NVIDIA H100.

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once (``run.py``).
The harness (``harness.py``, ``drivers/``), the inputs and the device
arithmetic (``yardstick.py``), the comparison (``compare.py``) and the
plain reference (``reference/``) live here, so that a change to the
program cannot move them.  Nothing here imports ``jax`` or
``tpu_pathtracer``; the program is imported inside the drivers.
"""
