"""The captured-graph render against the eager step loop on every render
cell of chip_smoke.py, in one process on one card
(run: python3 scripts/graph_cells.py).

Each cell is a scene, film size, strategy, sampler and hit test of
chip_smoke.py's render and ladder phases (4 spp, depth 16, table_res 64;
the scan-sized OBJ dragon of its files phase is left out: it needs a
102 MB file written first).  For each, ``chip_smoke.graph_vs_eager``
renders it four times in turns (eager, graph, graph, eager: the first
graph call captures the step, the second replays the kept graph), holds
the films equal bit for bit and the launches at 1 + G a step, and the script
prints its JSON line: seconds, ms a step, Mray/s and peak device memory of
each way.  Then the card's name and power limit.  Needs a CUDA device.
"""
from __future__ import annotations

import json
import os
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# scene, film width = height, strategy, sampler, precise
CELLS = (
    (17, 1024, "mis", "sobol", False),
    (17, 1024, "mis", "sobol", True),
    (6, 512, "nee", "random", True),
    (0, 256, "pt", "random", True),
    (3, 256, "pt", "random", False),
    (8, 512, "mis", "sobol", False),
    (8, 512, "mis", "sobol", True),
    (10, 1024, "mis", "sobol", False),
    (19, 512, "mis", "sobol", False),
    (1, 512, "nee", "sobol", False),
    (7, 512, "mis", "sobol", False),
    (12, 512, "mis", "sobol", False),
    (12, 512, "mis", "sobol", True),
)


def main() -> int:
    if not torch.cuda.is_available():
        print("graph_cells: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from tpu_pathtracer_torch.ops import cuda_trace
    from tpu_pathtracer_torch.render import integrator as integ
    from tpu_pathtracer_torch.scenes import load_scene

    t_start = time.perf_counter()
    cuda_trace.build()
    built = {}
    for n, size, strategy, sampler, precise in CELLS:
        if n not in built:
            built = {n: load_scene(n, size, size, table_res=64,
                                   device="cuda")}
        scene, meta, cam = built[n]
        cfg = integ.RenderConfig(width=size, height=size, spp=4,
                                 max_depth=16, strategy=strategy,
                                 sampler=sampler, precise=precise)
        names = cs.PRECISE if precise else cs.FAST
        expect = names[:1] if strategy == "pt" else names
        row = cs.graph_vs_eager(integ, cuda_trace, scene, meta, cam, cfg,
                                expect)
        cs.emit("graph_cell", scene=n, width=size, height=size, spp=4,
                max_depth=16, strategy=strategy, sampler=sampler,
                precise=precise, groups=len(scene.instanced), **row)
    print(json.dumps({"done_s": time.perf_counter() - t_start}))
    print(cs.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
