"""Run one cell of the benchmark once, on one card, and print its result.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell is an entry of ``BENCHMARK.json``'s
``workloads``.  With ``--trace 0`` the result line carries the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, the device's
busy and traced seconds and a breakdown.  Every run checks what the timed
path produced against the reference; the compared numbers and their
limits are the last lines on standard error and the ``compared`` key of
the result line, which is the last line on standard output.  With no
card, or with fewer cards than the cell asks for, it exits with 2 and
prints no result; it exits with 3 and prints no result when ``jax``,
``jaxlib``, ``flax`` or ``tpu_pathtracer`` is loaded once the window has
closed.  The inputs (an OBJ mesh, an EXR sky) go to a fresh directory
under ``TMPDIR``, removed at exit; the kernels build into the checkout's
``build/``.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r}; have {sorted(cells)}",
              file=sys.stderr)
        return 2

    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    chips = cells[args.workload]["chips"]
    if torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} cards, {torch.cuda.device_count()} "
              "found", file=sys.stderr)
        return 2

    from benchmark import harness
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    with tempfile.TemporaryDirectory(prefix="bench_inputs_") as workdir:
        ctx = harness.Context(bench, args.workload, args.seed, args.seconds,
                              bool(args.trace), dev, T_START, workdir)
        harness.run_cell(ctx)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"forbidden modules loaded: {loaded}", file=sys.stderr)
        return 3
    out = harness.result(ctx, harness.device_info(dev, ctx.memory_peak))
    for name, c in ctx.compared.items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
