"""One run of one cell: the set-up, the window, the traced segment, the
check against the reference, and the result line.

A cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
configuration and a traffic mix.  Everything that belongs to one of them
is found by name: ``configs/<config>.json`` (sizes) and
``configs/<config>.py`` (inputs, scene), ``traffic/<traffic>.json`` (whose
``kind`` names the driver, ``drivers/<kind>.py``), ``limits/<cell>.json``
(the limit of each compared number) and, for each per-layer metric,
``metrics/<metric>.py`` (a reader that returns its value or None).
"""
from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time

import torch

from . import compare, yardstick

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the prefix of the benchmark's own record_function spans
SPAN = "bench."
# modules that may not be loaded in a run, compared by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_pathtracer")


class WindowClosed(Exception):
    """Raised from a driver's hook to end a render at a pass boundary."""


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def span(ctx, name: str):
    """A harness span of set-up: its seconds become ``<name>_s``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        ctx.layer[name + "_s"] = time.perf_counter() - t0


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def reader(metric: str):
    """``metrics/<metric>.py``'s ``read``."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


class Context:
    """What a driver reads (the cell, its inputs, the run's arguments) and
    fills in (metrics, counts, the traced segment, the comparisons)."""

    def __init__(self, bench: dict, cell_name: str, seed: int,
                 seconds: float, trace: bool, device, t_start: float,
                 workdir: str, limits: dict | None = None,
                 conf_over: dict | None = None,
                 traffic_over: dict | None = None):
        """``limits``, ``conf_over``, ``traffic_over``: replacements of the
        cell's limits and of entries of its configuration and traffic
        (the benchmark's own tests run a cell small on the CPU)."""
        self.bench = bench
        self.cell = next(w for w in bench["workloads"]
                         if w["name"] == cell_name)
        self.conf = load_json(HERE, "configs", self.cell["config"] + ".json")
        self.traffic = load_json(HERE, "traffic",
                                 self.cell["traffic"] + ".json")
        self.conf.update(conf_over or {})
        self.traffic.update(traffic_over or {})
        self.config_module = importlib.import_module(
            "benchmark.configs." + self.cell["config"])
        self.limits = (limits if limits is not None
                       else load_json(HERE, "limits", cell_name + ".json"))
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.t_start = device, t_start
        self.inputs = self.config_module.make_inputs(self.conf, workdir, seed)
        self.end_to_end, self.layer, self.counts = {}, {}, {}
        self.compared = {}
        self.attempted = self.failed = 0
        self.memory_peak = 0
        self.device_trace = None

    def note(self, text: str) -> None:
        """A line for the run's standard error."""
        print(text, file=sys.stderr, flush=True)

    def setup_done(self) -> None:
        self.end_to_end["setup_s"] = time.perf_counter() - self.t_start

    def read_memory(self) -> None:
        if self.device.type == "cuda":
            sync(self.device)
            self.memory_peak = int(torch.cuda.max_memory_allocated(
                self.device))

    def trace_segment(self, fn, span_name: str) -> None:
        """Run ``fn`` under the profiler (CPU and CUDA activity) inside the
        span ``span_name``; keep its ``DeviceTrace``."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        sync(self.device)
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            with torch.profiler.record_function(SPAN + span_name):
                fn()
                sync(self.device)
            window = time.perf_counter() - t0
        self.device_trace = yardstick.DeviceTrace.from_profiler(
            prof, window, SPAN)

    def _hold(self, name: str, value: float) -> bool:
        limit = self.limits[name]
        self.compared[name] = {"value": value, "limit": limit}
        return value <= limit

    def compare_films(self, films, ref, chunk: int) -> None:
        share, per_pass = compare.film_mismatch(films, ref, chunk)
        self._hold("film_mismatch_share", share)
        limit = self.limits["film_mismatch_share"]
        self.failed = sum(s > limit for s in per_pass)

    def compare_fit(self, prog: dict, ref: dict) -> None:
        gaps = compare.fit_gaps(prog, ref)
        ok = [self._hold(k, v) for k, v in gaps.items()]
        self.failed = 0 if all(ok) else len(ref["losses"])

    @property
    def correct(self) -> bool:
        return bool(self.compared) and all(
            c["value"] <= c["limit"] for c in self.compared.values())


def device_info(dev, memory_peak: int) -> dict:
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1, "memory_peak_bytes": memory_peak}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", str(dev.index or 0)],
            capture_output=True, text=True, timeout=20).stdout.strip()
        info["power_limit_w"] = float(out)
    except (OSError, ValueError, subprocess.SubprocessError):
        info["power_limit_w"] = None
    return info


def run_cell(ctx: Context) -> None:
    """Run the cell's driver: set-up, window, trace, check."""
    driver = importlib.import_module(
        "benchmark.drivers." + ctx.traffic["kind"])
    driver.run(ctx)


def result(ctx: Context, device: dict) -> dict:
    """The run's result line (``compared`` last)."""
    cell = ctx.cell["name"]
    metrics = {}
    if ctx.trace:
        for m in ctx.bench["per_layer"]:
            if applies(m, cell):
                value = reader(m["name"])(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in ctx.bench["end_to_end"]:
            if applies(m, cell):
                metrics[m["name"]] = {"value": ctx.end_to_end[m["name"]],
                                      "unit": m["unit"]}
    out = {"correct": ctx.correct, "attempted": ctx.attempted,
           "failed": ctx.failed, "metrics": metrics, "device": device}
    if ctx.trace and ctx.device_trace is not None:
        t = ctx.device_trace
        device["busy_s"] = t.busy_s()
        device["window_s"] = t.window_s
        out["breakdown"] = {"device_ops": t.top_ops(10),
                            "idle_gaps": t.idle_gaps(10)}
    out["compared"] = ctx.compared
    return out
