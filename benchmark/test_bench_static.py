"""CPU tests of the benchmark's files: no forbidden import, and
``BENCHMARK.json`` against the files it names."""
from __future__ import annotations

import ast
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "tpu_pathtracer"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _sources():
    for d, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imported(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_no_module_imports_jax_or_the_jax_package():
    """Top-level names compared whole: ``tpu_pathtracer_torch`` is the
    program, ``tpu_pathtracer`` the JAX package."""
    bad = [(os.path.relpath(p, ROOT), m) for p in _sources()
           for m in _imported(p) if m.split(".")[0] in FORBIDDEN]
    assert bad == []


def test_the_program_is_imported_only_inside_functions():
    for p in _sources():
        tree = ast.parse(open(p).read(), p)
        for node in tree.body:
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = ([a.name for a in node.names]
                         if isinstance(node, ast.Import) else [node.module])
                assert not any((n or "").startswith("tpu_pathtracer_torch")
                               for n in names), p


def test_benchmark_json_names_its_files():
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in bench["configs"]]
    for c in bench["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert os.path.isfile(os.path.join(HERE, "configs",
                                           c["name"] + ".py"))
        assert json.load(open(os.path.join(ROOT, c["file"])))["name"] \
            == c["name"]
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
    cells = [w["name"] for w in bench["workloads"]]
    for w in bench["workloads"]:
        assert w["config"] in names and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        for d, f in (("traffic", w["traffic"]), ("limits", w["name"])):
            assert os.path.isfile(os.path.join(HERE, d, f + ".json"))
    metrics = bench["end_to_end"] + bench["per_layer"]
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in metrics:
        assert NAME.match(m["name"]) and set(m.get("workloads", cells)) \
            <= set(cells)
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert os.path.isfile(os.path.join(HERE, "metrics",
                                           m["name"] + ".py"))
    for n in names + cells + [m["name"] for m in metrics]:
        assert NAME.match(n)
    assert len(set(cells)) == len(cells)
    assert len({m["name"] for m in metrics}) == len(metrics)
