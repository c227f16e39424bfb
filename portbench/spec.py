"""Where the benchmark finds its parts: BENCHMARK.json at the root of the
checkout, and under this directory the files of each configuration,
traffic mix and per-layer metric, by the names BENCHMARK.json gives them,
and of each scene and reference renderer, by the names a configuration
gives them."""

from __future__ import annotations

import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str) -> dict:
    """The configuration's file (its `file` entry), with its name."""
    for c in bench["configs"]:
        if c["name"] == name:
            with open(os.path.join(ROOT, c["file"])) as f:
                return {"name": name, **json.load(f)}
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    """The traffic mix's file, traffic/<name>.json."""
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as f:
        return {"name": name, **json.load(f)}


def metrics_of(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics a run of `workload` reports: with trace the per-layer
    metrics whose `workloads` list it (or that have no such key and move
    an end-to-end metric the cell reports), else the end-to-end ones the
    cell reports."""
    def listed(m):
        return "workloads" not in m or workload in m["workloads"]

    e2e = [m for m in bench["end_to_end"] if listed(m)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]


def part(kind: str, name: str):
    """The module of `<kind>/<name>.py` under this directory: a scene
    (`scenes`, by a configuration's `scene`), a reference renderer
    (`reference/renderers`, by its `reference`) or a per-layer metric
    (`metrics`, by its name)."""
    module_name = "portbench." + kind.replace("/", ".") + "." + name
    if module_name not in sys.modules:
        path = os.path.join(HERE, *kind.split("/"), f"{name}.py")
        spec = importlib.util.spec_from_file_location(module_name, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        sys.modules[module_name] = module
    return sys.modules[module_name]


def metric_reader(name: str):
    """`read(run)` of metrics/<name>.py: the metric's value, or None where
    the run holds nothing for it to read."""
    return part("metrics", name).read
