"""The benchmark's description, found by name: ``BENCHMARK.json`` at the
checkout's root, ``configs/<config>.json`` (the configuration's ``file``),
``workloads/<traffic>.json`` and ``metrics/<name>.py``."""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Any, Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict[str, Any]:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def workload(spec: Dict[str, Any], name: str) -> Dict[str, Any]:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_of(spec: Dict[str, Any], name: str) -> Dict[str, Any]:
    for c in spec["configs"]:
        if c["name"] == name:
            return load_json(os.path.join(ROOT, c["file"]))
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic_of(name: str) -> Dict[str, Any]:
    return load_json(os.path.join(BENCH_DIR, "workloads", f"{name}.json"))


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def end_to_end(spec: Dict[str, Any], cell: str) -> List[Dict[str, Any]]:
    return [m for m in spec["end_to_end"] if _applies(m, cell)]


def per_layer(spec: Dict[str, Any], cell: str) -> List[Dict[str, Any]]:
    """Per-layer metrics of `cell`: those that list it, and those without
    a list whose end-to-end metric the cell reports."""
    reported = {m["name"] for m in end_to_end(spec, cell)}
    return [m for m in spec["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]


def reader(name: str):
    """``read(run)`` of ``metrics/<name>.py``."""
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    mod_spec = importlib.util.spec_from_file_location(
        "metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read
