"""The benchmark's pieces, found by the names `BENCHMARK.json` gives.

A cell (`workloads[]`) names a configuration, `configs/<config>.json`, and a
traffic mix, `traffic/<traffic>.json`. A configuration names its entry,
`entries/<entry>.py`, the code that drives the port's timed path. A metric is
read by `metrics/<name>.py`; a kernel's work per lane is
`kernel_work/<key>.json`. Adding any of them adds a file and edits none.
"""

from __future__ import annotations

import functools
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


@functools.lru_cache(maxsize=None)
def benchmark() -> dict:
    return json.loads((REPO / "BENCHMARK.json").read_text())


def workload(name: str) -> dict:
    for w in benchmark()["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def _json(kind: str, name: str) -> dict:
    return json.loads((HERE / kind / f"{name}.json").read_text())


def config(name: str) -> dict:
    return _json("configs", name)


def traffic(name: str) -> dict:
    return _json("traffic", name)


def metrics_for(workload_name: str, kind: str) -> list[dict]:
    """The `end_to_end` or `per_layer` metrics the cell reports: those that
    list it under `workloads`, and those that list no cells."""
    return [m for m in benchmark()[kind]
            if workload_name in m.get("workloads", [workload_name])]


def _module(path: Path, name: str):
    mod_spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def reader(metric: str):
    """The reader module of a per-layer metric."""
    return _module(HERE / "metrics" / f"{metric}.py",
                   f"bench_gpu.metrics.{metric.replace('.', '_')}")


@functools.lru_cache(maxsize=None)
def entry(name: str):
    """The module that drives a configuration's entry point."""
    return _module(HERE / "entries" / f"{name}.py",
                   f"bench_gpu.entries.{name.replace('.', '_')}")


@functools.lru_cache(maxsize=None)
def kernel_work() -> dict[str, dict]:
    """Every kernel key's work per lane, by key."""
    return {p.stem: json.loads(p.read_text())
            for p in sorted((HERE / "kernel_work").glob("*.json"))}


@functools.lru_cache(maxsize=None)
def peaks() -> dict:
    return json.loads((HERE / "peaks.json").read_text())
