"""Where the harness finds each piece by its name in ``BENCHMARK.json``.

* a configuration ``<config>``: ``crate_bench/configs/<config>.json`` (the
  ``file`` of its entry);
* a traffic mix ``<mix>``: ``crate_bench/traffic/<mix>.json``, parameters
  that the one generator of ``traffic.py`` reads;
* a per-layer metric ``<metric>``: ``crate_bench/metrics/<metric>.py``, a
  reader with ``read(view) -> float | None``.

So a later cell, mix or metric is added as files and entries, and no file
that is here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_entry(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def load_config(bench: dict, name: str, root: Path = ROOT) -> dict:
    return json.loads((root / config_entry(bench, name)["file"]).read_text())


def traffic_path(mix: str) -> Path:
    return HERE / "traffic" / f"{mix}.json"


def load_traffic(mix: str) -> dict:
    return json.loads(traffic_path(mix).read_text())


def metric_path(name: str) -> Path:
    return HERE / "metrics" / f"{name}.py"


_METRICS: dict = {}


def metric_module(name: str):
    """The reader module of a per-layer metric, loaded from its own file."""
    mod = _METRICS.get(name)
    if mod is None:
        spec = importlib.util.spec_from_file_location(f"crate_bench.metrics.{name}",
                                                      metric_path(name))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _METRICS[name] = mod
    return mod


def applies(metric: dict, workload_name: str) -> bool:
    return "workloads" not in metric or workload_name in metric["workloads"]
