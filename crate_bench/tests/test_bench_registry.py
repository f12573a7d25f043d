"""BENCHMARK.json against its schema, every name resolving to
its file, and a cell, a mix and a metric added as files alone."""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

from crate_bench import registry

ROOT = registry.ROOT
BENCH = registry.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["crate_bench"]
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("crate_bench/") and len(c["source"]) <= 200
    cells = {w["name"] for w in BENCH["workloads"]}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200 and NAME.match(w["traffic"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_name_resolves_to_its_file():
    for w in BENCH["workloads"]:
        cfg = registry.load_config(BENCH, w["config"])
        assert {"world", "crates", "jitter", "limits"} <= set(cfg)
        mix = registry.load_traffic(w["traffic"])
        assert mix["entry"] in ("physics_tick", "stream_frames", "batched_run")
    for m in BENCH["per_layer"]:
        assert callable(registry.metric_module(m["name"]).read)


def _tree_hashes(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "crate_bench").rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_cell_mix_and_metric_are_added_as_files(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a
    per-layer metric and a cell by new files and new entries alone, and
    the copy's harness runs the new cell (on the CPU, at a tiny size)."""
    shutil.copytree(ROOT / "crate_bench", tmp_path / "crate_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _tree_hashes(tmp_path)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "crate_bench/configs/dam_break_1m.json").read_text())
    w = cfg["world"]
    w["initial_particles"][0]["block"]["spacing"] = 0.02
    w["coefficients"].update(particle_radius=0.011, max_particles=1000)
    cfg.update(forces_mode="pmajor")
    (tmp_path / "crate_bench/configs/tiny_dam.json").write_text(json.dumps(cfg))
    (tmp_path / "crate_bench/traffic/live_short.json").write_text(json.dumps(
        {"entry": "physics_tick", "warm_ticks": 3, "check_ticks": 1, "check_span": [1, 2]}))
    (tmp_path / "crate_bench/metrics/ticks_traced.py").write_text(
        "def read(view):\n    return float(view.ticks)\n")
    bench["configs"].append({"name": "tiny_dam", "source": "https://example.org/tiny",
                             "file": "crate_bench/configs/tiny_dam.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "tiny_dam.live_short", "config": "tiny_dam",
                               "traffic": "live_short", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "ticks_traced", "unit": "ticks", "better": "higher",
                               "source": "device_trace", "layer": "entry",
                               "moves": "particle_steps_per_s",
                               "workloads": ["tiny_dam.live_short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _tree_hashes(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before
    code = (
        "import json, torch\n"
        "from crate_bench import registry, run\n"
        "b = registry.load_benchmark()\n"
        "assert registry.metric_module('ticks_traced').read(type('V', (), {'ticks': 7})()) == 7\n"
        "r = run.run_cell(b, 'tiny_dam.live_short', 5, 0.2, False, torch.device('cpu'))\n"
        "print(json.dumps(r))\n")
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{ROOT}")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert set(res["metrics"]) == {"particle_steps_per_s", "setup_s"}


def test_run_refuses_without_a_card():
    """No CUDA device: no result on standard output and a non-zero exit."""
    code = ("import sys, torch\n"
            "torch.cuda.is_available = lambda: False\n"
            "from crate_bench import run\n"
            "sys.exit(run.main(['--workload', 'dam_break_1m.live', '--seed', '1',"
            " '--seconds', '1', '--trace', '0']))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
