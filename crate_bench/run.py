"""Run one cell of the benchmark once, on the card.

    python3 -m crate_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell (``BENCHMARK.json``'s ``workloads``)
names a configuration and a traffic mix; both are found by name
(``registry.py``).  The run builds the program and its inputs from the
seed and warms every shape the window uses (set-up), drives the mix's
entry point for ``--seconds`` (the window), then compares the ticks it
checked with the plain reference (``check.py``).  With ``--trace 0`` the
result carries the cell's end-to-end metrics; with ``--trace 1`` the first
units of the window run once untraced and once under ``torch.profiler``
(``trace.py``), and the result carries the per-layer metrics, read by
each metric's own file from those stretches.

The last line of standard output is the result, one JSON object; the last
lines of standard error are the numbers compared, each beside its limit.
Without a CUDA device, or with fewer than the cell asks for, it prints no
result and exits 2.  If the process holds ``jax``, ``jaxlib``, ``flax`` or
``sand_crate_tpu`` once the window has closed, it names them and exits 3.
"""

from __future__ import annotations

import os
import sys
import time


def _process_age() -> float:
    """Seconds since this process started (Linux: /proc; else 0)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - _process_age()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "sand_crate_tpu")
ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".bench_cache"


def clean_environment() -> None:
    """No knob of the program is inherited, and every build or kernel
    cache lives at a fixed path inside the checkout."""
    for k in [k for k in os.environ if k.startswith("SAND_CRATE_")]:
        del os.environ[k]
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool, device,
             cfg: dict | None = None, control: bool = False) -> dict:
    """One run of a cell on ``device`` -> the result object.  ``cfg``
    replaces the cell's configuration file (the tests' small crates).
    ``control`` also reads the control (``calibrate.py``): the reference in
    bfloat16 in the program's place, under ``result["control"]``."""
    import torch

    from . import check, registry, traffic
    from . import trace as tracing
    from .reference import step as ref
    from .reference.world import initial_particles, read_world
    from .yardstick import pair_work

    w = registry.workload(bench, name)
    cfg = cfg or registry.load_config(bench, w["config"])
    mix = registry.load_traffic(w["traffic"])
    seed = seed % (1 << 63)
    trace_units = mix.get("trace_units", 0) if trace else 0
    # no checked unit falls in the two stretches that the trace times
    run = traffic.entry(cfg, mix, seed, device, 2 * trace_units)
    run.set_up()
    _sync(device)
    t0 = time.perf_counter()
    setup_s = t0 - T_START
    print(f"# set-up {setup_s:.3f} s ({w['name']}, seed {seed})", file=sys.stderr, flush=True)

    steps, view = 0, None
    tpu = mix.get("ticks_per_frame", 1)
    if trace:
        untraced, steps = tracing.run_untraced(run.unit, trace_units, device)
        snap = check.snapshot(run.state, run.batched)
        alive_n, pairs = pair_work(snap["pos"], snap["alive"], run.coef["particle_radius"] * 2.0)
        del snap
        view, more = tracing.run_traced(run.unit, trace_units, tpu, device)
        view.untraced_seconds = untraced
        view.pair_work = {"alive": alive_n, "pairs": pairs}
        steps += more
    while time.perf_counter() - t0 < seconds:
        steps += run.unit()
    steps += run.drain()
    _sync(device)
    window = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    bad = forbidden_modules()
    if bad:
        print(f"# forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        raise SystemExit(3)
    run.after_window()
    # the program's state is freed before the reference runs
    start, checked, frame_gaps, coef = run.start, run.checked, run.frame_gaps, run.coef
    checked = [tuple(check.to_host(x) if isinstance(x, dict) else x for x in c) for c in checked]
    n_units, tick_ms = run.n, run.tick_ms
    run.release()
    del run
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    world = read_world(cfg["world"])
    readings, controls = [], []
    for before, after, gen_state in checked:
        before = {k: v.to(device) for k, v in before.items()}
        after = {k: v.to(device) for k, v in after.items()}
        jit = check.jitter_for(cfg["jitter"], before, after, gen_state)
        want = ref.step(before, coef, world, jit)
        readings.append(check.numbers(check.by_input_slot(before, after), want, before, coef))
        if control:
            low = ref.step(before, coef, world, jit, dtype=torch.bfloat16)
            controls.append(check.numbers(low, want, before, coef))
        del want
    nums = check.worst(readings) if readings else {}
    p0 = initial_particles(world, seed)
    nums["start_gap"] = check.start_gap(start, p0, world.segments0, coef)
    if frame_gaps:
        nums["frame_gap"] = max(frame_gaps)
    info = {"flagged_share": nums.pop("flagged_share", 0.0)}
    limits = cfg["limits"]
    nums = {k: nums[k] for k in limits if k in nums}
    correct = bool(readings) and check.judge(nums, limits)

    metrics = {}
    if not trace:
        have = {"particle_steps_per_s": steps / window, "setup_s": setup_s}
        if len(tick_ms) == 1:  # a window of one tick (a small crate on a loaded CPU)
            have["tick_ms_p95"] = tick_ms[0]
        elif tick_ms:
            have["tick_ms_p95"] = statistics.quantiles(tick_ms, n=20, method="inclusive")[18]
        for m in bench["end_to_end"]:
            if registry.applies(m, name) and m["name"] in have:
                metrics[m["name"]] = {"value": have[m["name"]], "unit": m["unit"]}
    else:
        for m in bench["per_layer"]:
            if registry.applies(m, name):
                v = registry.metric_module(m["name"]).read(view)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": n_units,
              "failed": sum(not check.judge(r, limits) for r in readings),
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = view.busy_seconds()
        dev["window_s"] = view.seconds
        result["breakdown"] = tracing.breakdown(view)
    if control:
        low = check.worst(controls)
        low["start_gap"] = check.start_gap(
            start, *(torch.as_tensor(x).bfloat16().double() for x in (p0, world.segments0)), coef)
        result["control"] = {k: low[k] for k in limits if k in low}
        result["program"] = dict(nums, **info)
    result["checks"] = {k: {"value": v, "limit": limits[k]} for k, v in nums.items()}
    print(f"# window {window:.3f} s, {n_units} units, memory peak {peak} bytes, "
          f"set-up {setup_s:.3f} s", file=sys.stderr)
    for k, v in info.items():
        print(f"# {k} = {v!r} (not compared)", file=sys.stderr)
    for k, v in nums.items():
        ok = "ok" if v <= limits[k] else "FAIL"
        print(f"check {k} = {v!r} limit {limits[k]!r} {ok}", file=sys.stderr)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    clean_environment()
    from . import registry

    bench = registry.load_benchmark()
    chips = registry.workload(bench, a.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"# needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    result = run_cell(bench, a.workload, a.seed, a.seconds, bool(a.trace), device)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
