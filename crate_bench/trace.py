"""The traced stretch of a ``--trace 1`` run, read from ``torch.profiler``.

:func:`run_traced` runs units of the window under the profiler with the
card's activity alone (CUPTI: kernels, copies, fills), the card
synchronised before the first unit and after the last, and times the
stretch on the host clock.  The profiler lengthens the host's part of a
tick (a live 1M tick took 2.37 ms traced against 1.65-1.74 ms untraced on
an H100), so no metric divides by that wall time: :func:`run_untraced`
first runs as many units without the profiler, timed the same way, and
the idle share and the host's part of a tick take that stretch's wall
time (``View.untraced_seconds``) against the traced stretch's device
time.  The trace is exported as Chrome JSON into the run's temporary
directory, read, and deleted.  ``View`` is what each per-layer metric's
reader gets: the device operations of the stretch, the ticks it ran, its
wall times, and the pair work counted from a snapshot of the state at its
start.  :func:`breakdown` is the result's ``breakdown``.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from dataclasses import dataclass, field

import torch

from . import registry

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Op:
    name: str
    cat: str
    start: float  # microseconds on the trace's clock
    end: float


@dataclass
class View:
    ops: list  # device operations of the stretch
    seconds: float  # the stretch's wall time (host clock, card synchronised at both ends)
    ticks: int
    untraced_seconds: float = 0.0  # the wall time of as many units run just before, untraced
    pair_work: dict = field(default_factory=dict)  # alive, pairs (per tick)

    def kernels(self, names=None):
        """Kernels whose name holds one of ``names`` (all kernels if None)."""
        out = [o for o in self.ops if o.cat == "kernel"]
        if names is not None:
            out = [o for o in out if any(n in o.name for n in names)]
        return out

    def ms_per_tick(self, ops) -> float:
        return sum(o.end - o.start for o in ops) * 1e-3 / self.ticks

    def busy(self) -> list:
        """The union of the device operations' intervals, in order, each
        with the name of the operation that ends it."""
        out = []
        for o in sorted(self.ops, key=lambda o: o.start):
            if out and o.start <= out[-1][1]:
                if o.end > out[-1][1]:
                    out[-1][1:] = [o.end, o.name]
            else:
                out.append([o.start, o.end, o.name])
        return out

    def busy_seconds(self) -> float:
        return sum(e - s for s, e, _ in self.busy()) * 1e-6

    @staticmethod
    def metric(name: str):
        return registry.metric_module(name)


def read(path: str, seconds: float, ticks: int) -> View:
    events = json.loads(open(path).read()).get("traceEvents", [])
    ops = [Op(e.get("name", ""), e["cat"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
           for e in events if e.get("ph") == "X" and e.get("cat", "") in DEVICE_CATS]
    return View(ops, seconds, ticks)


def breakdown(view: View, top: int = 10) -> dict:
    """The device operations of the traced stretch that took most time, in
    seconds, and its idle gaps in seconds, summed by the device operation
    that ended just before each: what the card last did before it waited
    for the host."""
    by_name, idle = {}, {}
    for o in view.ops:
        by_name[o.name] = by_name.get(o.name, 0.0) + (o.end - o.start) * 1e-6
    busy = view.busy()
    for (_, end, name), (start, _, _) in zip(busy, busy[1:]):
        label = f"after {name}"
        idle[label] = idle.get(label, 0.0) + (start - end) * 1e-6

    def most(d):
        return [[n[:160], v] for n, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": most(by_name), "idle_gaps": most(idle)}


def run_untraced(units, n: int, device) -> tuple[float, int]:
    """Run ``n`` units without the profiler, the card synchronised before
    the first and after the last: (their wall seconds, their
    particle-steps)."""
    steps = 0
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(n):
        steps += units()
    torch.cuda.synchronize(device)
    return time.perf_counter() - t0, steps


def run_traced(units, n: int, ticks_per_unit: int, device) -> tuple[View, int]:
    """Run ``n`` units (``units()`` each) under the profiler, the card's
    activity alone; returns the view and the particle-steps the units
    completed."""
    from torch.profiler import ProfilerActivity, profile

    steps = 0
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(n):
            steps += units()
        torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        view = read(path, seconds, n * ticks_per_unit)
    finally:
        os.unlink(path)
    return view, steps
