"""Host-side observability: phase timer, force monitor and profiler trace.

The counterparts of ``sand_crate_tpu/diagnostics.py`` (reference timer.py:10-48
and force_monitor.py:13-37): the wall-clock timer covers host-visible phases
(dispatch, sync, render), the per-force attribution comes from the
``Diagnostics`` the step returns, and :func:`profile` traces a block with
``torch.profiler``.  Reports are YAML-shaped text written
without PyYAML, so the port runs where PyYAML is not installed.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path

import numpy as np

OUTSIDE_CONTEXT = "Outside"
TIMER_DECAY = 0.9  # reference: timer.py:7
FORCE_DECAY = 0.80  # reference: force_monitor.py:10


def yaml_block(data, indent: int = 0) -> str:
    """``data`` (nested dicts of scalars, or a list of one-key dicts) as
    block-style YAML text, keys sorted like ``yaml.dump``."""
    pad = "  " * indent
    if isinstance(data, list):
        return "".join(f"{pad}- {yaml_block(item).strip()}\n" for item in data)
    lines = []
    for key in sorted(data):
        value = data[key]
        if isinstance(value, dict):
            lines.append(f"{pad}{key}:\n{yaml_block(value, indent + 1)}")
        else:
            lines.append(f"{pad}{key}: {value}\n")
    return "".join(lines)


class PhaseTimer:
    """EMA wall-clock timer with an implicit 'Outside' bucket.

    Context-manager API compatible with the reference Timer (timer.py:10-48):
    ``with timer("Collisions"): ...``; ``report()`` yields the same shape
    with per-phase ms, percent, and FPS.
    """

    def __init__(self) -> None:
        self._stack: list[str] = []
        self._starts: dict[str, float] = {OUTSIDE_CONTEXT: time.time()}
        self._durations: dict[str, float] = defaultdict(float)

    def __call__(self, context: str) -> "PhaseTimer":
        self._stack.append(context)
        return self

    def __enter__(self) -> "PhaseTimer":
        now = time.time()
        self._starts[self._stack[-1]] = now
        if len(self._stack) == 1:
            self._ema(OUTSIDE_CONTEXT, now - self._starts[OUTSIDE_CONTEXT])
        return self

    def __exit__(self, *exc) -> None:
        ctx = self._stack.pop()
        self._ema(ctx, time.time() - self._starts[ctx])
        if not self._stack:
            self._starts[OUTSIDE_CONTEXT] = time.time()

    def _ema(self, ctx: str, duration: float) -> None:
        self._durations[ctx] = (
            self._durations[ctx] * TIMER_DECAY + (1 - TIMER_DECAY) * duration
        )

    def report(self) -> str:
        total = sum(self._durations.values()) or 1e-9
        phases = {
            ctx: f"{1000 * d:.1f} ms ({100 * d / total:.0f}%)"
            for ctx, d in self._durations.items()
        }
        return yaml_block(
            {"Timing": phases, "FPS": f"{int(1 / total)} ({1000 * total:.1f} ms)"}
        )


class ForceMonitor:
    """EMA of per-force mean ||dv|| fed by the step's Diagnostics output."""

    def __init__(self, labels: tuple[str, ...]) -> None:
        self.labels = labels
        self._ema = defaultdict(float)

    def update(self, force_dv: np.ndarray) -> None:
        for label, value in zip(self.labels, np.asarray(force_dv)):
            self._ema[label] = self._ema[label] * FORCE_DECAY + (
                1 - FORCE_DECAY
            ) * float(value)

    def report(self) -> str:
        rounded = {k: float(f"{1000 * v:.1f}") for k, v in self._ema.items()}
        return yaml_block({"Forces": rounded})


@contextlib.contextmanager
def profile(log_dir):
    """Trace a block with ``torch.profiler`` (host ops, and the card's
    kernels when CUDA is available) and write it as a Chrome trace,
    ``<log_dir>/trace.json`` (chrome://tracing or Perfetto); yields
    ``log_dir``."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(str(out / "trace.json"))
