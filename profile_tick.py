"""Where the device time of one tick goes, on one NVIDIA GPU.

    python3 profile_tick.py            # from the repository root, one GPU

For each backend and p-major schedule of the port (pmajor with K1/K2,
pmajor with K10 under SAND_CRATE_PMSUB=1, then the slot grid "pallas") on
the bench's 1,001,700-particle dam break: SETTLE_TICKS ticks, the wall
time per tick over WALL_TICKS ticks (host clock closed by a synchronize,
no profiler), then PROFILED_TICKS ticks under torch.profiler: the device
time per tick of the largest kernels (self CUDA time), the sum over all
kernels, the kernel launches per tick, and the busy share = kernel time /
wall time; the port's own kernels are listed wherever they rank.  Then the
two p-major schedules in turns (K1/K2, K10, K10, K1/K2, twice), WALL_TICKS
ticks each from their settled states: the wall time per tick and the
median per-tick CUDA-event time of each turn.
Prints the card's name and power limit first; needs CUDA.
"""

from __future__ import annotations

import os
import re
import statistics
import subprocess
import sys
import time

SETTLE_TICKS = 50
WALL_TICKS = 50
PROFILED_TICKS = 10
TOP = 15
# The kernels of the port's csrc/ (K1/K2, K10, K3-K9), printed wherever they rank.
OWN = re.compile(r"::(pm|pms|place|slab_pass|pass_b)_kernel\b")


PMSUB = "SAND_CRATE_PMSUB"


def set_schedule(knob) -> None:
    """Select the p-major schedule: ``knob`` set to "1", or none."""
    os.environ.pop(PMSUB, None)
    if knob is not None:
        os.environ[knob] = "1"


def timed_ticks(crate, ticks: int):
    """(wall ms/tick, median CUDA-event ms/tick) over ``ticks`` ticks."""
    import torch

    from sand_crate_tpu_torch.physics import step

    events = [torch.cuda.Event(enable_timing=True) for _ in range(ticks + 1)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    events[0].record()
    for k in range(ticks):
        crate.state, _ = step(crate.state, crate.params, crate.scene, crate.generator)
        events[k + 1].record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / ticks * 1e3
    return wall_ms, statistics.median(events[k].elapsed_time(events[k + 1])
                                      for k in range(ticks))


def profile(forces_mode: str, n_target: int, knob=None):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from sand_crate_tpu_torch import Crate
    from sand_crate_tpu_torch.bench import dam_break_world

    set_schedule(knob)
    crate = Crate(dam_break_world(n_target), device="cuda", forces_mode=forces_mode)
    crate.run(SETTLE_TICKS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    crate.run(WALL_TICKS)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / WALL_TICKS * 1e3
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        crate.run(PROFILED_TICKS)
        torch.cuda.synchronize()
    events = prof.key_averages()

    def device_us(e):
        return e.self_device_time_total

    # Device-side events only: an aten op's row repeats its kernels' time.
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                     key=device_us, reverse=True)
    kernel_ms = sum(device_us(e) for e in kernels) / PROFILED_TICKS / 1e3
    launches = sum(e.count for e in events if e.key in ("cudaLaunchKernel", "cuLaunchKernel"))
    label = forces_mode + (f" ({knob}=1)" if knob else "")
    print(f"{label}: {crate.particle_count} particles, wall {wall_ms:.3f} ms/tick "
          f"({WALL_TICKS} ticks, host clock), kernels {kernel_ms:.3f} ms/tick, "
          f"busy share {kernel_ms / wall_ms:.3f}, {launches / PROFILED_TICKS:.0f} launches/tick")
    # The largest kernels, and every kernel of the port's csrc/ wherever it ranks.
    shown = kernels[:TOP] + [e for e in kernels[TOP:] if OWN.search(e.key)]
    for e in shown:
        print(f"  {device_us(e) / PROFILED_TICKS / 1e3:8.4f} ms/tick  "
              f"{e.count / PROFILED_TICKS:5.1f}/tick  {e.key[:110]}")
    return crate


def alternate(crates: dict) -> None:
    """The p-major schedules in turns from their settled states."""
    order = list(crates) + list(reversed(crates))
    names = " ".join(knob or "default" for knob in order)
    print(f"schedules in turns ({names}, twice; {WALL_TICKS} ticks each):")
    for _ in range(2):
        for knob in order:
            set_schedule(knob)
            wall_ms, p50 = timed_ticks(crates[knob], WALL_TICKS)
            print(f"  {knob or 'default (K1/K2)'}: wall {wall_ms:.3f} ms/tick, "
                  f"CUDA-event p50 {p50:.3f} ms/tick")
    set_schedule(None)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("profile_tick: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__}")
    crates = {knob: profile("pmajor", 1_000_000, knob) for knob in (None, PMSUB)}
    alternate(crates)
    del crates
    profile("pallas", 1_000_000)
    return 0


if __name__ == "__main__":
    sys.exit(main())
