"""Where the device time of one tick goes, on one NVIDIA GPU.

    python3 profile_tick.py            # from the repository root, one GPU

For each backend of the port (pmajor, then the slot grid "pallas") on
chip_smoke.py's 1,001,700-particle dam break: SETTLE_TICKS ticks, the wall
time per tick over WALL_TICKS ticks (host clock closed by a synchronize,
no profiler), then PROFILED_TICKS ticks under torch.profiler: the device
time per tick of the largest kernels (self CUDA time), the sum over all
kernels, the kernel launches per tick, and the busy share = kernel time /
wall time.  Prints the card's name and power limit first; needs CUDA.
"""

from __future__ import annotations

import subprocess
import sys
import time

SETTLE_TICKS = 50
WALL_TICKS = 50
PROFILED_TICKS = 10
TOP = 15


def profile(forces_mode: str, n_target: int) -> None:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from chip_smoke import dam_break_world
    from sand_crate_tpu_torch import Crate

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
    print(f"{forces_mode}: {crate.particle_count} particles, wall {wall_ms:.3f} ms/tick "
          f"({WALL_TICKS} ticks, host clock), kernels {kernel_ms:.3f} ms/tick, "
          f"busy share {kernel_ms / wall_ms:.3f}, {launches / PROFILED_TICKS:.0f} launches/tick")
    for e in kernels[:TOP]:
        print(f"  {device_us(e) / PROFILED_TICKS / 1e3:8.4f} ms/tick  "
              f"{e.count / PROFILED_TICKS:5.1f}/tick  {e.key[:110]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("profile_tick: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__}")
    for mode in ("pmajor", "pallas"):
        profile(mode, 1_000_000)
    return 0


if __name__ == "__main__":
    sys.exit(main())
