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
median per-tick CUDA-event time of each turn.  Then the pair stage of
each p-major schedule at its settled state, in turns (default, PMSUB,
PMSUB, default): for the default candidate_ranges + K1 + K2 (two-sided,
folded) and for PMSUB chunk_windows + K10 a + K10 b (one-sided, folded),
and for each search alone, two readings per call: the device time (the
kernels' sum under torch.profiler over STAGE_REPS calls; no host gap
counts) and the call's time (median of STAGE_REPS CUDA-event brackets,
measure.cuda_ms: the gaps between the call's launches count wherever the
host falls behind the device, as it does after a copy that waits for the
stream).
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
STAGE_REPS = 30
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


def stage_device_ms(fn, reps: int) -> float:
    """Device time of one call of ``fn``: the sum of its kernels' device
    times under torch.profiler over ``reps`` calls, per call (host gaps and
    host-side waits are not counted)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / reps / 1e3


def pair_stages(crates: dict) -> None:
    """The pair stage of a tick on each p-major schedule, at its crate's
    settled state, in turns: the candidate search and passes A and B."""
    import torch

    from sand_crate_tpu_torch.cellwise import cell_ids_grid
    from sand_crate_tpu_torch.ops import pmajor
    from sand_crate_tpu_torch.ops.measure import cuda_ms

    stages = {}
    for knob, crate in crates.items():
        st, sc, pr = crate.state, crate.scene, crate.params
        nx, ny = sc.grid_nx, sc.grid_ny
        cid, order = torch.sort(cell_ids_grid(st.pos, st.alive, sc), stable=True)
        alive = st.alive[order]
        symm = knob is None and sc.pmajor_symm
        coef = pmajor.coef_stack(pr.diameter, pr.target_pressure, pr.spring_overlap_balance)
        slab_a = pmajor.pass_a_slab(st.pos[order], st.vel[order], alive, cid,
                                    pr.diameter * pr.collider_noise_level, st.tick, sc, symm=symm)
        ranges = pmajor.candidate_ranges(cid, alive, nx, ny)
        out_a = pmajor.pm_pass(slab_a, ranges, coef, "a", symm=symm)
        cp = pmajor.finalize_cp(out_a[0], out_a[3], pr.ignored_pressure)
        slab_b = pmajor.pass_b_slab(slab_a, out_a, cp * (1.0 + pr.pressure_amplifier),
                                    pr.surface_smoothing)
        if knob is None:
            def search(cid=cid, alive=alive, nx=nx, ny=ny):
                return pmajor.candidate_ranges(cid, alive, nx, ny)

            def stage(search=search, slab_a=slab_a, slab_b=slab_b, coef=coef, symm=symm):
                r = search()
                pmajor.pm_pass(slab_a, r, coef, "a", symm=symm)
                pmajor.pm_pass(slab_b, r, coef, "b", fold=True, symm=symm)
            label = "default: candidate_ranges + K1 + K2"
        else:
            def search(cid=cid, alive=alive, nx=nx, ny=ny):
                return pmajor.chunk_windows(cid, alive, nx, ny, pmajor.PMS_CHUNK)

            def stage(search=search, slab_a=slab_a, slab_b=slab_b, coef=coef, cid=cid, nx=nx):
                w = search()
                pmajor.pms_pass(slab_a, cid, w, coef, "a", nx=nx, chunk=pmajor.PMS_CHUNK)
                pmajor.pms_pass(slab_b, cid, w, coef, "b", nx=nx, chunk=pmajor.PMS_CHUNK,
                                fold=True)
            label = f"PMSUB: chunk_windows + K10 a + K10 b (chunk {pmajor.PMS_CHUNK})"
        stages[knob] = (label, search, stage)
    order = list(crates) + list(reversed(crates))
    readings = (("device ms per call (kernel sums under torch.profiler over "
                 f"{STAGE_REPS} calls)", stage_device_ms),
                (f"ms per call (median of {STAGE_REPS} CUDA-event brackets, host gaps "
                 "between launches included)", cuda_ms))
    times = {(knob, r): ([], []) for knob in crates for r in range(len(readings))}
    for knob in order:
        _, search, stage = stages[knob]
        for r, (_, timer) in enumerate(readings):
            times[knob, r][0].append(timer(stage, STAGE_REPS))
            times[knob, r][1].append(timer(search, STAGE_REPS))
    for r, (what, _) in enumerate(readings):
        print(f"pair stage at the settled state, {what}, in turns "
              f"{' '.join(k or 'default' for k in order)}:")
        for knob, (label, _, _) in stages.items():
            stage_ms, search_ms = times[knob, r]
            print(f"  {label}: {' / '.join(f'{t:.4f}' for t in stage_ms)} ms, of which the "
                  f"search {' / '.join(f'{t:.4f}' for t in search_ms)} ms")


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
    pair_stages(crates)
    del crates
    profile("pallas", 1_000_000)
    return 0


if __name__ == "__main__":
    sys.exit(main())
