"""Device timing and the card's least time for a kernel's work.

One copy of what every kernel measurement uses (``chip_smoke.py``, the
probes' ``main``): :func:`cuda_ms`, the H100's peak rates and
:func:`bound`.

The peaks are the H100 SXM's (NVIDIA's data sheet and Hopper white paper,
700 W).  Every kernel of ``csrc/`` is built with ``-fmad=false``, so a
multiply and an add issue as two instructions: f32 operations count at half
the 67 TFLOP/s FMA peak (which counts an FMA as two operations), and bf16
operations, packed two to an instruction (bf16x2), at twice that.  Work
whose floats need not round as a plain version's do (held at a tolerance,
free to fuse a multiply and an add) is counted at the full published 67
TFLOP/s instead: the least time the card could take for it, whatever the
kernel's own flags (the pair sums, ``ops/pair_batch.py``).
"""

from __future__ import annotations

import statistics

import torch

HBM_BYTES_PER_S = 3.35e12
F32_PEAK_FLOPS = 67e12
F32_OPS_PER_S = F32_PEAK_FLOPS / 2
BF16_OPS_PER_S = 2 * F32_OPS_PER_S
# Device clock cycles the card waits before each timed run (~1 ms at the
# H100's clocks: longer than any wrapper takes to enqueue its launches).
HOLD_CYCLES = 2_000_000


def bound(n_bytes: float, f32_ops: float, bf16_ops: float = 0.0, f32_flops: float = 0.0):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    (each input read once, each output written once) and the operations
    over their peak rates (``f32_flops``: f32 operations free to fuse, at
    the published FMA peak)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = (f32_ops / F32_OPS_PER_S + bf16_ops / BF16_OPS_PER_S
             + f32_flops / F32_PEAK_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` in ms over ``reps`` runs (CUDA events),
    after one warm-up run.

    Before each run the device sleeps for HOLD_CYCLES while the host
    enqueues the start event, ``fn``'s launches and the stop event, so the
    events bracket device work only: timed right after the previous run, a
    ~0.05 ms kernel would also count the ~0.03 ms its Python wrapper takes to
    launch it.  A function that waits on the device inside (a plain version
    that reads a size back) still counts its host time."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOLD_CYCLES)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)
