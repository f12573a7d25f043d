"""The benchmark's yardstick: the card's peaks, the least time of a piece of
work, and the work of the pair sums counted from a state.

Frozen here so that no change to the program moves them.  The peaks and
``bound`` are those of the H100 SXM data sheet (700 W; dense float32
outside the tensor cores 67 TFLOP/s, HBM3 3.35 TB/s), as the port's
``ops/measure.py`` held them when this benchmark was written.

The pair sums' work is counted from the inputs, not from a kernel: each
alive particle's fields read once (position and velocity, 16 bytes) and
its pair sums written once (pressure, force, velocity sum and count, 24
bytes), and every ordered pair within a diameter computed once, at
``FLOPS_PER_PAIR`` operations (pass A: distance, weight, normal and
velocity sums, 20; pass B: direction, alignment, tension and pressure, 26).
So the same work reads the same whatever kernel does it.
"""

from __future__ import annotations

import math

import torch

from .reference.step import pair_list

HBM_BYTES_PER_S = 3.35e12
F32_PEAK_FLOPS = 67e12
BYTES_PER_PARTICLE = 16 + 24
FLOPS_PER_PAIR = 20 + 26


def bound(n_bytes: float, flops: float) -> tuple[float, str]:
    """(least seconds, what bounds it): the larger of the bytes over the
    memory rate and the operations over the float32 peak."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / F32_PEAK_FLOPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def pair_work(pos: torch.Tensor, alive: torch.Tensor, diameter: torch.Tensor) -> tuple[int, int]:
    """(alive particles, ordered pairs within a diameter) of a state with a
    leading crate axis: ``pos`` (B, P, 2), ``alive`` (B, P), ``diameter`` (B,)."""
    B, P = alive.shape
    flat = torch.nonzero(alive.reshape(-1)).squeeze(1)
    grp = flat // P
    diam = diameter.double().to(pos.device)
    i, _ = pair_list(pos.reshape(-1, 2)[flat].double(), grp, diam, float(diam.max()))
    return int(flat.numel()), int(i.numel())


def pair_min_seconds(alive: int, pairs: int) -> tuple[float, str]:
    """The least time of one tick's pair sums."""
    return bound(alive * BYTES_PER_PARTICLE, pairs * FLOPS_PER_PAIR)


def dam_break_rescale(n_target: int) -> dict:
    """The dam break's block rescaled for ``n_target`` particles: the
    spacing that puts ``n_target`` points on the block's area
    (0.40 x 0.88), the radius 0.55 x spacing, max_particles 1.05 x
    ``n_target``."""
    spacing = math.sqrt((0.42 - 0.02) * (0.98 - 0.10) / n_target)
    return {"spacing": spacing, "particle_radius": spacing * 0.55,
            "max_particles": int(n_target * 1.05)}
