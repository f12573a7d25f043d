"""The slot-grid PairSums provider (``forces_mode="pallas"``).

The PyTorch counterpart of ``sand_crate_tpu/ops/pallas_forces.py`` (the
name keeps the JAX mode's; nothing here is Pallas).  Torch glue around the
kernels of ``csrc/grid_pair.cu``.  The tick's provider works in slab order
and never builds the slot grid:

    slab_from_sorted (sorted state)         -> slab (8, P_pad), row_start
    pair_pass_a(slab, row_start)            -> PS (4, P_pad)
    pair_pass_b_emit(slab, PS, row_start)   -> (8|10, P_pad) in sorted order

The 1M dam break's dense grid (4, 1538, 16, 1664) f32 is 655 MB with 2.45%
of its slots occupied; the tick allocates, zeroes and places none of it.
:func:`neighbor_forces_pallas` (particle order) places the slab and its
pass-A columns into the grids G and PS (``place_grid``, twice), runs
grid-mode pass B and one gather (:func:`gather_pair_sums`).

``overflow`` counts the alive particles of rank >= M in their cell (they
read their rank % M cellmate's sums).  The JAX provider also adds the
two-level work units past its ``ADDON_UNIT_CAP``; the port sums every slot
pair, so it has no such loss to count.
"""

from __future__ import annotations

import torch

from ..cellwise import PairSums
from ..state import Scene
from . import pair_kernel, placement


def grid_width(nx: int) -> int:
    """NXP: the padded grid width, nx + 2 rounded up to 128 as in JAX."""
    return ((nx + 2 + 127) // 128) * 128


def pair_sums_from_planes(planes: torch.Tensor, enable_spring: bool, overflow, dtype) -> PairSums:
    """PairSums from the (NB, P) result planes in particle order."""
    mine = planes.to(dtype)
    nb = mine.shape[0]
    vis0 = 7 if enable_spring else 5
    spring = mine[5:7].T if enable_spring else torch.zeros_like(mine[1:3].T)
    return PairSums(
        p_i=mine[0],
        dv_tension=mine[1:3].T,
        pressure_real=mine[3:5].T,
        spring_real=spring,
        visc_vsum=mine[vis0:vis0 + 2].T,
        nbr_cnt=mine[nb - 1],
        overflow=overflow,
    )


def gather_pair_sums(b_out, pslot, M: int, nx: int, ny: int, nxp: int,
                     enable_spring: bool, overflow, dtype) -> PairSums:
    """One gather from the grid-mode pass-B planes (NB, ny, M, nxp) back to
    particle order; ``pslot`` (P,) is the flat cell * M + rank slot, >=
    nx * ny * M for dead particles (whose sums are 0)."""
    valid = pslot < nx * ny * M
    cid = torch.where(valid, pslot // M, 0)
    rank = torch.where(valid, pslot % M, 0)
    out_idx = (cid // nx) * (M * nxp) + rank * nxp + (cid % nx + 1)
    nb = b_out.shape[0]
    mine = b_out.reshape(nb, -1)[:, out_idx.long()]
    mine = torch.where(valid[None, :], mine, 0.0)
    return pair_sums_from_planes(mine, enable_spring, overflow, dtype)


def neighbor_forces_pallas_sorted(
    pos: torch.Tensor,  # all inputs pre-sorted by cell id (sorted-state step)
    vel: torch.Tensor,
    alive: torch.Tensor,
    sorted_cid: torch.Tensor,
    noise_amp: torch.Tensor,
    tick: torch.Tensor,
    diameter: torch.Tensor,
    surface_smoothing: torch.Tensor,
    target_pressure: torch.Tensor,
    ignored_pressure: torch.Tensor,
    spring_overlap_balance: torch.Tensor,
    scene: Scene,
) -> PairSums:
    """Slot-grid pair sums over pre-sorted operands, in the same order:
    the slab, pass A and pass B, both in slab order (no slot grid)."""
    M = scene.cell_capacity
    nx, ny = scene.grid_nx, scene.grid_ny
    slab, row_start, _, overflow = placement.slab_from_sorted(
        pos, alive, vel, sorted_cid, M, nx, ny
    )
    ps = pair_kernel.pair_pass_a(slab, row_start, M, nx, diameter, noise_amp, tick)
    out = pair_kernel.pair_pass_b_emit(
        slab, ps, row_start, M, nx, diameter, surface_smoothing, target_pressure,
        spring_overlap_balance, ignored_pressure, noise_amp, tick,
        enable_spring=scene.enable_spring,
    )
    return pair_sums_from_planes(out[:, :pos.shape[0]], scene.enable_spring, overflow, pos.dtype)


def neighbor_forces_pallas(
    pos: torch.Tensor,
    vel: torch.Tensor,
    alive: torch.Tensor,
    noise_amp: torch.Tensor,
    tick: torch.Tensor,
    diameter: torch.Tensor,
    surface_smoothing: torch.Tensor,
    target_pressure: torch.Tensor,
    ignored_pressure: torch.Tensor,
    spring_overlap_balance: torch.Tensor,
    scene: Scene,
) -> PairSums:
    """Particle-order provider: sort, pass A in slab order, the grids G and
    PS placed from the slab and its pass-A columns, grid-mode pass B, and
    one gather back to the caller's order."""
    M = scene.cell_capacity
    nx, ny = scene.grid_nx, scene.grid_ny
    nxp = grid_width(nx)
    slab, row_start, pslot, overflow = placement.cell_slab(pos, alive, vel, scene)
    ps = pair_kernel.pair_pass_a(slab, row_start, M, nx, diameter, noise_amp, tick)
    grid = placement.place_grid(slab, row_start, M, nx, ny, nxp)
    ps_grid = placement.place_grid(placement.with_features(slab, ps), row_start, M, nx, ny, nxp)
    b_out = pair_kernel.pair_pass_b(
        grid, ps_grid, diameter, surface_smoothing, target_pressure,
        spring_overlap_balance, ignored_pressure, noise_amp, tick,
        enable_spring=scene.enable_spring,
    )
    return gather_pair_sums(
        b_out, pslot, M, nx, ny, nxp, scene.enable_spring, overflow, pos.dtype
    )
