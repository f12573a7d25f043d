"""Pair-sum container and cell ids (the main path's part of
``sand_crate_tpu/cellwise.py``; its grid scheme is ROADMAP queue 1 item 8)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from .state import Scene


class PairSums(NamedTuple):
    """Per-particle neighbor-interaction accumulators consumed by step().

    All reductions are over the particle's within-diameter neighbor set,
    matching the per-particle loops of the reference crate.py:261-358.
    """

    p_i: torch.Tensor  # (P,)  particle pressure (crate.py:261-275)
    dv_tension: torch.Tensor  # (P,2) surface-tension kick, dt applied by step()
    pressure_real: torch.Tensor  # (P,2) sum m*(p_i+p_j)*nhat  (crate.py:301-303)
    spring_real: torch.Tensor  # (P,2) sum m*(balance-w)*nhat  (crate.py:330-332)
    visc_vsum: torch.Tensor  # (P,2) sum m*v_j_snapshot       (crate.py:322)
    nbr_cnt: torch.Tensor  # (P,)  neighbor count
    overflow: torch.Tensor  # ()    int32 pairs lost to a capacity limit


def cell_ids_grid(pos: torch.Tensor, alive: torch.Tensor, scene: Scene) -> torch.Tensor:
    """Flat row-major cell id per particle (int32); dead -> the NC sentinel."""
    nx, ny = scene.grid_nx, scene.grid_ny
    c = torch.floor(pos / scene.cell_size).to(torch.int32) + 1
    cx = torch.clamp(c[:, 0], 0, nx - 1)
    cy = torch.clamp(c[:, 1], 0, ny - 1)
    return torch.where(alive, cy * nx + cx, nx * ny).to(torch.int32)
