"""Pair-sum container, cell ids and slot bookkeeping (the parts of
``sand_crate_tpu/cellwise.py`` that the pmajor and pallas backends use; its
XLA grid scheme is ROADMAP queue 1 item 8)."""

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
    overflow: torch.Tensor  # ()    int32 particles past a cell's slot capacity


def cell_ids_grid(pos: torch.Tensor, alive: torch.Tensor, scene: Scene) -> torch.Tensor:
    """Flat row-major cell id per particle (int32); dead -> the NC sentinel."""
    nx, ny = scene.grid_nx, scene.grid_ny
    c = torch.floor(pos / scene.cell_size).to(torch.int32) + 1
    cx = torch.clamp(c[:, 0], 0, nx - 1)
    cy = torch.clamp(c[:, 1], 0, ny - 1)
    return torch.where(alive, cy * nx + cx, nx * ny).to(torch.int32)


def slot_assignment(sorted_cid: torch.Tensor, M: int, NC: int):
    """Slot bookkeeping over cell-sorted ids (the JAX ``slot_assignment``).

    Returns (rank, in_cap, slot_sorted, gather_slot, overflow), all int32
    but ``in_cap`` (bool): ``rank`` is the particle's place in its cell's
    run; ``slot_sorted`` the flat ``cell * M + rank`` grid slot (NC * M when
    dead or over capacity); ``gather_slot`` where the particle reads its
    pair sums — an over-cap particle reads its cell's slot ``rank % M``, a
    cellmate's, rather than zeros; ``overflow`` counts the over-cap alive
    particles.  The rank is the distance to the cell's run start, found by
    searching each id in the sorted ids (the JAX package takes a running
    max over run starts; torch's cummax scan took 2.6 ms a tick at 1M
    particles on an H100, profile_tick.py)."""
    P = sorted_cid.shape[0]
    iota = torch.arange(P, dtype=torch.int32, device=sorted_cid.device)
    run_start = torch.searchsorted(sorted_cid, sorted_cid, out_int32=True)
    rank = iota - run_start
    alive = sorted_cid < NC
    in_cap = (rank < M) & alive
    over = (rank >= M) & alive
    overflow = over.sum(dtype=torch.int32)
    slot_sorted = torch.where(in_cap, sorted_cid * M + rank, NC * M)
    gather_slot = torch.where(
        in_cap, slot_sorted, torch.where(over, sorted_cid * M + rank % M, NC * M)
    )
    return rank, in_cap, slot_sorted.to(torch.int32), gather_slot.to(torch.int32), overflow
