"""Pair-sum container, cell ids, slot bookkeeping and the dense all-pairs
backend (the parts of ``sand_crate_tpu/cellwise.py`` that the port's
backends use; its XLA grid scheme is ROADMAP queue 1 item 8)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from .state import Scene

EPS = 1e-12


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


def neighbor_forces_dense(
    pos: torch.Tensor,
    vel: torch.Tensor,
    alive: torch.Tensor,
    noise: torch.Tensor,
    diameter: torch.Tensor,
    surface_smoothing: torch.Tensor,
    target_pressure: torch.Tensor,
    ignored_pressure: torch.Tensor,
    spring_overlap_balance: torch.Tensor,
    scene: Scene,
) -> PairSums:
    """All-pairs masked (P, P) pair sums: no sort, no grid (the JAX
    ``neighbor_forces_dense``, sand_crate_tpu/cellwise.py:334-392).

    A pair (i, j) counts when both are alive, i != j and their distance is
    at most one diameter; its direction and weight use j's position plus
    ``noise[j]`` (the collider jitter, drawn by the caller).  Every term is
    the JAX function's, in its order, on x and y planes kept apart, so that
    no (P, P, 2) tensor is built; each plane is dropped once its last use
    is past (at a batch of 1024 crates of 640 slots one f32 plane is 1.68
    GB).  Nothing is read back to the host, so the function vmaps over a
    leading crate axis.  ``spring_real`` is zero unless
    ``scene.enable_spring`` (the step reads it only then)."""
    dtype = pos.dtype
    P = pos.shape[0]
    diam = torch.clamp(diameter, min=EPS)
    px, py = pos[:, 0], pos[:, 1]
    rx = px[:, None] - px[None, :]
    ry = py[:, None] - py[None, :]
    d2 = rx * rx + ry * ry
    del rx, ry
    eye = torch.eye(P, dtype=torch.bool, device=pos.device)
    mb = (d2 <= diam * diam) & alive[:, None] & alive[None, :] & ~eye
    del d2, eye
    m = mb.to(dtype)
    qx = px + noise[:, 0]
    qy = py + noise[:, 1]
    nx = px[:, None] - qx[None, :]
    ny = py[:, None] - qy[None, :]
    dist = torch.sqrt(torch.clamp(nx * nx + ny * ny, min=0.0))
    den = torch.clamp(dist, min=EPS)
    nx = nx / den
    ny = ny / den
    del den
    w = m * (1.0 - torch.clamp(dist / diam, 0.0, 1.0))
    del dist

    cnt = m.sum(dim=1)
    p_i = torch.where(cnt > 0, torch.clamp(w.sum(dim=1) - ignored_pressure, min=0.0), 0.0)
    coeff = (1.0 - w) * w
    sx = (coeff * nx).sum(dim=1)
    sy = (coeff * ny).sum(dim=1)
    del coeff

    align = ((sx[:, None] - sx[None, :]) * nx + (sy[:, None] - sy[None, :]) * ny) * (
        surface_smoothing
    )
    t = m * (align + (p_i[None, :] + p_i[:, None] - 2.0 * target_pressure))
    del align
    dv_tension = torch.stack([(t * nx).sum(dim=1), (t * ny).sum(dim=1)], dim=-1)
    t = m * (p_i[:, None] + p_i[None, :])
    pressure_real = torch.stack([(t * nx).sum(dim=1), (t * ny).sum(dim=1)], dim=-1)
    if scene.enable_spring:
        t = m * (spring_overlap_balance - w)
        spring_real = torch.stack([(t * nx).sum(dim=1), (t * ny).sum(dim=1)], dim=-1)
    else:
        spring_real = torch.zeros_like(pos)
    del t, w, nx, ny
    visc_vsum = torch.stack([(m * vel[None, :, 0]).sum(dim=1), (m * vel[None, :, 1]).sum(dim=1)],
                            dim=-1)
    return PairSums(
        p_i=p_i,
        dv_tension=dv_tension,
        pressure_real=pressure_real,
        spring_real=spring_real,
        visc_vsum=visc_vsum,
        nbr_cnt=cnt,
        overflow=torch.zeros((), dtype=torch.int32, device=pos.device),
    )
