"""Cell-list neighbor search -> fixed-K neighbor lists (the counterpart of
``sand_crate_tpu/neighbors.py``), for the "gather" backend.

Every alive particle gets a cell id on the diameter-sized grid (dead ones
the sentinel cell NC); one stable sort by cell id fills a dense
(NC + 1, M) cell table (M = ``scene.cell_capacity``; the last row stands
for cells off the grid); each particle then reads the 9 * M candidates of
its 3x3 cells, keeps those within one diameter and, of them, the K nearest
(``scene.max_neighbors``).  Below the cap the list is every neighbor within
one diameter; above it, the reference keeps an order-dependent subset
(collision_detector.py:44-45) and this keeps the K nearest.  Particles past
a cell's capacity are in no table slot, so no one lists them; they are
counted in the overflow.  Equal distances may be ordered differently from
the JAX package's ``lax.top_k`` by ``torch.topk``, which matters only when
the K-th and (K+1)-th nearest tie.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .cellwise import cell_ids_grid, slot_assignment
from .state import Scene


class NeighborList(NamedTuple):
    idx: torch.Tensor  # (P, K) int64 neighbor index (the particle itself where invalid)
    mask: torch.Tensor  # (P, K) bool
    overflow: torch.Tensor  # () int32 particles past their cell's capacity


# The cell id of every particle, dead ones the sentinel num_cells (the JAX
# package has this function twice, in neighbors.py and cellwise.py).
cell_ids = cell_ids_grid


def build_cell_table(cid: torch.Tensor, scene: Scene) -> tuple[torch.Tensor, torch.Tensor]:
    """(table, overflow): the (NC + 1, M) int32 table of particle indices per
    cell, the sentinel P in empty slots and in the whole last row, and the
    count of alive particles past their cell's capacity.  Ranks within a
    cell come from :func:`cellwise.slot_assignment`.  Built out of place
    (a scatter into a new table), so it vmaps over a crate axis."""
    P = cid.shape[0]
    M = scene.cell_capacity
    NC = scene.num_cells
    sorted_cid, order = torch.sort(cid, stable=True)
    _, _, slot_sorted, _, overflow = slot_assignment(sorted_cid, M, NC)
    empty = torch.full(((NC + 1) * M,), P, dtype=torch.int32, device=cid.device)
    # slot NC * M: a dump for the dead and over-cap particles, reset below
    flat = empty.scatter(0, slot_sorted.long(), order.to(torch.int32))
    table = torch.cat([flat[:NC * M], empty[NC * M:]]).reshape(NC + 1, M)
    return table, overflow


def neighbor_list(
    pos: torch.Tensor, alive: torch.Tensor, diameter: torch.Tensor, scene: Scene
) -> NeighborList:
    """Fixed-K nearest-within-diameter neighbor lists of all particles."""
    P = pos.shape[0]
    K = scene.max_neighbors
    nx, ny = scene.grid_nx, scene.grid_ny
    NC = scene.num_cells
    device = pos.device

    table, overflow = build_cell_table(cell_ids(pos, alive, scene), scene)

    # The 3x3 neighborhood's cell ids; cells off the grid -> the sentinel row.
    c = torch.floor(pos / scene.cell_size).to(torch.int32) + 1
    cx = torch.clamp(c[:, 0], 0, nx - 1)
    cy = torch.clamp(c[:, 1], 0, ny - 1)
    offs = torch.arange(-1, 2, dtype=torch.int32, device=device)  # made on the device
    ncx = cx[:, None, None] + offs[None, :, None]  # (P, 3, 1)
    ncy = cy[:, None, None] + offs[None, None, :]  # (P, 1, 3)
    valid_cell = (ncx >= 0) & (ncx < nx) & (ncy >= 0) & (ncy < ny)
    cell = torch.where(valid_cell, ncy * nx + ncx, NC).reshape(P, 9)

    cand = table[cell.long()].reshape(P, -1).long()  # (P, 9M) indices or P
    cand_valid = cand < P
    d = pos[torch.where(cand_valid, cand, 0)] - pos[:, None, :]
    dist2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
    self_idx = torch.arange(P, device=device)[:, None]
    ok = cand_valid & (cand != self_idx) & (dist2 <= diameter * diameter) & alive[:, None]
    score = torch.where(ok, -dist2, -torch.inf)
    top_score, top_slot = torch.topk(score, K, dim=1)
    mask = top_score > -torch.inf
    idx = torch.where(mask, torch.gather(cand, 1, top_slot), self_idx)
    return NeighborList(idx=idx, mask=mask, overflow=overflow)
