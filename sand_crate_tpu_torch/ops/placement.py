"""The cell-sorted placement slab and the padded slot grid built from it.

The PyTorch counterpart of ``sand_crate_tpu/ops/placement.py``:

1.  :func:`slab_from_sorted` (torch): from cell-sorted particles, the
    (8, P_pad) f32 slab [posx + off, posy + off, velx, vely, cx, rank, row,
    in_cap] and the per-row start offsets ``row_start`` (ny + 1,) of the
    sorted order.  :func:`cell_slab` / :func:`slab_from_cid` sort particle-
    order operands first and return the ``pslot`` gather map.
2.  :func:`place_grid`: the padded grid G (4, ny + 2, M, nxp) with the
    in-cap particle of rank m in cell (row, cx) at [:, row + 1, m, cx + 1]
    and zeros elsewhere.  On CUDA tensors it zeroes G and launches the
    placement kernel of ``csrc/grid_pair.cu`` (one thread per slab column,
    a direct slot write); on CPU tensors it runs :func:`place_grid_plain`.
    The tick's pair passes read the slab itself; the particle-order
    provider places G and, from :func:`with_features`, the pass-A grid PS.

The JAX package places with bf16 one-hot matmuls on the TPU's matrix unit
(a 3-way exact split, x-tile gating, DMA chunks, a lo and a hi pass); a
direct write needs none of it.  The slab keeps the JAX width P_pad =
round_up(P, 128) + 1024, so the two packages' slabs compare column for
column.
"""

from __future__ import annotations

import torch

from ..cellwise import cell_ids_grid, slot_assignment
from ..state import Scene
from .pair_kernel import ALIVE_OFFSET, NUM_G, check_cuda, load_lib, run_kernel

CHUNK = 1024  # slab tail padding of the JAX layout (its DMA chunk)
SLAB_F = 8  # posx+off, posy+off, velx, vely, cx, rank, row, in_cap


def slab_width(P: int) -> int:
    """P_pad of the JAX slab: round_up(P, 128) + CHUNK."""
    return ((P + 127) // 128) * 128 + CHUNK


def cell_slab(pos, alive, vel, scene: Scene):
    """Sort by cell and build the slab: (slab, row_start, pslot, overflow),
    ``pslot`` the (P,) particle-order gather slot."""
    cid = cell_ids_grid(pos, alive, scene)
    return slab_from_cid(pos, alive, vel, cid, scene.cell_capacity, scene.grid_nx, scene.grid_ny)


def slab_from_cid(pos, alive, vel, cid, M: int, nx: int, ny: int):
    """The slab from particle-order operands and cell ids (dead -> nx * ny):
    a stable sort, the sorted slab, and the inverse map ``pslot`` (P,) int32
    from particle order to gather slot (nx * ny * M when dead)."""
    P = pos.shape[0]
    sorted_cid, order = torch.sort(cid, stable=True)
    slab, row_start, gather_slot, overflow = slab_from_sorted(
        pos[order], alive[order], vel[order], sorted_cid, M, nx, ny
    )
    pslot = torch.full((P,), nx * ny * M, dtype=torch.int32, device=pos.device)
    pslot[order] = gather_slot
    return slab, row_start, pslot, overflow


def slab_from_sorted(pos, alive, vel, sorted_cid, M: int, nx: int, ny: int):
    """Placement slab from cell-sorted operands.

    Returns (slab (8, P_pad) f32, row_start (ny + 1,) int32, gather_slot (P,)
    int32 in sorted order, overflow () int32).  Dead particles carry cx 0,
    row ny and in_cap 0; the padding columns are zero.  Built out of place,
    so it vmaps over a crate axis."""
    P = pos.shape[0]
    rank, in_cap, _, gather_slot, overflow = slot_assignment(sorted_cid, M, nx * ny)
    off = ALIVE_OFFSET * alive.to(pos.dtype)[:, None]
    f32 = torch.float32
    cols = torch.cat([
        (pos + off).to(f32).T,
        vel.to(f32).T,
        torch.stack([sorted_cid % nx, rank, sorted_cid // nx, in_cap]).to(f32),
    ])
    slab = torch.nn.functional.pad(cols, (0, slab_width(P) - P))
    starts = torch.arange(ny + 1, dtype=sorted_cid.dtype, device=pos.device) * nx
    row_start = torch.searchsorted(sorted_cid, starts, out_int32=True)
    return slab, row_start, gather_slot, overflow


def with_features(slab, features):
    """The slab with its rows 0-3 replaced by ``features`` (4, P_pad): placed
    by :func:`place_grid`, each in-cap column's features land in its slot."""
    return torch.cat([features, slab[NUM_G:]])


def place_grid_plain(slab, row_start, m_slots: int, nx: int, ny: int, nxp: int):
    """Plain torch version of the placement kernel: the in-cap columns'
    four features copied into a zeroed grid (``index_copy_`` on the
    flattened slot axis)."""
    del row_start, nx
    valid = slab[7] > 0.0
    cx, rank, row = (slab[r][valid].long() for r in (4, 5, 6))
    grid = torch.zeros((NUM_G, ny + 2, m_slots, nxp), dtype=torch.float32, device=slab.device)
    flat = ((row + 1) * m_slots + rank) * nxp + cx + 1
    grid.view(NUM_G, -1).index_copy_(1, flat, slab[:NUM_G][:, valid])
    return grid


def place_grid(slab, row_start, m_slots: int, nx: int, ny: int, nxp: int):
    """Dense padded particle grid (4, ny + 2, m_slots, nxp) from the slab.

    ``row_start`` and ``nx`` keep the JAX signature; the slab's own cx,
    rank and row columns say where each particle goes."""
    if slab.device.type == "cpu":
        return place_grid_plain(slab, row_start, m_slots, nx, ny, nxp)
    p_pad = slab.shape[1]
    check_cuda("place_grid: slab", slab, torch.float32, (SLAB_F, p_pad))
    grid = torch.zeros((NUM_G, ny + 2, m_slots, nxp), dtype=torch.float32, device=slab.device)
    run_kernel("place_grid", load_lib().sc_place_grid, slab.data_ptr(), grid.data_ptr(),
               p_pad, m_slots, ny + 2, nxp, device=slab.device)
    return grid
