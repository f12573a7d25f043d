"""Hard inputs for holding the slab-order grid passes against their plain
versions.

``pair_pass_a`` and ``pair_pass_b_emit`` (``csrc/grid_pair.cu``) stage each
warp tile's three candidate windows through shared memory in pieces of
``SLAB_PIECE`` candidates and walk each self's exact cells in slab order;
the plain versions walk (dy, dx, rank) directly, and the dense plain
versions on the padded slot grid are their oracle.  Each case puts
particles where that design has an edge: cells deeper than the capacity
(over-cap candidates and selves), a window longer than a piece, tiles
across grid rows, the grid's first and last rows and columns, fewer
selves than a tile, a ragged last tile, a dead tail.  Positions are made
from a numpy seed in units of the scene's cell size (the diameter), so a
case fits any scene of at least 48 x 48 cells.  ``tests/test_torch_gridslab.py``
(the CPU), ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` (the card)
run every case with collider noise on, pass A at row offsets 0 and 5 and
emit-mode pass B with the spring off and on; and grid-mode pass B
(``pair_pass_b``, which tiles the dense grid by 32 cells of a row and
stages each occupied tile's neighbourhood) on G and PS placed from the
case's slab, spring off and on, row offsets 0 and 5
(:func:`grid_variants`).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..cellwise import cell_ids_grid
from . import pair_kernel as pk
from . import placement


class Case(NamedTuple):
    n: int  # particles
    side: float  # the square they fill, in diameters (edges: the band's depth)
    corner: float  # its lower-left corner, in diameters
    alive: float  # share of alive particles
    m_slots: int  # cell capacity
    seed: int
    claim: str  # what the case exercises, checked by :func:`facts`


CASES = {
    "deep_m8": Case(600, 6.0, 10.0, 1.0, 8, 3, "cells deeper than 8 at cell capacity 8"),
    "dense_blob": Case(3000, 2.0, 20.0, 1.0, 16, 7, "a window longer than one staged piece"),
    "row_spanning": Case(700, 40.0, 2.0, 0.9, 16, 11, "tiles across grid rows"),
    "edges": Case(800, 1.5, 0.0, 0.95, 16, 17, "the grid's first and last rows and columns"),
    "under_one_tile": Case(23, 3.0, 20.0, 1.0, 16, 9, "P smaller than one tile"),
    "ragged": Case(685, 10.0, 12.0, 1.0, 8, 5, "P not a multiple of the tile"),
    "dead_tail": Case(2000, 20.0, 14.0, 0.6, 16, 13, "a 40% dead tail"),
}
ROW_OFFSETS = (0, 5)
NOISE, TICK = 0.1, 5  # collider noise (x diameter) and tick


def case_scene(case: str, scene):
    """``scene`` at the case's cell capacity."""
    return dataclasses.replace(scene, cell_capacity=CASES[case].m_slots)


def sorted_particles(case: str, scene, device):
    """(pos, vel, alive, sorted cell ids) of the case, cell-sorted."""
    c = CASES[case]
    rng = np.random.default_rng(c.seed)
    d = scene.cell_size
    if case == "edges":  # bands along the four sides, reaching past them
        u = rng.random((c.n, 2))
        side = rng.integers(0, 4, c.n)
        far = np.array([scene.grid_nx, scene.grid_ny]) - 2.0
        depth = (rng.random(c.n) - 0.5) * c.side  # cells 0/1 or the last two
        axis = side % 2
        pos = u * far
        pos[np.arange(c.n), axis] = np.where(side < 2, depth, far[axis] + depth + 0.5)
        pos = pos * d
    else:
        pos = (rng.random((c.n, 2)) * c.side + c.corner) * d
    vel = rng.random((c.n, 2)) - 0.5
    alive = rng.random(c.n) < c.alive
    f32 = dict(dtype=torch.float32, device=device)
    pos, vel = torch.as_tensor(pos, **f32), torch.as_tensor(vel, **f32)
    alive = torch.as_tensor(alive, device=device)
    cid, order = torch.sort(cell_ids_grid(pos, alive, scene), stable=True)
    return pos[order], vel[order], alive[order], cid


def case_slab(case: str, scene, device):
    """(slab, row_start, sorted cell ids) of the case at its capacity."""
    pos, vel, alive, cid = sorted_particles(case, scene, device)
    slab, row_start, _, _ = placement.slab_from_sorted(
        pos, alive, vel, cid, CASES[case].m_slots, scene.grid_nx, scene.grid_ny)
    return slab, row_start, cid


def facts(case: str, scene, device) -> dict:
    """What the case's inputs hold at the kernels' tile and piece edges,
    and whether that is what the case claims (``"holds"``)."""
    c = CASES[case]
    slab, row_start, cid = case_slab(case, scene, device)
    nx, ny = scene.grid_nx, scene.grid_ny
    P, n = cid.shape[0], int(row_start[-1])
    win = pk.tile_windows(slab, row_start, nx)
    staged = (win[3:] - win[:3]).clamp(min=0).sum(dim=0)
    row, cx = slab[pk.ROW, :n].long(), slab[pk.CX, :n].long()
    deepest = int(torch.bincount(cid[:n].long()).max()) if n else 0
    ntiles, live_tiles = -(-P // pk.SLAB_TILE), -(-n // pk.SLAB_TILE)
    first = row[::pk.SLAB_TILE]
    last = row[torch.clamp(torch.arange(live_tiles, device=device) * pk.SLAB_TILE
                           + pk.SLAB_TILE - 1, max=n - 1)]
    rows_spanned = int((last - first).max()) + 1 if n else 0
    edges = (int(cx.min()), int(cx.max()), int(row.min()), int(row.max())) if n else ()
    holds = {
        "deep_m8": deepest > c.m_slots,
        "dense_blob": int(staged.max()) > pk.SLAB_PIECE,
        "row_spanning": rows_spanned > 2,
        "edges": edges == (0, nx - 1, 0, ny - 1),
        "under_one_tile": P < pk.SLAB_TILE,
        "ragged": P > pk.SLAB_TILE and P % pk.SLAB_TILE != 0,
        "dead_tail": live_tiles < ntiles,
    }[case]
    return dict(P=P, alive=n, deepest_cell=deepest, longest_window=int(staged.max()),
                rows_spanned=rows_spanned, dead_tiles=ntiles - live_tiles, holds=holds)


def variants(case: str, scene, device):
    """(label, kernel call, plain call, dense call) for pass A at each row
    offset and emit-mode pass B with the spring off and on, on the case's
    slab; pass B's pass-A columns come from the plain pass A.  The dense
    call is the same function through the padded slot grid."""
    m = CASES[case].m_slots
    nx = scene.grid_nx
    slab, row_start, _ = case_slab(case, scene, device)
    d = scene.cell_size

    def scalar(v, dtype=torch.float32):
        return torch.tensor(v, dtype=dtype, device=device)

    diam, amp, tick = scalar(d), scalar(NOISE * d), scalar(TICK, torch.int32)
    head = (slab, row_start, m, nx)
    out = []
    for off in ROW_OFFSETS:
        a_args = head + (diam, amp, tick)
        out.append((f"pass A row offset {off}",
                    lambda a=a_args, o=off: pk.pair_pass_a(*a, row_offset=o),
                    lambda a=a_args, o=off: pk.pair_pass_a_slab_plain(*a, row_offset=o),
                    lambda a=a_args, o=off: pk.pass_a_via_grid(*a, row_offset=o)))
    ps = pk.pair_pass_a_slab_plain(*head, diam, amp, tick)
    coefs = (diam, scalar(100.0), scalar(-2.0), scalar(0.5), scalar(0.3), amp, tick)
    for spring in (False, True):
        b_args = (slab, ps, row_start, m, nx) + coefs
        out.append((f"emit spring={spring}",
                    lambda a=b_args, s=spring: pk.pair_pass_b_emit(*a, enable_spring=s),
                    lambda a=b_args, s=spring: pk.pair_pass_b_emit_plain(*a, enable_spring=s),
                    lambda a=b_args, s=spring: pk.pass_b_emit_via_grid(*a, enable_spring=s)))
    return out


def grid_variants(case: str, scene, device):
    """(label, kernel call, plain call) for grid-mode pass B with the spring
    off and on at row offsets 0 and 5, on the grids G and PS placed from the
    case's slab and its plain pass-A columns."""
    from .pallas_forces import grid_width

    m = CASES[case].m_slots
    nx, ny = scene.grid_nx, scene.grid_ny
    nxp = grid_width(nx)
    slab, row_start, _ = case_slab(case, scene, device)
    d = scene.cell_size

    def scalar(v, dtype=torch.float32):
        return torch.tensor(v, dtype=dtype, device=device)

    diam, amp, tick = scalar(d), scalar(NOISE * d), scalar(TICK, torch.int32)
    ps = pk.pair_pass_a_slab_plain(slab, row_start, m, nx, diam, amp, tick)
    grid = placement.place_grid_plain(slab, row_start, m, nx, ny, nxp)
    ps_grid = placement.place_grid_plain(placement.with_features(slab, ps), row_start, m, nx,
                                         ny, nxp)
    args = (grid, ps_grid, diam, scalar(100.0), scalar(-2.0), scalar(0.5), scalar(0.3), amp,
            tick)
    out = []
    for spring in (False, True):
        for off in ROW_OFFSETS:
            kw = dict(enable_spring=spring, row_offset=off)
            out.append((f"grid pass B spring={spring} row offset {off}",
                        lambda kw=kw: pk.pair_pass_b(*args, **kw),
                        lambda kw=kw: pk.pair_pass_b_plain(*args, **kw)))
    return out
