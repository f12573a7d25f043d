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

The batched inputs (:func:`batch_variants`) stack the cases on a crate axis
for the passes' crate-axis launch, at one cell capacity
(``BATCH_SLOTS``): each case padded with dead slots to the largest case's
size (so the alive counts differ widely), then a crate with no alive
particle, each crate with coefficients, noise and a tick of its own; the
crate-axis launch is held to the plain version and to the solo launch of
each crate.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..cellwise import cell_ids_grid
from . import pair_kernel as pk
from . import placement
from .crate_axis import EMPTY, crates_plain, padded_crates, spread_widely


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


# The batched inputs: the cases on a crate axis at one cell capacity, then
# an empty crate.
BATCH = tuple(CASES) + (EMPTY,)
BATCH_SLOTS = 8


def batch_slabs(scene, device, names=BATCH):
    """(slab (B, 8, P_pad), row_start (B, ny + 1)) of the cases ``names``
    (EMPTY: no alive particle) at BATCH_SLOTS slots a cell, each padded with
    dead particles (cell id NC, sorted last) to the largest case's size."""
    nx, ny = scene.grid_nx, scene.grid_ny
    crates = padded_crates(names, lambda name: sorted_particles(name, scene, device), nx * ny,
                           device)
    slabs = [placement.slab_from_sorted(pos, alive, vel, cid, BATCH_SLOTS, nx, ny)[:2]
             for pos, vel, alive, cid in crates]
    return tuple(torch.stack(x) for x in zip(*slabs))


def batch_coefs(B: int, d: float, device):
    """Each crate's (pass A coefficients (B, 2), pass B coefficients (B, 6),
    tick (B,)): diameters up to the cell size d, noise, smoothing, target
    pressures, balances, ignored pressures and ticks that differ per
    crate (the rows of pair_kernel.coef_a / coef_b)."""
    i = torch.arange(B, dtype=torch.float32, device=device)
    diam = d * (1.0 - 0.1 * (i % 3))
    amp = NOISE * d * (1.0 + 0.2 * i)
    coef_b = torch.stack([diam, 100.0 - 5.0 * i, -2.0 + 0.5 * i, 0.5 + 0.05 * i, amp,
                          0.3 + 0.02 * i], dim=1)
    return torch.stack([diam, amp], dim=1), coef_b, (TICK + 3 * i).to(torch.int32)


def batch_facts(scene, device, names=BATCH) -> dict:
    """The batch's alive counts and whether they differ widely, with an
    empty crate among them (``"holds"``)."""
    slab, row_start = batch_slabs(scene, device, names)
    counts = row_start[:, -1].tolist()
    return dict(P_pad=slab.shape[-1], alive=counts, holds=spread_widely(counts))


def batch_variants(scene, device, names=BATCH):
    """(label, crate-axis call, plain calls, solo kernel calls) for pass A
    at row offsets 0 and 5 and emit-mode pass B with the spring off and on,
    on the batched inputs; the plain and solo calls run each crate alone
    and stack the results.  Pass B's pass-A columns come from the plain
    pass A."""
    m, nx = BATCH_SLOTS, scene.grid_nx
    slab, row_start = batch_slabs(scene, device, names)
    coef_a, coef_b, tick = batch_coefs(len(names), scene.cell_size, device)

    def each(fn, *xs):
        return crates_plain("batch_variants", fn, xs)

    out = []
    for off in ROW_OFFSETS:
        def plain_a(s, r, c, t, o=off):
            return pk.pair_pass_a_slab_plain(s, r, m, nx, c[0], c[1], t, row_offset=o)

        def solo_a(s, r, c, t, o=off):
            return pk.pair_pass_a(s, r, m, nx, c[0], c[1], t, row_offset=o)

        out.append((f"pass A row offset {off}",
                    lambda o=off: pk.pair_pass_a_crates(slab, row_start, m, nx, coef_a, tick,
                                                        row_offset=o),
                    lambda f=plain_a: each(f, slab, row_start, coef_a, tick),
                    lambda f=solo_a: each(f, slab, row_start, coef_a, tick)))
    ps = each(lambda s, r, c, t: pk.pair_pass_a_slab_plain(s, r, m, nx, c[0], c[1], t),
              slab, row_start, coef_a, tick)
    for spring in (False, True):
        def plain_b(s, p, r, c, t, sp=spring):  # c: coef_b's order
            return pk.pair_pass_b_emit_plain(s, p, r, m, nx, c[0], c[1], c[2], c[3], c[5], c[4],
                                             t, enable_spring=sp)

        def solo_b(s, p, r, c, t, sp=spring):
            return pk.pair_pass_b_emit(s, p, r, m, nx, c[0], c[1], c[2], c[3], c[5], c[4], t,
                                       enable_spring=sp)

        out.append((f"emit spring={spring}",
                    lambda sp=spring: pk.pair_pass_b_emit_crates(
                        slab, ps, row_start, m, nx, coef_b, tick, enable_spring=sp),
                    lambda f=plain_b: each(f, slab, ps, row_start, coef_b, tick),
                    lambda f=solo_b: each(f, slab, ps, row_start, coef_b, tick)))
    return out
