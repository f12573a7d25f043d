"""Hard inputs for holding the K1/K2 kernel against its plain version.

``pm_pass`` (``csrc/pmajor.cu``) stages each tile of ``PM_TILE`` sorted
selves' candidate windows through shared memory in pieces of ``PM_PIECE``
candidates; ``pm_pass_plain`` walks each self's ranges directly.  Each case
below puts particles where that design has an edge: a range longer than a
piece, tiles across many grid rows, a ragged last tile, fewer selves than
one tile, whole tiles of dead selves.  Positions are made from a numpy seed
in units of the scene's cell size (the diameter), so a case fits any scene;
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` run every case, pass A
and every pass-B variant, with two-sided and one-sided noise, and require
the kernel's bits.  K10 (``pms_pass``) runs the same walk on ranges it
finds inside each chunk's window (:func:`pmajor.window_ranges`); it runs on
every case at both chunk sizes (:func:`k10_variants`), held to its plain
version and to K1/K2 one-sided.

The batched inputs (:func:`batch_variants`) stack the cases on a crate axis
for the crate-axis launches of K1/K2 and K10: each case padded with dead
slots to the largest case's size (so the alive counts differ widely), then
a crate with no alive particle, each crate with coefficients, noise and a
tick of its own; the crate-axis launch is held to the plain version and to
the solo launch of each crate.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..cellwise import cell_ids_grid
from . import pmajor
from .crate_axis import EMPTY, crates_plain, padded_crates, spread_widely


class Case(NamedTuple):
    n: int  # particles
    side: float  # the square they fill, in diameters
    corner: float  # its lower-left corner, in diameters
    alive: float  # share of alive particles
    seed: int
    claim: str  # what the case exercises, checked by :func:`facts`


T = pmajor.PM_TILE
CASES = {
    "random": Case(20000, 90.0, 68.0, 0.95, 2, "several selves per cell, 5% dead"),
    "dense_blob": Case(3000, 2.0, 20.0, 1.0, 7, "a range longer than one piece"),
    "row_spanning": Case(4096, 200.0, 10.0, 0.9, 11, "tiles across many grid rows"),
    "ragged_tile": Case(685, 10.0, 30.0, 1.0, 5, "P not a multiple of the tile"),
    "under_one_tile": Case(23, 3.0, 40.0, 1.0, 9, "P smaller than one tile"),
    "dead_tail": Case(2000, 20.0, 50.0, 0.6, 13, "whole tiles of dead selves"),
}


def sorted_particles(case: str, scene, device):
    """(pos, vel, alive, sorted cell ids) of the case, cell-sorted."""
    c = CASES[case]
    rng = np.random.default_rng(c.seed)
    d = scene.cell_size
    pos = (rng.random((c.n, 2)) * c.side + c.corner) * d
    vel = rng.random((c.n, 2)) - 0.5
    alive = rng.random(c.n) < c.alive
    f32 = dict(dtype=torch.float32, device=device)
    pos, vel = torch.as_tensor(pos, **f32), torch.as_tensor(vel, **f32)
    alive = torch.as_tensor(alive, device=device)
    cid, order = torch.sort(cell_ids_grid(pos, alive, scene), stable=True)
    return pos[order], vel[order], alive[order], cid


def facts(case: str, scene, device) -> dict:
    """What the case's inputs hold at the kernel's tile and piece edges, and
    whether that is what the case claims (``"holds"``)."""
    _, _, alive, cid = sorted_particles(case, scene, device)
    P = cid.shape[0]
    ranges = pmajor.candidate_ranges(cid, alive, scene.grid_nx, scene.grid_ny)
    longest = int((ranges[3:] - ranges[:3]).max())
    n_alive = int(alive.sum())
    ntiles, live_tiles = -(-P // T), -(-n_alive // T)
    rows = torch.where(alive, cid // scene.grid_nx, -1)
    rows = torch.nn.functional.pad(rows, (0, ntiles * T - P), value=-1).view(ntiles, T)
    first = rows[:, 0]
    last = rows.max(dim=1).values
    rows_spanned = int((last - first)[first >= 0].max()) + 1 if n_alive else 0
    holds = {
        "random": n_alive < P and longest > 3,
        "dense_blob": longest > pmajor.PM_PIECE,
        "row_spanning": rows_spanned > 2,
        "ragged_tile": P > T and P % T != 0,
        "under_one_tile": P < T,
        "dead_tail": live_tiles < ntiles,
    }[case]
    return dict(P=P, alive=n_alive, longest_range=longest, rows_spanned=rows_spanned,
                tiles=ntiles, dead_tiles=ntiles - live_tiles, holds=holds)


def variants(case: str, scene, device):
    """(label, kernel call, plain call) for pass A and pass B folded, split
    and split with the spring, each with two-sided and one-sided noise, on
    the case's particles.  Pass B's slab is made from the plain pass A."""
    pos, vel, alive, cid = sorted_particles(case, scene, device)
    ranges = pmajor.candidate_ranges(cid, alive, scene.grid_nx, scene.grid_ny)
    d = scene.cell_size
    coef = torch.tensor([d, -2.0, 0.5], dtype=torch.float32, device=device)
    amp = torch.tensor(0.1 * d, dtype=torch.float32, device=device)
    tick = torch.tensor(5, dtype=torch.int32, device=device)
    out = []
    for symm in (True, False):
        slab_a = pmajor.pass_a_slab(pos, vel, alive, cid, amp, tick, scene, symm=symm)
        out.append((f"symm={symm} pass A", slab_a, "a", dict(symm=symm)))
        out_a = pmajor.pm_pass_plain(slab_a, ranges, coef, "a", symm=symm)
        cp = pmajor.finalize_cp(out_a[0], out_a[3], torch.tensor(0.3, device=device))
        slab_b = pmajor.pass_b_slab(slab_a, out_a, cp, torch.tensor(100.0, device=device))
        for name, kw in (("fold", dict(fold=True)), ("split", {}), ("split+spring", dict(spring=True))):
            out.append((f"symm={symm} pass B {name}", slab_b, "b", dict(symm=symm, **kw)))
    return [(label,
             lambda s=slab, m=mode, kw=kw: pmajor.pm_pass(s, ranges, coef, m, **kw),
             lambda s=slab, m=mode, kw=kw: pmajor.pm_pass_plain(s, ranges, coef, m, **kw))
            for label, slab, mode, kw in out]


def k10_variants(case: str, scene, device):
    """(label, K10 call, plain call, K1/K2 one-sided call) for pass A, pass B
    folded, pass B split and pass B split with the spring (the kernel's four
    instantiations), at both chunk sizes, on the case's particles with
    one-sided noise."""
    pos, vel, alive, cid = sorted_particles(case, scene, device)
    nx, ny = scene.grid_nx, scene.grid_ny
    ranges = pmajor.candidate_ranges(cid, alive, nx, ny)
    d = scene.cell_size
    coef = torch.tensor([d, -2.0, 0.5], dtype=torch.float32, device=device)
    amp = torch.tensor(0.1 * d, dtype=torch.float32, device=device)
    tick = torch.tensor(5, dtype=torch.int32, device=device)
    slab_a = pmajor.pass_a_slab(pos, vel, alive, cid, amp, tick, scene, symm=False)
    out_a = pmajor.pm_pass_plain(slab_a, ranges, coef, "a")
    cp = pmajor.finalize_cp(out_a[0], out_a[3], torch.tensor(0.3, device=device))
    slab_b = pmajor.pass_b_slab(slab_a, out_a, cp, torch.tensor(100.0, device=device))
    passes = (("pass A", slab_a, "a", {}), ("pass B fold", slab_b, "b", dict(fold=True)),
              ("pass B split", slab_b, "b", {}),
              ("pass B split+spring", slab_b, "b", dict(spring=True)))
    out = []
    for chunk in pmajor.PMS_CHUNKS:
        win = pmajor.chunk_windows(cid, alive, nx, ny, chunk)
        for name, slab, mode, kw in passes:
            run = dict(slab=slab, cid=cid, windows=win, coef=coef, mode=mode, nx=nx, chunk=chunk,
                       **kw)
            out.append((f"chunk {chunk} {name}",
                        lambda a=run: pmajor.pms_pass(**a),
                        lambda a=run: pmajor.pms_pass_plain(**a),
                        lambda s=slab, m=mode, kw=kw: pmajor.pm_pass(s, ranges, coef, m, **kw)))
    return out


# The batched inputs: the cases on a crate axis, then an empty crate.
BATCH = tuple(CASES) + (EMPTY,)


def batch_particles(scene, device, names=BATCH):
    """(pos, vel, alive, sorted cell ids), each (B, P, ...): the cases
    ``names`` (EMPTY: no alive particle), each padded with dead particles
    (cell id NC, sorted last) to the largest case's size."""
    crates = padded_crates(names, lambda name: sorted_particles(name, scene, device),
                           scene.grid_nx * scene.grid_ny, device)
    return tuple(torch.stack(x) for x in zip(*crates))


def batch_coefs(B: int, d: float, device):
    """Each crate's (coef (B, 3), noise amplitude (B,), tick (B,)): diameters
    up to the cell size d, target pressures, balances, noise and ticks that
    differ per crate."""
    i = torch.arange(B, dtype=torch.float32, device=device)
    coef = torch.stack([d * (1.0 - 0.1 * (i % 3)), -2.0 + 0.5 * i, 0.5 + 0.05 * i], dim=1)
    return coef, 0.1 * d * (1.0 + 0.2 * i), (5 + 3 * i).to(torch.int32)


def batch_facts(scene, device, names=BATCH) -> dict:
    """The batch's alive counts and whether they differ widely, with an
    empty crate among them (``"holds"``)."""
    _, _, alive, _ = batch_particles(scene, device, names)
    counts = alive.sum(dim=1).tolist()
    return dict(P=alive.shape[1], alive=counts, holds=spread_widely(counts))


def batch_variants(scene, device, names=BATCH):
    """(label, crate-axis call, plain calls, solo kernel calls), each
    (B, n_out, P), on the batched inputs: K1/K2 for pass A and pass B
    folded, split and split with the spring, with two-sided and one-sided
    noise; then K10 (labels "K10 chunk ...") for pass A, pass B folded and
    pass B split with the spring at both chunk sizes, one-sided.  The plain
    and solo calls run each crate alone and stack the results; pass B's slab
    is made from the plain pass A."""
    pos, vel, alive, cid = batch_particles(scene, device, names)
    nx, ny = scene.grid_nx, scene.grid_ny
    coef, amp, tick = batch_coefs(len(names), scene.cell_size, device)
    ranges = torch.func.vmap(lambda c, a: pmajor.candidate_ranges(c, a, nx, ny))(cid, alive)
    ign = torch.tensor(0.3, device=device)
    smooth = torch.tensor(100.0, device=device)

    def each(fn, *xs):
        return crates_plain("batch_variants", fn, xs)

    out, slabs = [], {}
    for symm in (True, False):
        slab_a = torch.func.vmap(
            lambda p, v, a, c, m, t: pmajor.pass_a_slab(p, v, a, c, m, t, scene, symm=symm)
        )(pos, vel, alive, cid, amp, tick)
        out.append((f"symm={symm} pass A", slab_a, "a", dict(symm=symm)))
        out_a = each(lambda s, r, c: pmajor.pm_pass_plain(s, r, c, "a", symm=symm),
                     slab_a, ranges, coef)
        cp = pmajor.finalize_cp(out_a[:, 0], out_a[:, 3], ign)
        slab_b = torch.func.vmap(lambda s, o, c: pmajor.pass_b_slab(s, o, c, smooth))(
            slab_a, out_a, cp)
        slabs[symm] = slab_a, slab_b
        for name, kw in (("fold", dict(fold=True)), ("split", {}),
                         ("split+spring", dict(spring=True))):
            out.append((f"symm={symm} pass B {name}", slab_b, "b", dict(symm=symm, **kw)))
    rows = [(label,
             lambda s=slab, m=mode, kw=kw: pmajor.pm_pass_crates(s, ranges, coef, m, **kw),
             lambda s=slab, m=mode, kw=kw: each(
                 lambda a, r, c: pmajor.pm_pass_plain(a, r, c, m, **kw), s, ranges, coef),
             lambda s=slab, m=mode, kw=kw: each(
                 lambda a, r, c: pmajor.pm_pass(a, r, c, m, **kw), s, ranges, coef))
            for label, slab, mode, kw in out]
    slab_a, slab_b = slabs[False]
    for chunk in pmajor.PMS_CHUNKS:
        win = torch.func.vmap(lambda c, a: pmajor.chunk_windows(c, a, nx, ny, chunk))(cid, alive)
        for name, slab, mode, kw in (("pass A", slab_a, "a", {}),
                                     ("pass B fold", slab_b, "b", dict(fold=True)),
                                     ("pass B split+spring", slab_b, "b", dict(spring=True))):
            kw = dict(kw, nx=nx, chunk=chunk)
            rows.append((
                f"K10 chunk {chunk} {name}",
                lambda s=slab, w=win, m=mode, kw=kw: pmajor.pms_pass_crates(s, cid, w, coef, m,
                                                                              **kw),
                lambda s=slab, w=win, m=mode, kw=kw: each(
                    lambda a, c, w, k: pmajor.pms_pass_plain(a, c, w, k, m, **kw),
                    s, cid, w, coef),
                lambda s=slab, w=win, m=mode, kw=kw: each(
                    lambda a, c, w, k: pmajor.pms_pass(a, c, w, k, m, **kw), s, cid, w, coef)))
    return rows
