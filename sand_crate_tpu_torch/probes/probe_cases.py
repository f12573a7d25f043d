"""Hard inputs for holding the probe kernels P2 and P3 against their plain
versions.

P2's kernel (``csrc/probes.cu`` ``passa_f32_kernel`` / ``passa_bf16_kernel``)
tiles the grid by 32 columns of a row block, stages the window with a halo
column each side and each slot twice (so that the rotation (s - k) mod m is
an offset), is compiled for each m in 1..8, and packs two columns into
bf16x2 in its bf16 form.  P3's (``hybrid_kernel``) gives a thread two
candidate columns and packs them in its hybrid form.  Each case puts its
inputs where those designs have an edge: an odd m, tr 1, 3 and 8, a grid 32
columns wide (the halo wraps into the tile itself), air blocks, coincident
particles (the squared distance falls to its floor), pairs at exactly one
diameter (the mask's <=), positions far from the origin (the bf16 relative
coordinates), noise on with a tick and a row offset; for P3 an odd W (one
column in the last pair), one visit and 64, equal rw columns, coincident
positions and a candidate at exactly the cutoff.  Inputs are made from a
numpy seed.  ``tests/test_torch_probes.py`` checks on the CPU that each case
holds what it claims (:func:`passa_facts`, :func:`hybrid_facts`) and holds
some against the tools' kernels; ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` hold every kernel on every case, and P2 at every compiled m
on one case (:data:`SWEEP_SLOTS`), bit for bit on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.pmajor import _u01
from . import hybrid_probe, passa_probe

ALIVE_OFFSET = 2.0  # the grid's encoding: an occupied slot holds position + 2, an empty one 0
DIAM = 2.0**-6  # exact in f32 and bf16, so lattice pairs land on the cutoff exactly


class PassaCase(NamedTuple):
    m_slots: int  # M (the kernel runs m = min(M, 8))
    tr: int
    nblocks: int
    nxp: int
    fill: float  # share of occupied slots
    layout: str  # "random", "coincident", "lattice" or "far"
    amp: float  # noise amplitude, in diameters
    tick: int
    row0: int  # the row offset
    air: bool  # every other block air
    seed: int
    claim: str  # what the case exercises, checked by :func:`passa_facts`


PASSA_CASES = {
    "nxp32_tr8": PassaCase(16, 8, 2, 32, 0.5, "random", 0.1, 7, 3, False, 1,
                           "NXP 32 (the halo wraps into the tile), tr 8, every block occupied"),
    "m4_tr3_air": PassaCase(4, 3, 4, 64, 0.6, "random", 0.1, 2, 5, True, 2,
                            "m 4, tr 3, every other block air"),
    "m3_tr1": PassaCase(3, 1, 6, 64, 0.7, "random", 0.05, 9, 0, False, 3,
                        "an odd m (the rotation mod 3), tr 1"),
    "coincident": PassaCase(8, 2, 3, 32, 0.6, "coincident", 0.0, 0, 0, False, 4,
                            "coincident particles: nd2 falls to eps2"),
    "one_diameter": PassaCase(8, 2, 3, 64, 0.5, "lattice", 0.0, 0, 0, False, 5,
                              "pairs at exactly one diameter (the mask's <=)"),
    "far": PassaCase(16, 4, 2, 32, 0.6, "far", 0.1, 11, 7, False, 6,
                     "positions far from the origin (the bf16 relative coordinates)"),
}


# The m sweep: every compiled m (M = 1..8; the kernel is built for each) on
# one small case, m = 1 and 2 being the edges of the twice-staged rotation.
SWEEP_CASE = "m3_tr1"
SWEEP_SLOTS = tuple(range(1, passa_probe.M_LO + 1))


def passa_inputs(case: str, device="cpu", m_slots: int | None = None):
    """(grid (4, NYP, M, NXP) f32, occ, coef, ticks, tr) of the case: cells
    filled as a prefix of their slots, positions in units of DIAM;
    ``m_slots`` replaces the case's M (the m sweep)."""
    c = PASSA_CASES[case]
    if m_slots is not None:
        c = c._replace(m_slots=m_slots)
    rng = np.random.default_rng(c.seed)
    nyp = c.nblocks * c.tr + 2
    shape = (nyp, c.m_slots, c.nxp)
    rows = np.arange(nyp)[:, None, None]
    cols = np.arange(c.nxp)[None, None, :]
    count = rng.binomial(c.m_slots, c.fill, size=(nyp, 1, c.nxp))
    occupied = np.arange(c.m_slots)[None, :, None] < count
    base = 0.9 / DIAM if c.layout == "far" else 0.0  # 2.9 + ...: near the far corner
    px = (base + cols + rng.random(shape)) * DIAM
    py = (base + rows + rng.random(shape)) * DIAM
    if c.layout == "coincident":  # slot 1 of a cell on slot 0
        px[:, 1], py[:, 1] = px[:, 0], py[:, 0]
    if c.layout == "lattice":  # slot 0 on the lattice of spacing DIAM, always occupied
        px[:, 0], py[:, 0] = (cols * DIAM)[:, 0], (rows * DIAM)[:, 0]
        occupied[:, 0] = True
    grid = np.zeros((4,) + shape, np.float32)
    grid[0] = np.where(occupied, ALIVE_OFFSET + px, 0.0)
    grid[1] = np.where(occupied, ALIVE_OFFSET + py, 0.0)
    grid[2:] = np.where(occupied, rng.random((2,) + shape) - 0.5, 0.0)
    occ = np.ones(c.nblocks, np.int32)
    if c.air:
        occ[1::2] = 0
    coef = np.array([DIAM, c.amp * DIAM], np.float32)
    ticks = np.array([c.tick, c.row0], np.int32)
    return (*(torch.as_tensor(a, device=device) for a in (grid, occ, coef, ticks)), c.tr)


def passa_facts(case: str) -> dict:
    """What the case's inputs hold, and whether that is what it claims
    (``"holds"``): counts over the stencil pairs of the occupied blocks
    where both slots are occupied."""
    c = PASSA_CASES[case]
    grid, occ, coef, ticks, tr = passa_inputs(case)
    m = min(c.m_slots, passa_probe.M_LO)
    nyp, nxp = grid.shape[1], grid.shape[3]
    nblocks = (nyp - 2) // tr
    rows = torch.arange(nblocks)[:, None] * tr + torch.arange(tr + 2)[None, :]
    win = grid[:2, :, :m][:, rows]  # (2, nb, tr + 2, m, nxp)
    gy = (ticks[1].long() + rows)[:, :, None, None]
    pid = (gy * (16 * 8192) + torch.arange(m)[None, None, :, None] * 8192
           + torch.arange(nxp)[None, None, None, :])
    npx = win[0] + (_u01(pid * 2, ticks[0]) - 0.5) * coef[1]
    npy = win[1] + (_u01(pid * 2 + 1, ticks[0]) - 0.5) * coef[1]
    full = win[0] > passa_probe.ALIVE_THRESHOLD
    sx, sy, s_on = win[0][:, 1:1 + tr], win[1][:, 1:1 + tr], full[:, 1:1 + tr]
    on_block = occ.bool()[:, None, None, None]
    diam2 = coef[0] * coef[0]
    coincident = boundary = 0
    for dy in range(3):
        for dx in (-1, 0, 1):
            for k in range(m):
                if dy == 1 and dx == 0 and k == 0:
                    continue

                def nb(p):
                    return torch.roll(p[:, dy:dy + tr], (-dx, k), dims=(-1, -2))

                both = s_on & nb(full) & on_block
                rx, ry = sx - nb(win[0]), sy - nb(win[1])
                nrx, nry = sx - nb(npx), sy - nb(npy)
                coincident += int((both & (nrx * nrx + nry * nry <= 1e-24)).sum())
                boundary += int((both & (rx * rx + ry * ry == diam2)).sum())
    pos = win[:, full]
    flags = passa_probe.block_flags(grid, tr)
    facts = dict(m=m, tr=tr, nxp=nxp, air_blocks=int((occ == 0).sum()),
                 content_blocks=int(flags.sum()), coincident_pairs=coincident,
                 boundary_pairs=boundary, least_position=float(pos.min()),
                 noise=bool(coef[1] > 0 and ticks[0] > 0))
    facts["holds"] = {
        "nxp32_tr8": nxp == 32 and tr == 8 and m == 8 and bool(flags.all()),
        "m4_tr3_air": m == 4 and tr == 3 and facts["air_blocks"] == nblocks // 2,
        "m3_tr1": m == 3 and tr == 1,
        "coincident": coincident > 0,
        "one_diameter": boundary > 0,
        "far": facts["least_position"] > ALIVE_OFFSET + 0.9 and facts["noise"]
        and int(ticks[1]) > 0,
    }[case]
    return facts


class HybridCase(NamedTuple):
    blocks: int
    w: int
    iters: int
    equal_rw: bool
    layout: str  # "uniform", "coincident" or "cutoff"
    seed: int
    claim: str  # checked by :func:`hybrid_facts`


HYBRID_CASES = {
    "w2_iters1": HybridCase(1, 2, 1, True, "uniform", 1, "W 2, one visit"),
    "w255_odd": HybridCase(1, 255, 64, True, "uniform", 2,
                           "an odd W: the last column pair holds one column"),
    "w256_tool_rw": HybridCase(1, 256, 64, False, "uniform", 3,
                               "W 256, the tool's random rw columns (the mask ~never holds)"),
    "w256_equal_rw": HybridCase(1, 256, 64, True, "uniform", 4,
                                "equal rw columns: the mask is the cutoff alone"),
    "coincident": HybridCase(1, 256, 1, True, "coincident", 5,
                             "a candidate on its self's position: nd2 falls to eps2"),
    "cutoff": HybridCase(1, 256, 1, True, "cutoff", 6,
                         "a candidate exactly one cutoff from its self, and one just past it"),
}


def _first_visit(sfeat: np.ndarray):
    """The self positions of the first visit (px, py, npx, npy), f32."""
    p = np.float32(hybrid_probe.perturbations(1)[0])
    return [sfeat[:, k] + p for k in range(4)]


def hybrid_inputs(case: str, device="cpu"):
    """(sfeat (blocks * 128, 8), cand (blocks * 8, W), iters) of the case,
    uniform [0, 0.02) as the tool's; "coincident" and "cutoff" place
    candidate j of block 0 against self j (j < 128) at the first visit."""
    c = HYBRID_CASES[case]
    rng = np.random.default_rng(c.seed)
    f32 = np.float32
    sfeat = (rng.random((c.blocks * hybrid_probe.CS, 8)) * 0.02).astype(f32)
    cand = (rng.random((c.blocks * 8, c.w)) * 0.02).astype(f32)
    if c.equal_rw:
        sfeat[:, 7] = 0.0
        cand[7::8] = 0.0
    n = min(hybrid_probe.CS, c.w)
    if c.layout == "coincident":
        for k, v in enumerate(_first_visit(sfeat)):
            cand[k, :n] = v[:n]
    if c.layout == "cutoff":
        # s_px in [0.02, 0.0256): s_px - 0.01f is exact in f32 (Sterbenz,
        # and it lies below 2^-6), so the candidate's x distance is 0.01f
        # and its squared distance diam * diam exactly.
        sfeat[:, 0] = (0.021 + rng.random(sfeat.shape[0]) * 0.004).astype(f32)
        s_px, s_py, _, _ = _first_visit(sfeat)
        cand[0, :n] = s_px[:n] - f32(hybrid_probe.DIAM)
        cand[1, :n] = s_py[:n]
        m = min(n, c.w - n)  # columns n..2n-1: one f32 step further off
        cand[0, n:n + m] = np.nextafter(cand[0, :m], f32(-1.0))
        cand[1, n:n + m] = s_py[:m]
    return torch.as_tensor(sfeat, device=device), torch.as_tensor(cand, device=device), c.iters


def hybrid_facts(case: str) -> dict:
    """What the case's inputs hold at the first visit for the pairs
    (self j, candidate j) and (self j, candidate 128 + j) of block 0, and
    whether that is what it claims (``"holds"``)."""
    c = HYBRID_CASES[case]
    sfeat, cand, iters = hybrid_inputs(case)
    sf, cd = sfeat.numpy(), cand.numpy()
    f32 = np.float32
    n = min(hybrid_probe.CS, c.w)
    s_px, s_py, s_npx, s_npy = (v[:n] for v in _first_visit(sf))
    rx, ry = s_px - cd[0, :n], s_py - cd[1, :n]
    nrx, nry = s_npx - cd[2, :n], s_npy - cd[3, :n]
    diam2 = f32(hybrid_probe.DIAM) * f32(hybrid_probe.DIAM)
    m = min(n, c.w - n) if c.layout == "cutoff" else 0
    px_rx = s_px[:m] - cd[0, n:n + m]
    past = int(((px_rx * px_rx + (s_py[:m] - cd[1, n:n + m]) ** 2) > diam2).sum())
    facts = dict(w=c.w, iters=iters, odd_w=c.w % 2 == 1,
                 equal_rw=bool((sf[:, 7] == 0).all() and (cd[7::8] == 0).all()),
                 coincident=int(((nrx * nrx + nry * nry) == 0).sum()),
                 at_cutoff=int(((rx * rx + ry * ry) == diam2).sum()), just_past=past,
                 mask_fraction=hybrid_probe.mask_fraction(sfeat, cand))
    facts["holds"] = {
        "w2_iters1": c.w == 2 and iters == 1,
        "w255_odd": facts["odd_w"] and iters == 64,
        "w256_tool_rw": not facts["equal_rw"] and facts["mask_fraction"] < 0.01,
        "w256_equal_rw": facts["equal_rw"] and facts["mask_fraction"] > 0.3,
        "coincident": facts["coincident"] == n,
        "cutoff": facts["at_cutoff"] == n and past == m,
    }[case]
    return facts
