"""Hard inputs for holding the probe kernels P1-P4 against their plain
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
positions and a candidate at exactly the cutoff.

P1's kernel (``pmajor_probe_kernel``) stages its three windows TILE columns
at a time and gives a thread two selves; its cases take W 200 and 1000 (a
partial tile, several tiles), windows the kernel clamps at 0 and at VCAP -
W, a last block whose selves and windows run into the slab's zero padding,
a candidate whose jittered position is its self's (nd2 at its 1e-12
floor), candidates at exactly one diameter and one step past it, and a
single block.  P4's (``chain_bf16_kernel`` and the f32 and mixed chains)
cases take an ``a`` and ``b`` that make every step round, inputs below
2^-126 (subnormal in bf16 and f32, which a flush to zero would show),
inputs near 3e38 (overflow to inf), a pair count that does not fill the
last block, and 0, 1 and 3 iterations; every case runs all three kinds.

Inputs are made from a numpy seed.  ``tests/test_torch_probes.py`` and
``tests/test_torch_probe_hard.py`` check on the CPU that each case holds
what it claims (:func:`passa_facts`, :func:`hybrid_facts`,
:func:`pmajor_facts`, :func:`chain_facts`) and hold some against the tools'
kernels; ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold every
kernel on every case, and P2 at every compiled m on one case
(:data:`SWEEP_SLOTS`), bit for bit on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.pmajor import _u01
from . import bf16_probe, hybrid_probe, passa_probe, pmajor_probe

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


# ---- P1: tools/pmajor_probe.py ----------------------------------------------


class PmajorCase(NamedTuple):
    nblocks: int
    w: int
    windows: str  # "inside" (every window start in [0, VCAP - W]) or "clamped"
    layout: str  # "random", "padding", "coincident" or "one_diameter"
    hadd: float  # coef[1]: added to the first hash's seed
    seed: int
    claim: str  # checked by :func:`pmajor_facts`


PMAJOR_CASES = {
    "w200": PmajorCase(2, 200, "inside", "random", 0.0, 11, "W 200: a partial tile"),
    "w1000": PmajorCase(1, 1000, "inside", "random", 3.0, 12,
                        "W 1000: several tiles, the last partial"),
    "clamped": PmajorCase(2, 384, "clamped", "random", 0.0, 13,
                          "window starts the kernel clamps to 0 and to VCAP - W"),
    "padding": PmajorCase(2, 256, "inside", "padding", 0.0, 14,
                          "the last block's selves and windows run into the zero padding"),
    "coincident": PmajorCase(1, 256, "inside", "coincident", 5.0, 15,
                             "a candidate whose jittered position is its self's: nd2 at 1e-12"),
    "one_diameter": PmajorCase(1, 256, "inside", "one_diameter", 0.0, 16,
                               "candidates at exactly one diameter, and one step past it"),
    "single_block": PmajorCase(1, 384, "inside", "random", 0.0, 17, "a single block"),
}
_PLANT_WINDOW = 4096  # where chunk 0 of block 0 finds its planted candidates


def pmajor_inputs(case: str, device="cpu"):
    """(slab_p (8, nblocks * OWN + VCAP), dma_lo, ws, coef, W) of the case:
    alive columns hold ALIVE_OFFSET + a position in a box of 4 diameters
    (about a fifth of the pairs pass the cutoff), small integer cell, rank
    and row columns and a random row 7; the columns past the alive ones are
    zero.  "coincident" and "one_diameter" plant, in chunk 0's window q = 1
    (columns _PLANT_WINDOW + t), a candidate for each self t of chunk 0."""
    c = PMAJOR_CASES[case]
    P = pmajor_probe
    rng = np.random.default_rng(c.seed)
    f32 = np.float32
    width = c.nblocks * P.OWN + P.VCAP
    n_alive = c.nblocks * P.OWN - (5000 if c.layout == "padding" else 0)
    slab = np.zeros((8, width), f32)
    slab[0:2, :n_alive] = ALIVE_OFFSET + rng.random((2, n_alive)) * 4 * DIAM
    slab[2:4, :n_alive] = rng.random((2, n_alive)) - 0.5
    slab[4, :n_alive] = rng.integers(0, 64, n_alive)
    slab[5, :n_alive] = rng.integers(0, 16, n_alive)
    slab[6, :n_alive] = rng.integers(0, 64, n_alive)
    slab[7, :n_alive] = rng.random(n_alive)
    blocks = np.arange(c.nblocks)
    dma_lo = np.maximum(blocks * P.OWN - 128 * rng.integers(0, 17, c.nblocks), 0)
    nchunks = c.nblocks * P.CPB
    base = np.repeat(dma_lo, P.CPB)[:, None]
    if c.windows == "clamped":
        rel = rng.integers(-2000, P.VCAP, (nchunks, 3))
    else:
        rel = rng.integers(0, P.VCAP - c.w + 1, (nchunks, 3))
    ws = base + rel
    coef = np.array([DIAM, c.hadd], f32)
    if c.layout in ("coincident", "one_diameter"):
        ws[0, 1] = _PLANT_WINDOW  # block 0 starts at 0: its chunk 0's selves are columns 0..127
        s_px, s_py = slab[0, :P.CHUNK], slab[1, :P.CHUNK]
        cols = _PLANT_WINDOW + np.arange(P.CHUNK)
        if c.layout == "coincident":
            npx, npy = (v.numpy() for v in P.jitter(torch.as_tensor(slab[:, cols]),
                                                     torch.as_tensor(coef)))
            slab[0, cols] = _preimage(s_px, npx - slab[0, cols])
            slab[1, cols] = _preimage(s_py, npy - slab[1, cols])
        else:
            slab[0, cols], slab[1, cols] = s_px - f32(DIAM), s_py
            past = cols + P.CHUNK  # one f32 step further off
            slab[0, past] = np.nextafter(s_px - f32(DIAM), f32(-np.inf))
            slab[1, past] = s_py
    out = (slab, dma_lo.astype(np.int32), ws.reshape(-1).astype(np.int32), coef)
    return (*(torch.as_tensor(a, device=device) for a in out), c.w)


def _preimage(target: np.ndarray, jitter: np.ndarray) -> np.ndarray:
    """f32 positions p with p + jitter == target exactly (f32), where one of
    target - jitter and its two neighbours gives it."""
    f32 = np.float32
    jitter = jitter.astype(f32)
    best = (target - jitter).astype(f32)
    for cand in (best, np.nextafter(best, f32(np.inf)), np.nextafter(best, f32(-np.inf))):
        hit = (cand + jitter).astype(f32) == target
        best = np.where(hit, cand, best)
    return best


def pmajor_facts(case: str) -> dict:
    """What the case's inputs hold over every (self, candidate) pair the
    kernel evaluates, and whether that is what it claims (``"holds"``)."""
    c = PMAJOR_CASES[case]
    P = pmajor_probe
    slab_p, dma_lo, ws, coef, w = pmajor_inputs(case)
    selves, starts = P._windows(dma_lo, ws, w)
    nchunks = selves.shape[0]
    rel = ws.long().reshape(nchunks, 3) - dma_lo.long().repeat_interleave(P.CPB)[:, None]
    diam2 = coef[0] * coef[0]
    coincident = at_cutoff = just_past = 0
    nd2_max = 0.0
    for k in range(nchunks):
        cand = slab_p[:, (starts[k][:, None] + torch.arange(w)[None, :]).reshape(-1)]
        npx, npy = P.jitter(cand, coef)
        s_px, s_py = slab_p[0, selves[k]][:, None], slab_p[1, selves[k]][:, None]
        rx, ry = s_px - cand[0], s_py - cand[1]
        nrx, nry = s_px - npx, s_py - npy
        d2, nd2 = rx * rx + ry * ry, nrx * nrx + nry * nry
        coincident += int((nd2 <= 1e-12).sum())
        at_cutoff += int((d2 == diam2).sum())
        just_past += int(((d2 > diam2) & (d2 < diam2 * (1 + 1e-4))).sum())
        nd2_max = max(nd2_max, float(nd2.max()))
    last = selves[-P.CPB:]
    last_cand = (starts[-P.CPB:][..., None] + torch.arange(w)).reshape(-1)
    facts = dict(
        nblocks=dma_lo.shape[0], w=w, tiles=-(-w // P.TILE), partial_tile=w % P.TILE != 0,
        clamped_low=int((rel < 0).sum()), clamped_high=int((rel > P.VCAP - w).sum()),
        zero_selves=int((slab_p[0, last] == 0).sum()),
        zero_candidates=int((slab_p[0, last_cand] == 0).sum()),
        coincident=coincident, at_cutoff=at_cutoff, just_past=just_past,
        nd2_max=nd2_max)
    facts["holds"] = {
        "w200": w == 200 and facts["partial_tile"],
        "w1000": w == 1000 and facts["tiles"] >= 3 and facts["partial_tile"],
        "clamped": facts["clamped_low"] > 0 and facts["clamped_high"] > 0,
        "padding": facts["zero_selves"] > 0 and facts["zero_candidates"] > 0,
        "coincident": coincident >= P.CHUNK,
        "one_diameter": at_cutoff >= P.CHUNK and just_past >= P.CHUNK,
        "single_block": facts["nblocks"] == 1,
    }[case] and nd2_max < 2.0**127  # inv_sqrt_rn's range: nd2 in [1e-12, 2^127]
    return facts


# ---- P4: tools/bf16_probe.py ------------------------------------------------


class ChainCase(NamedTuple):
    shape: tuple
    layout: str  # "uniform", "subnormal" or "huge"
    a: float
    b: float
    iters: int
    seed: int
    claim: str  # checked by :func:`chain_facts`


TINY = 2.0**-126  # the least normal f32 (and bf16)
CHAIN_CASES = {
    "rounding": ChainCase((256, 512), "uniform", 0.99, 0.01, 3, 21,
                          "a and b that make every multiply and add round"),
    "subnormal": ChainCase((256, 512), "subnormal", 0.75, 2.0**-133, 3, 22,
                           "inputs, chains and sums below 2^-126: a flush to zero would show"),
    "huge": ChainCase((256, 512), "huge", bf16_probe.A, bf16_probe.B, 1, 23,
                      "inputs near 3e38: chains overflow to inf"),
    "partial": ChainCase((2, 1027), "uniform", bf16_probe.A, bf16_probe.B, 3, 24,
                         "1,027 bf16x2 pairs: the last block is not full"),
    "iters0": ChainCase((256, 512), "uniform", bf16_probe.A, bf16_probe.B, 0, 25,
                        "no iteration: the scale and the sum alone"),
}


def chain_inputs(case: str, kind: str, device="cpu"):
    """(x, iters, a, b) of the case for ``kind`` (bf16 input for the bf16
    chains, f32 otherwise)."""
    c = CHAIN_CASES[case]
    u = np.random.default_rng(c.seed).random(c.shape)
    x = {"uniform": u, "subnormal": u * (TINY / 8), "huge": 3e38 * (0.9 + 0.1 * u)}[c.layout]
    dtype = torch.bfloat16 if kind == "bf16" else torch.float32
    return torch.as_tensor(x.astype(np.float32), device=device).to(dtype), c.iters, c.a, c.b


def chain_facts(case: str) -> dict:
    """What the case's inputs hold, and whether that is what it claims
    (``"holds"``): the bf16 chain of lane 0 stepped in the plain version's
    roundings, and the plain outputs of every kind."""
    c = CHAIN_CASES[case]
    x, iters, a, b = chain_inputs(case, "bf16")
    to_bf16 = bf16_probe.to_bf16
    a16, b16 = to_bf16(torch.tensor(a)), to_bf16(torch.tensor(b))
    chain = x.float()
    mul_rounds = add_rounds = 0
    for _ in range(iters):
        prod = chain * a16  # exact in f32: a product of two bf16 values
        mul_rounds += int((to_bf16(prod) != prod).sum())
        total = to_bf16(prod) + b16
        add_rounds += int((to_bf16(total) != total).sum())
        chain = to_bf16(total)
    steps = max(iters * x.numel(), 1)
    outs = {kind: bf16_probe.chain_plain(chain_inputs(case, kind)[0], kind, iters, a, b).float()
            for kind in bf16_probe.KINDS}
    nonzero = x.float() != 0
    pairs = x.numel() // 2
    facts = dict(
        n=x.numel(), iters=iters, mul_rounds=mul_rounds / steps, add_rounds=add_rounds / steps,
        least_input=float(x.float().abs().min()), largest_input=float(x.float().abs().max()),
        subnormal_inputs=float(((x.float().abs() < TINY) & nonzero).sum() / nonzero.sum()),
        subnormal_outputs={k: float(((o.abs() < TINY) & (o != 0)).float().mean())
                           for k, o in outs.items()},
        inf_outputs={k: float(o.isinf().float().mean()) for k, o in outs.items()},
        partial_block=pairs % (bf16_probe.CHAIN_THREADS * bf16_probe.CHAIN_PAIRS) != 0)
    facts["holds"] = {
        "rounding": facts["mul_rounds"] > 0.9 and facts["add_rounds"] > 0.9,
        "subnormal": facts["subnormal_inputs"] == 1.0
        and min(facts["subnormal_outputs"][k] for k in ("f32", "bf16")) > 0.5,
        "huge": facts["least_input"] > 2.6e38 and min(facts["inf_outputs"].values()) > 0,
        "partial": facts["partial_block"] and facts["n"] % 2 == 0,
        "iters0": iters == 0,
    }[case]
    return facts
