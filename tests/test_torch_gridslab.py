"""The slot-grid backend's slab-order passes on the CPU.

``pair_pass_a`` and ``pair_pass_b_emit`` run the grid's pair sums over the
cell-sorted slab, with no slot grid.  Their plain versions (what the
wrappers run on CPU tensors, and what the CUDA kernels are held to on the
card) walk (dy, dx, rank) in slab columns; here they are held bit for bit
to the dense plain versions on the padded grid plus a gather, on the hard
inputs of ``ops/grid_cases.py`` and on a settled dam break.  The window
rule that the kernels stage by (``tile_windows``) is held to cover every
self's exact cells (``cell_ranges``).  The dense versions are themselves
held to the JAX package in tests/test_torch_pallas.py.
"""

import re
from pathlib import Path

import pytest
import torch

from sand_crate_tpu_torch import Crate
from sand_crate_tpu_torch.bench import dam_break_world
from sand_crate_tpu_torch.cellwise import cell_ids_grid
from sand_crate_tpu_torch.ops import grid_cases
from sand_crate_tpu_torch.ops import pair_kernel as pk
from sand_crate_tpu_torch.ops import placement as pl
from sand_crate_tpu_torch.ops.pallas_forces import (
    grid_width,
    neighbor_forces_pallas,
    neighbor_forces_pallas_sorted,
)
from sand_crate_tpu_torch.scene import build_scene

torch.set_num_threads(1)

CASES = sorted(grid_cases.CASES)


@pytest.fixture(scope="module")
def base_scene():
    """A 72 x 72-cell pallas scene (the dam break rescaled to 2,000)."""
    return build_scene(dam_break_world(2000), forces_mode="pallas", device="cpu")


@pytest.fixture(scope="module")
def settled_slab():
    """(slab, row_start, scene) of a ~10k-particle dam break after 20 ticks
    on the slot grid, sorted as the tick sorts it."""
    crate = Crate(dam_break_world(10_000), device="cpu", forces_mode="pallas", cell_capacity=16)
    crate.run(20)
    st, sc = crate.state, crate.scene
    cid, order = torch.sort(cell_ids_grid(st.pos, st.alive, sc), stable=True)
    slab, row_start, _, _ = pl.slab_from_sorted(st.pos[order], st.alive[order], st.vel[order],
                                                cid, sc.cell_capacity, sc.grid_nx, sc.grid_ny)
    return slab, row_start, sc


@pytest.mark.parametrize("case", CASES)
def test_slab_plain_equals_dense_plus_gather(base_scene, case):
    """Pass A at row offsets 0 and 5 and emit-mode pass B with the spring
    off and on, noise on: the slab-order plain version equals the dense
    plain version on the placed grid plus a gather, bit for bit, on an input
    that holds what the case claims; the pairs are real and the row offset
    keys the noise."""
    scene = grid_cases.case_scene(case, base_scene)
    facts = grid_cases.facts(case, scene, "cpu")
    assert facts["holds"], facts
    outs = {}
    for label, run, plain, dense in grid_cases.variants(case, scene, "cpu"):
        got = plain()
        assert torch.equal(got, dense()), label
        assert torch.equal(run(), got), label  # the CPU wrapper is the plain version
        outs[label] = got
        assert float(got[-1].max()) >= 1, label  # counted neighbours
    assert not torch.equal(outs["pass A row offset 0"], outs["pass A row offset 5"])
    off, on = outs["emit spring=False"], outs["emit spring=True"]
    assert torch.equal(off[:5], on[:5]) and torch.equal(off[5:], on[7:])
    assert float(on[5:7].abs().max()) > 0  # the spring rows


def test_slab_plain_equals_dense_on_a_settled_dam_break(settled_slab):
    """The same at a settled ~10k dam break (16 slots, collider noise on)."""
    slab, row_start, sc = settled_slab
    M, nx = sc.cell_capacity, sc.grid_nx
    diam = torch.tensor(sc.cell_size, dtype=torch.float32)
    amp, tick = 0.1 * diam, torch.tensor(11, dtype=torch.int32)
    ps = pk.pair_pass_a(slab, row_start, M, nx, diam, amp, tick)
    assert torch.equal(ps, pk.pass_a_via_grid(slab, row_start, M, nx, diam, amp, tick))
    coefs = (diam, torch.tensor(100.0), torch.tensor(-2.0), torch.tensor(0.5),
             torch.tensor(0.3), amp, tick)
    for spring in (False, True):
        got = pk.pair_pass_b_emit(slab, ps, row_start, M, nx, *coefs, enable_spring=spring)
        assert torch.equal(got, pk.pass_b_emit_via_grid(slab, ps, row_start, M, nx, *coefs,
                                                        enable_spring=spring))
    assert float(ps[pk.CNT].mean()) > 2


def _window_rule(slab, row_start, nx, ny):
    """Every alive self's three exact cell ranges hold exactly the columns of
    its cells, and lie inside its tile's windows."""
    n = int(row_start[-1])
    win = pk.tile_windows(slab, row_start, nx)
    rng = pk.cell_ranges(slab, row_start, nx)
    assert not rng[:, n:].any() and not win[:, -(-n // pk.SLAB_TILE):].any()
    tile = torch.arange(n) // pk.SLAB_TILE
    a, b = rng[:3, :n], rng[3:, :n]
    nonempty = b > a
    assert bool((a >= win[:3][:, tile])[nonempty].all())
    assert bool((b <= win[3:][:, tile])[nonempty].all())
    # Exact, from per-cell counts and their prefix sums (no search): the
    # range starts at the first column of cell (row + dy, max(cx - 1, 0)) and
    # holds the columns of the (up to) three cells.
    row, cx = slab[pk.ROW, :n].long(), slab[pk.CX, :n].long()
    per_cell = torch.bincount(row * nx + cx, minlength=nx * ny)
    before = torch.cumsum(per_cell, 0) - per_cell
    for q, dy in enumerate((-1, 0, 1)):
        r = row + dy
        inside = (r >= 0) & (r < ny)
        key = torch.where(inside, r, 0) * nx
        lo, hi = torch.clamp(cx - 1, min=0), torch.clamp(cx + 1, max=nx - 1)
        count = sum(torch.where(c <= hi, per_cell[key + torch.clamp(c, max=nx - 1)], 0)
                    for c in (lo, lo + 1, lo + 2))
        assert torch.equal(b[q] - a[q], torch.where(inside, count, 0)), dy
        assert torch.equal(a[q][inside], before[(key + lo)[inside]]), dy
    return win


@pytest.mark.parametrize("case", CASES)
def test_tile_windows_cover_each_self(base_scene, case):
    """The kernels' window rule (tile_windows) on every hard case: each
    self's exact cells (cell_ranges) lie inside its tile's three windows,
    and the ranges hold exactly the columns of the self's cells."""
    scene = grid_cases.case_scene(case, base_scene)
    slab, row_start, _ = grid_cases.case_slab(case, scene, "cpu")
    _window_rule(slab, row_start, scene.grid_nx, scene.grid_ny)


def test_tile_windows_cover_each_self_in_a_settled_dam_break(settled_slab):
    slab, row_start, sc = settled_slab
    win = _window_rule(slab, row_start, sc.grid_nx, sc.grid_ny)
    n = int(row_start[-1])
    staged = float((win[3:] - win[:3]).clamp(min=0).sum()) / n
    assert 1.0 < staged < 8.0  # a few candidates staged per self


def test_slab_constants_mirror_the_kernel():
    """SLAB_PIECE is the kernel's kPiece and SLAB_TILE its warp, GRID_TILE
    and GRID_BLOCK_COLS grid-mode pass B's tile and block (csrc/grid_pair.cu)."""
    src = (Path(pk.__file__).parent.parent / "csrc" / "grid_pair.cu").read_text()
    piece = int(re.search(r"constexpr int kPiece = (\d+);", src).group(1))
    assert (pk.SLAB_TILE, pk.SLAB_PIECE) == (32, piece)
    assert "t0 = (blockIdx.x * kWarps + warp) * 32" in src
    # Grid-mode pass B: a warp tile of GRID_TILE cells stages GRID_TILE + 2
    # cells a row; a block of kWarps tiles spans GRID_BLOCK_COLS columns.
    cells = int(re.search(r"constexpr int kCells = (\d+);", src).group(1))
    warps = int(re.search(r"constexpr int kWarps = (\d+);", src).group(1))
    assert (pk.GRID_TILE + 2, pk.GRID_BLOCK_COLS) == (cells, warps * pk.GRID_TILE)
    assert "x0 = (blockIdx.y * kWarps + warp) * 32" in src


@pytest.mark.parametrize("case", ["deep_m8", "edges", "dead_tail"])
def test_placed_pass_a_is_the_dense_pass_a(base_scene, case):
    """The grid-mode consumers' PS grid — the slab-order pass A placed by
    place_grid — equals the dense pass A on the placed slab, bit for bit,
    zeros on the empty slots and the ring included."""
    scene = grid_cases.case_scene(case, base_scene)
    slab, row_start, _ = grid_cases.case_slab(case, scene, "cpu")
    M, nx, ny = scene.cell_capacity, scene.grid_nx, scene.grid_ny
    nxp = grid_width(nx)
    diam = torch.tensor(scene.cell_size, dtype=torch.float32)
    amp, tick = 0.1 * diam, torch.tensor(3, dtype=torch.int32)
    ps = pk.pair_pass_a(slab, row_start, M, nx, diam, amp, tick, row_offset=5)
    placed = pl.place_grid(pl.with_features(slab, ps), row_start, M, nx, ny, nxp)
    grid = pl.place_grid(slab, row_start, M, nx, ny, nxp)
    assert torch.equal(placed, pk.pair_pass_a_plain(grid, diam, amp, tick, row_offset=5))


@pytest.mark.parametrize("case", CASES)
def test_grid_mode_provider_equals_the_sorted_provider(base_scene, case):
    """The particle-order provider (G and the placed PS, grid-mode pass B,
    one gather) equals the sorted provider (slab order throughout) bit for
    bit on cell-sorted operands, noise on, over-cap particles included."""
    scene = grid_cases.case_scene(case, base_scene)
    pos, vel, alive, cid = grid_cases.sorted_particles(case, scene, "cpu")
    diam = torch.tensor(scene.cell_size, dtype=torch.float32)
    args = (0.1 * diam, torch.tensor(4, dtype=torch.int32), diam, torch.tensor(100.0),
            torch.tensor(-2.0), torch.tensor(0.3), torch.tensor(0.5), scene)
    new = neighbor_forces_pallas_sorted(pos, vel, alive, cid, *args)
    old = neighbor_forces_pallas(pos, vel, alive, *args)
    for name, a, b in zip(new._fields, new, old):
        assert torch.equal(a, b), name
    assert float(new.nbr_cnt.max()) >= 1


@pytest.mark.parametrize("case", CASES)
def test_grid_mode_pass_b_is_zero_past_each_cell_count(base_scene, case):
    """The contract grid-mode pass B's kernel relies on: in G a cell's
    occupied slots are a prefix (0 .. n - 1, so its count is its first empty
    slot), the pad columns x = 0 and x >= nx + 1 are empty, and the plain
    grid-mode output is exactly 0 at every empty slot (spring on, row
    offset 5, noise on)."""
    scene = grid_cases.case_scene(case, base_scene)
    label, _, plain = grid_cases.grid_variants(case, scene, "cpu")[-1]
    assert label == "grid pass B spring=True row offset 5"
    slab, row_start, _ = grid_cases.case_slab(case, scene, "cpu")
    M, nx, ny = scene.cell_capacity, scene.grid_nx, scene.grid_ny
    g = pl.place_grid(slab, row_start, M, nx, ny, grid_width(nx))
    occupied = g[pk.POSX] > pk.ALIVE_THRESHOLD  # (NYP, M, NXP)
    assert bool((occupied[:, 1:] <= occupied[:, :-1]).all())  # a prefix of the slots
    assert not occupied[:, :, 0].any() and not occupied[:, :, nx + 1:].any()
    assert not occupied[0].any() and not occupied[-1].any()  # the ring rows
    out = plain()
    empty = ~occupied[1:-1]
    assert not out[:, empty].any()
    assert float(out[-1].max()) >= 1 and int(occupied.sum()) == int(slab[pk.IN_CAP].sum())


def test_slab_wrappers_reject_bad_inputs():
    """Tensors neither on the CPU nor on a CUDA device raise; so do slabs of
    the wrong shape, a cell capacity past the noise hash's 16 slots, and
    operands on two devices."""
    z = torch.zeros(())
    rs = torch.zeros(5, dtype=torch.int32)
    with pytest.raises(ValueError):
        pk.pair_pass_a(torch.zeros((8, 128), device="meta"), rs.to("meta"), 8, 3, z, z, z)
    with pytest.raises(ValueError):
        pk.pair_pass_a(torch.zeros((7, 128)), rs, 8, 3, z, z, z)
    with pytest.raises(ValueError):
        pk.pair_pass_a(torch.zeros((8, 128)), rs, 17, 3, z, z, z)
    with pytest.raises(ValueError):
        pk.pair_pass_b_emit(torch.zeros((8, 128), device="meta"), torch.zeros((4, 128)), rs,
                            8, 3, z, z, z, z, z, z, z)
    with pytest.raises(ValueError):
        pk.pair_pass_a(torch.zeros((8, 128), device="meta"), rs, 8, 3, z, z, z)
