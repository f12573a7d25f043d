"""The port's CUDA kernels on the card (``cuda`` marker; skipped without a GPU).

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch with CUDA is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from sand_crate_tpu_torch.cellwise import cell_ids_grid
from sand_crate_tpu_torch.config import load_config_dict
from sand_crate_tpu_torch.engine import Crate
from sand_crate_tpu_torch.ops import grid_cases, pair_kernel, placement, pmajor, pmajor_cases
from sand_crate_tpu_torch.ops.pallas_forces import (
    gather_pair_sums,
    grid_width,
    pair_sums_from_planes,
)
from sand_crate_tpu_torch.probes import probe_cases

BOX = [[[0.0, 0.0], [0.0, 1.0]], [[0.0, 0.0], [1.0, 0.0]],
       [[1.0, 0.0], [1.0, 1.0]], [[0.0, 1.0], [1.0, 1.0]]]


def _world(spacing=0.004):
    """A dam-break-like block in a box (dam_break.yaml's coefficients)."""
    return load_config_dict({"world": {
        "coefficients": {
            "dt": 0.002, "particle_radius": spacing * 0.55, "wall_collision_decay": 0.2,
            "spring_overlap_balance": 0.5, "spring_amplifier": 100,
            "pressure_amplifier": 30, "ignored_pressure": 0.3,
            "collider_noise_level": 0.1, "viscosity": 8, "max_particles": 25000,
            "surface_smoothing": 100, "target_pressure": -2, "gravity": [0, 9.8],
        },
        "particle_sources": [],
        "initial_particles": [{"block": {"x0": 0.02, "y0": 0.1, "x1": 0.42,
                                         "y1": 0.98, "spacing": spacing,
                                         "velocity": [0.0, 0.0], "jitter": 0.2}}],
        "rigid_bodies": [{"fixed": {"name": "box", "segments": BOX}}],
    }}).world_config


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(pmajor_cases.CASES))
def test_kernels_bit_identical_to_plain(cuda, case):
    """Pass A and every pass-B variant, symm and one-sided noise, on the
    hard inputs of ops/pmajor_cases.py (several selves per cell, a range
    longer than a staged piece, tiles across grid rows, P not a multiple of
    the tile, P under one tile, a tail of dead selves): the kernel and its
    plain version agree bit for bit, neighbor counts included."""
    scene = Crate(_world(), device=cuda).scene
    facts = pmajor_cases.facts(case, scene, cuda)
    assert facts["holds"], facts
    for label, run, plain in pmajor_cases.variants(case, scene, cuda):
        got = run()
        assert torch.equal(got, plain()), label
        if label.endswith("pass A"):
            assert float(got[3].max()) > (3 if case in ("random", "dense_blob") else 0)


@pytest.mark.cuda
def test_crate_runs_through_the_kernels(cuda):
    """Crate.run launches each pass and each half of the pair glue once per
    tick and keeps the invariants."""
    crate = Crate(_world(), device=cuda)
    n0 = crate.particle_count
    for mode in pmajor.LAUNCHES:
        pmajor.LAUNCHES[mode] = 0
    diag = crate.run(10)
    assert pmajor.LAUNCHES == {"a": 10, "b": 10, "sub_a": 0, "sub_b": 0, "prep": 10,
                               "slab_b": 10}
    assert int(diag.particle_count) == n0
    assert int(diag.non_finite) == 0 and int(diag.neighbor_overflow) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(pmajor_cases.CASES))
def test_k10_bit_identical_to_plain_and_k1k2(cuda, case):
    """K10 at both chunk sizes, pass A, pass B folded, pass B split and pass
    B split with the spring, on the hard inputs of ops/pmajor_cases.py (several selves
    per cell, a range longer than a staged piece, tiles across grid rows, P
    not a multiple of the tile, P under one tile, a tail of dead selves):
    bit for bit its plain version and K1/K2 one-sided on the same slab; the
    in-kernel ranges are window_ranges', which equal candidate_ranges'."""
    scene = Crate(_world(), device=cuda).scene
    pos, vel, alive, cid = pmajor_cases.sorted_particles(case, scene, cuda)
    ranges = pmajor.candidate_ranges(cid, alive, scene.grid_nx, scene.grid_ny)
    for chunk in pmajor.PMS_CHUNKS:
        win = pmajor.chunk_windows(cid, alive, scene.grid_nx, scene.grid_ny, chunk)
        found = pmajor.window_ranges(cid, win, chunk, scene.grid_nx)
        assert torch.equal(found[:, alive], ranges[:, alive])
    for label, run, plain, k1k2 in pmajor_cases.k10_variants(case, scene, cuda):
        got = run()
        assert torch.equal(got, plain()), label
        assert torch.equal(got, k1k2()), label


@pytest.mark.cuda
def test_pmsub_crate_runs_through_k10(cuda, monkeypatch):
    """Under SAND_CRATE_PMSUB=1, Crate.run launches K10 once per pass per
    tick (and the pair glue's prep, without its ranges, and slab B) and
    K1/K2 never, and keeps the invariants."""
    monkeypatch.setenv("SAND_CRATE_PMSUB", "1")
    crate = Crate(_world(), device=cuda)
    n0 = crate.particle_count
    for mode in pmajor.LAUNCHES:
        pmajor.LAUNCHES[mode] = 0
    diag = crate.run(10)
    assert pmajor.LAUNCHES == {"a": 0, "b": 0, "sub_a": 10, "sub_b": 10, "prep": 10,
                               "slab_b": 10}
    assert int(diag.particle_count) == n0 and int(diag.non_finite) == 0


@pytest.mark.cuda
def test_pms_pass_rejects_bad_inputs(cuda):
    slab = torch.zeros((64, 8), device=cuda)
    cid = torch.zeros(64, dtype=torch.int32, device=cuda)
    win = torch.zeros((7, 2), dtype=torch.int32, device=cuda)
    coef = torch.zeros(3, device=cuda)
    with pytest.raises(ValueError):  # windows of chunk 32 given as chunk 128
        pmajor.pms_pass(slab, cid, win, coef, "a", nx=8, chunk=128)
    with pytest.raises(ValueError):  # cid on the CPU
        pmajor.pms_pass(slab, cid.cpu(), win, coef, "a", nx=8, chunk=32)


@pytest.mark.cuda
def test_pm_pass_rejects_cpu_mixed_inputs(cuda):
    slab = torch.zeros((8, 8), device=cuda)
    ranges = torch.zeros((6, 8), dtype=torch.int32)  # on the CPU
    with pytest.raises(ValueError):
        pmajor.pm_pass(slab, ranges, torch.zeros(3, device=cuda), "a")
    with pytest.raises(ValueError):
        pmajor.pm_pass(slab.double(), ranges.to(cuda), torch.zeros(3, device=cuda), "a")


def _deep_particles(cuda, n=20000):
    """Random particles with a 30-deep and a 12-deep cell (f32 on the card)."""
    rng = np.random.default_rng(3)
    pos = rng.random((n, 2)) * 0.4 + 0.3
    pos[:30] = 0.5 + (rng.random((30, 2)) - 0.5) * 0.002
    pos[30:42] = 0.6 + (rng.random((12, 2)) - 0.5) * 0.002
    vel = rng.random((n, 2)) - 0.5
    alive = rng.random(n) < 0.95
    alive[:42] = True
    f32 = dict(dtype=torch.float32, device=cuda)
    return (torch.as_tensor(pos, **f32), torch.as_tensor(vel, **f32),
            torch.as_tensor(alive, device=cuda))


@pytest.mark.cuda
def test_grid_kernels_bit_identical_to_plain(cuda):
    """place_grid, the slab-order pair_pass_a (row offsets 0 and 5) and
    pair_pass_b_emit, and grid-mode pair_pass_b on the placed G and PS
    (spring off and on, noise on, a row offset in grid mode) at M = 8 and 16
    on sorted particles with deep cells: kernel and plain version agree bit
    for bit, and emit mode equals grid mode plus gather_pair_sums bit for
    bit."""
    pos, vel, alive = _deep_particles(cuda)
    base = Crate(_world(), device=cuda, forces_mode="pallas").scene
    nx, ny = base.grid_nx, base.grid_ny
    nxp = grid_width(nx)
    diam, amp = torch.tensor(0.0044, device=cuda), torch.tensor(4e-4, device=cuda)
    tick = torch.tensor(9, dtype=torch.int32, device=cuda)
    coefs = (diam, torch.tensor(100.0, device=cuda), torch.tensor(-2.0, device=cuda),
             torch.tensor(0.5, device=cuda), torch.tensor(0.3, device=cuda), amp, tick)
    for M in (8, 16):
        scene = dataclasses.replace(base, cell_capacity=M)
        cid, order = torch.sort(cell_ids_grid(pos, alive, scene), stable=True)
        slab, row_start, gather_slot, overflow = placement.slab_from_sorted(
            pos[order], alive[order], vel[order], cid, M, nx, ny)
        assert int(overflow) >= 30 - M
        head = (slab, row_start, M, nx)
        grid = placement.place_grid(slab, row_start, M, nx, ny, nxp)
        assert torch.equal(grid, placement.place_grid_plain(slab, row_start, M, nx, ny, nxp))
        ps = pair_kernel.pair_pass_a(*head, diam, amp, tick)
        assert torch.equal(ps, pair_kernel.pair_pass_a_slab_plain(*head, diam, amp, tick))
        assert float(ps[3].max()) >= M - 1  # the deep cell's slots see each other
        shifted = pair_kernel.pair_pass_a(*head, diam, amp, tick, row_offset=5)
        assert torch.equal(shifted, pair_kernel.pair_pass_a_slab_plain(*head, diam, amp, tick,
                                                                       row_offset=5))
        ps_grid = placement.place_grid(placement.with_features(slab, ps), row_start, M, nx, ny,
                                       nxp)
        for spring in (False, True):
            kw = dict(enable_spring=spring)
            out_g = pair_kernel.pair_pass_b(grid, ps_grid, *coefs, **kw)
            assert torch.equal(out_g, pair_kernel.pair_pass_b_plain(grid, ps_grid, *coefs, **kw))
            off = pair_kernel.pair_pass_b(grid, ps_grid, *coefs, row_offset=5, **kw)
            assert torch.equal(off, pair_kernel.pair_pass_b_plain(grid, ps_grid, *coefs,
                                                                  row_offset=5, **kw))
            out_e = pair_kernel.pair_pass_b_emit(slab, ps, row_start, M, nx, *coefs, **kw)
            plain_e = pair_kernel.pair_pass_b_emit_plain(slab, ps, row_start, M, nx, *coefs,
                                                         **kw)
            assert torch.equal(out_e, plain_e)
            gathered = gather_pair_sums(out_g, gather_slot, M, nx, ny, nxp, spring, overflow,
                                        torch.float32)
            emitted = pair_sums_from_planes(out_e[:, :cid.shape[0]], spring, overflow,
                                            torch.float32)
            for a, b in zip(gathered, emitted):
                assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(grid_cases.CASES))
def test_slab_kernels_bit_identical_on_hard_cases(cuda, case):
    """The slab-order pass A (row offsets 0 and 5) and emit pass B (spring
    off and on) on the hard inputs of ops/grid_cases.py (cells deeper than
    the capacity, a window longer than a staged piece, tiles across grid
    rows, the grid's edge rows and columns, P < 32, P not a multiple of 32,
    a 40% dead tail): kernel == plain version, bit for bit."""
    scene = grid_cases.case_scene(case, Crate(_world(), device=cuda,
                                              forces_mode="pallas").scene)
    facts = grid_cases.facts(case, scene, cuda)
    assert facts["holds"], facts
    for label, run, plain, _ in grid_cases.variants(case, scene, cuda):
        got = run()
        assert torch.equal(got, plain()), label
        assert float(got[-1].max()) >= 1, label


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(grid_cases.CASES))
def test_grid_pass_b_bit_identical_on_hard_cases(cuda, case):
    """Grid-mode pass B (spring off and on, row offsets 0 and 5) on G and PS
    placed from the hard inputs of ops/grid_cases.py: kernel == plain
    version, bit for bit, zeros at every empty slot included."""
    scene = grid_cases.case_scene(case, Crate(_world(), device=cuda,
                                              forces_mode="pallas").scene)
    for label, run, plain in grid_cases.grid_variants(case, scene, cuda):
        got = run()
        assert torch.equal(got, plain()), label
        assert float(got[-1].max()) >= 1, label


@pytest.mark.cuda
def test_pallas_crate_runs_through_the_grid_kernels(cuda):
    """Crate.run on the slot grid launches the slab-order pass A and emit
    pass B once per tick and places no grid, and keeps the invariants."""
    crate = Crate(_world(), device=cuda, forces_mode="pallas")
    n0 = crate.particle_count
    for key in pair_kernel.LAUNCHES:
        pair_kernel.LAUNCHES[key] = 0
    diag = crate.run(10)
    assert pair_kernel.LAUNCHES == {"place_grid": 0, "pair_pass_a": 10,
                                    "pair_pass_b_grid": 0, "pair_pass_b_emit": 10}
    assert int(diag.particle_count) == n0 and int(diag.non_finite) == 0


@pytest.mark.cuda
def test_grid_wrappers_reject_mixed_inputs(cuda):
    grid = torch.zeros((4, 6, 8, 128), device=cuda)
    slab = torch.zeros((8, 1152), device=cuda)
    row_start = torch.zeros(5, dtype=torch.int32, device=cuda)
    z = torch.zeros((), device=cuda)
    with pytest.raises(ValueError):  # the pass-A planes on the CPU
        pair_kernel.pair_pass_b(grid, grid.cpu(), z, z, z, z, z, z, z)
    with pytest.raises(ValueError):  # f64 slab
        pair_kernel.pair_pass_a(slab.double(), row_start, 8, 3, z, z, z)
    with pytest.raises(ValueError):  # int64 row starts
        pair_kernel.pair_pass_a(slab, row_start.long(), 8, 3, z, z, z)
    with pytest.raises(ValueError):  # the pass-A columns on the CPU
        pair_kernel.pair_pass_b_emit(slab, torch.zeros((4, 1152)), row_start, 8, 3,
                                     z, z, z, z, z, z, z)


# ---- the crate axis: K1/K2, K4+K5 and K8+K9 for every crate of a batch -----------


@pytest.mark.cuda
def test_crate_axis_k1k2_bit_identical(cuda):
    """K1/K2's crate-axis launch on the batched hard inputs of
    ops/pmajor_cases.py (every case, padded to one size, and an empty crate;
    coefficients, noise and ticks per crate): one launch a pass, equal bit
    for bit to the plain version and to each crate's solo launch; the
    solo wrapper vmapped over the crates launches once too."""
    scene = Crate(_world(), device=cuda).scene
    facts = pmajor_cases.batch_facts(scene, cuda)
    assert facts["holds"], facts
    variants = [v for v in pmajor_cases.batch_variants(scene, cuda) if not v[0].startswith("K10")]
    for label, run, plain, solo in variants:
        before = dict(pmajor.LAUNCHES)
        got = run()
        mode = "a" if label.endswith("pass A") else "b"
        assert pmajor.LAUNCHES[mode] == before[mode] + 1, label
        assert torch.equal(got, plain()), label
        assert torch.equal(got, solo()), label
    _, run, plain, _ = pmajor_cases.batch_variants(scene, cuda)[0]
    pos, vel, alive, cid = pmajor_cases.batch_particles(scene, cuda)
    coef, amp, tick = pmajor_cases.batch_coefs(cid.shape[0], scene.cell_size, cuda)
    nx, ny = scene.grid_nx, scene.grid_ny
    ranges = torch.func.vmap(lambda c, a: pmajor.candidate_ranges(c, a, nx, ny))(cid, alive)
    slab = torch.func.vmap(lambda p, v, a, c, m, t: pmajor.pass_a_slab(
        p, v, a, c, m, t, scene, symm=True))(pos, vel, alive, cid, amp, tick)
    before = pmajor.LAUNCHES["a"]
    vm = torch.func.vmap(lambda s, r, c: pmajor.pm_pass(s, r, c, "a", symm=True))(
        slab, ranges, coef)
    assert pmajor.LAUNCHES["a"] == before + 1
    assert torch.equal(vm, run())


@pytest.mark.cuda
def test_crate_axis_k10_bit_identical(cuda):
    """K10's crate-axis launch on the batched hard inputs of
    ops/pmajor_cases.py (every case padded to one size, an empty crate;
    coefficients, noise and ticks per crate), pass A, pass B folded and
    pass B split with the spring at both chunk sizes: one launch a pass
    (sub_a / sub_b), equal bit for bit to the plain version and to each
    crate's solo launch; pms_pass vmapped over the crates launches once."""
    scene = Crate(_world(), device=cuda).scene
    variants = [v for v in pmajor_cases.batch_variants(scene, cuda) if v[0].startswith("K10")]
    assert len(variants) == 3 * len(pmajor.PMS_CHUNKS)
    for label, run, plain, solo in variants:
        key = "sub_a" if label.endswith("pass A") else "sub_b"
        before = dict(pmajor.LAUNCHES)
        got = run()
        assert pmajor.LAUNCHES == {**before, key: before[key] + 1}, label
        assert torch.equal(got, plain()), label
        assert torch.equal(got, solo()), label
    pos, vel, alive, cid = pmajor_cases.batch_particles(scene, cuda)
    coef, amp, tick = pmajor_cases.batch_coefs(cid.shape[0], scene.cell_size, cuda)
    nx, ny = scene.grid_nx, scene.grid_ny
    slab = torch.func.vmap(lambda p, v, a, c, m, t: pmajor.pass_a_slab(
        p, v, a, c, m, t, scene, symm=False))(pos, vel, alive, cid, amp, tick)
    for chunk in pmajor.PMS_CHUNKS:
        win = torch.func.vmap(lambda c, a: pmajor.chunk_windows(c, a, nx, ny, chunk))(cid, alive)
        before = pmajor.LAUNCHES["sub_a"]
        vm = torch.func.vmap(lambda s, c, w, k: pmajor.pms_pass(s, c, w, k, "a", nx=nx,
                                                                chunk=chunk))(slab, cid, win, coef)
        assert pmajor.LAUNCHES["sub_a"] == before + 1
        assert torch.equal(vm, pmajor.pms_pass_crates(slab, cid, win, coef, "a", nx=nx,
                                                      chunk=chunk))
    with pytest.raises(ValueError):  # one coefficient row for every crate
        pmajor.pms_pass_crates(slab, cid, win, coef[:1], "a", nx=nx, chunk=128)
    with pytest.raises(ValueError):  # the windows of one crate
        pmajor.pms_pass_crates(slab, cid, win[0], coef, "a", nx=nx, chunk=128)


@pytest.mark.cuda
def test_crate_axis_grid_passes_bit_identical(cuda):
    """K4+K5 and K8+K9's crate-axis launches on the batched hard inputs of
    ops/grid_cases.py (every case at 8 slots a cell, and an empty crate):
    one launch a pass, equal bit for bit to the plain version and to each
    crate's solo launch."""
    scene = Crate(_world(), device=cuda, forces_mode="pallas", cell_capacity=8).scene
    facts = grid_cases.batch_facts(scene, cuda)
    assert facts["holds"], facts
    for label, run, plain, solo in grid_cases.batch_variants(scene, cuda):
        key = "pair_pass_a" if label.startswith("pass A") else "pair_pass_b_emit"
        before = pair_kernel.LAUNCHES[key]
        got = run()
        assert pair_kernel.LAUNCHES[key] == before + 1, label
        assert torch.equal(got, plain()), label
        assert torch.equal(got, solo()), label


@pytest.mark.cuda
def test_crate_axis_wrappers_reject_bad_inputs(cuda):
    """The crate-axis entries raise on what the kernels do not take."""
    slab = torch.zeros((2, 64, 8), device=cuda)
    ranges = torch.zeros((2, 6, 64), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):  # one coefficient row for two crates
        pmajor.pm_pass_crates(slab, ranges, torch.zeros((1, 3), device=cuda), "a")
    with pytest.raises(ValueError):  # ranges of another crate count
        pmajor.pm_pass_crates(slab, ranges[:1], torch.zeros((2, 3), device=cuda), "a")
    gslab = torch.zeros((2, 8, 1152), device=cuda)
    row_start = torch.zeros((2, 5), dtype=torch.int32, device=cuda)
    tick = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):  # the coefficients of one crate
        pair_kernel.pair_pass_a_crates(gslab, row_start, 8, 3, torch.zeros(2, device=cuda), tick)
    with pytest.raises(ValueError):  # row starts of one crate
        pair_kernel.pair_pass_a_crates(gslab, row_start[0], 8, 3,
                                       torch.zeros((2, 2), device=cuda), tick)
    with pytest.raises(ValueError):  # the ticks on the CPU
        pair_kernel.pair_pass_b_emit_crates(gslab, torch.zeros((2, 4, 1152), device=cuda),
                                            row_start, 8, 3, torch.zeros((2, 6), device=cuda),
                                            tick.cpu())


# ---- the probe kernels of csrc/probes.cu (P1-P4) --------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "bf16", "mixed"])
def test_probe_chain_kernels_bit_identical_to_plain(cuda, kind):
    """P4's three kernels (f32 chains, packed bf16x2 chains, the mixed
    f32-mask / bf16 shape) against their plain versions."""
    from sand_crate_tpu_torch import probes
    from sand_crate_tpu_torch.probes import bf16_probe

    x = bf16_probe.make_input(kind, blocks=2, device=cuda)
    before = probes.LAUNCHES[bf16_probe._LABEL[kind]]
    got = bf16_probe.chain(x, kind, 16)
    assert probes.LAUNCHES[bf16_probe._LABEL[kind]] == before + 1
    assert torch.equal(got, bf16_probe.chain_plain(x, kind, 16))


@pytest.mark.cuda
@pytest.mark.parametrize("hybrid", [False, True])
def test_probe_hybrid_kernel_bit_identical_to_plain(cuda, hybrid):
    """P3 in both forms, on the tool's inputs and on equal rw columns."""
    from sand_crate_tpu_torch.probes import hybrid_probe

    for equal_rw in (False, True):
        sfeat, cand = hybrid_probe.make_inputs(blocks=4, device=cuda, equal_rw=equal_rw)
        got = hybrid_probe.chain(sfeat, cand, 8, hybrid)
        assert torch.equal(got, hybrid_probe.chain_plain(sfeat, cand, 8, hybrid))
        assert (got != 0).float().mean() > (0.3 if equal_rw else -1)


@pytest.mark.cuda
def test_probe_pmajor_and_passa_bit_identical_to_plain(cuda):
    """P1 (modes a and b) and every P2 variant on both grids, at a settled
    ~22k-particle block: kernel == plain version, with pairs counted."""
    from sand_crate_tpu_torch.ops.pallas_forces import grid_width
    from sand_crate_tpu_torch.probes import passa_probe, pmajor_probe

    crate = Crate(_world(), device=cuda)
    crate.run(10)
    st, sc, pr = crate.state, crate.scene, crate.params
    slab, cid = pmajor_probe.sorted_slab(st, pr, sc)
    slab_p, dma_lo, ws, _ = pmajor_probe.prepare(slab, cid, sc.grid_nx, sc.grid_ny)
    coef = pmajor_probe.coefficients(pr.diameter, cuda)
    for mode in ("a", "b"):
        got = pmajor_probe.probe(slab_p, dma_lo, ws, coef, 384, mode)
        assert torch.equal(got, pmajor_probe.probe_plain(slab_p, dma_lo, ws, coef, 384, mode))
        assert float(got[:, 3 if mode == "a" else 6].sum()) > 0
    grid = placement.place_grid(slab, None, sc.cell_capacity, sc.grid_nx, sc.grid_ny,
                                grid_width(sc.grid_nx))
    tr = passa_probe.row_block(grid.shape[3])
    pcoef, ticks = passa_probe.coefficients(pr.diameter, cuda)
    pcoef[1] = 0.1 * pcoef[0]  # the jitter hash on
    ticks[0] = 5
    for g in (grid, grid[:, :, :8].contiguous()):
        occ = passa_probe.block_flags(g, tr)
        assert 0 < int(occ.sum()) < occ.shape[0]
        for mode in passa_probe.VARIANTS:
            got = passa_probe.variant(g, occ, pcoef, ticks, tr, mode)
            assert torch.equal(got, passa_probe.variant_plain(g, occ, pcoef, ticks, tr, mode)), mode


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(probe_cases.PASSA_CASES) + sorted(probe_cases.HYBRID_CASES))
def test_probe_passa_and_hybrid_bit_identical_on_hard_cases(cuda, case):
    """P2 (every variant) or P3 (both forms) on a hard input of
    probes/probe_cases.py (an odd m, tr 1, 3 and 8, NXP 32, air blocks,
    coincident particles, pairs at exactly one diameter, far positions; an
    odd W, one visit, coincident positions, a candidate at the cutoff):
    kernel == plain version, bit for bit."""
    from sand_crate_tpu_torch.probes import hybrid_probe, passa_probe

    if case in probe_cases.PASSA_CASES:
        assert probe_cases.passa_facts(case)["holds"], case
        grid, occ, coef, ticks, tr = probe_cases.passa_inputs(case, cuda)
        for mode in passa_probe.VARIANTS:
            got = passa_probe.variant(grid, occ, coef, ticks, tr, mode)
            want = passa_probe.variant_plain(grid, occ, coef, ticks, tr, mode)
            assert torch.equal(got, want), mode
    else:
        assert probe_cases.hybrid_facts(case)["holds"], case
        sfeat, cand, iters = probe_cases.hybrid_inputs(case, cuda)
        for hybrid in (False, True):
            got = hybrid_probe.chain(sfeat, cand, iters, hybrid)
            assert torch.equal(got, hybrid_probe.chain_plain(sfeat, cand, iters, hybrid)), hybrid


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(probe_cases.PMAJOR_CASES) + sorted(probe_cases.CHAIN_CASES))
def test_probe_pmajor_and_chain_bit_identical_on_hard_cases(cuda, case):
    """P1 (modes a and b) or P4 (f32, bf16 and mixed) on a hard input of
    probes/probe_cases.py (W 200 and 1000, clamped windows, the zero
    padding, nd2 at its floor, pairs at one diameter, one block; every step
    rounding, subnormal inputs, overflow to inf, a partial last block, 0
    iterations): kernel == plain version, bit for bit."""
    from sand_crate_tpu_torch.probes import bf16_probe, pmajor_probe

    if case in probe_cases.PMAJOR_CASES:
        slab_p, dma_lo, ws, coef, w = probe_cases.pmajor_inputs(case, cuda)
        for mode in ("a", "b"):
            got = pmajor_probe.probe(slab_p, dma_lo, ws, coef, w, mode)
            assert torch.equal(got, pmajor_probe.probe_plain(slab_p, dma_lo, ws, coef, w, mode)), mode
    else:
        for kind in bf16_probe.KINDS:
            x, iters, a, b = probe_cases.chain_inputs(case, kind, cuda)
            got = bf16_probe.chain(x, kind, iters, a, b)
            want = bf16_probe.chain_plain(x, kind, iters, a, b)
            assert torch.equal(got, want), kind


@pytest.mark.cuda
@pytest.mark.parametrize("m_slots", probe_cases.SWEEP_SLOTS)
def test_probe_passa_bit_identical_at_every_m(cuda, m_slots):
    """P2 (every variant) on the sweep case at M = 1..8, so that each
    compiled m of both kernels (m = 1 and 2 the edges of the twice-staged
    rotation) runs: kernel == plain version, bit for bit."""
    from sand_crate_tpu_torch.probes import passa_probe

    grid, occ, coef, ticks, tr = probe_cases.passa_inputs(probe_cases.SWEEP_CASE, cuda,
                                                          m_slots=m_slots)
    for mode in passa_probe.VARIANTS:
        got = passa_probe.variant(grid, occ, coef, ticks, tr, mode)
        want = passa_probe.variant_plain(grid, occ, coef, ticks, tr, mode)
        assert torch.equal(got, want), mode


@pytest.mark.cuda
def test_probe_wrappers_reject_mixed_devices(cuda):
    from sand_crate_tpu_torch.probes import hybrid_probe

    sfeat, cand = hybrid_probe.make_inputs(blocks=1)
    with pytest.raises(ValueError, match="one device"):
        hybrid_probe.chain(sfeat.to(cuda), cand, 2, False)
