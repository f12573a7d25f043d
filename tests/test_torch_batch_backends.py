"""Batched crates on every backend the JAX vmapped step takes, on the CPU.

The port's vmapped step (``sweep.batched_step``: ``torch.func.vmap`` of
``physics.step``) on cellwise, gather, pmajor (default,
``SAND_CRATE_PMAJOR_GATE=1`` and ``SAND_CRATE_PMSUB=1``) and pallas against
``jax.jit(jax.vmap(step))``
of the JAX package: 4 crates of capacity 128 with coefficients of their
own, the same inputs carried across (``state_from_numpy`` /
``params_from_numpy``), 3 ticks, no emitter.  Collider noise is off for
gather and cellwise (each package draws its own) and on for pmajor and
pallas (both hash it from the slot and the tick).  The JAX Pallas kernels
run in interpret mode, as the JAX suite runs them here.  Tolerance: the
port's solo step tests against JAX (tests/test_torch_step.py,
test_torch_pallas.py, test_torch_cellwise_gather.py): positions and
velocities uid-aligned at rtol 2e-3, atol 2e-4 (tests/test_pmajor.py:
371-374), the alive set and the counters exactly.

Also: the vmapped step equals each crate stepped alone, bit for bit, on
all six backends and on pmajor under ``SAND_CRATE_PMSUB=1``; the batched
plain twins of K1/K2, K10, K4+K5 and K8+K9 (the crate-axis operators on
CPU tensors, and ``torch.func.vmap`` of the solo wrappers) equal per-crate
plain calls bit for bit on the batched hard inputs of ops/pmajor_cases.py
and ops/grid_cases.py; ``BatchedCrates`` takes all six backends, pmajor
under ``SAND_CRATE_PMSUB=1`` too, and keeps the default rule (dense up to
1024 slots, chunked above).
"""

import copy

import jax
import numpy as np
import pytest
import torch

from sand_crate_tpu import load_config_dict as jax_load_config_dict
from sand_crate_tpu import physics as jphys
from sand_crate_tpu import sweep as jsweep
from sand_crate_tpu.scene import build_scene as jax_build_scene
from sand_crate_tpu.scene import init_state as jax_init_state
from sand_crate_tpu.state import Params as JaxParams
from sand_crate_tpu_torch import load_config_dict, sweep
from sand_crate_tpu_torch.bench import dam_break_world
from sand_crate_tpu_torch.ops import grid_cases, pair_kernel, pmajor, pmajor_cases
from sand_crate_tpu_torch.ops.pallas_forces import gather_pair_sums
from sand_crate_tpu_torch.physics import step
from sand_crate_tpu_torch.scene import build_scene, init_state
from sand_crate_tpu_torch.state import CrateState, Params, params_from_numpy, state_from_numpy

torch.set_num_threads(1)

CRATES, CAPACITY, TICKS = 4, 128, 3
BOX = [[[0.0, 0.0], [0.0, 1.0]], [[0.0, 0.0], [1.0, 0.0]],
       [[1.0, 0.0], [1.0, 1.0]], [[0.0, 1.0], [1.0, 1.0]]]
VISCOSITIES = [2.0, 5.0, 8.0, 12.0]
# The backends JAX's vmapped step runs here, with the collider noise each
# is compared at and the scene options.
JAX_MODES = {
    "cellwise": (0.0, {}),
    "gather": (0.0, {}),
    "pmajor": (0.1, {}),
    "pmajor_gate": (0.1, {}),
    "pmajor_pmsub": (0.1, {}),
    "pallas": (0.1, {"cell_capacity": 8}),
}
ALL_MODES = ("dense", "chunked", "cellwise", "gather", "pmajor", "pallas")
# The environment knob each case name ends in (read by JAX at trace time, by
# the port at call time).
KNOBS = {"gate": "SAND_CRATE_PMAJOR_GATE", "pmsub": "SAND_CRATE_PMSUB"}
# The pmajor hard cases that fit the 72 x 72-cell scene below and run in
# seconds on the CPU (the card runs every case).
PM_NAMES = ("ragged_tile", "under_one_tile", "dead_tail", pmajor_cases.EMPTY)


def _world(noise):
    """~100 particles in a box with a motored paddle: no emitter."""
    return {"world": {
        "coefficients": {
            "dt": 0.002, "particle_radius": 0.02, "wall_collision_decay": 0.2,
            "spring_overlap_balance": 0.5, "spring_amplifier": 100,
            "pressure_amplifier": 30, "ignored_pressure": 0.3,
            "collider_noise_level": noise, "viscosity": 8, "max_particles": 120,
            "surface_smoothing": 100, "target_pressure": -2, "gravity": [0, 9.8],
        },
        "particle_sources": [],
        "initial_particles": [{"block": {"x0": 0.1, "y0": 0.3, "x1": 0.5, "y1": 0.7,
                                         "spacing": 0.04, "velocity": [0.3, 0.0],
                                         "jitter": 0.3}}],
        "rigid_bodies": [
            {"fixed": {"name": "box", "segments": BOX}},
            {"motored": {"name": "paddle", "segments": [[[-0.1, 0.0], [0.1, 0.0]]],
                         "position": [0.5, 0.5], "rotation": 30,
                         "angular_velocity": {"amplitude": 2.0, "frequency": 5.0}}},
        ],
    }}


def _numpy(tup):
    return {k: np.asarray(v) for k, v in tup._asdict().items() if k != "key"}


def _jax_batch(raw, mode, scene_kw):
    """The JAX scene, stacked states (crate i from seed i) and stacked
    params (a viscosity each)."""
    w = jax_load_config_dict(copy.deepcopy(raw)).world_config
    scene = jax_build_scene(w, capacity=CAPACITY, forces_mode=mode, **scene_kw)
    states = jsweep.stack_states([jax_init_state(w, scene, seed=i) for i in range(CRATES)])
    params = jsweep.grid_params(JaxParams.from_coefficients(w.coefficients),
                                {"viscosity": VISCOSITIES})
    return scene, states, params


def _port_batch(raw, mode, scene_kw, jstates=None, jparams=None):
    """The port's scene and the batch: carried across from JAX when given,
    else the port's own stacked init states and grid params."""
    w = load_config_dict(copy.deepcopy(raw)).world_config
    scene = build_scene(w, capacity=CAPACITY, forces_mode=mode, device="cpu", **scene_kw)
    if jstates is not None:
        return scene, state_from_numpy(_numpy(jstates), "cpu"), params_from_numpy(
            _numpy(jparams), "cpu")
    states = sweep.stack_states([init_state(w, scene, seed=i) for i in range(CRATES)])
    params = sweep.grid_params(Params.from_coefficients(w.coefficients, "cpu"),
                               {"viscosity": VISCOSITIES})
    return scene, states, params


@pytest.fixture
def knob_of(monkeypatch):
    """Sets the knob a case name ends in, if any; JAX reads it at trace
    time, so its compile caches are cleared around a test that sets one."""
    set_any = []

    def set_knob(case):
        name = KNOBS.get(case.split("_")[-1])
        if name:
            monkeypatch.setenv(name, "1")
            jax.clear_caches()
            set_any.append(name)

    yield set_knob
    if set_any:
        jax.clear_caches()


@pytest.mark.parametrize("case", sorted(JAX_MODES))
def test_vmapped_step_matches_jax(case, knob_of):
    """jax.jit(jax.vmap(step)) and the port's vmapped step, 3 ticks from the
    same stacked state and params: uid-aligned positions and velocities of
    every crate at the solo tests' tolerance, the same alive sets, particle
    counts, overflow and non-finite counts; pmajor's overflow 0 (K10's
    under SAND_CRATE_PMSUB=1 too)."""
    mode = case.split("_")[0]
    knob_of(case)
    noise, scene_kw = JAX_MODES[case]
    raw = _world(noise)
    jscene, jstates, jparams = _jax_batch(raw, mode, scene_kw)
    scene, states, params = _port_batch(raw, mode, scene_kw, jstates, jparams)
    if mode == "pmajor":
        assert scene.pmajor_symm == jscene.pmajor_symm
    jstep = jax.jit(jax.vmap(lambda s, p: jphys.step(s, p, jscene)))
    gen = torch.Generator()
    gen.manual_seed(0)
    for _ in range(TICKS):
        jstates, jdiag = jstep(jstates, jparams)
        states, diag = sweep.batched_step(states, params, scene, gen)
    for name in ("particle_count", "neighbor_overflow", "non_finite"):
        np.testing.assert_array_equal(getattr(diag, name).numpy(),
                                      np.asarray(getattr(jdiag, name)), err_msg=name)
    if mode == "pmajor":
        assert int(diag.neighbor_overflow.max()) == 0
    for i in range(CRATES):
        ia = np.argsort(np.asarray(jstates.uid[i]))
        ib = np.argsort(states.uid[i].numpy())
        alive = np.asarray(jstates.alive[i])[ia]
        assert alive.sum() > 80
        np.testing.assert_array_equal(states.alive[i].numpy()[ib], alive)
        for name in ("pos", "vel"):
            np.testing.assert_allclose(getattr(states, name)[i].numpy()[ib][alive],
                                       np.asarray(getattr(jstates, name)[i])[ia][alive],
                                       rtol=2e-3, atol=2e-4, err_msg=f"{name} crate {i}")


@pytest.mark.parametrize("mode", ALL_MODES + ("pmajor_pmsub",))
def test_vmapped_equals_each_crate_alone(mode, monkeypatch):
    """The vmapped step equals each crate stepped alone with its own params,
    bit for bit, every field and every diagnostic.  Noise on where it is
    hashed (chunked, pmajor, pallas), off where each crate draws its own
    (dense, cellwise, gather).  "pmajor_pmsub": pmajor under
    SAND_CRATE_PMSUB=1 (K10)."""
    if mode.endswith("pmsub"):
        monkeypatch.setenv(KNOBS["pmsub"], "1")
        mode = "pmajor"
    noise = 0.1 if mode in ("chunked", "pmajor", "pallas") else 0.0
    kw = {"cell_capacity": 8} if mode == "pallas" else {}
    scene, states, params = _port_batch(_world(noise), mode, kw)
    gen = torch.Generator()
    batch = states
    for _ in range(TICKS):
        batch, bdiag = sweep.batched_step(batch, params, scene, gen)
    for i in range(CRATES):
        st = CrateState(*(x[i] for x in states))
        pr = Params(*(x[i] for x in params))
        for _ in range(TICKS):
            st, diag = step(st, pr, scene, gen)
        for name, got, want in zip(CrateState._fields, batch, st):
            assert torch.equal(got[i], want), f"{mode} crate {i} {name}"
        for name, got, want in zip(diag._fields, bdiag, diag):
            assert torch.equal(got[i], want), f"{mode} crate {i} diag {name}"
    assert int(batch.alive.sum()) > 300


def test_pmajor_plain_twins_over_the_crate_axis():
    """K1/K2's crate-axis operator on CPU tensors, and torch.func.vmap of
    the solo wrapper (the operator's vmap rule), equal per-crate plain calls
    bit for bit on the batched hard inputs (alive counts from 0 to 1230,
    coefficients, noise and ticks per crate), every pass and variant."""
    scene = build_scene(dam_break_world(2000), forces_mode="pmajor", device="cpu")
    facts = pmajor_cases.batch_facts(scene, "cpu", PM_NAMES)
    assert facts["holds"], facts
    pos, vel, alive, cid = pmajor_cases.batch_particles(scene, "cpu", PM_NAMES)
    coef, _, _ = pmajor_cases.batch_coefs(len(PM_NAMES), scene.cell_size, "cpu")
    ranges = torch.func.vmap(
        lambda c, a: pmajor.candidate_ranges(c, a, scene.grid_nx, scene.grid_ny))(cid, alive)
    variants = [v for v in pmajor_cases.batch_variants(scene, "cpu", PM_NAMES)
                if not v[0].startswith("K10")]
    assert len(variants) == 8
    for label, run, plain, solo in variants:
        got = run()
        assert torch.equal(got, plain()), label
        assert torch.equal(got, solo()), label
        assert torch.equal(got[-1], torch.zeros_like(got[-1])), label  # the empty crate
    # the vmap rule: the solo wrapper vmapped over the crates
    slab = torch.func.vmap(
        lambda p, v, a, c: pmajor.pass_a_slab(p, v, a, c, torch.tensor(0.0), torch.tensor(1),
                                              scene, symm=False))(pos, vel, alive, cid)
    vm = torch.func.vmap(lambda s, r, c: pmajor.pm_pass(s, r, c, "a"))(slab, ranges, coef)
    want = torch.stack([pmajor.pm_pass_plain(slab[b], ranges[b], coef[b], "a")
                        for b in range(len(PM_NAMES))])
    assert torch.equal(vm, want)
    assert float(vm[:, 3].max()) > 3


def test_k10_plain_twins_over_the_crate_axis():
    """K10's crate-axis operator on CPU tensors, and torch.func.vmap of the
    solo wrapper (the operator's vmap rule; chunk_windows vmapped too),
    equal per-crate pms_pass_plain bit for bit on the batched hard inputs:
    pass A, pass B folded and pass B split with the spring, at both chunk
    sizes; the empty crate's sums are zero."""
    scene = build_scene(dam_break_world(2000), forces_mode="pmajor", device="cpu")
    variants = [v for v in pmajor_cases.batch_variants(scene, "cpu", PM_NAMES)
                if v[0].startswith("K10")]
    assert len(variants) == 3 * len(pmajor.PMS_CHUNKS)
    for label, run, plain, solo in variants:
        got = run()
        assert torch.equal(got, plain()), label
        assert torch.equal(got, solo()), label
        assert torch.equal(got[-1], torch.zeros_like(got[-1])), label
    pos, vel, alive, cid = pmajor_cases.batch_particles(scene, "cpu", PM_NAMES)
    coef, amp, tick = pmajor_cases.batch_coefs(len(PM_NAMES), scene.cell_size, "cpu")
    nx, ny = scene.grid_nx, scene.grid_ny
    slab = torch.func.vmap(lambda p, v, a, c, m, t: pmajor.pass_a_slab(
        p, v, a, c, m, t, scene, symm=False))(pos, vel, alive, cid, amp, tick)
    for chunk in pmajor.PMS_CHUNKS:
        vm = torch.func.vmap(lambda s, c, a, k: pmajor.pms_pass(
            s, c, pmajor.chunk_windows(c, a, nx, ny, chunk), k, "a", nx=nx, chunk=chunk))(
            slab, cid, alive, coef)
        want = torch.stack([pmajor.pms_pass_plain(
            slab[b], cid[b], pmajor.chunk_windows(cid[b], alive[b], nx, ny, chunk), coef[b], "a",
            nx=nx, chunk=chunk) for b in range(len(PM_NAMES))])
        assert torch.equal(vm, want), chunk
        assert float(vm[:, 3].max()) > 3


def test_grid_plain_twins_over_the_crate_axis():
    """K4+K5 and K8+K9's crate-axis operators on CPU tensors, and
    torch.func.vmap of the solo wrappers, equal per-crate plain calls bit
    for bit on the batched hard inputs of ops/grid_cases.py (every case at
    8 slots a cell, and an empty crate): pass A at row offsets 0 and 5, emit
    with the spring off and on."""
    scene = build_scene(dam_break_world(2000), forces_mode="pallas", device="cpu")
    facts = grid_cases.batch_facts(scene, "cpu")
    assert facts["holds"], facts
    for label, run, plain, solo in grid_cases.batch_variants(scene, "cpu"):
        got = run()
        assert torch.equal(got, plain()), label
        assert torch.equal(got, solo()), label
        assert float(got[:, -1].max()) > 3, label  # pairs counted
        assert torch.equal(got[-1], torch.zeros_like(got[-1])), label
    slab, row_start = grid_cases.batch_slabs(scene, "cpu")
    coef_a, coef_b, tick = grid_cases.batch_coefs(slab.shape[0], scene.cell_size, "cpu")
    m, nx = grid_cases.BATCH_SLOTS, scene.grid_nx
    ps = torch.func.vmap(lambda s, r, c, t: pair_kernel.pair_pass_a(
        s, r, m, nx, c[0], c[1], t, row_offset=5))(slab, row_start, coef_a, tick)
    assert torch.equal(ps, pair_kernel.pair_pass_a_crates(slab, row_start, m, nx, coef_a, tick,
                                                          row_offset=5))
    emit = torch.func.vmap(lambda s, p, r, c, t: pair_kernel.pair_pass_b_emit(
        s, p, r, m, nx, c[0], c[1], c[2], c[3], c[5], c[4], t, enable_spring=True))(
        slab, ps, row_start, coef_b, tick)
    assert torch.equal(emit, pair_kernel.pair_pass_b_emit_crates(
        slab, ps, row_start, m, nx, coef_b, tick, enable_spring=True))


def test_gather_pair_sums_vmaps():
    """The particle-order provider's gather from grid-mode pass B planes,
    vmapped over crates, equals each crate's gather."""
    M, nx, ny, nxp = 4, 6, 5, 128
    g = torch.Generator().manual_seed(1)
    planes = torch.rand((3, 8, ny, M, nxp), generator=g)
    pslot = torch.randint(0, nx * ny * M + 5, (3, 40), generator=g, dtype=torch.int32)
    over = torch.zeros((), dtype=torch.int32)
    vm = torch.func.vmap(lambda b, p: gather_pair_sums(b, p, M, nx, ny, nxp, False, over,
                                                        torch.float32))(planes, pslot)
    for i in range(3):
        one = gather_pair_sums(planes[i], pslot[i], M, nx, ny, nxp, False, over, torch.float32)
        for name in ("p_i", "dv_tension", "pressure_real", "visc_vsum", "nbr_cnt"):
            assert torch.equal(getattr(vm, name)[i], getattr(one, name)), name


def test_batched_crates_take_every_backend(monkeypatch):
    """BatchedCrates runs all six backends (pmajor's overflow 0); the
    default rule is unchanged; under SAND_CRATE_PMSUB=1 the pmajor batch
    constructs, runs 2 ticks on K10 with overflow 0, and
    _batched_rollout takes it, equal to the batch's own ticks."""
    cfg = load_config_dict(_world(0.1))
    base = Params.from_coefficients(cfg.world_config.coefficients, "cpu")
    batched = sweep.grid_params(base, {"viscosity": VISCOSITIES[:2]})
    for mode in ALL_MODES:
        crates = sweep.BatchedCrates(cfg, batched, forces_mode=mode, capacity=CAPACITY,
                                     device="cpu")
        diag = crates.run(2)
        assert crates.scene.forces_mode == mode
        assert int(diag.non_finite.max()) == 0 and (crates.particle_counts() > 80).all()
        if mode == "pmajor":
            assert int(diag.neighbor_overflow.max()) == 0
    assert sweep.BatchedCrates(cfg, batched, capacity=1024, device="cpu").scene.forces_mode \
        == "dense"
    assert sweep.BatchedCrates(cfg, batched, capacity=1152, device="cpu").scene.forces_mode \
        == "chunked"
    assert sweep.DENSE_MAX_CAPACITY == 1024
    monkeypatch.setenv("SAND_CRATE_PMSUB", "1")
    assert pmajor.schedule() == "pmsub"
    crates = sweep.BatchedCrates(cfg, batched, forces_mode="pmajor", capacity=CAPACITY,
                                 device="cpu")
    start = crates.state
    state, rolled = sweep._batched_rollout(start, crates.params, crates.scene, 2,
                                           torch.Generator())
    diag = crates.run(2)
    assert int(diag.non_finite.max()) == 0 and (crates.particle_counts() > 80).all()
    assert int(diag.neighbor_overflow.max()) == 0 and int(rolled.neighbor_overflow.max()) == 0
    for name, a, b in zip(CrateState._fields, state, crates.state):
        assert torch.equal(a, b), name
    assert not hasattr(sweep, "check_batchable")


def test_pallas_overflow_is_each_crates_largest():
    """On pallas at one slot a cell the overflow counts the alive particles
    past their cell's capacity: BatchedCrates.run reports each crate's
    largest over its ticks, the per-tick counts of the same batch run a
    tick at a time.  The block is packed ~2.5 particles a cell."""
    raw = _world(0.1)
    raw["world"]["initial_particles"][0]["block"]["spacing"] = 0.025
    cfg = load_config_dict(raw)
    base = Params.from_coefficients(cfg.world_config.coefficients, "cpu")
    batched = sweep.grid_params(base, {"viscosity": VISCOSITIES[:2]})
    kw = dict(forces_mode="pallas", capacity=CAPACITY, cell_capacity=1, device="cpu", seed=1)
    whole, by_tick = sweep.BatchedCrates(cfg, batched, **kw), sweep.BatchedCrates(cfg, batched, **kw)
    diag = whole.run(3)
    per_tick = torch.stack([by_tick.run(1).neighbor_overflow for _ in range(3)])
    assert torch.equal(diag.neighbor_overflow, per_tick.max(dim=0).values)
    assert int(per_tick.min()) > 0 and len(torch.unique(per_tick)) > 1
