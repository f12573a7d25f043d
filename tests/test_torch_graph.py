"""The compiled step loop (``sand_crate_tpu_torch/graphs.py``).

On the CPU a StepGraph runs its body eagerly (the tick, then a copy back
into the static buffers), so ``Crate.run``, ``physics_tick``,
``BatchedCrates.run`` and the rollout buffers are held here against a plain
loop of ``physics.step`` bit for bit, and a mid-run coefficient edit
against the JAX ``Crate`` given the same edit.  The cases marked ``cuda``
capture and replay graphs on the card (skipped without one; the JAX
package is imported only inside the one test that compares with it, so
on a machine without JAX they run with
``python -m pytest --noconftest -m cuda tests/test_torch_graph.py``).
"""

import copy
from pathlib import Path

import numpy as np
import pytest
import torch

from sand_crate_tpu_torch import Params, graphs, load_config, load_config_dict
from sand_crate_tpu_torch.bench import dam_break_world
from sand_crate_tpu_torch.engine import Crate
from sand_crate_tpu_torch.ops import pair_kernel, pmajor
from sand_crate_tpu_torch.physics import rollout, step
from sand_crate_tpu_torch.sweep import (
    DEFAULT_RANDOM_RANGES,
    BatchedCrates,
    batched_step,
    random_params,
)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
TICKS = 20
MODES = ("pmajor", "dense", "chunked", "pallas")


def _world(name: str):
    """stirring_cup (an emitter, a motored cup) or a ~300-particle dam break."""
    if name == "stirring_cup":
        raw = load_config(REPO / "configs" / "stirring_cup.yaml").raw
        raw = copy.deepcopy(raw)
        raw["world"]["coefficients"]["max_particles"] = 200
        return load_config_dict(raw).world_config
    return dam_break_world(300)


def _clone(tup):
    return type(tup)(*(x.clone() for x in tup))


def _assert_same(got, want, label=""):
    for name, a, b in zip(got._fields, got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), f"{label} {name}"


def _eager(state, params, scene, generator, ticks, live_rows=None, fn=step):
    """The plain loop the graphs are held against: (state, last diag,
    largest overflow over the ticks)."""
    worst = None
    for _ in range(ticks):
        state, diag = fn(state, params, scene, generator, live_rows)
        over = diag.neighbor_overflow
        worst = over if worst is None else torch.maximum(worst, over)
    return state, diag, worst


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("world", ["stirring_cup", "dam_break"])
def test_static_body_equals_step_loop(world, mode):
    """Crate.run and physics_tick advance the crate's own buffers in place
    (the same tensors before and after) and give a plain loop of
    physics.step's state and diagnostics bit for bit over 20 ticks."""
    w = _world(world)
    crate = Crate(w, seed=3, forces_mode=mode, device="cpu")
    ref = Crate(w, seed=3, forces_mode=mode, device="cpu")
    buffers = [t.data_ptr() for t in crate.state]
    crate.run(TICKS // 2 - 1)
    crate.physics_tick()
    diag = crate.run(TICKS // 2)
    state, want, _ = _eager(ref.state, ref.params, ref.scene, ref.generator, TICKS)
    _assert_same(crate.state, state, "state")
    _assert_same(diag, want, "diagnostics")
    assert [t.data_ptr() for t in crate.state] == buffers
    assert crate.tick == TICKS and int(diag.non_finite) == 0


def test_coefficient_edit_keeps_the_params_tensor():
    """An edit copies into the captured Params tensor (same object, same
    storage), leaves the key as it is, and the next tick reads it: equal to
    an eager tick with the edited coefficients."""
    crate = Crate(_world("stirring_cup"), seed=1, forces_mode="pmajor", device="cpu")
    crate.run(30)
    key = crate.graph.key(crate.scene, crate.generator)
    leaves = [(id(t), t.data_ptr()) for t in crate.params]
    crate.viscosity = 3.5
    crate.gravity = [0.5, 7.0]
    assert [(id(t), t.data_ptr()) for t in crate.params] == leaves
    assert crate.params is crate.graph.params
    assert crate.graph.key(crate.scene, crate.generator) == key
    assert crate.viscosity == 3.5 and crate.gravity.tolist() == [0.5, 7.0]
    before, gen = _clone(crate.state), crate.generator.get_state()
    crate.physics_tick()
    edited = _clone(crate.params)
    check = Crate(_world("stirring_cup"), seed=1, forces_mode="pmajor", device="cpu")
    check.generator.set_state(gen)
    state, _, _ = _eager(before, edited, crate.scene, check.generator, 1)
    _assert_same(crate.state, state)
    with pytest.raises(ValueError):
        crate.gravity = [1.0, 2.0, 3.0]


def test_mid_run_edit_matches_jax():
    """A ~300-particle dam break through the port's Crate and the JAX
    Crate (p-major, noise on; the JAX kernels in interpret mode), with the
    same viscosity and gravity edits between two runs: uid-aligned
    positions and velocities at tests/test_torch_step.py's tolerance (that
    of tests/test_pmajor.py:371-374) and the same counts."""
    from sand_crate_tpu import load_config_dict as jax_load_config_dict
    from sand_crate_tpu.engine import Crate as JaxCrate

    raw = copy.deepcopy(load_config(REPO / "configs" / "dam_break.yaml").raw)
    spacing = float(np.sqrt((0.42 - 0.02) * (0.98 - 0.10) / 300))  # bench.py's rescale
    raw["world"]["initial_particles"][0]["block"]["spacing"] = spacing
    raw["world"]["coefficients"]["particle_radius"] = spacing * 0.55
    raw["world"]["coefficients"]["max_particles"] = 315
    jc = JaxCrate(jax_load_config_dict(copy.deepcopy(raw)).world_config, forces_mode="pmajor")
    tc = Crate(load_config_dict(raw).world_config, forces_mode="pmajor", device="cpu")
    assert tc.scene.capacity == jc.scene.capacity
    for c in (jc, tc):
        c.run(6)
        c.viscosity = 2.0
        c.gravity = [1.0, 4.0]
        c.run(6)
    jstate, tstate = jc.state, tc.state
    ia, ib = np.argsort(np.asarray(jstate.uid)), np.argsort(tstate.uid.numpy())
    alive = np.asarray(jstate.alive)[ia]
    np.testing.assert_array_equal(tstate.alive.numpy()[ib], alive)
    for name in ("pos", "vel"):
        np.testing.assert_allclose(getattr(tstate, name).numpy()[ib][alive],
                                   np.asarray(getattr(jstate, name))[ia][alive],
                                   rtol=2e-3, atol=2e-4, err_msg=name)
    assert int(tstate.tick) == int(jstate.tick) == 12
    assert float(tc.params.viscosity) == float(jc.params.viscosity) == 2.0


def test_the_key(monkeypatch):
    """What a capture is specific to: a regrid, a schedule change, a new
    live_rows, another generator or tick count each give a new key; a
    coefficient value does not."""
    crate = Crate(_world("stirring_cup"), forces_mode="pmajor", device="cpu")
    g, gen = crate.graph, crate.generator
    key = g.key(crate.scene, gen)
    crate.viscosity = 1.0
    crate.particle_radius = 0.4 * crate.scene.cell_size  # fits: no regrid
    assert g.key(crate.scene, gen) == key
    assert g.key(crate.scene, gen, live_rows=128) != key
    assert g.key(crate.scene, gen, live_rows=128) != g.key(crate.scene, gen, live_rows=256)
    assert g.key(crate.scene, torch.Generator()) != key
    assert g.key(crate.scene, gen, ticks=2) != key
    monkeypatch.setenv("SAND_CRATE_PMSUB", "1")
    assert g.key(crate.scene, gen) != key
    monkeypatch.delenv("SAND_CRATE_PMSUB")
    monkeypatch.setenv("SAND_CRATE_PMAJOR_GATE", "1")
    assert g.key(crate.scene, gen) != key
    monkeypatch.delenv("SAND_CRATE_PMAJOR_GATE")
    assert g.key(crate.scene, gen) == key
    scene = crate.scene
    crate.particle_radius = scene.cell_size  # past the cell size: a new Scene
    assert crate.scene is not scene and g.key(crate.scene, gen) != key


def test_restore_into_a_crate_that_has_run(tmp_path):
    """A checkpoint restored into a crate that has already run (other seed,
    other coefficients) copies into its static buffers and generator and
    runs on exactly as the uninterrupted crate."""
    w = _world("stirring_cup")
    a = Crate(w, seed=2, forces_mode="dense", device="cpu")
    a.run(15)
    path = a.save_checkpoint(tmp_path / "ckpt.npz")
    a.run(15)
    b = Crate(w, seed=7, forces_mode="dense", device="cpu")
    b.run(9)
    b.viscosity = 1.0
    buffers = [t.data_ptr() for t in (*b.state, *b.params)]
    b.restore_checkpoint(path)
    assert b.tick == 15 and b.viscosity == a.viscosity
    b.run(15)
    _assert_same(b.state, a.state)
    assert [t.data_ptr() for t in (*b.state, *b.params)] == buffers
    assert torch.equal(b.generator.get_state(), a.generator.get_state())


def test_state_assignment_copies_into_the_buffers():
    """crate.state = ... copies into the static state (a capture reads
    those buffers); a state of another capacity is refused."""
    crate = Crate(_world("dam_break"), forces_mode="pmajor", device="cpu")
    buffers = [t.data_ptr() for t in crate.state]
    moved = crate.state._replace(pos=crate.state.pos + 0.001)
    crate.state = moved
    assert [t.data_ptr() for t in crate.state] == buffers
    assert torch.equal(crate.state.pos, moved.pos)
    with pytest.raises(ValueError):
        crate.state = crate.state._replace(pos=crate.state.pos[:-1])


# cellwise: seconds a CPU tick here
@pytest.mark.parametrize("mode", MODES + ("gather", "pmajor_pmsub"))
def test_batched_body_equals_vmapped_loop(mode, monkeypatch):
    """BatchedCrates.run (the vmapped tick on static buffers, the overflow's
    running max in a static buffer reset each run) == a plain loop of the
    vmapped step with the run's live_rows, bit for bit ("pmajor_pmsub":
    pmajor under SAND_CRATE_PMSUB=1)."""
    if mode.endswith("pmsub"):
        monkeypatch.setenv("SAND_CRATE_PMSUB", "1")
        mode = "pmajor"
    raw = copy.deepcopy(load_config(REPO / "configs" / "stirring_cup.yaml").raw)
    raw["world"]["coefficients"]["max_particles"] = 128
    config = load_config_dict(raw)
    base = Params.from_coefficients(config.world_config.coefficients, "cpu")
    gen = torch.Generator()
    gen.manual_seed(4)
    batch = BatchedCrates(config, random_params(gen, base, DEFAULT_RANDOM_RANGES, 3),
                          seed=4, forces_mode=mode, device="cpu")
    batch.run(6)
    s0, p0, g0 = _clone(batch.state), _clone(batch.params), batch.generator.get_state()
    live = batch.live_rows(8)
    diag = batch.run(8)
    batch.generator.set_state(g0)
    state, want, worst = _eager(s0, p0, batch.scene, batch.generator, 8, live, batched_step)
    _assert_same(batch.state, state)
    _assert_same(diag, want._replace(neighbor_overflow=worst))
    assert (live is None) == (mode != "chunked")


def test_rollout_buffers_copy_in_and_out():
    """rollout_graph keeps one buffer set per shape: a call copies the
    caller's state in, and the states handed back never alias the buffers."""
    w = _world("dam_break")
    crate = Crate(w, forces_mode="pmajor", device="cpu")
    g = graphs.rollout_graph(crate.state, crate.params, step)
    assert graphs.rollout_graph(crate.state, crate.params, step) is g
    assert all(a.data_ptr() != b.data_ptr() for a, b in zip(g.state, crate.state))
    g.step(crate.scene, crate.generator)
    out = graphs.clone(g.state)
    again = graphs.rollout_graph(crate.state, crate.params, step)
    assert again is g and torch.equal(g.state.pos, crate.state.pos)
    assert not torch.equal(out.pos, g.state.pos)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _reset_counts():
    for counter in (*graphs.COUNTERS, graphs.LAUNCHES):
        for k in counter:
            counter[k] = 0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES + ("cellwise", "gather", "pmajor_1m"))
def test_replay_equals_eager_on_the_card(cuda, mode, monkeypatch):
    """Replayed ticks (the tick captured first) == the eager loop of
    physics.step bit for bit, with a viscosity edit between two runs that
    captures nothing anew; the kernel counters rise once a pass a tick.
    The p-major eager loop runs the plain pair glue (pair_prep_plain,
    pass_b_prep_plain: the torch chain), so the replayed kernels of
    csrc/pm_prep.cu are held to it; "pmajor_1m" is the bench's 1,001,700
    particle dam break over 20 ticks."""
    big = mode == "pmajor_1m"
    mode = "pmajor" if big else mode
    world = dam_break_world(1_000_000) if big else _world("stirring_cup")
    half = 10 if big else 5
    crate = Crate(world, seed=5, forces_mode=mode, device=cuda)
    crate.run(4)
    s0, p0, g0 = _clone(crate.state), _clone(crate.params), crate.generator.get_state()
    _reset_counts()
    crate.run(half)
    crate.viscosity = 2.5
    diag = crate.run(half)
    n = 2 * half
    assert graphs.LAUNCHES == {"replay": n, "capture": 0, "evict": 0}
    want = {"pmajor": {"a": n, "b": n, "prep": n, "slab_b": n}}.get(mode, {})
    assert {k: v for k, v in pmajor.LAUNCHES.items() if v} == want
    grid = {"pallas": {"pair_pass_a": n, "pair_pass_b_emit": n}}.get(mode, {})
    assert {k: v for k, v in pair_kernel.LAUNCHES.items() if v} == grid
    monkeypatch.setattr(pmajor, "pair_prep", pmajor.pair_prep_plain)
    monkeypatch.setattr(pmajor, "pass_b_prep", pmajor.pass_b_prep_plain)
    crate.generator.set_state(g0)
    state, _, _ = _eager(s0, p0, crate.scene, crate.generator, half)
    p0 = p0._replace(viscosity=torch.full_like(p0.viscosity, 2.5))
    state, want_diag, _ = _eager(state, p0, crate.scene, crate.generator, half)
    _assert_same(crate.state, state)
    _assert_same(diag, want_diag)


@pytest.mark.cuda
def test_new_key_captures_anew_and_graphs_are_bounded(cuda, monkeypatch):
    """A schedule change captures anew (and its kernels count), the old key
    replays again without a capture; past MAX_GRAPHS live graphs the least
    recently used is dropped and captured again at its next call."""
    crate = Crate(dam_break_world(3000), forces_mode="pmajor", device=cuda)
    crate.run(2)
    _reset_counts()
    monkeypatch.setenv("SAND_CRATE_PMSUB", "1")
    crate.run(3)
    assert (graphs.LAUNCHES["replay"], graphs.LAUNCHES["capture"]) == (2, 1)
    assert pmajor.LAUNCHES == {"a": 0, "b": 0, "sub_a": 3, "sub_b": 3, "prep": 3, "slab_b": 3}
    monkeypatch.delenv("SAND_CRATE_PMSUB")
    crate.run(2)
    assert (graphs.LAUNCHES["replay"], graphs.LAUNCHES["capture"]) == (4, 1)
    others = [Crate(dam_break_world(3000), seed=i, device=cuda) for i in range(graphs.MAX_GRAPHS)]
    for other in others:
        other.run(1)
    assert not crate.graph._graphs
    _reset_counts()
    crate.run(2)
    # the capture evicts the least recently used of the MAX_GRAPHS live graphs
    assert graphs.LAUNCHES == {"replay": 1, "capture": 1, "evict": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES + ("cellwise", "gather", "pmajor_pmsub"))
def test_batched_replay_equals_eager_on_the_card(cuda, mode, monkeypatch):
    """BatchedCrates.run replays the captured vmapped tick: == the eager
    vmapped loop bit for bit, the overflow's running max included; the
    p-major (K1/K2, or K10 under SAND_CRATE_PMSUB=1) and slot-grid passes
    launch once a tick for the whole batch."""
    pmsub = mode.endswith("pmsub")
    if pmsub:
        monkeypatch.setenv("SAND_CRATE_PMSUB", "1")
        mode = "pmajor"
    raw = copy.deepcopy(load_config(REPO / "configs" / "stirring_cup.yaml").raw)
    config = load_config_dict(raw)
    base = Params.from_coefficients(config.world_config.coefficients, cuda)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(6)
    batch = BatchedCrates(config, random_params(gen, base, DEFAULT_RANDOM_RANGES, 8),
                          seed=6, forces_mode=mode, device=cuda)
    batch.run(10)
    s0, p0, g0 = _clone(batch.state), _clone(batch.params), batch.generator.get_state()
    live = batch.live_rows(10)
    _reset_counts()
    diag = batch.run(10)
    fresh = int(mode == "chunked")  # a new sweep bound captures anew
    assert (graphs.LAUNCHES["replay"], graphs.LAUNCHES["capture"]) == (10 - fresh, fresh)
    glue = {"prep": 10, "slab_b": 10}
    want = {"pmajor": {"sub_a": 10, "sub_b": 10, **glue} if pmsub
            else {"a": 10, "b": 10, **glue}}.get(mode, {})
    assert {k: v for k, v in pmajor.LAUNCHES.items() if v} == want
    grid = {"pallas": {"pair_pass_a": 10, "pair_pass_b_emit": 10}}.get(mode, {})
    assert {k: v for k, v in pair_kernel.LAUNCHES.items() if v} == grid
    batch.generator.set_state(g0)
    state, want, worst = _eager(s0, p0, batch.scene, batch.generator, 10, live, batched_step)
    _assert_same(batch.state, state)
    _assert_same(diag, want._replace(neighbor_overflow=worst))


@pytest.mark.cuda
def test_rollout_and_trajectory_replay_on_the_card(cuda):
    """physics.rollout and trajectory on a CUDA state replay graphs and hand
    back fresh copies: equal to the eager loop, and a returned state is not
    overwritten by the next call."""
    crate = Crate(_world("stirring_cup"), seed=8, forces_mode="pmajor", device=cuda)
    s0, g0 = _clone(crate.state), crate.generator.get_state()
    first, _ = rollout(crate.state, crate.params, crate.scene, 6, crate.generator)
    kept = _clone(first)
    second, _ = rollout(first, crate.params, crate.scene, 6, crate.generator)
    _assert_same(first, kept)
    crate.generator.set_state(g0)
    state, _, _ = _eager(s0, crate.params, crate.scene, crate.generator, 12)
    _assert_same(second, state)
