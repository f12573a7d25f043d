"""The instrumented tick as one graph a phase (``instrument.PhaseGraphs``,
run by ``Crate(instrument=True).physics_tick``).

On the CPU the phases run eagerly over the crate's static buffers; they
must give the fused step's state bit for bit (fold off, as the
instrumented crate builds its scene) with an emitter and the spring on,
and the JAX ``Crate(instrument=True)`` at tests/test_torch_step.py's
tolerance (that of tests/test_pmajor.py:371-374).  The cases marked
``cuda`` capture the phases and replay them on the card (skipped without
one): the replays equal the eager ``instrumented_tick`` bit for bit, and a
coefficient edit reaches the next replay with no new capture.
"""

import copy
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from sand_crate_tpu_torch import graphs, load_config, load_config_dict
from sand_crate_tpu_torch.diagnostics import PhaseTimer
from sand_crate_tpu_torch.engine import Crate
from sand_crate_tpu_torch.instrument import instrumented_tick, tick_phases

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
TICKS = 5


def _cup():
    """stirring_cup (an emitter, a motored cup) at 300 particles."""
    raw = copy.deepcopy(load_config(REPO / "configs" / "stirring_cup.yaml").raw)
    raw["world"]["coefficients"]["max_particles"] = 300
    return load_config_dict(raw).world_config


def _dam_break_raw(n=300):
    """configs/dam_break.yaml at ``n`` particles, rescaled as bench.py."""
    raw = copy.deepcopy(load_config(REPO / "configs" / "dam_break.yaml").raw)
    spacing = float(np.sqrt((0.42 - 0.02) * (0.98 - 0.10) / n))
    raw["world"]["initial_particles"][0]["block"]["spacing"] = spacing
    raw["world"]["coefficients"]["particle_radius"] = spacing * 0.55
    raw["world"]["coefficients"]["max_particles"] = n + 15
    return raw


def _assert_same(got, want):
    for name, a, b in zip(got._fields, got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name


@pytest.mark.parametrize("mode", ["pmajor", "dense", "cellwise"])
def test_instrumented_crate_equals_fused_step(mode):
    """Crate(instrument=True) with the cup's emitter and the spring on
    advances its own buffers in place and gives a fused run's state (fold
    off) bit for bit over 5 ticks, and the same generator state; its
    PhaseTimer holds every phase, the spring's included."""
    world = _cup()
    kw = dict(seed=2, forces_mode=mode, enable_spring=True, device="cpu")
    if mode == "cellwise":
        kw["cell_capacity"] = 4  # its planes cost M^2 a cell
    inst = Crate(world, instrument=True, **kw)
    fused = Crate(world, **kw)
    fused.scene = dataclasses.replace(fused.scene, fold_pairs=False)
    buffers = [t.data_ptr() for t in inst.state]
    for _ in range(TICKS):
        inst.physics_tick()
        fused.physics_tick()
    assert [t.data_ptr() for t in inst.state] == buffers
    assert inst.particle_count > 0 and inst.tick == TICKS
    _assert_same(inst.state, fused.state)
    assert torch.equal(inst.generator.get_state(), fused.generator.get_state())
    report = inst.debug_timer.report()
    got = set(re.findall(r"^  (\w[\w ]*): [\d.]+ ms", report, re.M)) - {"Outside"}
    assert got == {name for name, _ in tick_phases(inst.scene)}


def test_phases_follow_the_jax_tick():
    """The phases carry the JAX instrumented tick's timer names in its
    order; the spring phase only with the spring on."""
    src = (REPO / "sand_crate_tpu" / "instrument.py").read_text()
    jax_order = re.findall(r'timer\("([^"]+)"\)', src)
    scene = Crate(_cup(), enable_spring=True, device="cpu").scene
    assert [name for name, _ in tick_phases(scene)] == jax_order
    off = dataclasses.replace(scene, enable_spring=False)
    assert [name for name, _ in tick_phases(off)] == [n for n in jax_order if n != "spring"]


def test_instrumented_crate_matches_jax():
    """A ~300-particle dam break with the spring on, p-major with the
    collider noise on (hashed: both packages draw the same jitter),
    through the port's and the JAX Crate(instrument=True) for 5 ticks:
    uid-aligned positions and velocities at 2e-3 / 2e-4, the same alive
    set and tick."""
    from sand_crate_tpu import load_config_dict as jax_load_config_dict
    from sand_crate_tpu.engine import Crate as JaxCrate

    raw = _dam_break_raw()
    jc = JaxCrate(jax_load_config_dict(copy.deepcopy(raw)).world_config, forces_mode="pmajor",
                  enable_spring=True, instrument=True)
    tc = Crate(load_config_dict(raw).world_config, forces_mode="pmajor", enable_spring=True,
               instrument=True, device="cpu")
    assert tc.scene.capacity == jc.scene.capacity and not tc.scene.fold_pairs
    for _ in range(TICKS):
        jc.physics_tick()
        tc.physics_tick()
    jstate, tstate = jc.state, tc.state
    ia, ib = np.argsort(np.asarray(jstate.uid)), np.argsort(tstate.uid.numpy())
    alive = np.asarray(jstate.alive)[ia]
    assert alive.sum() > 250
    np.testing.assert_array_equal(tstate.alive.numpy()[ib], alive)
    for name in ("pos", "vel"):
        np.testing.assert_allclose(getattr(tstate, name).numpy()[ib][alive],
                                   np.asarray(getattr(jstate, name))[ia][alive],
                                   rtol=2e-3, atol=2e-4, err_msg=name)
    assert int(tstate.tick) == int(jstate.tick) == TICKS


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["pmajor", "dense", "pallas"])
def test_replayed_phases_equal_eager_on_the_card(cuda, mode):
    """After the call that captures, each physics_tick replays one graph a
    phase: == the eager instrumented_tick loop bit for bit (state, last
    Diagnostics, generator state), with a viscosity edit between two
    ticks that captures nothing anew."""
    crate = Crate(_cup(), instrument=True, seed=3, forces_mode=mode, enable_spring=True,
                  device=cuda)
    crate.physics_tick()  # eager, then the capture
    s0, p0 = graphs.clone(crate.state), graphs.clone(crate.params)
    g0 = crate.generator.get_state()
    for counter in (*graphs.COUNTERS, graphs.LAUNCHES):
        for k in counter:
            counter[k] = 0
    n_phases = len(tick_phases(crate.scene))
    for t in range(TICKS):
        if t == 2:
            crate.viscosity = 2.5
        diag = crate.phases.step(crate.scene, crate.generator, crate.debug_timer)
    assert graphs.LAUNCHES == {"replay": TICKS * n_phases, "capture": 0, "evict": 0}
    replayed = crate.generator.get_state()
    crate.generator.set_state(g0)
    state, timer = s0, PhaseTimer()
    for t in range(TICKS):
        if t == 2:
            p0 = p0._replace(viscosity=torch.full_like(p0.viscosity, 2.5))
        state, want = instrumented_tick(state, p0, crate.scene, crate.generator, timer)
    _assert_same(crate.state, state)
    _assert_same(diag, want)
    assert torch.equal(crate.generator.get_state(), replayed)
