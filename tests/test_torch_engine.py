"""The port's Crate beyond the fused step, on the CPU: the instrumented
tick, the grid rebuild on a radius edit, frame streaming and the bench
entry point.

The instrumented tick runs the step's own phase helpers, so it must give
the fused step's state bit for bit (the JAX package holds its two at
1e-5, tests/test_engine.py:169; the port's phases are the same torch
operations in the same order); the rebuilt Scene must equal the JAX
package's after the same edit; streamed frames must equal the states of a
step-by-step run.
"""

import dataclasses
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from sand_crate_tpu import load_config as jax_load_config
from sand_crate_tpu.engine import Crate as JaxCrate
from sand_crate_tpu_torch import bench, load_config
from sand_crate_tpu_torch.engine import Crate, crate_from_config
from sand_crate_tpu_torch.physics import step, trajectory
from sand_crate_tpu_torch.state import to_numpy

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
# JAX Scene fields that tune TPU tactics the port does not have (as
# tests/test_torch_scene.py).
TPU_ONLY = {"row_block", "pmajor_w", "pmajor_cs", "pmajor_split"}


def _world(name="stirring_cup.yaml", max_particles=400):
    world = load_config(REPO / "configs" / name).world_config
    world.coefficients = dict(world.coefficients, max_particles=max_particles)
    return world


def test_instrumented_tick_matches_fused_step():
    """Crate(instrument=True) builds its scene with fold off (JAX
    engine.py:79-82); over 5 ticks of an emitter scene with moving bodies
    it gives the state of a fused run on that scene, bit for bit, and its
    PhaseTimer carries the JAX package's phase names."""
    world = _world()
    inst = Crate(world, instrument=True, seed=2, forces_mode="pmajor", device="cpu")
    fused = Crate(world, seed=2, forces_mode="pmajor", device="cpu")
    assert fused.scene.fold_pairs and not inst.scene.fold_pairs
    fused.scene = dataclasses.replace(fused.scene, fold_pairs=False)
    for _ in range(5):
        inst.physics_tick()
        fused.physics_tick()
    assert inst.tick == 5 and inst.particle_count > 0
    for name, a, b in zip(inst.state._fields, inst.state, fused.state):
        assert torch.equal(a, b), name
    src = (REPO / "sand_crate_tpu" / "instrument.py").read_text()
    jax_phases = set(re.findall(r'timer\("([^"]+)"\)', src))
    report = inst.debug_timer.report()
    got = set(re.findall(r"^  (\w[\w ]*): [\d.]+ ms", report, re.M)) - {"Outside"}
    assert got == jax_phases - {"spring"}  # the scene has no spring
    assert "Step" in fused.debug_timer.report()


def test_regrid_matches_jax():
    """A particle_radius edit past the cell size rebuilds the Scene around
    the new diameter: every field equal to the JAX package's after the same
    edit; an edit that fits keeps the scene."""
    jworld = jax_load_config(REPO / "configs" / "stirring_cup.yaml").world_config
    tworld = load_config(REPO / "configs" / "stirring_cup.yaml").world_config
    jc = JaxCrate(jworld, forces_mode="pmajor", capacity=512)
    tc = Crate(tworld, forces_mode="pmajor", capacity=512, device="cpu")
    scene = tc.scene
    tc.particle_radius = scene.cell_size / 2
    assert tc.scene is scene
    radius = 1.5 * scene.cell_size
    jc.particle_radius = radius
    tc.particle_radius = radius
    assert tc.scene.cell_size == pytest.approx(2 * radius) and tc.scene.grid_nx < scene.grid_nx
    jfields = {f.name: getattr(jc.scene, f.name) for f in dataclasses.fields(jc.scene)}
    jfields = {k: np.asarray(v) if hasattr(v, "shape") else v for k, v in jfields.items()}
    tfields = to_numpy(tc.scene)
    assert set(jfields) - set(tfields) == TPU_ONLY
    for k, v in tfields.items():
        if k == "motor_exprs":
            assert [(b, c, e.src) for b, c, e in v] == [(b, c, e.src) for b, c, e in jfields[k]]
        elif isinstance(v, np.ndarray):
            np.testing.assert_array_equal(v, jfields[k], err_msg=k)
        else:
            assert v == jfields[k], k
    tc.run(2)  # the rebuilt grid steps
    assert tc.tick == 2 and tc.diameter == pytest.approx(2 * radius)


def test_trajectory_and_stream_frames_match_steps():
    """physics.trajectory and Crate.stream_frames (chunks of 2 frames of 3
    ticks, with a partial last chunk) give the states of a step-by-step
    run, frame by frame, bit for bit."""
    world = _world()
    ref = Crate(world, seed=1, device="cpu")
    want = []
    state = ref.state
    for _ in range(5):
        for _ in range(3):
            state, diag = step(state, ref.params, ref.scene, ref.generator)
        want.append(dict(pos=state.pos, alive=state.alive, pressure=state.pressure,
                         segments=state.segments, force_dv=diag.force_dv))

    traj = Crate(world, seed=1, device="cpu")
    final, frames = trajectory(traj.state, traj.params, traj.scene, 5, traj.generator, 3)
    assert frames["pos"].shape == (5, traj.scene.capacity, 2)
    assert frames["force_dv"].shape == (5, 7)
    for i, w in enumerate(want):
        for k, v in w.items():
            assert torch.equal(frames[k][i], v), (i, k)
    assert torch.equal(final.pos, state.pos)

    streamed = Crate(world, seed=1, device="cpu")
    got = list(streamed.stream_frames(5, ticks_per_frame=3, chunk_frames=2))
    assert len(got) == 5
    for i, w in enumerate(want):
        for k, v in w.items():
            assert isinstance(got[i][k], np.ndarray)
            np.testing.assert_array_equal(got[i][k], v.numpy(), err_msg=f"{i} {k}")
    assert streamed.tick == 15 and torch.equal(streamed.state.pos, state.pos)


def test_crate_extras():
    """crate_from_config, current_coefficients, the diameter and the
    velocity arrows of the debug overlay (JAX engine.py:233-239)."""
    config = load_config(REPO / "configs" / "hourglass.yaml")
    crate = crate_from_config(config, device="cpu")
    coeff = crate.current_coefficients()
    assert set(coeff) == set(config.world_config.coefficients)
    assert isinstance(coeff["max_particles"], int) and isinstance(coeff["gravity"], list)
    assert crate.diameter == pytest.approx(2 * coeff["particle_radius"])
    crate.velocity_arrows_every = 7
    crate.physics_tick()
    n = crate.particle_count
    assert len(crate.debug_arrows) == len(range(0, n, 7)) > 0
    point, vec = crate.debug_arrows[1]
    np.testing.assert_allclose(vec, crate.particle_velocities[7] * 0.02)
    np.testing.assert_array_equal(point, crate.particles[7])


@pytest.mark.parametrize("json_only", [True, False])
def test_bench_main_on_cpu(monkeypatch, capsys, json_only):
    """bench.main prints bench.py's one JSON line (metric, value, unit,
    vs_baseline); without --json-only also its stderr line with overflow 0.
    The p50 chunks are shortened for the CPU."""
    monkeypatch.setattr(bench, "P50_CHUNKS", 3)
    monkeypatch.setattr(bench, "_p50_chunk", lambda n: 2)
    result = bench.main(particles=2000, ticks=3, json_only=json_only, device="cpu")
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == result
    assert set(result) == {"metric", "value", "unit", "vs_baseline"}
    assert re.fullmatch(r"particle-steps/sec/chip@\d+", result["metric"])
    assert result["value"] > 0 and result["vs_baseline"] == pytest.approx(result["value"] / 1e4)
    if json_only:
        assert err == ""
    else:
        assert "overflow=0 " in err and "non_finite=0" in err and "schedule=default" in err


def test_bench_world_is_bench_py_rescaling():
    """dam_break_world rescales the YAML as bench.py:34-47 does."""
    w = bench.dam_break_world(1_000_000)
    spacing = float(np.sqrt((0.42 - 0.02) * (0.98 - 0.10) / 1_000_000))
    assert w.initial_particles[0].spacing == pytest.approx(spacing)
    assert w.coefficients["particle_radius"] == pytest.approx(0.55 * spacing)
    assert w.coefficients["max_particles"] == 1_050_000
    assert bench.DAM_BREAK["world"]["initial_particles"][0]["block"]["spacing"] == 0.00265
