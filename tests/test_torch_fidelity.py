"""The port's step against the float64 oracle ``numpy_ref.step_numpy``: the
twin of tests/test_fidelity.py, at its scenes, seeds and tolerances.

The port's ``Crate`` (on the CPU) and the NumPy twin start from the same
seeded grid with noise and emission off, and are held together tick by
tick; ``run`` (the queued rollout) equals ``physics_tick`` exactly.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from sand_crate_tpu import load_config as jax_load_config
from sand_crate_tpu.numpy_ref import build_np_scene, step_numpy
from sand_crate_tpu_torch import Crate, load_config

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def deterministic_world(config):
    w = config.world_config
    w.coefficients = dict(w.coefficients)
    w.coefficients["collider_noise_level"] = 0.0
    for s in w.particle_sources:
        s.active_ticks = 0
    return w


def seed_grid(n_side, x0, y0, spacing):
    xs = x0 + spacing * np.arange(n_side)
    ys = y0 + spacing * np.arange(n_side)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    return np.stack([gx.ravel(), gy.ravel()], -1)


def make_pair(config_path, p0):
    """(port Crate on the CPU, coefficients, numpy twin scene, twin state)
    seeded with the same grid."""
    world = deterministic_world(load_config(config_path))
    # The 1k gate seeds more particles than stirring_cup's shipped budget.
    world.coefficients["max_particles"] = max(int(world.coefficients["max_particles"]), len(p0))
    n = len(p0)
    # Emission is off, so the capacity only has to hold the grid: the auto
    # backend (dense) at wave_machine's shipped 4096 slots would spend ~80 s
    # on (P, P) planes on the CPU.
    crate = Crate(world, capacity=-(-n // 128) * 128, device="cpu")
    pos = torch.zeros((crate.scene.capacity, 2), dtype=torch.float32)
    pos[:n] = torch.as_tensor(p0, dtype=torch.float32)
    alive = torch.zeros(crate.scene.capacity, dtype=torch.bool)
    alive[:n] = True
    crate.state = crate.state._replace(pos=pos, alive=alive)
    jworld = deterministic_world(jax_load_config(config_path))
    npsc, npst = build_np_scene(jworld)
    npst.pos = p0.astype(np.float64).copy()
    npst.vel = np.zeros_like(npst.pos)
    npst.pressure = np.zeros(n)
    return crate, world.coefficients, npsc, npst


@pytest.mark.parametrize(
    "scene_name,seed_kwargs,p_tol",
    [
        ("stirring_cup.yaml", dict(n_side=15, x0=0.3, y0=0.55, spacing=0.009), 1e-3),
        ("wave_machine.yaml", dict(n_side=14, x0=0.45, y0=0.82, spacing=0.0095), 1e-3),
        # tests/test_fidelity.py's 1024-particle rows, where its pressure
        # gate ladders to 3e-3.
        ("stirring_cup.yaml", dict(n_side=32, x0=0.35, y0=0.40, spacing=0.009), 3e-3),
        ("wave_machine.yaml", dict(n_side=32, x0=0.35, y0=0.62, spacing=0.0095), 3e-3),
    ],
)
def test_step_matches_numpy_twin(scene_name, seed_kwargs, p_tol):
    """40 ticks of the port's f32 step vs the f64 twin."""
    p0 = seed_grid(**seed_kwargs)
    crate, coeff, npsc, npst = make_pair(REPO / "configs" / scene_name, p0)
    for t in range(40):
        crate.physics_tick()
        npst = step_numpy(npst, coeff, npsc)
        assert len(crate.particles) == len(npst.pos), t
        dp = np.abs(crate.particles - npst.pos).max()
        dv = np.abs(crate.particle_velocities - npst.vel).max()
        assert dp < 1e-3, (t, dp)
        assert dv < 5e-2, (t, dv)
    assert np.abs(crate.particles_pressure - npst.pressure).max() < p_tol
    ds = np.abs(crate.segments - npst.segments).max()
    assert ds < 1e-5


def test_rollout_matches_tick_by_tick():
    """run() (the queued rollout) and physics_tick() give the same state."""
    p0 = seed_grid(10, 0.4, 0.6, 0.009)
    crate_a, *_ = make_pair(REPO / "configs" / "stirring_cup.yaml", p0)
    crate_b, *_ = make_pair(REPO / "configs" / "stirring_cup.yaml", p0)
    for _ in range(12):
        crate_a.physics_tick()
    crate_b.run(12)
    np.testing.assert_array_equal(crate_a.particles, crate_b.particles)
    np.testing.assert_array_equal(crate_a.particle_velocities, crate_b.particle_velocities)
    assert crate_a.tick == crate_b.tick == 12
