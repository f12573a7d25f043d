"""The showcase scenes on the port's ``Crate``, on the CPU: the twins of
``tests/test_scenes.py``'s hourglass and fountain tests, with its tick
counts and bounds.

Neither scene exists upstream.  The hourglass has sloped fixed segments
and a seeded block; its box is closed, so nothing may be culled.  The
fountain's upward emitter recycles its slots through the cull.  ``auto``
picks the dense backend for both (capacity at most 4096).  The emitters
draw from the crate's generator, not JAX's PRNG, so the assertions are the
JAX tests' physical invariants, not trajectories.  This file imports no
JAX.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from sand_crate_tpu_torch import Crate, load_config

torch.set_num_threads(1)

CONFIGS = Path(__file__).resolve().parent.parent / "configs"


@pytest.fixture(scope="module")
def hourglass():
    return load_config(CONFIGS / "hourglass.yaml")


@pytest.fixture(scope="module")
def fountain():
    return load_config(CONFIGS / "fountain.yaml")


def test_hourglass_config_shape(hourglass):
    world = hourglass.world_config
    assert [b.name for b in world.rigid_bodies] == ["box", "funnel"]
    assert len(world.rigid_bodies[1].segments) == 2
    assert world.particle_sources == []
    assert len(world.initial_particles) == 1


def test_hourglass_drains_through_neck(hourglass):
    crate = Crate(hourglass.world_config, device="cpu")
    assert crate.scene.forces_mode == "dense"
    n0 = crate.particle_count
    assert 900 < n0 <= 1100  # the seeded block
    y0 = crate.particles[:, 1]
    assert float(y0.max()) < 0.25  # all above the funnel plates

    crate.run(250)  # 0.5 s of simulated time: the center column falls through the neck

    assert crate.particle_count == n0  # closed box: nothing culled
    p = crate.particles
    v = crate.particle_velocities
    assert np.isfinite(p).all() and np.isfinite(v).all()
    # Some grains are through the neck (below the plates' y = 0.5 line)...
    assert (p[:, 1] > 0.55).sum() > 20
    # ...but the baffles hold most of the pile in the upper chamber for now.
    assert (p[:, 1] < 0.5).sum() > n0 // 2


def test_fountain_jets_and_recycles(fountain):
    crate = Crate(fountain.world_config, device="cpu")
    assert crate.scene.forces_mode == "dense"
    assert crate.particle_count == 0
    crate.run(60)
    n60 = crate.particle_count
    assert n60 > 50  # the emitter is feeding
    crate.run(540)  # 600 total
    p = crate.particles
    v = crate.particle_velocities
    assert np.isfinite(p).all() and np.isfinite(v).all()
    assert 0 < crate.particle_count <= 1200
    # Slot recycling, behaviorally: the budget saturates by ~tick 300
    # (flow * dt = 4 a tick against a cap of 1200), and a launched particle
    # is back in the pool within ~265 ticks (2 v / g at v = 2.6).  So a
    # particle still well above the pool at tick 600 was emitted after the
    # saturation, which the floor drain's culls alone make possible.
    aloft = (p[:, 1] < 0.8).sum()
    assert aloft > 10
    # The jet rises well above the nozzle (y = 0.9; smaller y is higher).
    assert float(p[:, 1].min()) < 0.75
    # Speeds stay bounded (launch speed 2.6 + jitter + kicks; no blow-up).
    assert float(np.linalg.norm(v, axis=1).max()) < 12.0
