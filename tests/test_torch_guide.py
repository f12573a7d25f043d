"""The guide's Python-API snippets (docs/GUIDE.md section 6) on the port,
on the CPU: the twins of tests/test_guide_examples.py's three tests, so the
port keeps the API that the guide shows."""

from pathlib import Path

import numpy as np
import pytest
import torch

from sand_crate_tpu_torch import Crate, build_all, load_config, rollout, step

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def stirring_cup():
    return load_config(REPO / "configs" / "stirring_cup.yaml")


def test_guide_crate_snippet(stirring_cup):
    crate = Crate(stirring_cup.world_config, device="cpu")
    crate.physics_tick()
    crate.run(10)
    assert crate.particles.shape[1] == 2
    assert crate.particle_velocities.shape == crate.particles.shape
    assert crate.particles_pressure.shape[0] == crate.particles.shape[0]
    assert crate.segments.ndim == 3

    before = crate.viscosity
    crate.viscosity *= 1.1  # a live edit
    assert crate.viscosity == pytest.approx(before * 1.1)
    assert "viscosity" in crate.editable_coefficients()

    frames = list(crate.stream_frames(num_frames=3, ticks_per_frame=2))
    assert len(frames) == 3 and "pos" in frames[0]


def test_guide_functional_core_snippet(stirring_cup):
    scene, state, params = build_all(stirring_cup, device="cpu")
    generator = torch.Generator().manual_seed(0)
    state, diag = step(state, params, scene, generator)
    assert int(diag.non_finite) == 0
    state, last_diag = rollout(state, params, scene, num_ticks=5, generator=generator)
    assert int(last_diag.non_finite) == 0
    assert int(state.tick) == 6


def test_guide_batched_snippet(stirring_cup):
    from sand_crate_tpu_torch.state import Params
    from sand_crate_tpu_torch.sweep import BatchedCrates, random_params, stack_params

    base = Params.from_coefficients(stirring_cup.world_config.coefficients, "cpu")
    params = stack_params([base] * 4)
    batch = BatchedCrates(stirring_cup, params, seed=0, device="cpu")
    batch.run(5)
    assert batch.positions().shape[0] == 4
    assert len(batch.particle_counts()) == 4

    rnd = random_params(torch.Generator().manual_seed(0), base, {"viscosity": (4.0, 8.0)}, n=4)
    assert rnd.viscosity.shape == (4,)
    assert np.all(rnd.viscosity.numpy() >= 4.0)
