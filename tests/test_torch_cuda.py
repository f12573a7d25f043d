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
from sand_crate_tpu_torch.ops import pmajor

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
def test_kernels_bit_identical_to_plain(cuda):
    """Pass A and every pass-B variant, symm and one-sided noise, on random
    sorted particles: the kernel and its plain version agree bit for bit."""
    rng = np.random.default_rng(2)
    n = 20000
    pos = torch.as_tensor(rng.random((n, 2)) * 0.4 + 0.3, dtype=torch.float32, device=cuda)
    vel = torch.as_tensor(rng.random((n, 2)) - 0.5, dtype=torch.float32, device=cuda)
    alive = torch.as_tensor(rng.random(n) < 0.95, device=cuda)
    crate = Crate(_world(), device=cuda)
    cid, order = torch.sort(cell_ids_grid(pos, alive, crate.scene), stable=True)
    coef = torch.tensor([0.0044, -2.0, 0.5], device=cuda)  # diameter, target, balance
    for symm in (True, False):
        scene = dataclasses.replace(crate.scene, pmajor_symm=symm)
        slab_a, ranges = pmajor.pass_a_inputs(
            pos[order], vel[order], alive[order], cid,
            torch.tensor(4e-4, device=cuda), torch.tensor(5, dtype=torch.int32, device=cuda),
            scene,
        )
        out_a = pmajor.pm_pass(slab_a, ranges, coef, "a", symm=symm)
        assert torch.equal(out_a, pmajor.pm_pass_plain(slab_a, ranges, coef, "a", symm=symm))
        assert float(out_a[3].max()) > 3  # real neighborhoods
        cp = pmajor.finalize_cp(out_a[0], out_a[3], torch.tensor(0.3, device=cuda))
        slab_b = pmajor.pass_b_slab(slab_a, out_a, cp, torch.tensor(100.0, device=cuda))
        for fold, spring in ((True, False), (False, False), (False, True)):
            kw = dict(fold=fold, spring=spring, symm=symm)
            got = pmajor.pm_pass(slab_b, ranges, coef, "b", **kw)
            assert torch.equal(got, pmajor.pm_pass_plain(slab_b, ranges, coef, "b", **kw))


@pytest.mark.cuda
def test_crate_runs_through_the_kernels(cuda):
    """Crate.run launches each pass once per tick and keeps the invariants."""
    crate = Crate(_world(), device=cuda)
    n0 = crate.particle_count
    for mode in pmajor.LAUNCHES:
        pmajor.LAUNCHES[mode] = 0
    diag = crate.run(10)
    assert pmajor.LAUNCHES == {"a": 10, "b": 10}
    assert int(diag.particle_count) == n0
    assert int(diag.non_finite) == 0 and int(diag.neighbor_overflow) == 0


@pytest.mark.cuda
def test_pm_pass_rejects_cpu_mixed_inputs(cuda):
    slab = torch.zeros((8, 8), device=cuda)
    ranges = torch.zeros((6, 8), dtype=torch.int32)  # on the CPU
    with pytest.raises(ValueError):
        pmajor.pm_pass(slab, ranges, torch.zeros(3, device=cuda), "a")
    with pytest.raises(ValueError):
        pmajor.pm_pass(slab.double(), ranges.to(cuda), torch.zeros(3, device=cuda), "a")
