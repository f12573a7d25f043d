"""The port's crate-axis data parallel (``parallel.py``) and the twins of
``__graft_entry__.py`` (``entry.py``), on the CPU.

Twins of the 5 tests of tests/test_parallel.py: the mesh keeps the JAX axis
sizes; ``shard_batched`` puts every leaf's block of crates on its device;
the sharded step runs each device's block through the vmapped step and
advances every crate one tick; with nothing random that matters (no
emitter, no collider noise) it equals the unsharded vmap; and the port's
``dryrun_multichip(8)`` runs its five legs.  The "devices" are 8 entries of
the CPU.  The JAX batched setup runs the cellwise backend; these run
chunked, the dry run's backend, and the sharded-equals-unsharded check runs
on cellwise too, the JAX test's own backend (the port's vmapped step takes
every backend, ``sweep.py``).
"""

import copy

import numpy as np
import pytest
import torch
import yaml

from sand_crate_tpu_torch import entry, load_config_dict
from sand_crate_tpu_torch.parallel import (
    make_mesh,
    params_pspecs,
    shard_batched,
    sharded_batched_step,
    state_pspecs,
)
from sand_crate_tpu_torch.scene import build_scene, init_state
from sand_crate_tpu_torch.state import CrateState, Params
from sand_crate_tpu_torch.sweep import _batched_rollout, stack_params, stack_states

torch.set_num_threads(1)

CPU8 = ["cpu"] * 8


def _batch(raw, emitters=True, noise=None, forces_mode="chunked"):
    raw = copy.deepcopy(raw)
    w = load_config_dict(raw).world_config
    w.coefficients = dict(w.coefficients)
    w.coefficients["max_particles"] = 64
    if noise is not None:
        w.coefficients["collider_noise_level"] = noise
    if not emitters:
        from sand_crate_tpu_torch.config import InitialParticlesConfig

        w.particle_sources = []
        w.initial_particles = [InitialParticlesConfig(x0=0.3, y0=0.2, x1=0.7, y1=0.7,
                                                      spacing=0.05, jitter=0.3)]
    scene = build_scene(w, capacity=128, forces_mode=forces_mode, device="cpu")
    mesh = make_mesh(8, devices=CPU8)
    n_batch = mesh.shape["crates"] * 2
    base = Params.from_coefficients(w.coefficients, "cpu")
    params = stack_params([base] * n_batch)
    states = stack_states([init_state(w, scene, seed=i) for i in range(n_batch)])
    return scene, mesh, states, params


@pytest.fixture(scope="module")
def raw(request):
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "configs/stirring_cup.yaml"
    return yaml.safe_load(path.read_text())


@pytest.fixture(scope="module")
def batched_setup(raw):
    return _batch(raw)


def test_make_mesh_shape():
    mesh = make_mesh(8, devices=CPU8)
    assert dict(mesh.shape) == {"crates": 4, "space": 2}
    assert mesh.devices.size == 8
    mesh3 = make_mesh(3, devices=CPU8)
    assert dict(mesh3.shape) == {"crates": 3, "space": 1}
    if not torch.cuda.is_available():  # the default devices are the cards
        with pytest.raises(RuntimeError, match="make_mesh runs on the CUDA device"):
            make_mesh(1)


def test_shard_batched_places_every_leaf(batched_setup):
    scene, mesh, states, params = batched_setup
    sh_states, sh_params, (s_specs, p_specs) = shard_batched(mesh, states, params)
    assert s_specs == state_pspecs() and p_specs == params_pspecs()
    assert len(sh_states.parts) == len(mesh.flat) == 8
    n = 0
    for part, pparts, dev in zip(sh_states.parts, sh_params.parts, sh_states.devices):
        assert isinstance(part, CrateState) and isinstance(pparts, Params)
        k = part.pos.shape[0]
        for leaf, full in zip(part, states):
            assert leaf.device == torch.device(dev) and leaf.shape[0] == k
            assert torch.equal(leaf, full[n:n + k])
        for leaf in pparts:
            assert leaf.device == torch.device(dev) and leaf.shape[0] == k
        n += k
    assert n == states.pos.shape[0]


def test_sharded_batched_step_executes_and_preserves_sharding(batched_setup):
    scene, mesh, states, params = batched_setup
    sh_states, sh_params, _ = shard_batched(mesh, states, params)
    new_states, diags = sharded_batched_step(mesh, scene)(sh_states, sh_params)
    assert [p.pos.shape for p in new_states.parts] == [p.pos.shape for p in sh_states.parts]
    merged = new_states.gather()
    assert merged.pos.shape == states.pos.shape
    assert np.isfinite(merged.pos.numpy()[merged.alive.numpy()]).all()
    assert (merged.tick.numpy() == states.tick.numpy() + 1).all()
    assert len(diags) == 8 and all(int(d.non_finite.max()) == 0 for d in diags)


def test_sharded_step_matches_unsharded_vmap(raw):
    """No emitter and no collider noise: nothing drawn changes a result, so
    the device blocks' vmapped steps equal one vmap over every crate."""
    scene, mesh, states, params = _batch(raw, emitters=False, noise=0.0)
    gen = torch.Generator()
    gen.manual_seed(0)
    ref, _ = _batched_rollout(states, params, scene, 1, gen)
    sh_states, sh_params, _ = shard_batched(mesh, states, params)
    new_states, _ = sharded_batched_step(mesh, scene)(sh_states, sh_params)
    merged = new_states.gather()
    assert int(merged.alive.sum()) > 100
    np.testing.assert_allclose(merged.pos.numpy(), ref.pos.numpy(), atol=1e-6)
    np.testing.assert_allclose(merged.vel.numpy(), ref.vel.numpy(), atol=1e-6)


def test_sharded_step_matches_unsharded_vmap_cellwise(raw):
    """The same on the cellwise backend, the JAX mesh test's own
    (tests/test_parallel.py:28-31)."""
    scene, mesh, states, params = _batch(raw, emitters=False, noise=0.0, forces_mode="cellwise")
    gen = torch.Generator()
    gen.manual_seed(0)
    ref, _ = _batched_rollout(states, params, scene, 1, gen)
    sh_states, sh_params, _ = shard_batched(mesh, states, params)
    new_states, diags = sharded_batched_step(mesh, scene)(sh_states, sh_params)
    merged = new_states.gather()
    assert int(merged.alive.sum()) > 100
    assert all(int(d.non_finite.max()) == 0 for d in diags)
    np.testing.assert_allclose(merged.pos.numpy(), ref.pos.numpy(), atol=1e-6)
    np.testing.assert_allclose(merged.vel.numpy(), ref.vel.numpy(), atol=1e-6)


def test_sharded_crates_draw_per_device(batched_setup):
    """With the emitter on, each device's generator draws its own numbers:
    every crate spawns within its budget, and crates on two devices that
    start alike spawn at other positions."""
    scene, mesh, states, params = batched_setup
    sh_states, sh_params, _ = shard_batched(mesh, states, params)
    step_fn = sharded_batched_step(mesh, scene)
    for _ in range(30):
        sh_states, _ = step_fn(sh_states, sh_params)
    merged = sh_states.gather()
    counts = merged.alive.sum(dim=1)
    assert (counts > 0).all() and (counts <= 64 + scene.max_spawn * scene.num_sources).all()
    first = [p.pos[0][p.alive[0]] for p in sh_states.parts[:2]]
    assert not torch.equal(first[0], first[1])


def test_dryrun_multichip():
    """The twin of ``__graft_entry__.dryrun_multichip`` passes on 8 CPU
    entries."""
    out = entry.dryrun_multichip(8, device="cpu")
    for leg in ("batched", "spatial", "spatial-pallas", "spatial-pmajor", "spatial-rebalance"):
        assert out[leg] > 0, leg
    assert out["band_edges"][0] == 0 and out["band_edges"][-1] == 104


def test_entry_step_on_the_cpu():
    """entry(): one stirring_cup step; on the card by default."""
    fn, (state, params) = entry.entry(device="cpu")
    pos, dv = fn(state, params)
    assert tuple(pos.shape) == tuple(state.pos.shape) and dv.shape == (7,)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="runs on the CUDA device"):
            entry.entry()
        with pytest.raises(RuntimeError, match="runs on the CUDA device"):
            entry.dryrun_multichip(2)
