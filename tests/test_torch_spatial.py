"""The port's spatial bands (``sand_crate_tpu_torch/spatial.py``) on the CPU.

Twins of the 14 tests of tests/test_spatial.py, with their tick counts,
tolerances and assertions: a crate split into y-bands over a 4-shard
``LocalGroup`` must reproduce the port's single-device step (positions as
sorted sets, rtol 1e-4 / atol 1e-5), migrate without losing or
duplicating a particle, count its halo spill and spawn truncation, and
hold its balance under rebalanced edges.  The three ``_migrate`` harness
tests also run the JAX ``_migrate`` on the same hand-built 2-shard layout
(its harness, on the conftest's CPU mesh): equal arrays.  The rollouts
that several twins read are made once (``cellwise_runs``,
``pmajor_single``).

The cellwise twins build the cell grid with 4 slots a cell where the JAX
setup has 16: the block never holds more than 2 particles in a cell (the
overflow checks below would show it), so the sums are those of 16 slots,
and the port's cell grid costs M^2 per cell (16 slots: ~10 minutes of CPU
for these twins).  tests/test_torch_spatial_jax.py holds the port against
the JAX package; this file also checks the port's own rules (the card by
default, the group's collectives and its failure path).
"""

import copy
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from sand_crate_tpu import load_config as jax_load_config
from sand_crate_tpu.scene import build_scene as jax_build_scene
from sand_crate_tpu_torch import load_config_dict
from sand_crate_tpu_torch import spatial
from sand_crate_tpu_torch.collectives import LocalGroup
from sand_crate_tpu_torch.config import InitialParticlesConfig
from sand_crate_tpu_torch.physics import step
from sand_crate_tpu_torch.scene import build_scene, init_state
from sand_crate_tpu_torch.spatial import (
    initial_band_edges,
    make_spatial_step,
    merge_state,
    shard_of,
    split_state,
)
from sand_crate_tpu_torch.state import Params
from test_spatial import _migrate_harness

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
N_SHARDS = 4
TICKS = 25
CELLWISE_SLOTS = 4
BLOCK = dict(x0=0.30, y0=0.15, x1=0.70, y1=0.75, spacing=0.018, jitter=0.0)


def _world(max_particles=256, noise=0.0, sources=False):
    """The stirring cup of tests/test_spatial.py's setup: a block of 782
    particles, no emitters (``sources`` keeps the cup's emitter)."""
    world = load_config_dict(yaml.safe_load((REPO / "configs/stirring_cup.yaml").read_text()))
    w = world.world_config
    w.coefficients = dict(w.coefficients)
    w.coefficients["max_particles"] = max_particles
    if noise is not None:
        w.coefficients["collider_noise_level"] = noise
    if not sources:
        w.particle_sources = []
        w.initial_particles = [InitialParticlesConfig(**BLOCK)]
    return w


def _scene(w, mode, capacity=1024, **kw):
    if mode == "cellwise":
        kw.setdefault("cell_capacity", CELLWISE_SLOTS)
    return build_scene(w, capacity=capacity, forces_mode=mode, device="cpu", **kw)


@pytest.fixture
def threads():
    """Four intra-op threads for the plane-heavy twins (the shards take
    turns, so each runs its operations alone)."""
    before = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def group():
    g = LocalGroup(N_SHARDS, device="cpu")
    yield g
    g.close()


@pytest.fixture(scope="module")
def setup():
    w = _world()
    scene = _scene(w, "cellwise")
    assert scene.grid_ny % N_SHARDS == 0
    return scene, init_state(w, scene, seed=0), Params.from_coefficients(w.coefficients, "cpu"), w


def _single(state, params, scene, ticks):
    gen = torch.Generator()
    gen.manual_seed(0)
    for _ in range(ticks):
        state, _ = step(state, params, scene, gen)
    return state


def _bands(group, state0, params, scene, ticks, rebalance=False):
    """(split state, last stats, initial edges) after ``ticks`` band ticks."""
    edges = initial_band_edges(state0, scene, group.size) if rebalance else None
    s = split_state(state0, scene, group.size, edges)
    edges0 = edges
    spatial_step = make_spatial_step(group, scene, rebalance=rebalance)
    stats = None
    for _ in range(ticks):
        if rebalance:
            s, stats = spatial_step(s, params, edges)
            edges = stats["band_edges"]
        else:
            s, stats = spatial_step(s, params)
    return s, stats, edges0


def _sorted_alive_positions(state):
    p = state.pos.numpy()[state.alive.numpy()]
    return p[np.lexsort((p[:, 1], p[:, 0]))]


def _close_to_single(single, split, scene):
    merged = merge_state(split, scene, N_SHARDS)
    a, b = _sorted_alive_positions(single), _sorted_alive_positions(merged)
    assert len(a) == len(b) > 0
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def cellwise_runs(setup, group):
    """The cellwise setup's single-device rollout and uniform band rollout
    (TICKS each), shared by the tests that read them."""
    scene, state0, params, _ = setup
    before = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        split, stats, _ = _bands(group, state0, params, scene, TICKS)
        return _single(state0, params, scene, TICKS), split, stats
    finally:
        torch.set_num_threads(before)


def test_spatial_matches_single_device(setup, cellwise_runs):
    scene, _, _, _ = setup
    single, split, stats = cellwise_runs
    assert int(stats["migration_dropped"]) == 0
    assert int(stats["neighbor_overflow"]) == 0
    n_single = int(single.alive.sum())
    n_spatial = int(merge_state(split, scene, N_SHARDS).alive.sum())
    assert n_single == n_spatial > 0
    _close_to_single(single, split, scene)


def test_migration_happens(setup, cellwise_runs):
    """Falling particles must actually cross band boundaries."""
    scene, state0, _, _ = setup
    owner0 = shard_of(state0.pos[:, 1], scene, N_SHARDS)[state0.alive].numpy()
    merged = merge_state(cellwise_runs[1], scene, N_SHARDS)
    owner1 = shard_of(merged.pos[:, 1], scene, N_SHARDS)[merged.alive].numpy()
    assert owner1.mean() != pytest.approx(owner0.mean())


def _port_migrate(scene, pos0, alive0, mig_cap, uid0=None):
    """The port's _migrate once on a hand-built 2-shard layout (the JAX
    harness's arguments and returns)."""
    n_shards = 2
    pos = torch.as_tensor(np.asarray(pos0, np.float32).reshape(n_shards, -1, 2))
    alive = torch.as_tensor(np.asarray(alive0, bool).reshape(n_shards, -1))
    P_cap = pos.shape[1]
    if uid0 is None:
        uid0 = np.arange(n_shards * P_cap, dtype=np.int32)
    uid = torch.as_tensor(np.asarray(uid0, np.int32).reshape(n_shards, P_cap))
    g = LocalGroup(n_shards, device="cpu")
    try:
        outs = g.run(
            lambda comm, p, a, u: spatial._migrate(p, torch.zeros_like(p), a, u, scene, comm,
                                                   mig_cap),
            list(pos), list(alive), list(uid))
    finally:
        g.close()
    return (
        np.stack([o[0].numpy() for o in outs]),
        np.stack([o[2].numpy() for o in outs]),
        int(sum(o[4] for o in outs)),
        int(sum(o[5] for o in outs)),
        np.stack([o[3].numpy() for o in outs]),
    )


@pytest.fixture(scope="module")
def jax_scene():
    config = copy.deepcopy(jax_load_config(REPO / "configs/stirring_cup.yaml"))
    w = config.world_config
    w.coefficients = dict(w.coefficients)
    w.coefficients["max_particles"] = 256
    w.particle_sources = []
    return jax_build_scene(w, capacity=1024, forces_mode="cellwise")


def _both_migrate(jax_scene, scene, pos, alive, mig_cap, uid=None):
    """The port's and the JAX _migrate on one layout: equal arrays."""
    ref = _migrate_harness((jax_scene,), pos, alive, mig_cap, uid0=uid)
    got = _port_migrate(scene, pos, alive, mig_cap, uid0=uid)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r))
    return got


def test_migration_full_shard_never_overwrites(setup, jax_scene):
    """Arrivals at a full shard are dropped and counted, never written over
    live particles."""
    scene = setup[0]
    P_cap = scene.capacity
    band_h = scene.grid_ny // 2 * scene.cell_size
    pos = np.zeros((2, P_cap, 2), np.float32)
    alive = np.zeros((2, P_cap), bool)
    pos[0, 0] = (0.5, band_h + 0.5 * scene.cell_size)
    alive[0, 0] = True
    rng = np.random.default_rng(0)
    pos[1, :, 0] = rng.uniform(0.1, 0.9, P_cap)
    pos[1, :, 1] = rng.uniform(band_h, 2 * band_h - scene.cell_size, P_cap)
    alive[1] = True
    new_pos, new_alive, dropped, deferred, _ = _both_migrate(jax_scene, scene, pos, alive, 4)
    assert new_alive[1].all()
    np.testing.assert_array_equal(new_pos[1], pos[1])
    assert dropped == 1
    assert deferred == 0
    assert not new_alive[0].any()


def test_migration_overflow_movers_retry_not_killed(setup, jax_scene):
    """Movers beyond mig_cap stay alive locally for the next tick."""
    scene = setup[0]
    P_cap = scene.capacity
    band_h = scene.grid_ny // 2 * scene.cell_size
    pos = np.zeros((2, P_cap, 2), np.float32)
    alive = np.zeros((2, P_cap), bool)
    n_movers = 3
    for i in range(n_movers):
        pos[0, i] = (0.2 + 0.1 * i, band_h + 0.5 * scene.cell_size)
        alive[0, i] = True
    new_pos, new_alive, dropped, deferred, _ = _both_migrate(jax_scene, scene, pos, alive, 1)
    assert dropped == 0
    assert deferred == n_movers - 1
    assert int(new_alive[1].sum()) == 1
    assert int(new_alive[0].sum()) == n_movers - 1
    assert int(new_alive.sum()) == n_movers


def test_spatial_spawn_budget_is_global():
    """Sources spawn only on their owning shard and respect the global cap.
    On the p-major bands (the JAX test runs cellwise; the budget is the
    step's, before any pair sum, and the cellwise bands take ~3x as long
    for its 120 ticks on the CPU)."""
    w = _world(max_particles=40, noise=None, sources=True)
    scene = _scene(w, "pmajor", capacity=256)
    assert scene.grid_ny % N_SHARDS == 0
    params = Params.from_coefficients(w.coefficients, "cpu")
    g = LocalGroup(N_SHARDS, device="cpu")
    try:
        _, stats, _ = _bands(g, init_state(w, scene, seed=0), params, scene, 120)
    finally:
        g.close()
    total = int(stats["particle_count"])
    assert 0 < total
    assert total <= 40 + scene.max_spawn * scene.num_sources


def test_migration_preserves_uid(setup, jax_scene):
    """A migrated particle keeps its uid, and the global uid multiset is a
    pure swap of the pre-migration one."""
    scene = setup[0]
    P_cap = scene.capacity
    band_h = scene.grid_ny // 2 * scene.cell_size
    pos = np.zeros((2, P_cap, 2), np.float32)
    alive = np.zeros((2, P_cap), bool)
    pos[0, 0] = (0.5, band_h + 0.5 * scene.cell_size)
    pos[0, 1] = (0.3, band_h + 0.5 * scene.cell_size)
    pos[0, 2] = (0.5, 0.5 * band_h)
    alive[0, :3] = True
    pos[1, 0] = (0.5, 1.5 * band_h)
    alive[1, 0] = True
    uid = np.arange(2 * P_cap, dtype=np.int32).reshape(2, P_cap) + 1000
    new_pos, new_alive, dropped, deferred, new_uid = _both_migrate(
        jax_scene, scene, pos, alive, 4, uid)
    assert dropped == 0 and deferred == 0
    arrivals = {int(u): tuple(p) for u, p in zip(new_uid[1][new_alive[1]],
                                                 new_pos[1][new_alive[1]])}
    assert set(arrivals) == {1000, 1001, 1000 + P_cap}
    np.testing.assert_allclose(arrivals[1000], pos[0, 0], atol=0)
    np.testing.assert_allclose(arrivals[1001], pos[0, 1], atol=0)
    assert sorted(new_uid.ravel().tolist()) == sorted(uid.ravel().tolist())


def test_spatial_uid_unique_after_rollout(setup, cellwise_runs):
    """After TICKS band ticks with real migration, alive uids are globally
    unique and a subset of the initial assignment."""
    scene, state0, _, _ = setup
    uid0 = split_state(state0, scene, N_SHARDS).uid.numpy()
    split = cellwise_runs[1]
    uid1, alive1 = split.uid.numpy(), split.alive.numpy()
    live = uid1[alive1]
    assert len(np.unique(live)) == len(live)
    assert sorted(uid1.tolist()) == sorted(uid0.tolist())


def test_spatial_pallas_matches_single_device(setup, group, threads):
    """The slot-grid band route (slab-order K4+K5 and K8+K9 per band, as
    their plain versions here) reproduces the single-device pallas step."""
    _, state0, params, w = setup
    scene = _scene(w, "pallas")
    assert scene.grid_ny % N_SHARDS == 0
    ticks = 10
    single = _single(state0, params, scene, ticks)
    split, stats, _ = _bands(group, state0, params, scene, ticks)
    assert int(stats["migration_dropped"]) == 0
    assert int(single.alive.sum()) == int(stats["particle_count"]) > 0
    _close_to_single(single, split, scene)


@pytest.fixture(scope="module")
def pmajor_single(setup):
    _, state0, params, w = setup
    scene = _scene(w, "pmajor")
    return scene, _single(state0, params, scene, 6)


def test_spatial_pmajor_matches_single_device(setup, group, pmajor_single):
    """The banded p-major route (particle-slab halos, the pass-A sums
    exchanged before pass B) reproduces the single-device pmajor step."""
    _, state0, params, _ = setup
    scene, single = pmajor_single
    assert scene.grid_ny % N_SHARDS == 0
    split, stats, _ = _bands(group, state0, params, scene, 6)
    assert int(stats["migration_dropped"]) == 0
    assert int(stats["neighbor_overflow"]) == 0
    assert int(single.alive.sum()) == int(stats["particle_count"]) > 0
    _close_to_single(single, split, scene)


def test_spatial_pmajor_halo_spill_counted(setup):
    """An edge row holding more particles than the static halo buffer
    surfaces in the psum'd overflow, never silently."""
    _, _, params, w = setup
    scene = _scene(w, "pmajor")
    n_shards = 2
    assert scene.grid_ny % n_shards == 0
    hc = spatial._halo_cap(scene)
    assert hc < 512
    state = init_state(w, scene, seed=0)
    P_cap = scene.capacity
    band_h = scene.grid_ny // n_shards
    rng = np.random.default_rng(1)
    pos = np.zeros((P_cap, 2), np.float32)
    n = 2 * hc
    pos[:n, 0] = rng.uniform(0.1, 0.9, n)
    pos[:n, 1] = (band_h - 1.5) * scene.cell_size
    alive = np.zeros(P_cap, bool)
    alive[:n] = True
    state = state._replace(pos=torch.as_tensor(pos), alive=torch.as_tensor(alive))
    g = LocalGroup(n_shards, device="cpu")
    try:
        _, stats = make_spatial_step(g, scene)(split_state(state, scene, n_shards), params)
    finally:
        g.close()
    assert int(stats["neighbor_overflow"]) >= hc


@pytest.mark.parametrize("mode,rebalance", [
    ("pmajor", False), ("pmajor", True), ("pallas", False), ("cellwise", False),
    ("cellwise", True),
])
def test_spatial_sent_runs_beside_the_spill(setup, mode, rebalance):
    """stats["shard_sent"] holds the edge-row runs each shard sends, so a
    spill has its cause beside it: 2 x _halo_cap particles in band 0's last
    row are sent whole by p-major (its spill is the run past the cap), and
    as the in-cap particles of their cells by pallas and cellwise (their
    overflow is the rest).  Rebalanced steps take the same edges as
    tensors, so the bottom row is read at a traced band height."""
    _, _, params, w = setup
    # 4 slots a cell, so the row's cells overflow on every route but p-major.
    scene = _scene(w, mode, cell_capacity=CELLWISE_SLOTS)
    n_shards = 2
    hc = spatial._halo_cap(scene)
    P_cap, M, nx = scene.capacity, scene.cell_capacity, scene.grid_nx
    band_h = scene.grid_ny // n_shards
    rng = np.random.default_rng(1)
    pos = np.zeros((P_cap, 2), np.float32)
    n = 2 * hc
    pos[:n, 0] = rng.uniform(0.1, 0.9, n)
    pos[:n, 1] = (band_h - 1.5) * scene.cell_size
    alive = np.zeros(P_cap, bool)
    alive[:n] = True
    state = init_state(w, scene, seed=0)
    state = state._replace(pos=torch.as_tensor(pos), alive=torch.as_tensor(alive))
    cx = np.clip(np.floor(pos[:n, 0] / scene.cell_size).astype(np.int64) + 1, 0, nx - 1)
    in_cap = int(np.minimum(np.bincount(cx, minlength=nx), M).sum())
    edges = torch.tensor([0, band_h, scene.grid_ny], dtype=torch.int32) if rebalance else None
    g = LocalGroup(n_shards, device="cpu")
    try:
        step_fn = make_spatial_step(g, scene, rebalance=rebalance)
        split = split_state(state, scene, n_shards, edges)
        _, stats = step_fn(split, params, edges) if rebalance else step_fn(split, params)
    finally:
        g.close()
    sent, over = stats["shard_sent"].numpy(), stats["shard_overflow"].numpy()
    if mode == "pmajor":
        np.testing.assert_array_equal(sent, [[0, n], [0, 0]])
        np.testing.assert_array_equal(over, np.maximum(sent - hc, 0).sum(axis=1))
    else:
        assert in_cap < n
        np.testing.assert_array_equal(sent, [[0, in_cap], [0, 0]])
        np.testing.assert_array_equal(over, [n - in_cap, 0])


def test_spatial_pmajor_sentinels_inside_ranges_pass_no_pair(setup):
    """Band 1's above halo pads its unused entries with the sort-safe cid
    lo * nx - 1 and zero features.  Particles pressed against the right
    wall (x = 1 bins in column nx - 2) in row lo have that cid inside their
    d = -1 range, so only the pair mask keeps the sentinels out: each
    self's pass-A neighbor count must equal a brute force over the slab's
    real entries (the band's and the halo's particles)."""
    _, _, params, w = setup
    scene = _scene(w, "pmajor")
    nx, ny, cs = scene.grid_nx, scene.grid_ny, scene.cell_size
    lo = ny // 2
    rng = np.random.default_rng(3)
    pos = np.zeros((scene.capacity, 2), np.float32)
    alive = np.zeros(scene.capacity, bool)
    n = 48
    pos[:n, 0] = np.where(np.arange(n) % 2 == 0, 1.0, rng.uniform(0.97, 1.0, n))
    pos[:n, 1] = (lo - 2 + rng.uniform(0.0, 3.0, n)) * cs  # rows lo - 1 .. lo + 1
    alive[:n] = True
    state = init_state(w, scene, seed=0)
    state = state._replace(pos=torch.as_tensor(pos), alive=torch.as_tensor(alive))
    capture = [{}, {}]
    g = LocalGroup(2, device="cpu")
    try:
        make_spatial_step(g, scene)(split_state(state, scene, 2), params, capture=capture)
    finally:
        g.close()
    cap = capture[1]
    cid, slab, ranges, hc = cap["cid"], cap["slab_a"], cap["ranges"], cap["hc"]
    assert int(cap["lo"]) == lo
    real = (cid < nx * ny) & (slab[:, :6] != 0).any(dim=1)
    sentinel = (cid == lo * nx - 1) & ~real
    assert 0 < int(sentinel.sum()) < hc and int(real[:hc].sum()) > 0
    edge = torch.zeros(cid.numel() + 1, dtype=torch.int32)
    for q in range(3):
        edge.index_add_(0, ranges[q].long(), torch.ones_like(ranges[q]))
        edge.index_add_(0, ranges[3 + q].long(), -torch.ones_like(ranges[q]))
    covered = torch.cumsum(edge, 0)[:-1] > 0
    assert int((sentinel & covered).sum()) > 0

    selves = torch.nonzero(ranges[3:].sum(dim=0) > ranges[:3].sum(dim=0)).flatten()
    assert selves.numel() > 0
    xy = slab[:, :2].double()
    d2 = ((xy[selves, None] - xy[None, real]) ** 2).sum(dim=-1)
    brute = (d2 <= float(params.diameter) ** 2).sum(dim=1) - 1  # less the self
    assert int(brute.max()) > 0
    np.testing.assert_array_equal(cap["out_a"][3, selves].numpy(), brute.numpy())


def test_spatial_spawn_truncation_counted():
    """A flow spike past the static max_spawn bound surfaces in the psum'd
    spawn_truncated counter."""
    w = _world(max_particles=200, noise=None, sources=True)
    scene = _scene(w, "cellwise", capacity=256)
    assert scene.num_sources > 0 and scene.grid_ny % N_SHARDS == 0
    scene = dataclasses.replace(scene, max_spawn=2,
                                src_flow=torch.full_like(scene.src_flow, 5000.0))
    params = Params.from_coefficients(w.coefficients, "cpu")
    g = LocalGroup(N_SHARDS, device="cpu")
    try:
        _, stats = make_spatial_step(g, scene)(
            split_state(init_state(w, scene, seed=0), scene, N_SHARDS), params)
    finally:
        g.close()
    assert int(stats["spawn_truncated"]) > 0


def test_spatial_rebalance_pmajor_matches_single_device(setup, group, pmajor_single):
    """Variable-height bands and the banded p-major route together (band
    edges are device tensors; the halo runs follow them)."""
    _, state0, params, _ = setup
    scene, single = pmajor_single
    split, stats, _ = _bands(group, state0, params, scene, 6, rebalance=True)
    assert int(stats["migration_dropped"]) == 0
    assert int(stats["neighbor_overflow"]) == 0
    _close_to_single(single, split, scene)


def test_spatial_rebalance_matches_single_device(setup, group, cellwise_runs, threads):
    """Density-quantile edges, recomputed in the step and threaded tick to
    tick, reproduce the single-device trajectory with better balance than
    the uniform split."""
    scene, state0, params, _ = setup
    edges = initial_band_edges(state0, scene, N_SHARDS).numpy()
    assert edges[0] == 0 and edges[-1] == scene.grid_ny
    assert (np.diff(edges) >= 1).all()
    uniform = np.arange(N_SHARDS + 1) * (scene.grid_ny // N_SHARDS)
    assert not np.array_equal(edges, uniform)
    split, stats, _ = _bands(group, state0, params, scene, TICKS, rebalance=True)
    single = cellwise_runs[0]
    assert int(stats["migration_dropped"]) == 0
    assert int(single.alive.sum()) == int(stats["particle_count"]) > 0
    _close_to_single(single, split, scene)
    per_band = stats["shard_alive"].numpy()
    assert (per_band > 0).all()
    assert per_band.max() / per_band.mean() < 2.0


def test_spatial_rebalance_subsampled_edges_match(setup, group, cellwise_runs, monkeypatch,
                                                  threads):
    """Edges from a strided subsample (1/8 of the slots here) still give
    exact ownership and migration: the trajectory matches single-device."""
    scene, state0, params, _ = setup
    monkeypatch.setattr(spatial, "EDGE_SAMPLE_TARGET", 128)
    assert spatial._edge_sample_stride(scene.capacity) == 8
    split, stats, _ = _bands(group, state0, params, scene, TICKS, rebalance=True)
    assert int(stats["migration_dropped"]) == 0
    _close_to_single(cellwise_runs[0], split, scene)
    assert (stats["shard_alive"].numpy() > 0).all()


# ---- the port's own rules ---------------------------------------------------------


def test_band_entry_points_default_to_the_card(setup):
    """make_spatial_step and LocalGroup run on the card unless asked for
    the CPU (without one they raise); split_state keeps the input's
    device; a group and a scene on different devices are refused."""
    scene, state0, _, _ = setup
    if torch.cuda.is_available():
        assert LocalGroup(2).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="LocalGroup runs on the CUDA device"):
            LocalGroup(2)
        with pytest.raises(RuntimeError, match="runs on the CUDA device"):
            make_spatial_step(N_SHARDS, scene)
    assert split_state(state0, scene, N_SHARDS).pos.device.type == "cpu"
    step_ = make_spatial_step(N_SHARDS, scene, device="cpu")
    assert step_.group.device.type == "cpu" and step_.mig_cap == 64
    step_.group.close()


def test_local_group_collectives():
    """Both rings, psum and all_gather in rank order, including the wrap."""
    g = LocalGroup(3, device="cpu")
    try:
        outs = g.run(lambda c: (
            c.exchange([torch.tensor([c.rank])], [torch.tensor([10 + c.rank])]),
            c.psum(torch.tensor(c.rank + 1)),
            c.all_gather(torch.tensor([c.rank, -c.rank])),
        ))
    finally:
        g.close()
    for r, ((from_prev, from_next), total, gathered) in enumerate(outs):
        assert int(from_prev[0]) == (r - 1) % 3
        assert int(from_next[0]) == 10 + (r + 1) % 3
        assert int(total) == 6
        assert gathered.tolist() == [[0, 0], [1, -1], [2, -2]]


def test_local_group_stress_many_shards_short_switch_interval():
    """More shards than cores, the interpreter switching threads every
    microsecond, 200 rounds of both rings and a psum: every value arrives
    from the right shard and round (a lost or stale slot would not)."""
    n, rounds = 16, 200
    g = LocalGroup(n, device="cpu", timeout=60.0)

    def fn(c):
        seen = []
        for k in range(rounds):
            (p,), (q,) = c.exchange([torch.tensor([c.rank, k])], [torch.tensor([c.rank, -k])])
            seen.append((p.tolist(), q.tolist(), int(c.psum(torch.tensor(k)))))
        return seen

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        outs = g.run(fn)
    finally:
        sys.setswitchinterval(interval)
        g.close()
    for r, seen in enumerate(outs):
        assert seen == [([(r - 1) % n, k], [(r + 1) % n, -k], n * k) for k in range(rounds)]


def test_local_group_failing_shard_raises_not_hangs():
    """A shard that raises fails the call with its own error while the
    others wait at an exchange; the group runs again afterwards."""
    g = LocalGroup(4, device="cpu", timeout=30.0)

    def fn(c):
        if c.rank == 2:
            raise ValueError("shard 2 failed")
        return c.psum(torch.tensor(1))

    try:
        with pytest.raises(ValueError, match="shard 2 failed"):
            g.run(fn)
        assert [int(x) for x in g.run(lambda c: c.psum(torch.tensor(1)))] == [4] * 4
    finally:
        g.close()


def test_merge_state_warns_past_capacity(setup):
    """More alive particles than one crate holds: warn and truncate."""
    scene, state0, _, _ = setup
    split = split_state(state0, scene, 2)
    full = split._replace(alive=torch.ones_like(split.alive))
    with pytest.warns(UserWarning, match="exceed single-crate capacity"):
        merged = merge_state(full, scene, 2)
    assert int(merged.alive.sum()) == scene.capacity
