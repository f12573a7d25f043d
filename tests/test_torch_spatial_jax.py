"""The port's spatial bands against the JAX package's, on the CPU.

The same inputs, made from tests/test_spatial.py's setup (the stirring cup
block of 782 particles, no emitters), go through both packages:
``split_state``, ``merge_state``, ``initial_band_edges``, ``shard_of`` and
``_edges_from_hist`` must agree exactly; one band tick per backend from
the same split state, the port's ``make_spatial_step`` over a 4-shard
``LocalGroup`` against JAX's on the conftest's 4-device CPU mesh (its
Pallas kernels in interpret mode): cellwise with noise 0 (each package
draws its cellwise jitter from its own generator), pallas (8 slots a cell,
which keeps the interpret-mode kernels at ~20 s) and pmajor with the
collider noise on (the hashes must agree), pmajor also under
``SAND_CRATE_PMAJOR_GATE=1``.  Positions at 1e-4 / 1e-5 (tests/test_spatial.py:83),
the pressure and the velocity change over dt (the pair sums' kicks) at the
suite's PairSums tolerance 3e-3 (tests/test_pmajor.py:53), alive, uids and
every stat exactly.
"""

import copy
import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import sand_crate_tpu.spatial as jspatial
from sand_crate_tpu import load_config as jax_load_config
from sand_crate_tpu.config import InitialParticlesConfig as JaxBlock
from sand_crate_tpu.scene import build_scene as jax_build_scene
from sand_crate_tpu.scene import init_state as jax_init_state
from sand_crate_tpu.state import Params as JaxParams
from sand_crate_tpu_torch import spatial
from sand_crate_tpu_torch.collectives import LocalGroup
from sand_crate_tpu_torch.spatial import (
    initial_band_edges,
    make_spatial_step,
    merge_state,
    shard_of,
    split_state,
)
from sand_crate_tpu_torch.state import (
    CrateState,
    params_from_numpy,
    scene_from_numpy,
    state_from_numpy,
)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
N_SHARDS = 4
BLOCK = dict(x0=0.30, y0=0.15, x1=0.70, y1=0.75, spacing=0.018, jitter=0.0)
PAIR_TOL = 3e-3


@pytest.fixture(scope="module")
def group():
    g = LocalGroup(N_SHARDS, device="cpu")
    yield g
    g.close()


def _jax_world(noise=0.0):
    config = copy.deepcopy(jax_load_config(REPO / "configs/stirring_cup.yaml"))
    w = config.world_config
    w.coefficients = dict(w.coefficients)
    w.coefficients["max_particles"] = 256
    if noise is not None:
        w.coefficients["collider_noise_level"] = noise
    w.particle_sources = []
    w.initial_particles = [JaxBlock(**BLOCK)]
    return w


def _carry(js, jp, jstate, mode):
    """The JAX scene, params and state in the port, leaf by leaf."""
    fields = {f.name: getattr(js, f.name) for f in dataclasses.fields(js)}
    fields = {k: np.asarray(v) if hasattr(v, "shape") else v for k, v in fields.items()}
    fields["forces_mode"] = mode
    ts = scene_from_numpy(fields, device="cpu")
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp._asdict().items()}, device="cpu")
    t0 = state_from_numpy({k: np.asarray(getattr(jstate, k)) for k in CrateState._fields},
                          device="cpu")
    return ts, tp, t0


def _same_split(jsplit, tsplit):
    for k in spatial.PARTICLE_LEAVES:
        np.testing.assert_array_equal(getattr(tsplit, k).numpy(), np.asarray(getattr(jsplit, k)))


@pytest.mark.parametrize("rebalance", [False, True], ids=["uniform", "edges"])
def test_split_and_merge_match_jax(rebalance):
    """split_state and merge_state equal the JAX package's, leaf by leaf, on
    a state with dead slots between live ones and shuffled uids."""
    w = _jax_world()
    js = jax_build_scene(w, capacity=1024, forces_mode="cellwise")
    j0 = jax_init_state(w, js, seed=0)
    rng = np.random.default_rng(7)
    alive = np.asarray(j0.alive) & (rng.random(1024) > 0.2)
    uid = rng.permutation(1024).astype(np.int32)
    j0 = j0._replace(alive=jax.numpy.asarray(alive), uid=jax.numpy.asarray(uid))
    ts, _, t0 = _carry(js, JaxParams.from_coefficients(w.coefficients), j0, "cellwise")
    jedges = jspatial.initial_band_edges(j0, js, N_SHARDS) if rebalance else None
    tedges = initial_band_edges(t0, ts, N_SHARDS) if rebalance else None
    if rebalance:
        np.testing.assert_array_equal(tedges.numpy(), np.asarray(jedges))
    jsplit = jspatial.split_state(j0, js, N_SHARDS, jedges)
    tsplit = split_state(t0, ts, N_SHARDS, tedges)
    _same_split(jsplit, tsplit)
    jm = jspatial.merge_state(jsplit, js, N_SHARDS)
    tm = merge_state(tsplit, ts, N_SHARDS)
    for k in spatial.PARTICLE_LEAVES:
        np.testing.assert_array_equal(getattr(tm, k).numpy(), np.asarray(getattr(jm, k)))


def test_shard_of_matches_jax():
    """shard_of, uniform and on quantile edges, equals JAX's on positions
    that cover the grid and beyond it."""
    w = _jax_world()
    js = jax_build_scene(w, capacity=1024, forces_mode="cellwise")
    ts, _, _ = _carry(js, JaxParams.from_coefficients(w.coefficients),
                      jax_init_state(w, js, seed=0), "cellwise")
    y = np.random.default_rng(3).uniform(-0.05, 1.05, 4096).astype(np.float32)
    edges = np.array([0, 17, 50, 51, js.grid_ny], np.int32)
    for e in (None, edges):
        ref = jspatial.shard_of(jax.numpy.asarray(y), js, N_SHARDS,
                                None if e is None else jax.numpy.asarray(e))
        got = shard_of(torch.as_tensor(y), ts, N_SHARDS, None if e is None else torch.as_tensor(e))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_edges_from_hist_matches_jax(seed):
    """Quantile edges from random row histograms, with and without the
    previous edges' hysteresis and a height cap that binds: exact."""
    rng = np.random.default_rng(seed)
    ny, n_shards = 104, 4
    hist = (rng.random(ny) < 0.4) * rng.integers(0, 50, ny)
    hist = hist.astype(np.int32)
    prev = np.array([0, 20, 40, 70, ny], np.int32)
    for p in (None, prev):
        for bh_max in (ny, 40):
            ref = jspatial._edges_from_hist(
                jax.numpy.asarray(hist), None if p is None else jax.numpy.asarray(p), ny,
                n_shards, bh_max)
            got = spatial._edges_from_hist(
                torch.as_tensor(hist), None if p is None else torch.as_tensor(p), ny, n_shards,
                bh_max)
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("mode", ["cellwise", "pmajor", "pallas", "pmajor-gate"])
def test_band_step_matches_jax(mode, monkeypatch, group):
    """One band tick from the same split state: the port's against JAX's
    ``make_spatial_step`` on a 4-device CPU mesh.  Noise on for the hashed
    backends (pallas, pmajor), off for cellwise (its jitter comes from
    each package's own generator)."""
    backend = mode.split("-")[0]
    if mode.endswith("gate"):
        monkeypatch.setenv("SAND_CRATE_PMAJOR_GATE", "1")
        jax.clear_caches()
    w = _jax_world(noise=0.0 if backend == "cellwise" else None)
    kw = {"cell_capacity": 8} if backend == "pallas" else {}
    js = jax_build_scene(w, capacity=1024, forces_mode=backend, **kw)
    jp = JaxParams.from_coefficients(w.coefficients)
    assert backend == "cellwise" or float(jp.collider_noise_level) > 0
    j0 = jax_init_state(w, js, seed=0)
    ts, tp, t0 = _carry(js, jp, j0, backend)

    jsplit = jspatial.split_state(j0, js, N_SHARDS)
    tsplit = split_state(t0, ts, N_SHARDS)
    _same_split(jsplit, tsplit)
    mesh = Mesh(np.array(jax.devices()[:N_SHARDS]), ("space",))
    with mesh:
        jnew, jstats = jspatial.make_spatial_step(mesh, js)(jsplit, jp)
    tnew, tstats = make_spatial_step(group, ts)(tsplit, tp)
    if mode.endswith("gate"):
        jax.clear_caches()

    for k in ("alive", "uid"):
        np.testing.assert_array_equal(getattr(tnew, k).numpy(), np.asarray(getattr(jnew, k)))
    for k, v in jstats.items():
        np.testing.assert_array_equal(tstats[k].numpy(), np.asarray(v), err_msg=k)
    alive = tnew.alive.numpy()
    assert alive.sum() > 700
    np.testing.assert_allclose(tnew.pos.numpy()[alive], np.asarray(jnew.pos)[alive],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tnew.pressure.numpy(), np.asarray(jnew.pressure),
                               rtol=PAIR_TOL, atol=PAIR_TOL)
    dt = float(jp.dt)
    v0 = np.asarray(jsplit.vel)[alive]
    np.testing.assert_allclose((tnew.vel.numpy()[alive] - v0) / dt,
                               (np.asarray(jnew.vel)[alive] - v0) / dt,
                               rtol=PAIR_TOL, atol=PAIR_TOL)
