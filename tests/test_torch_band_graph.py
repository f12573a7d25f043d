"""The band step as one captured graph a tick (``spatial.SpatialStep`` over
``graphs.BandGraph``).

On the CPU the step runs its static-buffer body eagerly: every shard's
band tick over the shard views of one split state, the new state written
back into it, fresh copies handed out.  Here that body is held against
the plain loop of ``spatial.spatial_step`` over ``LocalGroup.run`` (shard
states joined by a ``torch.cat``, the same shard generators) bit for bit
over 5 ticks, and against the JAX ``make_spatial_step`` on the conftest's
4-device CPU mesh (its Pallas kernels in interpret mode) at
tests/test_torch_spatial_jax.py's tolerances: positions 1e-4 / 1e-5, the
pressure and the pair kicks 3e-3, alive, uids and every stat exactly, on
pmajor (uniform and rebalanced) and cellwise; the pallas bands meet JAX's
in that file's one tick (five interpret-mode ticks would take ~30 s
more).  The world is that file's: the stirring-cup block of 782 particles on 4
shards.  The cases marked ``cuda`` capture and replay on the card
(skipped without one): a replay equals the eager band loop bit for bit,
with the cup's emitter on so the shard generators draw.  JAX is imported
only inside the test that compares with it, so on a machine without JAX
they run with ``python -m pytest --noconftest -m cuda
tests/test_torch_band_graph.py``.
"""

import contextlib
import copy
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from sand_crate_tpu_torch import collectives, graphs, load_config_dict, spatial
from sand_crate_tpu_torch.collectives import LocalGroup, shard_generator
from sand_crate_tpu_torch.config import InitialParticlesConfig
from sand_crate_tpu_torch.ops import pair_kernel, pmajor
from sand_crate_tpu_torch.scene import build_scene, init_state
from sand_crate_tpu_torch.spatial import (
    initial_band_edges,
    make_spatial_step,
    split_state,
)
from sand_crate_tpu_torch.state import Params
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
# tests/test_torch_spatial_jax.py's block and pair tolerance.
BLOCK = dict(x0=0.30, y0=0.15, x1=0.70, y1=0.75, spacing=0.018, jitter=0.0)
PAIR_TOL = 3e-3
N_SHARDS = 4
TICKS = 5
MODES = {"cellwise": {"cell_capacity": 4}, "pmajor": {}, "pallas": {"cell_capacity": 8}}


@pytest.fixture(scope="module")
def group():
    g = LocalGroup(N_SHARDS, device="cpu")
    yield g
    g.close()


def _world(noise=None, sources=False):
    """The port's twin of the JAX world: the block (noise None keeps the
    config's collider noise), or the cup with its emitter."""
    raw = yaml.safe_load((REPO / "configs/stirring_cup.yaml").read_text())
    w = load_config_dict(copy.deepcopy(raw)).world_config
    w.coefficients = dict(w.coefficients)
    w.coefficients["max_particles"] = 256
    if noise is not None:
        w.coefficients["collider_noise_level"] = noise
    if not sources:
        w.particle_sources = []
        w.initial_particles = [InitialParticlesConfig(**BLOCK)]
    return w


def _setup(mode, device="cpu", sources=False, rebalance=False):
    w = _world(noise=0.0 if mode == "cellwise" else None, sources=sources)
    scene = build_scene(w, capacity=1024, forces_mode=mode, device=device, **MODES[mode])
    s0 = init_state(w, scene, seed=0)
    edges = initial_band_edges(s0, scene, N_SHARDS) if rebalance else None
    return scene, split_state(s0, scene, N_SHARDS, edges), \
        Params.from_coefficients(w.coefficients, device), edges


def _plain_loop(group, scene, split, params, edges, ticks, mig_cap, gens):
    """The eager band loop: spatial_step over group.run on shard slices,
    joined by a cat, drawing from ``gens`` (one a shard); returns (state,
    last stats)."""
    D, P = N_SHARDS, scene.capacity
    bh = spatial.max_band_rows(scene, D) if edges is not None else None
    stats = None
    for _ in range(ticks):
        outs = group.run(
            lambda comm, st: spatial.spatial_step(st, params, scene, comm, mig_cap,
                                                  gens[comm.rank], edges, bh),
            [spatial.shard_slice(split, r, P) for r in range(D)])
        split = outs[0][0]._replace(**{k: torch.cat([getattr(o[0], k) for o in outs])
                                       for k in spatial.PARTICLE_LEAVES})
        stats = outs[0][1]
        if edges is not None:
            edges = stats["band_edges"]
    return split, stats


def _graph_loop(step, split, params, edges, ticks):
    stats = None
    for _ in range(ticks):
        if edges is None:
            split, stats = step(split, params)
        else:
            split, stats = step(split, params, edges)
            edges = stats["band_edges"]
    return split, stats


def _assert_same(got, want):
    for name, a, b in zip(got._fields, got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name


def _same_stats(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("rebalance", [False, True], ids=["uniform", "rebalanced"])
@pytest.mark.parametrize("mode", list(MODES))
def test_static_body_equals_plain_loop(mode, rebalance, group):
    """The step's static-buffer body == the plain spatial_step loop over
    group.run, bit for bit over 5 ticks: state, stats and every shard
    generator (pmajor and pallas with the collider noise on)."""
    scene, split, params, edges = _setup(mode, rebalance=rebalance)
    step = make_spatial_step(group, scene, rebalance=rebalance)
    got, got_stats = _graph_loop(step, split, params, edges, TICKS)
    gens = [shard_generator(0, r, "cpu") for r in range(N_SHARDS)]
    want, want_stats = _plain_loop(group, scene, split, params, edges, TICKS, step.mig_cap,
                                   gens)
    _assert_same(got, want)
    _same_stats(got_stats, want_stats)
    for r, g in step.generators.items():
        assert torch.equal(g.get_state(), gens[r].get_state())
    assert int(got_stats["particle_count"]) > 700


@pytest.mark.parametrize("case", ["pmajor", "pmajor-rebalanced", "cellwise"])
def test_graph_driven_step_matches_jax(case, group):
    """5 ticks of the graph-driven make_spatial_step against JAX's on a
    4-device CPU mesh from the same split state: alive, uids and stats
    exactly, positions at 1e-4 / 1e-5, the pressure and the last tick's
    pair kicks at 3e-3 (pmajor with the collider noise on; cellwise with
    it off, each package drawing its jitter from its own generator)."""
    import jax
    from jax.sharding import Mesh

    import sand_crate_tpu.spatial as jspatial
    from sand_crate_tpu.scene import build_scene as jax_build_scene
    from sand_crate_tpu.scene import init_state as jax_init_state
    from sand_crate_tpu.state import Params as JaxParams
    from test_torch_spatial_jax import _carry, _jax_world, _same_split

    mode = case.split("-")[0]
    rebalance = case.endswith("rebalanced")
    w = _jax_world(noise=0.0 if mode == "cellwise" else None)
    js = jax_build_scene(w, capacity=1024, forces_mode=mode, **MODES[mode])
    jp = JaxParams.from_coefficients(w.coefficients)
    j0 = jax_init_state(w, js, seed=0)
    ts, tp, t0 = _carry(js, jp, j0, mode)
    jedges = jspatial.initial_band_edges(j0, js, N_SHARDS) if rebalance else None
    tedges = initial_band_edges(t0, ts, N_SHARDS) if rebalance else None
    jsplit = jspatial.split_state(j0, js, N_SHARDS, jedges)
    tsplit = split_state(t0, ts, N_SHARDS, tedges)
    _same_split(jsplit, tsplit)

    mesh = Mesh(np.array(jax.devices()[:N_SHARDS]), ("space",))
    jstep = jspatial.make_spatial_step(mesh, js, rebalance=rebalance)
    tstep = make_spatial_step(group, ts, rebalance=rebalance)
    with mesh:
        for t in range(TICKS):
            jprev, tprev = jsplit, tsplit
            if rebalance:
                jsplit, jstats = jstep(jsplit, jp, jedges)
                tsplit, tstats = tstep(tsplit, tp, tedges)
                jedges, tedges = jstats["band_edges"], tstats["band_edges"]
            else:
                jsplit, jstats = jstep(jsplit, jp)
                tsplit, tstats = tstep(tsplit, tp)
            for k, v in jstats.items():
                np.testing.assert_array_equal(tstats[k].numpy(), np.asarray(v),
                                              err_msg=f"tick {t + 1}: {k}")
            for k in ("alive", "uid"):
                np.testing.assert_array_equal(getattr(tsplit, k).numpy(),
                                              np.asarray(getattr(jsplit, k)), err_msg=k)
    alive = tsplit.alive.numpy()
    assert alive.sum() > 700
    np.testing.assert_allclose(tsplit.pos.numpy()[alive], np.asarray(jsplit.pos)[alive],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tsplit.pressure.numpy(), np.asarray(jsplit.pressure),
                               rtol=PAIR_TOL, atol=PAIR_TOL)
    dt = float(jp.dt)
    tkick = (tsplit.vel.numpy() - tprev.vel.numpy())[alive] / dt
    jkick = (np.asarray(jsplit.vel) - np.asarray(jprev.vel))[alive] / dt
    np.testing.assert_allclose(tkick, jkick, rtol=PAIR_TOL, atol=PAIR_TOL)


def test_returns_fresh_copies(group):
    """A state and stats kept from tick t are unchanged by tick t + 1, and
    none of them is the step's static buffer."""
    scene, split, params, edges = _setup("pmajor", rebalance=True)
    step = make_spatial_step(group, scene, rebalance=True)
    first, stats = step(split, params, edges)
    kept = graphs.clone(first)
    kept_stats = {k: v.clone() for k, v in stats.items()}
    second, _ = step(first, params, stats["band_edges"])
    _assert_same(first, kept)
    _same_stats(stats, kept_stats)
    assert not torch.equal(second.pos, first.pos)
    buffers = {t.data_ptr() for t in (*step.graph.state, step.graph.edges)}
    assert not buffers & {t.data_ptr() for t in (*first, *second, *stats.values())}


def test_the_key(group, monkeypatch):
    """A new mig_cap, Scene, schedule, rebalance flag or shard generator
    makes a new key; a new Params value does not enter it."""
    scene, _, _, _ = _setup("pmajor")
    step = make_spatial_step(group, scene)
    key = step.key()
    assert make_spatial_step(group, scene).key()[:5] == key[:5]
    assert make_spatial_step(group, scene, mig_cap=2 * step.mig_cap).key() != key
    assert make_spatial_step(group, scene, rebalance=True).key() != key
    other = build_scene(_world(), capacity=1024, forces_mode="pmajor", device="cpu")
    assert make_spatial_step(group, other).key() != key
    assert make_spatial_step(group, scene, seed=1).key() != key
    monkeypatch.setenv("SAND_CRATE_PMSUB", "1")
    assert step.key() != key
    monkeypatch.delenv("SAND_CRATE_PMSUB")
    assert step.key() == key


def test_local_group_runs_shards_on_the_callers_stream(group, monkeypatch):
    """LocalGroup.run reads the calling thread's current stream once and
    makes it current in every shard's thread around its function."""
    caller = object()
    seen = {}
    current = {}

    def fake_current(device):
        return caller

    @contextlib.contextmanager
    def fake_on(stream):
        current[threading.get_ident()] = stream
        yield
        del current[threading.get_ident()]

    monkeypatch.setattr(collectives, "_current_stream", fake_current)
    monkeypatch.setattr(collectives, "_on_stream", fake_on)

    def fn(comm, x):
        seen[comm.rank] = (current.get(threading.get_ident()), threading.get_ident())
        return comm.psum(torch.tensor(x))

    out = group.run(fn, list(range(N_SHARDS)))
    assert [int(v) for v in out] == [sum(range(N_SHARDS))] * N_SHARDS
    assert all(s is caller for s, _ in seen.values()) and len(seen) == N_SHARDS
    assert threading.get_ident() not in {t for _, t in seen.values()}


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def cuda_group(cuda):
    g = LocalGroup(N_SHARDS, device=cuda)
    yield g
    g.close()


def _reset_counts():
    for counter in (*graphs.COUNTERS, graphs.LAUNCHES):
        for k in counter:
            counter[k] = 0


@pytest.mark.cuda
@pytest.mark.parametrize("rebalance", [False, True], ids=["uniform", "rebalanced"])
@pytest.mark.parametrize("mode", ["pmajor", "pallas", "cellwise"])
def test_band_replay_equals_eager_on_the_card(cuda_group, mode, rebalance):
    """The cup with its emitter on 4 bands: after a call that captures,
    replayed ticks (one graph launch each) == the eager band loop bit for
    bit in state, stats and every shard generator's state; the kernel
    counters rise by one a pass a band a tick."""
    scene, split, params, edges = _setup(mode, device=cuda_group.device, sources=True,
                                         rebalance=rebalance)
    step = make_spatial_step(cuda_group, scene, rebalance=rebalance)
    split, stats = _graph_loop(step, split, params, edges, 1)
    edges = stats.get("band_edges")
    gens0 = [g.get_state() for g in step.generators.values()]
    _reset_counts()
    got, got_stats = _graph_loop(step, split, params, edges, TICKS)
    assert graphs.LAUNCHES == {"replay": TICKS, "capture": 0, "evict": 0}
    want_pm = (dict.fromkeys(("a", "b", "prep"), N_SHARDS * TICKS) if mode == "pmajor"
               else {})
    assert {k: v for k, v in pmajor.LAUNCHES.items() if v} == want_pm
    want_grid = ({"pair_pass_a": N_SHARDS * TICKS, "pair_pass_b_emit": N_SHARDS * TICKS}
                 if mode == "pallas" else {})
    assert {k: v for k, v in pair_kernel.LAUNCHES.items() if v} == want_grid
    replayed = [g.get_state() for g in step.generators.values()]
    for g, s in zip(step.generators.values(), gens0):
        g.set_state(s)
    want, want_stats = _plain_loop(cuda_group, scene, split, params, edges, TICKS,
                                   step.mig_cap, step.generators)
    _assert_same(got, want)
    _same_stats(got_stats, want_stats)
    for g, s in zip(step.generators.values(), replayed):
        assert torch.equal(g.get_state(), s)


@pytest.mark.cuda
def test_shards_enqueue_on_the_callers_stream_on_the_card(cuda_group):
    """Under a side stream, every shard thread's current stream is it."""
    side = torch.cuda.Stream(cuda_group.device)
    with torch.cuda.stream(side):
        streams = cuda_group.run(lambda comm, _: torch.cuda.current_stream(),
                                 [None] * N_SHARDS)
    assert all(s == side for s in streams)
