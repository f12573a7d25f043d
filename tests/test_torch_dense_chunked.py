"""The port's dense and chunked pair backends against the JAX package's.

The same inputs, made with numpy from a seed, go through
``cellwise.neighbor_forces_dense`` and ``ops.chunked.neighbor_forces_chunked``
of both packages (plain XLA code in the JAX package, no Pallas kernel):
float fields at 1e-5, neighbor counts and the overflow exact.  The chunked
sweep bound (``live_rows``) is checked against the full sweep, including a
bound past the slab, which the JAX loop mishandles (ops/chunked.py:250), so
that case is held against the port's own full sweep.  Then whole ticks:
20 ticks of a world with every body kind through both ``Crate``s on each
backend, uid-aligned at tests/test_pmajor.py:371-374's tolerance; and
``auto`` picks the JAX package's accelerator backends by capacity.
"""

import copy
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from sand_crate_tpu import load_config_dict as jax_load_config_dict
from sand_crate_tpu.cellwise import neighbor_forces_dense as jax_dense
from sand_crate_tpu.engine import Crate as JaxCrate
from sand_crate_tpu.ops.chunked import neighbor_forces_chunked as jax_chunked
from sand_crate_tpu.scene import build_scene as jax_build_scene
from sand_crate_tpu.state import Params as JaxParams
from sand_crate_tpu_torch import load_config, load_config_dict
from sand_crate_tpu_torch.cellwise import neighbor_forces_dense
from sand_crate_tpu_torch.engine import Crate
from sand_crate_tpu_torch.ops.chunked import live_chunks, neighbor_forces_chunked
from sand_crate_tpu_torch.scene import auto_forces_mode, build_scene
from sand_crate_tpu_torch.state import Params

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
STIRRING_CUP = REPO / "configs" / "stirring_cup.yaml"
FLOAT_FIELDS = ("p_i", "dv_tension", "pressure_real", "spring_real", "visc_vsum")
BOX = [[[0.0, 0.0], [0.0, 1.0]], [[0.0, 0.0], [1.0, 0.0]],
       [[1.0, 0.0], [1.0, 1.0]], [[0.0, 1.0], [1.0, 1.0]]]
# A block of ~780 particles in a fixed box with a motored paddle (an
# expression motor) and a free plank: every body kind, no emitter.
BODIES = {"world": {
    "coefficients": {
        "dt": 0.002, "particle_radius": 0.01, "wall_collision_decay": 0.2,
        "spring_overlap_balance": 0.5, "spring_amplifier": 100,
        "pressure_amplifier": 30, "ignored_pressure": 0.3,
        "collider_noise_level": 0.1, "viscosity": 8, "max_particles": 800,
        "surface_smoothing": 100, "target_pressure": -2, "gravity": [0, 9.8],
    },
    "particle_sources": [],
    "initial_particles": [{"block": {"x0": 0.1, "y0": 0.1, "x1": 0.6, "y1": 0.5,
                                     "spacing": 0.016, "velocity": [0.5, 0.0],
                                     "jitter": 0.3}}],
    "rigid_bodies": [
        {"fixed": {"name": "box", "segments": BOX}},
        {"motored": {
            "name": "paddle", "segments": [[[-0.1, 0.0], [0.1, 0.0]]],
            "position": [0.5, 0.5], "rotation": 30,
            "velocity_func": "lambda t: np.array([np.sin(3 * t) * 0.2, 0.1])",
            "angular_velocity_func": "lambda t: np.maximum(np.cos(40 * t), 0.5) * 2",
        }},
        {"free": {"name": "plank", "segments": [[[-0.05, 0.0], [0.05, 0.0]]],
                  "position": [0.3, 0.3], "velocity": [0.1, -0.2]}},
    ],
}}


def _scenes(capacity, forces_mode, **kw):
    """(JAX scene, JAX params), (port scene, port params) of stirring_cup."""
    jworld = jax_load_config_dict(_stirring_cup_dict()).world_config
    tworld = load_config(STIRRING_CUP).world_config
    js = jax_build_scene(jworld, capacity=capacity, forces_mode=forces_mode, **kw)
    ts = build_scene(tworld, capacity=capacity, forces_mode=forces_mode, device="cpu", **kw)
    return ((js, JaxParams.from_coefficients(jworld.coefficients)),
            (ts, Params.from_coefficients(tworld.coefficients, "cpu")))


def _stirring_cup_dict():
    return yaml.safe_load(STIRRING_CUP.read_text())


def _coefs(params):
    names = ("diameter", "surface_smoothing", "target_pressure", "ignored_pressure",
             "spring_overlap_balance")
    return [getattr(params, n) for n in names]


def _random(seed, P, lo=0.3, span=0.1, p_alive=1.0, dead_tail=0):
    rng = np.random.default_rng(seed)
    pos = (rng.random((P, 2)) * span + lo).astype(np.float32)
    vel = (rng.random((P, 2)) - 0.5).astype(np.float32)
    alive = rng.random(P) < p_alive
    if dead_tail:
        alive[-dead_tail:] = False
    return pos, vel, alive


def _row(seed, P, diam):
    """One long dense row: every particle within one grid row, so a sorted
    window of 128 misses partners (the halo loss)."""
    rng = np.random.default_rng(seed)
    x = rng.random(P).astype(np.float32) * 0.9 + 0.05
    y = (rng.random(P).astype(np.float32) * 0.5 + 0.5) * diam
    return np.stack([x, y], -1), (rng.random((P, 2)) - 0.5).astype(np.float32), np.ones(P, bool)


def _assert_sums(got, ref, fields=FLOAT_FIELDS, tol=1e-5):
    """Float fields within ``tol`` relative, plus ``tol`` of the field's
    largest magnitude: a pair sum cancels terms up to that size, and the two
    packages may round its f32 terms (XLA's and torch's rsqrt) and their
    sum in another order."""
    for name in fields:
        want = np.asarray(getattr(ref, name))
        np.testing.assert_allclose(getattr(got, name).numpy(), want, rtol=tol,
                                   atol=tol * max(float(np.abs(want).max()), 1.0),
                                   err_msg=name)
    np.testing.assert_array_equal(got.nbr_cnt.numpy(), np.asarray(ref.nbr_cnt))
    assert int(got.overflow) == int(ref.overflow)


@pytest.mark.parametrize("spring", [False, True])
def test_dense_matches_jax(spring):
    """P = 256 with a dead tail and the same collider noise array in both
    packages: the masked all-pairs sums agree (spring_real is computed by
    the port only with the spring on, which is when the step reads it)."""
    (js, jp), (ts, tp) = _scenes(256, "dense", enable_spring=spring)
    diam = float(np.asarray(jp.diameter))
    pos, vel, alive = _random(1, 256, dead_tail=40)
    noise = ((np.random.default_rng(2).random((256, 2)) - 0.5) * diam * 0.1).astype(np.float32)
    ref = jax_dense(jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(alive), jnp.asarray(noise),
                    *_coefs(jp), js)
    got = neighbor_forces_dense(torch.as_tensor(pos), torch.as_tensor(vel),
                                torch.as_tensor(alive), torch.as_tensor(noise),
                                *_coefs(tp), ts)
    assert float(got.nbr_cnt.max()) >= 4 and float(got.nbr_cnt[-40:].max()) == 0
    fields = FLOAT_FIELDS if spring else tuple(f for f in FLOAT_FIELDS if f != "spring_real")
    _assert_sums(got, ref, fields)
    assert int(got.overflow) == 0
    if not spring:
        assert not bool(got.spring_real.any())


def _chunked_both(setup, pos, vel, alive, amp, tick=4, live_rows=None):
    (js, jp), (ts, tp) = setup
    ref = jax_chunked(jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(alive),
                      jnp.asarray(amp, jnp.float32), jnp.asarray(tick, jnp.int32),
                      *_coefs(jp), js,
                      live_rows=None if live_rows is None else jnp.int32(live_rows))
    got = _chunked(ts, tp, pos, vel, alive, amp, tick, live_rows)
    return ref, got


def _chunked(ts, tp, pos, vel, alive, amp, tick=4, live_rows=None):
    return neighbor_forces_chunked(
        torch.as_tensor(pos), torch.as_tensor(vel), torch.as_tensor(alive),
        torch.tensor(amp, dtype=torch.float32), torch.tensor(tick, dtype=torch.int32),
        *_coefs(tp), ts, live_rows=live_rows)


@pytest.mark.parametrize("cs", [128, 256])
@pytest.mark.parametrize("halo", [None, 128])
def test_chunked_matches_jax(cs, halo):
    """Capacity 512, chunks of 128 and 256, the default halo and a halo of
    128, collider noise on (the hash is shared): a random cloud (no loss)
    and one dense row (a halo of 128 loses pairs, counted alike; so does
    the default halo of 256 at chunks of 128, a row of 512 being wider than
    its window)."""
    setup = _scenes(512, "chunked", chunk_cs=cs, chunk_halo=halo)
    ts = setup[1][0]
    assert ts.chunk_cs == cs and ts.chunk_halo == (halo or 256) == setup[0][0].chunk_halo
    diam = float(np.asarray(setup[0][1].diameter))
    lost = []
    for pos, vel, alive in (_random(3, 512, p_alive=0.9), _row(5, 512, diam)):
        ref, got = _chunked_both(setup, pos, vel, alive, 0.1 * diam)
        _assert_sums(got, ref)
        assert float(got.nbr_cnt.max()) >= 4
        lost.append(int(got.overflow))
    assert lost[0] == 0 and (lost[1] > 0 if halo == 128 else True)


def test_chunked_live_rows_bound():
    """A bound at or above the alive count gives the full sweep's sums and
    skips chunks (cs 128: 300 alive sweep 3 of 4); a bound too small counts
    every unswept alive row into the overflow, as the JAX package does; a
    bound past the slab sweeps it whole (the port clamps the chunk count,
    where the JAX loop runs on), so it is held against the port's own
    unbounded sweep."""
    setup = _scenes(512, "chunked", chunk_cs=128)
    (js, jp), (ts, tp) = setup
    diam = float(np.asarray(jp.diameter))
    pos, vel, _ = _random(13, 512)
    alive = np.arange(512) < 300
    full = _chunked(ts, tp, pos, vel, alive, 0.1 * diam)
    assert int(full.overflow) == 0
    for bound in (300, 384):
        assert live_chunks(bound, 512, 128) == 3
        ref, got = _chunked_both(setup, pos, vel, alive, 0.1 * diam, live_rows=bound)
        _assert_sums(got, ref)
        for name in FLOAT_FIELDS + ("nbr_cnt",):
            assert torch.equal(getattr(got, name), getattr(full, name)), name
    ref, got = _chunked_both(setup, pos, vel, alive, 0.1 * diam, live_rows=128)
    _assert_sums(got, ref)
    assert int(got.overflow) == 300 - 128
    assert live_chunks(5000, 512, 128) == 4 and live_chunks(-3, 512, 128) == 0
    past = _chunked(ts, tp, pos, vel, alive, 0.1 * diam, live_rows=5000)
    for name in FLOAT_FIELDS + ("nbr_cnt", "overflow"):
        assert torch.equal(getattr(past, name), getattr(full, name)), name


def test_chunked_equals_dense_when_the_halo_covers_everything():
    """With no noise and a halo as wide as the slab, the chunked backend
    sees every pair the dense one does: the same counts, and the sums
    within f32 rounding of a reordered sum."""
    (_, _), (ts, tp) = _scenes(512, "chunked", chunk_halo=512)
    pos, vel, alive = _random(7, 512, p_alive=0.9)
    got = _chunked(ts, tp, pos, vel, alive, 0.0)
    ref = neighbor_forces_dense(torch.as_tensor(pos), torch.as_tensor(vel),
                                torch.as_tensor(alive), torch.zeros(512, 2),
                                *_coefs(tp), ts)
    assert torch.equal(got.nbr_cnt, ref.nbr_cnt) and int(got.overflow) == 0
    for name in ("p_i", "dv_tension", "pressure_real", "visc_vsum"):
        torch.testing.assert_close(getattr(got, name), getattr(ref, name), rtol=1e-4, atol=1e-4)


def _crates(mode, noise):
    raw = copy.deepcopy(BODIES)
    raw["world"]["coefficients"]["collider_noise_level"] = noise
    jc = JaxCrate(jax_load_config_dict(copy.deepcopy(raw)).world_config, forces_mode=mode)
    tc = Crate(load_config_dict(copy.deepcopy(raw)).world_config, forces_mode=mode,
               device="cpu")
    return jc, tc


@pytest.mark.parametrize("mode,noise", [("chunked", 0.1), ("dense", 0.0)])
def test_step_matches_jax(mode, noise):
    """20 ticks of the bodies world through both Crates: uid-aligned
    positions and velocities at tests/test_pmajor.py:371-374's tolerance,
    and the same alive set and overflow.  Chunked runs with collider noise
    (the same hash in both); dense without, as its noise is a random draw
    of each package's own generator."""
    from sand_crate_tpu import physics as jphys

    jc, tc = _crates(mode, noise)
    assert tc.scene.capacity == jc.scene.capacity == 896 and tc.particle_count > 700
    jstate, jdiag = jphys.rollout(jc.state, jc.params, jc.scene, 20)
    tdiag = tc.run(20)
    tstate = tc.state
    ia = np.argsort(np.asarray(jstate.uid))
    ib = np.argsort(tstate.uid.numpy())
    alive = np.asarray(jstate.alive)[ia]
    np.testing.assert_array_equal(tstate.alive.numpy()[ib], alive)
    for name in ("pos", "vel"):
        np.testing.assert_allclose(
            getattr(tstate, name).numpy()[ib][alive],
            np.asarray(getattr(jstate, name))[ia][alive],
            rtol=2e-3, atol=2e-4, err_msg=name,
        )
    for name in ("particle_count", "neighbor_overflow", "non_finite"):
        assert int(getattr(tdiag, name)) == int(getattr(jdiag, name)), name
    assert int(tdiag.neighbor_overflow) == 0 and int(tdiag.non_finite) == 0
    if mode == "dense":  # the dense backend keeps slot order: no sort
        assert torch.equal(tstate.uid, torch.arange(tc.scene.capacity, dtype=torch.int32))


def test_dense_step_with_noise_keeps_invariants():
    """Dense with collider noise on, drawn from the crate's generator: the
    alive set and identities stay, every value stays finite, the noise
    moves the result, and the same seed replays it."""
    raw = copy.deepcopy(BODIES)
    world = load_config_dict(copy.deepcopy(raw)).world_config
    a = Crate(world, forces_mode="dense", device="cpu", seed=4)
    n0 = a.particle_count
    diag = a.run(20)
    assert int(diag.particle_count) == a.particle_count == n0
    assert int(diag.non_finite) == 0 and int(diag.neighbor_overflow) == 0
    st = a.state
    assert torch.equal(st.uid, torch.arange(a.scene.capacity, dtype=torch.int32))
    assert bool(torch.isfinite(st.pos).all() and torch.isfinite(st.vel).all())
    again = Crate(world, forces_mode="dense", device="cpu", seed=4)
    again.run(20)
    assert torch.equal(again.state.pos, st.pos)
    other = Crate(world, forces_mode="dense", device="cpu", seed=5)
    other.run(20)
    assert not torch.equal(other.state.pos, st.pos)


@pytest.mark.parametrize("capacity,mode", [(640, "dense"), (2048, "dense"), (2176, "dense"),
                                           (4096, "dense"), (4224, "pmajor")])
def test_auto_picks_by_capacity(capacity, mode):
    """``auto`` takes the JAX package's accelerator thresholds
    (sand_crate_tpu/scene.py:85-100) on every device, but for 2049-4096,
    where the H100 ran dense ahead of chunked (PERF.md): dense up
    to 4096, p-major above."""
    assert auto_forces_mode(capacity) == mode
    world = load_config(STIRRING_CUP).world_config
    assert build_scene(world, capacity=capacity, device="cpu").forces_mode == mode


@pytest.mark.parametrize("name,mode", [("stirring_cup", "dense"), ("fountain", "dense"),
                                       ("hourglass", "dense"), ("wave_machine", "dense"),
                                       ("dam_break", "pmajor")])
def test_shipped_configs_backend(name, mode):
    """Each shipped config runs the backend the JAX package picks on its
    accelerator, but wave_machine (capacity 4096: chunked there), which
    runs dense, the faster on the H100; the scene's chunked halo is the JAX
    default."""
    world = load_config(REPO / "configs" / f"{name}.yaml").world_config
    scene = build_scene(world, device="cpu")
    assert scene.forces_mode == mode
    jworld = jax_load_config_dict(
        yaml.safe_load((REPO / "configs" / f"{name}.yaml").read_text())).world_config
    js = jax_build_scene(jworld, forces_mode=mode)
    assert (scene.capacity, scene.chunk_halo, scene.chunk_cs) == (
        js.capacity, js.chunk_halo, js.chunk_cs)
