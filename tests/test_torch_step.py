"""The port's physics step against the JAX package's, on the CPU.

The ghost pass, the body motion and the seven velocity kicks run on the same
random inputs (made with numpy from a seed) in both packages; a small dam
break runs 20 ticks through both ``Crate``s on the p-major backend (noise
on, the JAX kernels in interpret mode) and is compared uid-aligned; an
emitter scene, whose random draws differ between the packages, is checked
by its invariants.
"""

import copy
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sand_crate_tpu import load_config_dict as jax_load_config_dict
from sand_crate_tpu import physics as jphys
from sand_crate_tpu.cellwise import PairSums as JaxPairSums
from sand_crate_tpu.engine import Crate as JaxCrate
from sand_crate_tpu.scene import build_scene as jax_build_scene
from sand_crate_tpu.scene import init_state as jax_init_state
from sand_crate_tpu.state import Params as JaxParams
from sand_crate_tpu_torch import load_config, load_config_dict
from sand_crate_tpu_torch import physics as tphys
from sand_crate_tpu_torch.cellwise import PairSums
from sand_crate_tpu_torch.engine import Crate
from sand_crate_tpu_torch.ops import kick as tkick
from sand_crate_tpu_torch.scene import build_scene, init_state
from sand_crate_tpu_torch.state import Params

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
BOX = [[[0.0, 0.0], [0.0, 1.0]], [[0.0, 0.0], [1.0, 0.0]],
       [[1.0, 0.0], [1.0, 1.0]], [[0.0, 1.0], [1.0, 1.0]]]
# A fixed box, a motored paddle driven by arbitrary safe lambdas (ExprMotor
# channels, including a numpy function of a tensor and a number) and a free
# plank: every body kind of the step.
BODIES = {
    "world": {
        "coefficients": {
            "dt": 0.002, "particle_radius": 0.01, "wall_collision_decay": 0.2,
            "spring_overlap_balance": 0.5, "spring_amplifier": 100,
            "pressure_amplifier": 30, "ignored_pressure": 0.3,
            "collider_noise_level": 0.1, "viscosity": 8, "max_particles": 256,
            "surface_smoothing": 100, "target_pressure": -2, "gravity": [0, 9.8],
        },
        "particle_sources": [],
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
    }
}


def _pair(world_dict):
    """(JAX scene, state, params), (port scene, state, params) of one world."""
    jw = jax_load_config_dict(copy.deepcopy(world_dict)).world_config
    tw = load_config_dict(copy.deepcopy(world_dict)).world_config
    js = jax_build_scene(jw, forces_mode="pmajor")
    ts = build_scene(tw, forces_mode="pmajor", device="cpu")
    return (
        (js, jax_init_state(jw, js), JaxParams.from_coefficients(jw.coefficients)),
        (ts, init_state(tw, ts), Params.from_coefficients(tw.coefficients, "cpu")),
    )


def _close(got, ref, rtol, atol, what=""):
    if isinstance(got, tuple):
        for k, (g, r) in enumerate(zip(got, ref)):
            _close(g, r, rtol, atol, f"{what}[{k}]")
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=rtol, atol=atol, err_msg=what)


def test_bodies_match_jax():
    """advance_bodies (cosine, ExprMotor and free bodies) and the free-body
    gravity, over a few ticks: the same f32 elementwise math, so 1e-6."""
    (js, jst, jp), (ts, tst, tp) = _pair(BODIES)
    assert len(ts.motor_exprs) == 2
    for _ in range(5):
        jst = jst._replace(body_lin_vel=jphys.gravity_on_free_bodies(jst, jp, js))
        tst = tst._replace(body_lin_vel=tphys.gravity_on_free_bodies(tst, tp, ts))
        jst = jphys.advance_bodies(jst, jp, js)
        tst = tphys.advance_bodies(tst, tp, ts)
    for name in ("segments", "body_lin_vel", "body_ang_vel", "time"):
        _close(getattr(tst, name), getattr(jst, name), 1e-6, 1e-6, name)


def test_ghost_pass_matches_jax():
    """_ghost_core and ghost_sums on random pre-fix positions (near and past
    the walls, around the moving bodies).  Same f32 ops; the reductions over
    the segment axis may round in another order: 1e-5."""
    (js, jst, jp), (ts, tst, tp) = _pair(BODIES)
    rng = np.random.default_rng(4)
    P = 512
    prepos = (rng.random((P, 2)) * 1.1 - 0.05).astype(np.float32)
    prepos[:64] = (rng.random((64, 2)) * 0.2 + 0.4).astype(np.float32)  # at the paddle
    alive = rng.random(P) < 0.9
    blv = rng.normal(size=jst.body_lin_vel.shape).astype(np.float32)
    bav = rng.normal(size=jst.body_ang_vel.shape).astype(np.float32)
    seg = np.array(jst.segments)  # a writable copy for torch
    jargs = (jnp.asarray(prepos), jnp.asarray(alive), jnp.asarray(seg),
             jnp.asarray(blv), jnp.asarray(bav))
    targs = (torch.as_tensor(prepos), torch.as_tensor(alive), torch.as_tensor(seg),
             torch.as_tensor(blv), torch.as_tensor(bav))
    ref = jphys._ghost_core(*jargs, jp, js)
    got = tphys._ghost_core(*targs, tp, ts)
    assert float(got.g_cnt.sum()) > 20  # the walls and the paddle are touched
    _close(tuple(got), tuple(ref), 1e-5, 1e-6, "ghost_core")
    _close(tphys.ghost_sums(*targs, tp, ts), jphys.ghost_sums(*jargs, jp, js),
           1e-5, 1e-6, "ghost_sums")


def _random_kick_inputs(seed, P=512):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    arrays = dict(
        pos=(rng.random((P, 2)) * 0.98 + 0.01).astype(np.float32),
        vel=f(P, 2) * 3,
        alive=rng.random(P) < 0.85,
        p_i=np.abs(f(P)),
        dv_tension=f(P, 2) * 50,
        pressure_real=f(P, 2) * 5,
        spring_real=f(P, 2),
        visc_vsum=f(P, 2) * 4,
        nbr_cnt=rng.integers(0, 9, P).astype(np.float32),
        g_cnt=rng.integers(0, 3, P).astype(np.float32),
        gsum=f(P, 2) * 0.01,
        gvel_sum=f(P, 2),
    )
    arrays["pos"][:40, 0] = 0.004  # a few particles at the left wall
    arrays["vel"][:40, 0] = -20.0  # that move through it this tick
    return arrays


@pytest.mark.parametrize(
    "kick",
    ["tension", "gravity", "pressure", "spring", "viscosity", "wall_bounce",
     "continuous_collision"],
)
def test_kicks_match_jax(kick):
    """Each velocity kick on random operands: the same f32 elementwise math,
    but XLA may fuse the normalisations and the mean-|dv| reduction rounds
    in another order, so rtol 1e-5."""
    (js, jst, jp), (ts, tst, tp) = _pair(BODIES)
    a = _random_kick_inputs(7)
    J = {k: jnp.asarray(v) for k, v in a.items()}
    T = {k: torch.as_tensor(v) for k, v in a.items()}
    zero_j, zero_t = jnp.zeros((), jnp.int32), torch.zeros((), dtype=torch.int32)
    jsums = JaxPairSums(*(J[k] for k in JaxPairSums._fields[:-1]), overflow=zero_j)
    tsums = PairSums(*(T[k] for k in PairSums._fields[:-1]), overflow=zero_t)
    jg = jphys.GhostInfo(J["pos"], J["g_cnt"], J["gsum"], J["gvel_sum"])
    tg = tphys.GhostInfo(T["pos"], T["g_cnt"], T["gsum"], T["gvel_sum"])
    calls = {
        "tension": lambda v, al, s, g, p, sc, seg: jphys.apply_tension(v, al, s, p),
        "gravity": lambda v, al, s, g, p, sc, seg: jphys.apply_gravity(v, al, p),
        "pressure": lambda v, al, s, g, p, sc, seg: jphys.apply_pressure_force(v, al, s, g, p),
        "spring": lambda v, al, s, g, p, sc, seg: jphys.apply_spring(v, al, s, g, p),
        "viscosity": lambda v, al, s, g, p, sc, seg: jphys.apply_viscosity(v, al, s, p),
        "wall_bounce": lambda v, al, s, g, p, sc, seg: jphys.apply_wall_bounce(v, al, g, p),
        "continuous_collision": lambda v, al, s, g, p, sc, seg:
            jphys.apply_continuous_collision(g.pos, v, al, seg, p, sc),
    }
    ref = calls[kick](J["vel"], J["alive"], jsums, jg, jp, js, jst.segments)
    # the port: that kick as one stage of the tick's velocity update, its
    # mean |dv| from its norm row
    stage = tkick.KICKS[list(calls).index(kick)] | tkick.NORMS
    out = tkick.velocity_update(stage, T["vel"], T["pos"], T["alive"], tsums, tg, tst.segments,
                                tp, ts.seg_valid)
    cnt = torch.clamp(T["alive"].sum().to(torch.float32), min=1.0)
    got = (out.vel, tkick.force_dv(out.norms, cnt)[0])
    _close(got, tuple(ref), 1e-5, 1e-6, kick)
    assert float(got[1]) > 0  # the kick did something


def _small_dam_break(n_target=900):
    """The dam break rescaled as bench.py rescales it (capacity 1024)."""
    import yaml

    raw = yaml.safe_load((REPO / "configs" / "dam_break.yaml").read_text())
    area = (0.42 - 0.02) * (0.98 - 0.10)
    spacing = float(np.sqrt(area / n_target))
    raw["world"]["initial_particles"][0]["block"]["spacing"] = spacing
    raw["world"]["coefficients"]["particle_radius"] = spacing * 0.55
    raw["world"]["coefficients"]["max_particles"] = int(n_target * 1.05)
    return raw


def test_dam_break_trajectory_matches_jax():
    """20 ticks of a ~900-particle dam break through both Crates (p-major,
    symm + fold, collider noise on): uid-aligned positions and velocities at
    tests/test_pmajor.py:371-374's tolerance, and the same diagnostics."""
    raw = _small_dam_break()
    jc = JaxCrate(jax_load_config_dict(copy.deepcopy(raw)).world_config, forces_mode="pmajor")
    tc = Crate(load_config_dict(copy.deepcopy(raw)).world_config, forces_mode="pmajor",
               device="cpu")
    assert tc.scene.capacity == jc.scene.capacity <= 1024
    assert (tc.scene.pmajor_symm, tc.scene.fold_pairs) == (True, True)
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
    for name in ("particle_count", "neighbor_overflow", "non_finite", "spawn_truncated"):
        assert int(getattr(tdiag, name)) == int(getattr(jdiag, name)), name
    assert int(tdiag.neighbor_overflow) == 0 and int(tdiag.non_finite) == 0
    for name in ("force_dv", "max_speed"):
        np.testing.assert_allclose(
            getattr(tdiag, name).numpy(), np.asarray(getattr(jdiag, name)),
            rtol=2e-3, atol=2e-4, err_msg=name,
        )


def test_emitter_scene_invariants():
    """stirring_cup emits through the generator: spawn never exceeds the
    particle budget, truncation is counted (>= 0), identities stay unique,
    and every alive particle stays finite."""
    world = load_config(REPO / "configs" / "stirring_cup.yaml").world_config
    crate = Crate(world, seed=5, device="cpu")
    budget = int(world.coefficients["max_particles"])
    counts = []
    for _ in range(4):
        diag = crate.run(15)
        counts.append(crate.particle_count)
        assert counts[-1] <= budget
        assert int(diag.spawn_truncated) >= 0
        assert int(diag.non_finite) == 0 and int(diag.neighbor_overflow) == 0
    assert counts[-1] > counts[0] > 0  # the emitter runs
    st = crate.state
    uids = st.uid[st.alive]
    assert uids.unique().numel() == uids.numel()
    assert bool(torch.isfinite(st.pos[st.alive]).all())
    # The same seed replays the same emission.
    again = Crate(world, seed=5, device="cpu")
    for _ in range(4):
        again.run(15)
    assert torch.equal(again.state.pos, crate.state.pos)


def test_crate_surface(tmp_path):
    """Coefficient get/set on device tensors, the views, a radius edit past
    the cell size rebuilding the grid, and a checkpoint round trip (the
    edited coefficients and the state come back)."""
    world = load_config(REPO / "configs" / "hourglass.yaml").world_config
    crate = Crate(world, forces_mode="pmajor", device="cpu")
    n = crate.particle_count
    assert crate.particles.shape == (n, 2) == crate.particle_velocities.shape
    assert crate.particles_pressure.shape == (n,)
    assert crate.segments.shape[1:] == (2, 2)
    crate.viscosity = 4.5
    assert crate.viscosity == 4.5 and crate.params.viscosity.dtype == torch.float32
    crate.gravity = [0.0, 5.0]
    assert crate.gravity.tolist() == [0.0, 5.0]
    scene = crate.scene
    crate.particle_radius = scene.cell_size / 2  # fits the grid: no rebuild
    assert crate.scene is scene
    crate.particle_radius = scene.cell_size  # past it: the grid is rebuilt
    assert crate.scene.cell_size == 2 * scene.cell_size
    assert crate.diameter == pytest.approx(crate.scene.cell_size)  # f32 radius
    with pytest.raises(AttributeError):
        crate.not_a_coefficient = 1
    crate.physics_tick()
    assert crate.tick == 1 and "Tick: 1" in crate.debug_prints
    assert crate.current_coefficients()["viscosity"] == 4.5
    path = crate.save_checkpoint(tmp_path / "ckpt.npz")
    saved = crate.state
    crate.physics_tick()
    crate.viscosity = 1.0
    crate.restore_checkpoint(path)
    assert crate.tick == 1 and crate.viscosity == 4.5
    for name, a, b in zip(saved._fields, saved, crate.state):
        assert torch.equal(a, b), name


def test_crate_defaults_to_the_card():
    """An entry point runs on the card unless the caller asks for the CPU:
    with no device argument, Crate builds its state on CUDA, and without a
    card it raises instead of falling back."""
    world = load_config(REPO / "configs" / "stirring_cup.yaml").world_config
    if torch.cuda.is_available():
        assert Crate(world).state.pos.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Crate(world)
    assert Crate(world, device="cpu").state.pos.device.type == "cpu"
