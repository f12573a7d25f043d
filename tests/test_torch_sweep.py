"""The port's batched crates (``sand_crate_tpu_torch/sweep.py``) on the CPU.

Stacked params carry over from the JAX package leaf by leaf; a vmapped
``BatchedCrates`` equals both the port's solo step per crate and the JAX
``BatchedCrates`` on the same stacked params (dense and chunked); the
chunked sweep bound skips chunks at cs = 128 without changing a sum; an
overflow in the middle of a ``run`` is reported (the JAX rollout keeps only
the last tick's, sweep.py:152); every crate's emitters draw their own
numbers within the budget; ``run_datagen`` writes shards and labels that
read back with a leading crate axis.
"""

import copy
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from sand_crate_tpu import load_config_dict as jax_load_config_dict
from sand_crate_tpu import sweep as jsweep
from sand_crate_tpu.ops.chunked import neighbor_forces_chunked as jax_chunked
from sand_crate_tpu.scene import build_scene as jax_build_scene
from sand_crate_tpu.state import Params as JaxParams
from sand_crate_tpu_torch import load_config_dict, sweep
from sand_crate_tpu_torch.ops.chunked import live_chunks, neighbor_forces_chunked
from sand_crate_tpu_torch.physics import step
from sand_crate_tpu_torch.recording import load_trajectory, trajectory_info
from sand_crate_tpu_torch.scene import build_scene, init_state
from sand_crate_tpu_torch.state import Params, params_from_numpy, to_numpy

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
STIRRING_CUP = REPO / "configs" / "stirring_cup.yaml"
BOX = [[[0.0, 0.0], [0.0, 1.0]], [[0.0, 0.0], [1.0, 0.0]],
       [[1.0, 0.0], [1.0, 1.0]], [[0.0, 1.0], [1.0, 1.0]]]


def _block_world(max_particles=400, noise=0.1, spacing=0.02, rigid=True):
    """A block of particles in a box with a motored paddle: no emitter."""
    return {"world": {
        "coefficients": {
            "dt": 0.002, "particle_radius": 0.01, "wall_collision_decay": 0.2,
            "spring_overlap_balance": 0.5, "spring_amplifier": 100,
            "pressure_amplifier": 30, "ignored_pressure": 0.3,
            "collider_noise_level": noise, "viscosity": 8, "max_particles": max_particles,
            "surface_smoothing": 100, "target_pressure": -2, "gravity": [0, 9.8],
        },
        "particle_sources": [],
        "initial_particles": [{"block": {"x0": 0.1, "y0": 0.3, "x1": 0.5, "y1": 0.7,
                                         "spacing": spacing, "velocity": [0.3, 0.0],
                                         "jitter": 0.3}}],
        "rigid_bodies": [
            {"fixed": {"name": "box", "segments": BOX}},
            {"motored": {"name": "paddle", "segments": [[[-0.1, 0.0], [0.1, 0.0]]],
                         "position": [0.5, 0.5], "rotation": 30,
                         "angular_velocity": {"amplitude": 2.0, "frequency": 5.0}}},
        ] if rigid else [],
    }}


def _configs(raw):
    return (jax_load_config_dict(copy.deepcopy(raw)),
            load_config_dict(copy.deepcopy(raw)))


def _stirring_cup(max_particles=None):
    raw = yaml.safe_load(STIRRING_CUP.read_text())
    if max_particles:
        raw["world"]["coefficients"]["max_particles"] = max_particles
    return load_config_dict(raw)


OPTIONS = {"viscosity": [4.0, 8.0], "target_pressure": [-5.0, -2.0, 2.0]}


def test_grid_params_order_equals_jax():
    """The cartesian product in itertools.product order, every leaf equal to
    the JAX grid's, and stacked Params carry over leaf by leaf."""
    jcfg, tcfg = _configs(_block_world())
    jbase = JaxParams.from_coefficients(jcfg.world_config.coefficients)
    tbase = Params.from_coefficients(tcfg.world_config.coefficients, "cpu")
    want = jsweep.grid_params(jbase, OPTIONS)
    got = sweep.grid_params(tbase, OPTIONS)
    assert got.viscosity.tolist() == [4, 4, 4, 8, 8, 8]
    assert got.target_pressure.tolist() == [-5, -2, 2, -5, -2, 2]
    carried = params_from_numpy({k: np.asarray(v) for k, v in want._asdict().items()}, "cpu")
    for name, a, b in zip(Params._fields, to_numpy(got).values(), to_numpy(carried).values()):
        np.testing.assert_array_equal(a, np.asarray(getattr(want, name)), err_msg=name)
        np.testing.assert_array_equal(a, b, err_msg=name)
        assert a.dtype == b.dtype, name
    assert got.gravity.shape == (6, 2) and got.max_particles.dtype == torch.int32


def test_random_params_within_ranges_and_seeded():
    base = Params.from_coefficients(_stirring_cup().world_config.coefficients, "cpu")
    ranges = {"viscosity": (2.0, 10.0), "target_pressure": (-6.0, 3.0)}

    def draw(seed):
        g = torch.Generator()
        g.manual_seed(seed)
        return sweep.random_params(g, base, ranges, n=16)

    a, b, c = draw(0), draw(0), draw(1)
    for name, (lo, hi) in ranges.items():
        v = getattr(a, name)
        assert v.shape == (16,) and bool(((v >= lo) & (v <= hi)).all())
        assert len(torch.unique(v)) == 16
        assert torch.equal(v, getattr(b, name)) and not torch.equal(v, getattr(c, name))
    assert torch.equal(a.dt, base.dt.expand(16)) and a.gravity.shape == (16, 2)


@pytest.mark.parametrize("mode", ["dense", "chunked"])
def test_vmapped_crate_equals_solo_crate(mode):
    """Crate i of a vmapped BatchedCrates (no emitters, coefficients that
    differ per crate) equals the port's solo step with params i.  Dense runs
    without collider noise (a draw per crate), chunked with it (hashed)."""
    _, cfg = _configs(_block_world(noise=0.0 if mode == "dense" else 0.1))
    base = Params.from_coefficients(cfg.world_config.coefficients, "cpu")
    batched = sweep.grid_params(base, {"viscosity": [2.0, 12.0], "pressure_amplifier": [20.0]})
    crates = sweep.BatchedCrates(cfg, batched, forces_mode=mode, device="cpu", seed=3)
    assert crates.scene.forces_mode == mode and crates.n == 2
    crates.run(6)
    crates.run(4)
    for i in range(2):
        pr = Params(*(x[i] for x in batched))
        st = init_state(cfg.world_config, crates.scene, seed=3 + i)
        gen = torch.Generator()
        for _ in range(10):
            st, diag = step(st, pr, crates.scene, gen)
        for name in ("pos", "vel", "alive", "uid", "pressure", "segments"):
            torch.testing.assert_close(getattr(crates.state, name)[i], getattr(st, name),
                                       rtol=1e-6, atol=1e-6, msg=name)
    assert not torch.equal(crates.state.pos[0], crates.state.pos[1])


@pytest.mark.parametrize("mode,capacity", [("dense", 512), ("chunked", 1152)])
def test_batched_crates_match_jax(mode, capacity):
    """The JAX BatchedCrates and the port's on the same stacked params,
    carried across: the default backend by capacity (dense up to 1024,
    chunked above), 12 ticks in two runs (the chunked bound computed
    between them), uid-aligned at tests/test_pmajor.py:371-374's
    tolerance.  Dense runs without collider noise (each package draws its
    own), chunked with it."""
    jcfg, tcfg = _configs(_block_world(capacity - 100, noise=0.0 if mode == "dense" else 0.1))
    jbase = JaxParams.from_coefficients(jcfg.world_config.coefficients)
    jb = jsweep.grid_params(jbase, {"viscosity": [3.0, 10.0]})
    tb = params_from_numpy({k: np.asarray(v) for k, v in jb._asdict().items()}, "cpu")
    ja = jsweep.BatchedCrates(jcfg, jb, capacity=capacity)
    ta = sweep.BatchedCrates(tcfg, tb, capacity=capacity, device="cpu")
    assert ja.scene.forces_mode == ta.scene.forces_mode == mode
    for ticks in (6, 6):
        if mode == "chunked":
            assert ta.live_rows(ticks) == int(ta.particle_counts().max())  # no emitter
        jd, td = ja.run(ticks), ta.run(ticks)
    np.testing.assert_array_equal(ta.particle_counts(), ja.particle_counts())
    for name in ("neighbor_overflow", "non_finite", "particle_count"):
        np.testing.assert_array_equal(getattr(td, name).numpy(), np.asarray(getattr(jd, name)))
    for i in range(2):
        ia = np.argsort(np.asarray(ja.state.uid[i]))
        ib = np.argsort(ta.state.uid[i].numpy())
        alive = np.asarray(ja.state.alive[i])[ia]
        np.testing.assert_array_equal(ta.state.alive[i].numpy()[ib], alive)
        for name in ("pos", "vel"):
            np.testing.assert_allclose(getattr(ta.state, name)[i].numpy()[ib][alive],
                                       np.asarray(getattr(ja.state, name)[i])[ia][alive],
                                       rtol=2e-3, atol=2e-4, err_msg=f"{name} crate {i}")


def test_vmapped_live_rows_bound_skips_chunks():
    """The torch twin of tests/test_chunked.py's live-rows test at cs = 128,
    where chunks really are skipped: crates at very different fills under
    vmap with one batch-uniform bound (3 of 4 chunks swept) equal the full
    sweep of each crate alone, with the same overflow; and the JAX sums."""
    world = _stirring_cup().world_config
    scene = build_scene(world, capacity=512, chunk_cs=128, forces_mode="chunked", device="cpu")
    params = Params.from_coefficients(world.coefficients, "cpu")
    rng = np.random.default_rng(11)
    B, P = 3, 512
    pos = torch.as_tensor((rng.random((B, P, 2)) * 0.3 + 0.1).astype(np.float32))
    vel = torch.as_tensor((rng.random((B, P, 2)) - 0.5).astype(np.float32))
    counts = (60, 250, 300)
    alive = torch.as_tensor(np.stack([np.arange(P) < c for c in counts]))
    bound = max(counts)
    assert live_chunks(bound, P, 128) == 3
    amp = torch.tensor(0.1 * float(params.diameter))
    tick = torch.tensor(7, dtype=torch.int32)
    coefs = (params.diameter, params.surface_smoothing, params.target_pressure,
             params.ignored_pressure, params.spring_overlap_balance)

    def run(p, v, a, live_rows):
        return neighbor_forces_chunked(p, v, a, amp, tick, *coefs, scene, live_rows=live_rows)

    batched = torch.func.vmap(lambda p, v, a: run(p, v, a, bound))(pos, vel, alive)
    jscene = jax_build_scene(
        jax_load_config_dict(yaml.safe_load(STIRRING_CUP.read_text())).world_config,
        capacity=512, chunk_cs=128, forces_mode="chunked")
    for i in range(B):
        solo = run(pos[i], vel[i], alive[i], None)
        for name in ("p_i", "dv_tension", "pressure_real", "visc_vsum", "nbr_cnt"):
            torch.testing.assert_close(getattr(batched, name)[i], getattr(solo, name),
                                       rtol=1e-6, atol=1e-7, msg=f"{name} crate {i}")
        assert int(batched.overflow[i]) == int(solo.overflow) == 0
        ref = jax_chunked(jnp.asarray(pos[i].numpy()), jnp.asarray(vel[i].numpy()),
                          jnp.asarray(alive[i].numpy()), jnp.float32(float(amp)), jnp.int32(7),
                          *(jnp.float32(float(c)) for c in coefs), jscene)
        scale = float(np.abs(np.asarray(ref.dv_tension)).max())
        np.testing.assert_allclose(batched.dv_tension[i].numpy(), np.asarray(ref.dv_tension),
                                   rtol=1e-5, atol=1e-5 * scale)


def test_overflow_in_the_middle_of_a_run_is_reported():
    """A row of 500 particles in one grid row with a halo of 128 overflows
    on the first tick, then falls out of the open crate and is culled, so
    the last tick counts nothing: the run reports the largest overflow of
    its ticks (the JAX rollout keeps only the last tick's)."""
    raw = _block_world(max_particles=500, rigid=False)
    raw["world"]["initial_particles"] = [{"block": {
        "x0": 0.05, "y0": 0.004, "x1": 0.95, "y1": 0.0045, "spacing": 0.0018,
        "velocity": [0.0, -10.0], "jitter": 0.0}}]
    _, cfg = _configs(raw)
    base = Params.from_coefficients(cfg.world_config.coefficients, "cpu")
    batched = sweep.stack_params([base, base])
    crates = sweep.BatchedCrates(cfg, batched, forces_mode="chunked", chunk_cs=128,
                                 chunk_halo=128, device="cpu")
    assert int(crates.particle_counts().min()) == 500
    diag = crates.run(3)
    assert diag.particle_count.tolist() == [0, 0]  # all culled: the last tick loses nothing
    assert bool((diag.neighbor_overflow > 0).all())


def test_emitters_draw_per_crate_within_budget():
    """stirring_cup crates with equal coefficients under vmap: each crate's
    emitter draws its own counts and positions (no warning of a resized
    output), no crate exceeds its particle budget, and a crate's generator
    seed replays the batch."""
    cfg = _stirring_cup(max_particles=48)
    base = Params.from_coefficients(cfg.world_config.coefficients, "cpu")
    batched = sweep.stack_params([base] * 3)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        crates = sweep.BatchedCrates(cfg, batched, device="cpu", seed=2)
        diag = crates.run(15)
    counts = crates.particle_counts()
    assert crates.scene.forces_mode == "dense"
    assert (counts > 0).all() and (counts <= 48).all()
    assert int(diag.non_finite.max()) == 0
    pos = crates.positions()
    assert not np.array_equal(pos[0], pos[1]) and not np.array_equal(pos[1], pos[2])
    again = sweep.BatchedCrates(cfg, batched, device="cpu", seed=2)
    again.run(15)
    np.testing.assert_array_equal(again.positions(), pos)


def test_run_datagen_writes_shards_and_params(tmp_path):
    cfg = _stirring_cup(max_particles=128)
    out = sweep.run_datagen(cfg, n_crates=3, ticks=20, sample_every=10,
                            out_dir=tmp_path / "dg", seed=1, device="cpu")
    assert out["frames"] == 2 and out["crates"] == 3
    assert out["overflow"] == 0 and out["non_finite"] == 0
    info = trajectory_info(tmp_path / "dg")
    assert info["frames"] == 2 and info["meta"] == {"crates": 3, "sample_every": 10}
    frames = list(load_trajectory(tmp_path / "dg"))
    assert frames[0]["pos"].shape == (3, 128, 2) and frames[1]["alive"].shape == (3, 128)
    assert frames[1]["alive"].sum() > frames[0]["alive"].sum() > 0
    params = np.load(tmp_path / "dg" / "params.npz")
    assert set(params.files) == set(Params._fields)
    for name, (lo, hi) in sweep.DEFAULT_RANDOM_RANGES.items():
        v = params[name]
        assert v.shape == (3,) and len(np.unique(v)) == 3 and ((v >= lo) & (v <= hi)).all()


def test_run_vmapped_sweep_prints_every_variant(capsys):
    cfg = _stirring_cup(max_particles=32)
    out = sweep.run_vmapped_sweep(cfg, {"viscosity": [4.0, 8.0]}, ticks=5, device="cpu")
    assert out["particle_counts"].shape == (2,)
    assert out["diagnostics"].force_dv.shape == (2, 7)
    assert "viscosity" in capsys.readouterr().out


def test_errors_and_the_card_default(monkeypatch):
    """Every backend vmaps, pmajor under SAND_CRATE_PMSUB=1 too (K10 takes
    a crate axis): BatchedCrates constructs and runs 2 ticks with overflow
    0.  The sweep entry points run on the card unless the caller asks for
    the CPU, and raise without one."""
    cfg = _stirring_cup(max_particles=32)
    base = Params.from_coefficients(cfg.world_config.coefficients, "cpu")
    batched = sweep.stack_params([base, base])
    for mode in ("pmajor", "pallas", "cellwise", "gather"):
        assert sweep.BatchedCrates(cfg, batched, forces_mode=mode,
                                   device="cpu").scene.forces_mode == mode
    monkeypatch.setenv("SAND_CRATE_PMSUB", "1")
    diag = sweep.BatchedCrates(cfg, batched, forces_mode="pmajor", device="cpu").run(2)
    assert int(diag.neighbor_overflow.max()) == 0 and int(diag.non_finite.max()) == 0
    monkeypatch.delenv("SAND_CRATE_PMSUB")
    with pytest.raises(ValueError, match="num_ticks"):
        sweep.BatchedCrates(cfg, batched, device="cpu").run(0)
    calls = (lambda: sweep.BatchedCrates(cfg, batched),
             lambda: sweep.run_datagen(cfg, 2, 10, 5, "unused"),
             lambda: sweep.run_vmapped_sweep(cfg, {"viscosity": [1.0]}, ticks=1))
    if torch.cuda.is_available():
        assert sweep.BatchedCrates(cfg, batched).state.pos.device.type == "cuda"
    else:
        for call in calls:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
