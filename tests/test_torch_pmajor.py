"""The port's p-major pair sums against the JAX package's, on the CPU.

The same inputs, made with numpy from a seed, go through the JAX
``neighbor_forces_pmajor`` (its Pallas kernel in interpret mode, as
tests/test_pmajor.py runs it here) and the port's counterpart, whose pair
passes run as their plain torch versions on CPU tensors.  The regimes are
those of tests/test_pmajor.py.  The CUDA kernels themselves are held
against the plain versions on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""

import copy
import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sand_crate_tpu.ops import pmajor as jpm
from sand_crate_tpu.scene import build_scene as jax_build_scene
from sand_crate_tpu.state import Params as JaxParams
from sand_crate_tpu_torch.bench import dam_break_world
from sand_crate_tpu_torch.cellwise import cell_ids_grid
from sand_crate_tpu_torch.engine import Crate
from sand_crate_tpu_torch.ops import pmajor as tpm
from sand_crate_tpu_torch.state import params_from_numpy, scene_from_numpy

torch.set_num_threads(1)

FIELDS = ("p_i", "dv_tension", "pressure_real", "spring_real", "visc_vsum")


def _jax_scene_fields(scene):
    """The JAX Scene, leaf by leaf, as the port's scene_from_numpy takes it."""
    fields = {f.name: getattr(scene, f.name) for f in dataclasses.fields(scene)}
    out = {k: np.asarray(v) if hasattr(v, "shape") else v for k, v in fields.items()}
    out["forces_mode"] = "pmajor"
    return out


def _setup(stirring_cup_config, capacity=128, max_particles=96, **scene_kw):
    config = copy.deepcopy(stirring_cup_config)
    config.world_config.coefficients["max_particles"] = max_particles
    config.world_config.coefficients["collider_noise_level"] = 0.0
    world = config.world_config
    scene = jax_build_scene(world, capacity=capacity, **scene_kw)
    params = JaxParams.from_coefficients(world.coefficients)
    return scene, params


def _both(scene, params, pos, vel, alive, noise_amp=0.0, tick=0, fold=False):
    """(JAX PairSums, port PairSums) as dicts of numpy arrays."""
    pa = params.pressure_amplifier if fold else None
    ref = jpm.neighbor_forces_pmajor(
        jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(alive),
        jnp.asarray(noise_amp, jnp.float32), jnp.asarray(tick, jnp.int32),
        params.diameter, params.surface_smoothing, params.target_pressure,
        params.ignored_pressure, params.spring_overlap_balance, scene,
        pressure_amplifier=pa,
    )
    tscene = scene_from_numpy(_jax_scene_fields(scene), device="cpu")
    tparams = params_from_numpy({k: np.asarray(v) for k, v in params._asdict().items()},
                                device="cpu")
    got = tpm.neighbor_forces_pmajor(
        torch.as_tensor(pos), torch.as_tensor(vel), torch.as_tensor(alive),
        torch.tensor(noise_amp, dtype=torch.float32),
        torch.tensor(tick, dtype=torch.int32),
        tparams.diameter, tparams.surface_smoothing, tparams.target_pressure,
        tparams.ignored_pressure, tparams.spring_overlap_balance, tscene,
        pressure_amplifier=tparams.pressure_amplifier if fold else None,
    )
    ref = {k: np.asarray(v) for k, v in ref._asdict().items()}
    got = {k: v.numpy() for k, v in got._asdict().items()}
    return ref, got


def _assert_match(ref, got, tol):
    """nbr_cnt exact (same pair set); every other field at ``tol``."""
    np.testing.assert_array_equal(got["nbr_cnt"], ref["nbr_cnt"], err_msg="nbr_cnt")
    for name in FIELDS:
        np.testing.assert_allclose(
            got[name], ref[name], rtol=tol, atol=tol, err_msg=name
        )
    assert int(got["overflow"]) == 0  # exact ranges: no pair is ever lost


def _random(seed, n, scale, offset, p_alive, vscale=1.0):
    rng = np.random.default_rng(seed)
    pos = rng.random((n, 2)).astype(np.float32) * scale + offset
    vel = ((rng.random((n, 2)).astype(np.float32) - 0.5) * vscale).astype(np.float32)
    alive = rng.random(n) < p_alive
    return pos.astype(np.float32), vel, alive


def _blob(seed, diam, n=256, side=2.0, corner=20.0):
    """``n`` particles in a square of ``side`` diameters: many per cell."""
    rng = np.random.default_rng(seed)
    pos = ((rng.random((n, 2)).astype(np.float32) * side + corner) * diam).astype(np.float32)
    vel = (rng.random((n, 2)).astype(np.float32) - 0.5).astype(np.float32)
    return pos, vel, np.ones(n, bool)


def test_u01_bit_exact_with_wraparound():
    rng = np.random.default_rng(0)
    seeds = np.concatenate([
        rng.integers(-(2**31), 2**31, 4096, dtype=np.int64),
        [0, 1, -1, 2**31 - 1, -(2**31), 2**30, 123456789],
    ]).astype(np.int32)
    for tick in (0, 7, 2**31 - 1, -(2**31), -5):
        ref = np.asarray(jpm._u01(jnp.asarray(seeds), jnp.int32(tick)))
        got = tpm._u01(torch.as_tensor(seeds), torch.tensor(tick, dtype=torch.int32))
        np.testing.assert_array_equal(got.numpy().view(np.uint32), ref.view(np.uint32))


def test_feature_rows_bit_exact():
    pos, vel, alive = _random(1, 3000, 0.9, 0.05, 0.8)
    for amp, tick in ((0.0, 0), (0.0007, 41), (0.003, 2**31 - 3)):
        ref = jpm.feature_rows(
            jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(alive),
            jnp.asarray(amp, jnp.float32), jnp.asarray(tick, jnp.int32),
        )
        got = tpm.feature_rows(
            torch.as_tensor(pos), torch.as_tensor(vel), torch.as_tensor(alive),
            torch.tensor(amp, dtype=torch.float32), torch.tensor(tick, dtype=torch.int32),
        )
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(g.numpy().view(np.uint32), np.asarray(r).view(np.uint32))


# (regime, JAX test it mirrors, tolerance and why).  Tolerances: 1e-5 where
# JAX itself holds two of its implementations of the same pair set against
# each other (tests/test_pmajor.py:429 — here the port's two-sided sums vs
# JAX's halved-and-merged or windowed sums: the same pairs, only the f32
# summation order differs); 3e-3 where sums of hundreds of near-coincident
# pairs cancel (tests/test_pmajor.py:53's PairSums tolerance).
REGIMES = {
    # tests/test_pmajor.py:65 — random mix with dead slots, split, two-sided.
    "random_mix": dict(scene_kw=dict(forces_mode="cellwise"), tol=1e-5,
                       data=lambda d: _random(3, 128, 0.3, 0.1, 0.75, 2.0)),
    # :82 — a blob packing > cell_capacity particles per cell.
    "dense_blob": dict(scene_kw=dict(forces_mode="dense", cell_capacity=8),
                       capacity=256, tol=3e-3, data=lambda d: _blob(7, d)),
    # :115 — sparse spray: chunks span many grid rows.
    "row_spanning": dict(scene_kw=dict(forces_mode="dense"), capacity=512,
                         tol=1e-5, data=lambda d: _random(11, 512, 0.9, 0.05, 0.9)),
    # :137 — the spring sums (split pass B, 6 outputs).
    "spring": dict(scene_kw=dict(forces_mode="cellwise", enable_spring=True),
                   tol=1e-5, data=lambda d: _random(5, 128, 0.25, 0.2, 0.9)),
    # :336 — one-sided collider noise on.
    "noise_one_sided": dict(scene_kw=dict(forces_mode="cellwise"), tol=1e-5,
                            noise=0.1, tick=4,
                            data=lambda d: _random(9, 128, 0.2, 0.3, 1.0, 0.0)),
    # :377 — the folded pass B (fold + symm, the main path's defaults).
    "fold": dict(scene_kw=dict(forces_mode="pmajor"), tol=1e-5, fold=True,
                 data=lambda d: _random(11, 128, 0.3, 0.1, 0.75, 2.0)),
    # :412 — symm (two-sided noise form), split pass B.
    "symm": dict(scene_kw=dict(forces_mode="pmajor", pmajor_symm=True), tol=1e-5,
                 data=lambda d: _random(5, 128, 0.3, 0.1, 0.75, 2.0)),
    # :460 — symm with the spring.
    "symm_spring": dict(scene_kw=dict(forces_mode="pmajor", enable_spring=True,
                                      pmajor_symm=True),
                        tol=1e-5, data=lambda d: _random(9, 128, 0.3, 0.1, 0.8)),
    # :497 — symm with strong two-sided noise in a packed square (dozens of
    # pairs per particle, sums ~1e3: the 3e-3 PairSums tolerance).
    "symm_noise": dict(scene_kw=dict(forces_mode="pmajor", pmajor_symm=True),
                       tol=3e-3, noise=0.3, tick=17,
                       data=lambda d: _blob(13, d, 128, 4.0, 30.0)),
}


@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_pair_sums_match_jax(stirring_cup_config, regime):
    cfg = REGIMES[regime]
    cap = cfg.get("capacity", 128)
    scene, params = _setup(
        stirring_cup_config, capacity=cap, max_particles=cap, **cfg["scene_kw"]
    )
    diam = float(np.asarray(params.diameter))
    pos, vel, alive = cfg["data"](diam)
    ref, got = _both(
        scene, params, pos, vel, alive,
        noise_amp=cfg.get("noise", 0.0) * diam, tick=cfg.get("tick", 0),
        fold=cfg.get("fold", False),
    )
    assert int(ref["overflow"]) == 0
    _assert_match(ref, got, cfg["tol"])
    if regime == "symm_noise":
        # Pair-antisymmetric noise: the pair kicks still cancel in sum.
        for name in ("dv_tension", "pressure_real"):
            total = np.abs(got[name].sum(axis=0)).max()
            assert total <= 2e-4 * max(np.abs(got[name]).max(), 1.0), name


def _regime_sorted(stirring_cup_config, regime):
    """(sorted cell ids, alive, scene) of a REGIMES input, cell-sorted."""
    cfg = REGIMES[regime]
    cap = cfg.get("capacity", 128)
    scene, params = _setup(stirring_cup_config, capacity=cap, max_particles=cap,
                           **cfg["scene_kw"])
    tscene = scene_from_numpy(_jax_scene_fields(scene), device="cpu")
    pos, _, alive = cfg["data"](float(np.asarray(params.diameter)))
    pos, alive = torch.as_tensor(pos), torch.as_tensor(alive)
    cid, order = torch.sort(cell_ids_grid(pos, alive, tscene), stable=True)
    return cid, alive[order], tscene


def _settled_dam_break():
    """(sorted cell ids, alive, scene) of a ~10k-particle dam break after 30
    ticks on the CPU (the bench world, sorted as the tick sorts it)."""
    crate = Crate(dam_break_world(10_000), device="cpu")
    crate.run(30)
    st = crate.state
    cid, order = torch.sort(cell_ids_grid(st.pos, st.alive, crate.scene), stable=True)
    return cid, st.alive[order], crate.scene


@pytest.mark.parametrize("regime", sorted(REGIMES) + ["dam_break_10k"])
def test_tile_windows_cover_the_ranges(stirring_cup_config, regime):
    """What the K1/K2 kernel relies on to stage a tile's candidates: the
    starts of candidate_ranges never decrease over the sorted selves, dead
    selves' ranges are empty, and for tiles of T consecutive selves the
    window [ranges[q][first self], max ranges[3 + q]) covers every alive
    self's range; the window the kernel computes (tile_windows: the least
    start and largest end of the non-empty ranges) covers every range too
    and lies inside that one."""
    if regime == "dam_break_10k":
        cid, alive, scene = _settled_dam_break()
    else:
        cid, alive, scene = _regime_sorted(stirring_cup_config, regime)
    ranges = tpm.candidate_ranges(cid, alive, scene.grid_nx, scene.grid_ny)
    ws, we = ranges[:3].long(), ranges[3:].long()
    assert bool((ws[:, 1:] >= ws[:, :-1]).all()), "a range start decreases"
    assert torch.equal(we[:, ~alive], ws[:, ~alive]), "a dead self has candidates"
    assert bool((we[1, alive] > ws[1, alive]).all())  # an alive self's own cell
    P = cid.shape[0]
    for T in (32, 128, 256):
        tile = torch.arange(P) // T
        first = ws[:, tile * T]
        pad = (0, -(-P // T) * T - P)
        most = torch.nn.functional.pad(we, pad).view(3, -1, T).amax(dim=2)[:, tile]
        live = alive[None, :] & (we > ws)
        assert bool((ws >= first)[live].all()) and bool((we <= most)[live].all()), T
        win = tpm.tile_windows(ranges, T).long()
        lo, hi = win[:3][:, tile], win[3:][:, tile]
        nonempty = we > ws
        assert bool((ws >= lo)[nonempty].all()) and bool((we <= hi)[nonempty].all()), T
        assert bool((lo >= first)[nonempty].all()) and bool((hi <= most)[nonempty].all()), T
        assert bool((hi - lo <= most - first)[nonempty].all()), T


def test_tile_constants_mirror_the_kernel():
    """PM_TILE is the kernel's warp and PM_PIECE its kPiece (csrc/pmajor.cu)."""
    src = (Path(tpm.__file__).parent.parent / "csrc" / "pmajor.cu").read_text()
    piece = int(re.search(r"constexpr int kPiece = (\d+);", src).group(1))
    threads = int(re.search(r"constexpr int kThreads = (\d+);", src).group(1))
    assert (tpm.PM_TILE, tpm.PM_PIECE) == (32, piece) and threads % tpm.PM_TILE == 0


def test_plain_chunking_is_invisible(stirring_cup_config, monkeypatch):
    """The plain version's self chunking changes nothing but the chunk loop."""
    scene, params = _setup(stirring_cup_config, capacity=512, max_particles=512,
                           forces_mode="pmajor")
    tscene = scene_from_numpy(_jax_scene_fields(scene), device="cpu")
    pos, vel, alive = _random(21, 512, 0.9, 0.05, 0.9)
    args = (torch.as_tensor(pos), torch.as_tensor(vel), torch.as_tensor(alive))
    tp = params_from_numpy({k: np.asarray(v) for k, v in params._asdict().items()}, device="cpu")

    def run():
        return tpm.neighbor_forces_pmajor(
            *args, tp.diameter * 0.1, torch.tensor(3, dtype=torch.int32),
            tp.diameter, tp.surface_smoothing, tp.target_pressure,
            tp.ignored_pressure, tp.spring_overlap_balance, tscene,
            pressure_amplifier=tp.pressure_amplifier,
        )

    whole = run()
    monkeypatch.setattr(tpm, "PLAIN_CHUNK", 100)
    chunked = run()
    for a, b in zip(whole, chunked):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_pm_pass_rejects_bad_inputs():
    slab = torch.zeros((8, 8))
    ranges = torch.zeros((6, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        tpm.pm_pass(slab, ranges, torch.zeros(3), "c")
    meta = torch.zeros((8, 8), device="meta")
    with pytest.raises(ValueError):
        tpm.pm_pass(meta, ranges, torch.zeros(3), "a")
