"""The port's p-major schedules behind the environment knobs, against the
JAX package's, on the CPU.

``SAND_CRATE_PMSUB=1`` selects the chunk-window pass (K10, ``pms_pass``)
and ``SAND_CRATE_PMAJOR_GATE=1`` the one-sided K1/K2 passes, in both
packages; both turn the two-sided collider noise off.  The same inputs, made
with numpy from a seed, go through the JAX ``neighbor_forces_pmajor`` (its
Pallas kernels in interpret mode, the knob set as tests/test_pmajor.py:195
sets it) and the port's, whose passes run as their plain torch versions on
CPU tensors.  Tolerances: 3e-3, the JAX suite's PairSums tolerance
(tests/test_pmajor.py:53), in the regimes of tests/test_pmajor.py:195-269;
1e-5 where both sides sum the same one-sided pairs in another order (as
tests/test_torch_pmajor.py); neighbour counts exact.  The plain K10 version
is held bit for bit against the plain K1/K2 version here, and the CUDA
kernels against both on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import copy
import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sand_crate_tpu.ops import pmajor as jpm
from sand_crate_tpu.scene import build_scene as jax_build_scene
from sand_crate_tpu.state import Params as JaxParams
from sand_crate_tpu_torch.cellwise import cell_ids_grid
from sand_crate_tpu_torch.ops import pmajor as tpm
from sand_crate_tpu_torch.state import params_from_numpy, scene_from_numpy

torch.set_num_threads(1)

FIELDS = ("p_i", "dv_tension", "pressure_real", "spring_real", "visc_vsum")


@pytest.fixture
def knob(monkeypatch):
    """Set one of the JAX package's knobs for the test; JAX reads them at
    trace time, so its compile caches are cleared around the test."""

    def set_knob(name):
        monkeypatch.setenv(name, "1")
        jax.clear_caches()

    yield set_knob
    jax.clear_caches()


def _setup(stirring_cup_config, capacity=128, max_particles=96, **scene_kw):
    """(JAX scene, JAX params, port scene, port params); the port's scene
    is the JAX scene leaf by leaf, on the p-major backend."""
    config = copy.deepcopy(stirring_cup_config)
    config.world_config.coefficients["max_particles"] = max_particles
    config.world_config.coefficients["collider_noise_level"] = 0.0
    world = config.world_config
    js = jax_build_scene(world, capacity=capacity, **scene_kw)
    jp = JaxParams.from_coefficients(world.coefficients)
    fields = {f.name: getattr(js, f.name) for f in dataclasses.fields(js)}
    fields = {k: np.asarray(v) if hasattr(v, "shape") else v for k, v in fields.items()}
    fields["forces_mode"] = "pmajor"
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp._asdict().items()}, device="cpu")
    return js, jp, scene_from_numpy(fields, device="cpu"), tp


def _both(setup, pos, vel, alive, noise_amp=0.0, tick=0, fold=False):
    """(JAX PairSums, port PairSums) as dicts of numpy arrays."""
    js, jp, ts, tp = setup
    ref = jpm.neighbor_forces_pmajor(
        jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(alive),
        jnp.asarray(noise_amp, jnp.float32), jnp.asarray(tick, jnp.int32),
        jp.diameter, jp.surface_smoothing, jp.target_pressure,
        jp.ignored_pressure, jp.spring_overlap_balance, js,
        pressure_amplifier=jp.pressure_amplifier if fold else None,
    )
    got = tpm.neighbor_forces_pmajor(
        torch.as_tensor(pos), torch.as_tensor(vel), torch.as_tensor(alive),
        torch.tensor(noise_amp, dtype=torch.float32), torch.tensor(tick, dtype=torch.int32),
        tp.diameter, tp.surface_smoothing, tp.target_pressure,
        tp.ignored_pressure, tp.spring_overlap_balance, ts,
        pressure_amplifier=tp.pressure_amplifier if fold else None,
    )
    return ({k: np.asarray(v) for k, v in ref._asdict().items()},
            {k: v.numpy() for k, v in got._asdict().items()})


def _assert_match(ref, got, tol):
    assert int(ref["overflow"]) == 0 and int(got["overflow"]) == 0
    np.testing.assert_array_equal(got["nbr_cnt"], ref["nbr_cnt"], err_msg="nbr_cnt")
    for name in FIELDS:
        np.testing.assert_allclose(got[name], ref[name], rtol=tol, atol=tol, err_msg=name)


def _random(seed, n, scale, offset, p_alive):
    rng = np.random.default_rng(seed)
    pos = (rng.random((n, 2)).astype(np.float32) * scale + offset).astype(np.float32)
    vel = (rng.random((n, 2)).astype(np.float32) - 0.5).astype(np.float32)
    return pos, vel, rng.random(n) < p_alive


def _blob(seed, diam, n=256):
    """``n`` particles in a 2 x 2-diameter square: dozens per cell."""
    rng = np.random.default_rng(seed)
    pos = ((rng.random((n, 2)).astype(np.float32) * 2.0 + 20.0) * diam).astype(np.float32)
    vel = (rng.random((n, 2)).astype(np.float32) - 0.5).astype(np.float32)
    return pos, vel, np.ones(n, bool)


# tests/test_pmajor.py:195-269's three regimes: (scene options, data, noise
# amplitude and tick).
REGIMES = {
    # Over-capacity blob: no-cap pair sums, zero overflow.
    "blob": dict(scene=dict(capacity=256, max_particles=256, forces_mode="dense",
                            cell_capacity=8),
                 data=lambda d: _blob(7, d)),
    # Row-spanning sparse spray with dead slots.
    "spray": dict(scene=dict(capacity=512, max_particles=512, forces_mode="dense"),
                  data=lambda d: _random(11, 512, 0.9, 0.05, 0.9)),
    # Spring + collider noise (split pass B with 6 outputs, one-sided jitter).
    "spring_noise": dict(scene=dict(forces_mode="cellwise", enable_spring=True),
                         data=lambda d: _random(5, 128, 0.25, 0.2, 0.9), noise=0.02, tick=9),
}


@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_pmsub_matches_jax_pmsub(stirring_cup_config, knob, regime):
    """The port's K10 path (SAND_CRATE_PMSUB=1) against JAX's _pms_kernel
    path on the same inputs, at tests/test_pmajor.py:53's 3e-3."""
    knob("SAND_CRATE_PMSUB")
    cfg = REGIMES[regime]
    setup = _setup(stirring_cup_config, **cfg["scene"])
    assert tpm.schedule() == "pmsub"
    pos, vel, alive = cfg["data"](float(np.asarray(setup[1].diameter)))
    ref, got = _both(setup, pos, vel, alive, cfg.get("noise", 0.0), cfg.get("tick", 0))
    _assert_match(ref, got, 3e-3)


def test_gate_matches_jax_gate_with_noise(stirring_cup_config, knob):
    """Under SAND_CRATE_PMAJOR_GATE=1 JAX turns the two-sided (symm) noise
    off and jitters one side at the full amplitude (ops/pmajor.py:1143-1147);
    so does the port.  The main path's scene (pmajor: symm + fold), noise
    on: the same one-sided pairs, so 1e-5.  Before the port read the knob,
    it kept the two-sided noise and missed this by far more."""
    knob("SAND_CRATE_PMAJOR_GATE")
    setup = _setup(stirring_cup_config, capacity=128, max_particles=128, forces_mode="pmajor")
    assert setup[2].pmajor_symm and setup[2].fold_pairs and tpm.schedule() == "gate"
    diam = float(np.asarray(setup[1].diameter))
    pos, vel, alive = _random(3, 128, 0.3, 0.1, 0.75)
    for fold in (False, True):
        ref, got = _both(setup, pos, vel, alive, noise_amp=0.1 * diam, tick=4, fold=fold)
        _assert_match(ref, got, 1e-5)


def _sorted_case(seed, n=3000, p_alive=0.9):
    """Cell-sorted random particles of a 4096-capacity stirring_cup scene
    with a dense blob; (scene, slab_a, sorted cid, alive, ranges, coef)."""
    from sand_crate_tpu_torch import load_config
    from sand_crate_tpu_torch.scene import build_scene

    world = load_config(Path(__file__).resolve().parent.parent / "configs" /
                        "stirring_cup.yaml").world_config
    scene = build_scene(world, capacity=4096, forces_mode="pmajor", device="cpu")
    diam = 2 * float(world.coefficients["particle_radius"])
    pos, vel, alive = _random(seed, n, 0.5, 0.2, p_alive)
    pos[:200] = _blob(seed, diam, 200)[0]
    pos, vel, alive = torch.as_tensor(pos), torch.as_tensor(vel), torch.as_tensor(alive)
    cid, order = torch.sort(cell_ids_grid(pos, alive, scene), stable=True)
    alive = alive[order]
    slab_a = tpm.pass_a_slab(pos[order], vel[order], alive, cid, torch.tensor(0.1 * diam),
                             torch.tensor(3, dtype=torch.int32), scene, symm=False)
    ranges = tpm.candidate_ranges(cid, alive, scene.grid_nx, scene.grid_ny)
    coef = tpm.coef_stack(torch.tensor(diam), torch.tensor(-2.0), torch.tensor(0.5))
    return scene, slab_a, cid, alive, ranges, coef


@pytest.mark.parametrize("chunk", tpm.PMS_CHUNKS)
def test_pms_plain_bit_identical_to_pm_plain(chunk):
    """pms_pass_plain gives pm_pass_plain's one-sided bits: the same pairs
    (the cell test) added in the same order, pass A and every pass-B
    variant, with dead particles and a deep blob."""
    scene, slab_a, cid, alive, ranges, coef = _sorted_case(1)
    nx = scene.grid_nx
    win = tpm.chunk_windows(cid, alive, nx, scene.grid_ny, chunk)
    out_a = tpm.pm_pass_plain(slab_a, ranges, coef, "a")
    assert float(out_a[3].max()) > 20  # the blob's dense neighbourhoods
    assert torch.equal(tpm.pms_pass_plain(slab_a, cid, win, coef, "a", nx=nx, chunk=chunk), out_a)
    cp = tpm.finalize_cp(out_a[0], out_a[3], torch.tensor(0.3))
    slab_b = tpm.pass_b_slab(slab_a, out_a, cp, torch.tensor(100.0))
    for fold, spring in ((True, False), (False, False), (False, True)):
        kw = dict(fold=fold, spring=spring)
        want = tpm.pm_pass_plain(slab_b, ranges, coef, "b", **kw)
        # On CPU tensors the wrapper runs the plain version.
        got = tpm.pms_pass(slab_b, cid, win, coef, "b", nx=nx, chunk=chunk, **kw)
        assert torch.equal(got, want), (fold, spring)


@pytest.mark.parametrize("chunk", tpm.PMS_CHUNKS)
def test_chunk_windows_cover_every_range(chunk):
    """Every alive self's exact range lies inside its chunk's window, row
    6 is one past the chunk's last alive self, and dead chunks are empty."""
    scene, _, cid, alive, ranges, _ = _sorted_case(2, n=2500, p_alive=0.6)
    win = tpm.chunk_windows(cid, alive, scene.grid_nx, scene.grid_ny, chunk)
    P, n_alive = cid.shape[0], int(alive.sum())
    assert win.dtype == torch.int32 and tuple(win.shape) == (7, -(-P // chunk))
    c = torch.arange(P) // chunk
    for q in range(3):
        a = alive
        assert bool((ranges[q][a] >= win[q][c[a]]).all())
        assert bool((ranges[3 + q][a] <= win[3 + q][c[a]]).all())
    off = torch.arange(win.shape[1]) * chunk
    assert torch.equal(win[6], torch.clamp(torch.clamp(off + chunk, max=n_alive), min=off)
                       .to(torch.int32))
    dead = off >= n_alive
    assert bool(dead.any()) and bool((win[3:6, dead] == win[:3, dead]).all())


def test_pms_pass_rejects_bad_inputs():
    slab = torch.zeros((64, 8))
    win = torch.zeros((7, 2), dtype=torch.int32)
    cid = torch.zeros(64, dtype=torch.int32)
    with pytest.raises(ValueError):
        tpm.pms_pass(slab, cid, win, torch.zeros(3), "c", nx=8, chunk=32)
    with pytest.raises(ValueError):
        tpm.pms_pass(slab, cid, win, torch.zeros(3), "a", nx=8, chunk=64)
    with pytest.raises(ValueError):  # neither the CPU nor a CUDA device
        tpm.pms_pass(slab.to("meta"), cid, win, torch.zeros(3), "a", nx=8, chunk=32)


@pytest.fixture(scope="module")
def window_inputs():
    """Sorted (cid, alive, nx, ny) inputs for K10's in-window range search:
    the hard cases of ops/pmajor_cases.py and the grid's "edges" bands (cells
    in rows 0 and ny - 1, so targets below cell 0 and past the last one) on
    a 72 x 72 grid, and a ~10k dam break settled 20 ticks on the p-major
    backend."""
    from sand_crate_tpu_torch import Crate
    from sand_crate_tpu_torch.bench import dam_break_world
    from sand_crate_tpu_torch.ops import grid_cases, pmajor_cases
    from sand_crate_tpu_torch.scene import build_scene

    scene = build_scene(dam_break_world(2000), forces_mode="pmajor", device="cpu")
    nx, ny = scene.grid_nx, scene.grid_ny
    out = {case: pmajor_cases.sorted_particles(case, scene, "cpu")[2:] + (nx, ny)
           for case in pmajor_cases.CASES}
    out["edges"] = grid_cases.sorted_particles("edges", scene, "cpu")[2:] + (nx, ny)
    crate = Crate(dam_break_world(10_000), device="cpu")
    crate.run(20)
    st, sc = crate.state, crate.scene
    cid, order = torch.sort(cell_ids_grid(st.pos, st.alive, sc), stable=True)
    out["settled_dam_break"] = (st.alive[order], cid, sc.grid_nx, sc.grid_ny)
    return {k: (cid, alive, nx, ny) for k, (alive, cid, nx, ny) in out.items()}


WINDOW_INPUTS = ["dead_tail", "dense_blob", "edges", "ragged_tile", "random", "row_spanning",
                 "settled_dam_break", "under_one_tile"]


@pytest.mark.parametrize("chunk", tpm.PMS_CHUNKS)
@pytest.mark.parametrize("name", WINDOW_INPUTS)
def test_window_ranges_equal_candidate_ranges(window_inputs, name, chunk):
    """K10 finds each self's exact ranges by a binary search inside its
    chunk's window (window_ranges mirrors the kernel's search): for every
    alive self they equal candidate_ranges' (the searches over all P with
    their clamps at 0 and nx * ny), and dead selves get empty ranges."""
    cid, alive, nx, ny = window_inputs[name]
    ranges = tpm.candidate_ranges(cid, alive, nx, ny)
    win = tpm.chunk_windows(cid, alive, nx, ny, chunk)
    found = tpm.window_ranges(cid, win, chunk, nx)
    assert found.dtype == torch.int32 and tuple(found.shape) == (6, cid.shape[0])
    assert torch.equal(found[:, alive], ranges[:, alive])
    assert not found[:, ~alive].any()
    assert int((ranges[3:] - ranges[:3])[:, alive].sum()) > 0
    if name == "edges":  # the targets the clamps catch are reached
        rows = cid[alive] // nx
        assert (int(rows.min()), int(rows.max())) == (0, ny - 1)


def test_k10_constants_mirror_the_kernel():
    """K10's chunks are one warp or one block of csrc/pmajor.cu, which the
    kernel launches over P with the block size of K1/K2."""
    src = (Path(tpm.__file__).parent.parent / "csrc" / "pmajor.cu").read_text()
    threads = int(re.search(r"constexpr int kThreads = (\d+);", src).group(1))
    assert tpm.PMS_CHUNKS == (tpm.PM_TILE, threads) and tpm.PMS_CHUNK in tpm.PMS_CHUNKS
    assert "static_assert(CHUNK == 32 || CHUNK == kThreads" in src
    assert "launch_pms_mode<kThreads>" in src and "chunk == 32" in src
