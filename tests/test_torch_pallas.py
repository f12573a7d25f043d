"""The port's slot-grid backend (``forces_mode="pallas"``) against the JAX
package's, on the CPU.

The same inputs, made with numpy from a seed, go through the JAX functions
(their Pallas kernels in interpret mode, as tests/test_forces_providers.py
runs them here) and through the port, whose kernels run as their plain
torch versions on CPU tensors.  JAX's interpret mode compiles each kernel
for tens of seconds, so the kernel-level cases share one M=8 scene (the
JAX compile cache then serves the providers too), and the M=16 providers
are held against the JAX cellwise backend, the JAX suite's own oracle for
them (tests/test_forces_providers.py:54).  Tolerances: exact where the two
packages move the same values (slot bookkeeping, slab, grid, counts); 3e-3
for pair sums, the JAX suite's cross-backend tolerance
(test_forces_providers.py:76-83).  The CUDA kernels themselves are held
against the plain versions on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""

import copy
import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sand_crate_tpu import load_config_dict as jax_load_config_dict
from sand_crate_tpu import physics as jphys
from sand_crate_tpu.cellwise import cell_ids_grid as jax_cell_ids
from sand_crate_tpu.cellwise import neighbor_forces_cellwise
from sand_crate_tpu.cellwise import slot_assignment as jax_slot_assignment
from sand_crate_tpu.engine import Crate as JaxCrate
from sand_crate_tpu.ops import pair_kernel as jpk
from sand_crate_tpu.ops import placement as jpl
from sand_crate_tpu.ops.pallas_forces import neighbor_forces_pallas_sorted as jax_sorted
from sand_crate_tpu.scene import build_scene as jax_build_scene
from sand_crate_tpu.state import Params as JaxParams
from sand_crate_tpu_torch import load_config_dict
from sand_crate_tpu_torch.cellwise import slot_assignment
from sand_crate_tpu_torch.engine import Crate
from sand_crate_tpu_torch.ops import pair_kernel as tpk
from sand_crate_tpu_torch.ops import placement as tpl
from sand_crate_tpu_torch.ops.pallas_forces import (
    grid_width,
    neighbor_forces_pallas,
    neighbor_forces_pallas_sorted,
)
from sand_crate_tpu_torch.state import params_from_numpy, scene_from_numpy

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
TOL = 3e-3
FIELDS = ("p_i", "dv_tension", "pressure_real", "spring_real", "visc_vsum", "nbr_cnt")
NOISE, TICK = 0.1, 7  # collider noise level (x diameter) and tick of the noisy cases


def _t(a):
    return torch.as_tensor(np.array(a))


def _setup(stirring_cup_config, M, enable_spring=False, capacity=512):
    """(JAX scene, JAX params, port scene, port params) of a stirring_cup
    world at ``capacity`` with ``M`` slots per cell."""
    config = copy.deepcopy(stirring_cup_config)
    w = config.world_config
    w.coefficients = dict(w.coefficients)
    w.coefficients["max_particles"] = 400
    js = jax_build_scene(w, capacity=capacity, forces_mode="pallas",
                         cell_capacity=M, enable_spring=enable_spring)
    fields = {f.name: getattr(js, f.name) for f in dataclasses.fields(js)}
    ts = scene_from_numpy({k: np.asarray(v) if hasattr(v, "shape") else v
                           for k, v in fields.items()}, device="cpu")
    jp = JaxParams.from_coefficients(w.coefficients)
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp._asdict().items()}, device="cpu")
    assert ts.cell_capacity == M and ts.forces_mode == "pallas"
    return js, jp, ts, tp


def _particles(scene, seed, deep=((10.5, 12.5, 20), (40.5, 30.5, 10)), P=512):
    """Random particles with a few deep cells ((cx, cy, count) in cell
    units), cell-sorted: (pos, vel, alive, sorted_cid) as numpy."""
    rng = np.random.default_rng(seed)
    pos = (rng.random((P, 2)) * 0.35 + 0.1).astype(np.float32)
    cell = scene.cell_size
    k = 0
    for cx, cy, n in deep:
        pos[k:k + n] = (cx * cell, cy * cell) + (rng.random((n, 2)) - 0.5) * 0.7 * cell
        k += n
    vel = ((rng.random((P, 2)) - 0.5) * 2).astype(np.float32)
    alive = rng.random(P) < 0.85
    alive[:k] = True
    cid = np.asarray(jax_cell_ids(jnp.asarray(pos), jnp.asarray(alive), scene))
    order = np.argsort(cid, kind="stable")
    return pos[order], vel[order], alive[order], cid[order].astype(np.int32)


def _grid_inputs(js, data):
    """The JAX slab, row_start and grid of cell-sorted particles."""
    pos, vel, alive, scid = (jnp.asarray(a) for a in data)
    M, nx, ny = js.cell_capacity, js.grid_nx, js.grid_ny
    slab, row_start, gather_slot, overflow = jpl.slab_from_sorted(pos, alive, vel, scid, M, nx, ny)
    grid = jpl.place_grid(slab, row_start, M, nx, ny, grid_width(nx))
    return slab, row_start, gather_slot, overflow, grid


def test_slot_assignment_matches_jax():
    """Rank, in-cap mask, slots, the rank % M gather fallback and the
    overflow count, exactly, with a cell past capacity and dead tail ids."""
    rng = np.random.default_rng(1)
    NC, M = 50, 8
    cid = np.sort(np.concatenate([rng.integers(0, NC, 300), np.full(13, 17), np.full(40, NC)]))
    cid = cid.astype(np.int32)
    ref = jax_slot_assignment(jnp.asarray(cid), M, NC)
    got = slot_assignment(torch.as_tensor(cid), M, NC)
    for k, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=str(k))
        assert g.dtype == (torch.bool if k == 1 else torch.int32), k
    assert int(got[4]) > 0


@pytest.mark.parametrize("M", [8, 16])
def test_slab_and_place_grid_match_jax(stirring_cup_config, M):
    """slab_from_sorted and place_grid with a 20-deep and a 10-deep cell:
    the slab, row starts, gather slots, overflow and the padded grid are the
    JAX ones exactly."""
    js, _, ts, _ = _setup(stirring_cup_config, M)
    data = _particles(js, 3)
    ref = _grid_inputs(js, data)
    pos, vel, alive, scid = (_t(a) for a in data)
    got = tpl.slab_from_sorted(pos, alive, vel, scid, M, ts.grid_nx, ts.grid_ny)
    grid = tpl.place_grid(got[0], got[1], M, ts.grid_nx, ts.grid_ny, grid_width(ts.grid_nx))
    for name, g, r in zip(("slab", "row_start", "gather_slot", "overflow", "grid"),
                          (*got, grid), ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
    assert int(got[3]) >= (20 - M) + max(10 - M, 0)


def _noisy_args(jp, tp, js):
    """(JAX, port) pass arguments with the collider noise on."""
    amp = float(np.asarray(jp.diameter)) * NOISE
    return (jnp.float32(amp), jnp.int32(TICK)), (
        torch.tensor(amp, dtype=torch.float32), torch.tensor(TICK, dtype=torch.int32))


def _in_cap_slots(slab):
    """(columns, slots) of the slab's in-cap particles: the padded grid slot
    (row + 1, rank, cx + 1) of each."""
    slab = np.asarray(slab)
    cols = np.nonzero(slab[7] > 0)[0]
    cx, rank, row = (slab[r, cols].astype(np.int64) for r in (4, 5, 6))
    return cols, (row + 1, rank, cx + 1)


def test_pair_pass_a_matches_jax(stirring_cup_config):
    """Pass A with noise on, M=8: the port's slab-order pass A against the
    JAX grid pass A gathered at each in-cap particle's slot — [w_sum, s_x,
    s_y] at 3e-3, counts exactly; the other columns hold 0."""
    js, jp, ts, tp = _setup(stirring_cup_config, 8)
    slab, row_start, _, _, grid = _grid_inputs(js, _particles(js, 5))
    (jamp, jtick), (tamp, ttick) = _noisy_args(jp, tp, js)
    occ = jpk.occ_from_row_start(row_start, js.row_block, js.grid_ny)
    ref = np.asarray(jpk.pair_pass_a(grid, jp.diameter, jamp, jtick, tr=js.row_block, occ=occ,
                                     units=None))
    got = tpk.pair_pass_a(_t(slab), _t(row_start), 8, ts.grid_nx, tp.diameter, tamp,
                          ttick).numpy()
    cols, slot = _in_cap_slots(slab)
    ref = ref[(slice(None),) + slot]
    np.testing.assert_array_equal(got[3, cols], ref[3], err_msg="cnt")
    np.testing.assert_allclose(got[:3, cols], ref[:3], rtol=TOL, atol=TOL)
    rest = np.ones(got.shape[1], bool)
    rest[cols] = False
    assert not got[:, rest].any()
    assert ref[3].max() >= 7 and np.abs(ref[1]).max() > 0


@pytest.mark.parametrize("spring", [False, True], ids=["nospring", "spring"])
@pytest.mark.parametrize("mode", ["grid", "emit"])
def test_pair_pass_b_matches_jax(stirring_cup_config, mode, spring):
    """Pass B with noise on, spring on and off, both modes, on the JAX
    grid and pass-A planes: every plane at 3e-3, counts exactly, at the
    occupied slots (grid mode) or the particle columns (emit mode)."""
    js, jp, ts, tp = _setup(stirring_cup_config, 8, enable_spring=spring)
    data = _particles(js, 5)
    slab, row_start, _, _, grid = _grid_inputs(js, data)
    (jamp, jtick), (tamp, ttick) = _noisy_args(jp, tp, js)
    occ = jpk.occ_from_row_start(row_start, js.row_block, js.grid_ny)
    ps = jpk.pair_pass_a(grid, jp.diameter, jamp, jtick, tr=js.row_block, occ=occ, units=None)
    jcoef = (jp.diameter, jp.surface_smoothing, jp.target_pressure,
             jp.spring_overlap_balance, jp.ignored_pressure, jamp, jtick)
    tcoef = (tp.diameter, tp.surface_smoothing, tp.target_pressure,
             tp.spring_overlap_balance, tp.ignored_pressure, tamp, ttick)
    P = data[0].shape[0]
    if mode == "grid":
        ref = jpk.pair_pass_b(grid, ps, *jcoef, tr=js.row_block, enable_spring=spring)
        got = tpk.pair_pass_b(_t(grid), _t(ps), *tcoef, enable_spring=spring)
        sel = np.asarray(grid)[0, 1:-1] > tpk.ALIVE_THRESHOLD
        ref, got = np.asarray(ref)[:, sel], got.numpy()[:, sel]
    else:  # the JAX pass-A grid at each in-cap column, as the port's slab-order PS
        scid = jnp.asarray(data[3])
        ref = jpk.pair_pass_b_emit(grid, ps, slab, row_start, scid, js.grid_nx, *jcoef,
                                   tr=js.row_block, enable_spring=spring, occ=occ, units=None)
        cols, slot = _in_cap_slots(slab)
        ps_cols = np.zeros((4, np.asarray(slab).shape[1]), np.float32)
        ps_cols[:, cols] = np.asarray(ps)[(slice(None),) + slot]
        got = tpk.pair_pass_b_emit(_t(slab), _t(ps_cols), _t(row_start), 8, ts.grid_nx,
                                   *tcoef, enable_spring=spring)
        assert not got[:, P:].any()
        ref, got = np.asarray(ref)[:, :P], got.numpy()[:, :P]
    assert got.shape[0] == tpk.num_b(spring)
    np.testing.assert_array_equal(got[-1], ref[-1], err_msg="count")
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    assert np.abs(ref[1:3]).max() > 1.0  # real tension sums


def _port_args(tp, noise_amp=0.0, tick=0):
    return (torch.as_tensor(noise_amp, dtype=torch.float32),
            torch.as_tensor(tick, dtype=torch.int32),
            tp.diameter, tp.surface_smoothing, tp.target_pressure, tp.ignored_pressure,
            tp.spring_overlap_balance)


def _assert_sums(got, ref, tol=TOL, fields=FIELDS):
    for name in fields:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=tol, atol=tol, err_msg=name)


def test_emit_overflow_fallback_at_m8(stirring_cup_config):
    """test_forces_providers.py:285 (M=8, a 14-deep cell): the sorted
    provider equals the particle-order one bit for bit, every over-cap
    particle gets nonzero pressure, and both match the JAX sorted provider
    with noise on, overflow included."""
    js, jp, ts, tp = _setup(stirring_cup_config, 8)
    pos, vel, alive, scid = _particles(js, 5, deep=((10.5, 12.5, 14),))
    (jamp, jtick), (tamp, ttick) = _noisy_args(jp, tp, js)
    ref = jax_sorted(jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(alive), jnp.asarray(scid),
                     jamp, jtick, jp.diameter, jp.surface_smoothing, jp.target_pressure,
                     jp.ignored_pressure, jp.spring_overlap_balance, js)
    args = _port_args(tp, tamp, ttick) + (ts,)
    new = neighbor_forces_pallas_sorted(_t(pos), _t(vel), _t(alive), _t(scid), *args)
    old = neighbor_forces_pallas(_t(pos), _t(vel), _t(alive), *args)
    assert int(new.overflow) == int(old.overflow) == int(ref.overflow) >= 6
    deep = scid == np.argmax(np.bincount(scid[alive]))
    assert (new.pressure_real.numpy()[deep] != 0).any(axis=1).all()
    for a, b in zip(new, old):
        assert torch.equal(a, b)
    _assert_sums(new, ref)


def _cellwise(js, jp, pos, vel, alive):
    return neighbor_forces_cellwise(
        jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(alive), jnp.zeros(pos.shape, jnp.float32),
        jp.diameter, jp.surface_smoothing, jp.target_pressure, jp.ignored_pressure,
        jp.spring_overlap_balance, js,
    )


@pytest.mark.parametrize("spring", [False, True], ids=["nospring", "spring"])
def test_providers_match_cellwise_at_m16(stirring_cup_config, spring):
    """test_forces_providers.py:54, :136 and :342 (M=16, noise off, a
    20-deep and a 10-deep cell): the particle-order provider against the
    JAX cellwise backend, the spring planes included, and the sorted
    provider equal to it bit for bit, overflow included."""
    js, jp, ts, tp = _setup(stirring_cup_config, 16, enable_spring=spring)
    pos, vel, alive, scid = _particles(js, 9)
    perm = np.random.default_rng(2).permutation(pos.shape[0])  # particle order
    ref = _cellwise(js, jp, pos[perm], vel[perm], alive[perm])
    args = _port_args(tp) + (ts,)
    got = neighbor_forces_pallas(_t(pos[perm]), _t(vel[perm]), _t(alive[perm]), *args)
    assert int(got.overflow) == int(ref.overflow) >= 4
    # Cellwise sums the spring planes whether or not the scene enables them.
    _assert_sums(got, ref, fields=FIELDS if spring else
                 tuple(f for f in FIELDS if f != "spring_real"))
    assert float(got.spring_real.abs().max()) > 0 if spring else not got.spring_real.any()
    # On cell-sorted operands (as the JAX test feeds both providers) the
    # particle-order provider assigns the same ranks as the sorted one.
    sorted_args = (_t(pos), _t(vel), _t(alive))
    new = neighbor_forces_pallas_sorted(*sorted_args, _t(scid), *args)
    old = neighbor_forces_pallas(*sorted_args, *args)
    for name, a, b in zip(new._fields, new, old):
        assert torch.equal(a, b), name


def _small_dam_break(n_target=450):
    """The dam break rescaled as bench.py rescales it (capacity 512)."""
    import yaml

    raw = yaml.safe_load((REPO / "configs" / "dam_break.yaml").read_text())
    area = (0.42 - 0.02) * (0.98 - 0.10)
    spacing = float(np.sqrt(area / n_target))
    raw["world"]["initial_particles"][0]["block"]["spacing"] = spacing
    raw["world"]["coefficients"]["particle_radius"] = spacing * 0.55
    raw["world"]["coefficients"]["max_particles"] = int(n_target * 1.05)
    return raw


def test_dam_break_trajectory_matches_jax():
    """20 ticks of a ~450-particle dam break through both Crates on the
    slot-grid backend (M=8, collider noise on): uid-aligned positions and
    velocities at tests/test_torch_step.py's tolerance, and the same
    counters."""
    raw = _small_dam_break()
    kw = dict(forces_mode="pallas", cell_capacity=8)
    jc = JaxCrate(jax_load_config_dict(copy.deepcopy(raw)).world_config, **kw)
    tc = Crate(load_config_dict(copy.deepcopy(raw)).world_config, device="cpu", **kw)
    assert tc.scene.capacity == jc.scene.capacity <= 512
    assert (tc.scene.fold_pairs, tc.scene.pmajor_symm) == (False, False)
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
    assert int(tdiag.non_finite) == 0


def test_grid_wrappers_reject_bad_inputs():
    """Tensors neither on the CPU nor on a CUDA device raise; so do grids and
    cell capacities past the noise hash's strides and a slab of the wrong
    shape."""
    meta = torch.zeros((4, 6, 8, 128), device="meta")
    z = torch.zeros(())
    rs = torch.zeros(5, dtype=torch.int32)
    with pytest.raises(ValueError):
        tpk.pair_pass_b(meta, meta, z, z, z, z, z, z, z)
    with pytest.raises(ValueError):
        tpl.place_grid(torch.zeros((8, 1152), device="meta"), None, 8, 3, 4, 128)
    with pytest.raises(ValueError):
        tpk.pair_pass_a(torch.zeros((8, 1152)), rs, 17, 3, z, z, z)
    with pytest.raises(ValueError):
        tpk.pair_pass_b(torch.zeros((4, 6, 17, 128)), torch.zeros((4, 6, 17, 128)),
                        z, z, z, z, z, z, z)
    with pytest.raises(ValueError):
        tpk.pair_pass_b_emit(torch.zeros((4, 1152)), torch.zeros((4, 1152)), rs, 8, 3,
                             z, z, z, z, z, z, z)
