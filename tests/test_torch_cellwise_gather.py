"""The port's cell-grid ("cellwise") and neighbor-list ("gather") backends
against the JAX package's.

The same inputs, made with numpy from a seed, go through both packages'
``cellwise.neighbor_forces_cellwise`` (and ``_sorted``), ``pass_a_on_grid``
/ ``pass_b_on_grid`` on one padded grid, and ``physics.neighbor_forces_
gather`` with the collider noise off (the port draws the gather's noise from
its generator, JAX from its key): the same arithmetic op for op, so float
fields agree at 1e-5 (plus 1e-5 of the field's largest magnitude), neighbor
counts and the overflow exactly.  The gather is also held against the
port's cellwise below the 20-neighbor cap at the suite's PairSums tolerance
(3e-3, tests/test_pmajor.py:53), their sums being ordered differently.
Then one tick of each backend through both packages' step, noise off.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sand_crate_tpu import cellwise as jcw
from sand_crate_tpu import load_config_dict as jax_load_config_dict
from sand_crate_tpu import physics as jphys
from sand_crate_tpu.engine import Crate as JaxCrate
from sand_crate_tpu_torch import cellwise as tcw
from sand_crate_tpu_torch import load_config_dict
from sand_crate_tpu_torch.engine import Crate
from sand_crate_tpu_torch.physics import neighbor_forces_gather
from test_torch_dense_chunked import BODIES, FLOAT_FIELDS, _assert_sums, _coefs, _random, _scenes

torch.set_num_threads(1)


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _noise(seed, P, diam):
    return ((np.random.default_rng(seed).random((P, 2)) - 0.5) * diam * 0.1).astype(np.float32)


def _cluster(seed, P, diam):
    """P particles within about two diameters: cells far over a capacity of 4."""
    rng = np.random.default_rng(seed)
    pos = (0.5 + (rng.random((P, 2)) - 0.5) * 2.5 * diam).astype(np.float32)
    return pos, (rng.random((P, 2)) - 0.5).astype(np.float32), np.ones(P, bool)


def _sorted_by_cell(ts, pos, vel, alive, noise):
    cid = tcw.cell_ids_grid(*_t(pos, alive), ts).numpy()
    order = np.argsort(cid, kind="stable")
    return cid[order], pos[order], vel[order], alive[order], noise[order]


@pytest.mark.parametrize("spring", [False, True])
@pytest.mark.parametrize("case", ["cloud", "over_capacity"])
def test_cellwise_matches_jax(spring, case):
    """Both entry points, particle order and pre-sorted, on a random cloud
    with a dead share and collider noise (M 16, no overflow), and on a
    cluster over a capacity of 4, where over-cap particles read their
    rank % M cellmate's sums; the sorted entry returns the particle-order
    sums permuted."""
    M = 16 if case == "cloud" else 4
    (js, jp), (ts, tp) = _scenes(512, "cellwise", enable_spring=spring, cell_capacity=M)
    diam = float(np.asarray(jp.diameter))
    if case == "cloud":
        pos, vel, alive = _random(21, 512, p_alive=0.9)
    else:
        pos, vel, alive = _cluster(22, 512, diam)
    noise = _noise(23, 512, diam)
    ref = jcw.neighbor_forces_cellwise(*_j(pos, vel, alive, noise), *_coefs(jp), js)
    got = tcw.neighbor_forces_cellwise(*_t(pos, vel, alive, noise), *_coefs(tp), ts)
    _assert_sums(got, ref)
    assert float(got.nbr_cnt.max()) >= 4
    assert (int(got.overflow) > 0) == (case == "over_capacity")

    sorted_cid, *ops = _sorted_by_cell(ts, pos, vel, alive, noise)
    ref_s = jcw.neighbor_forces_cellwise_sorted(*_j(*ops[:3], sorted_cid, ops[3]),
                                                *_coefs(jp), js)
    got_s = tcw.neighbor_forces_cellwise_sorted(*_t(*ops[:3], sorted_cid, ops[3]),
                                                *_coefs(tp), ts)
    _assert_sums(got_s, ref_s)
    order = np.argsort(tcw.cell_ids_grid(*_t(pos, alive), ts).numpy(), kind="stable")
    for name in FLOAT_FIELDS + ("nbr_cnt",):
        assert torch.equal(getattr(got_s, name), getattr(got, name)[order]), name


def test_grid_passes_match_jax():
    """pass_a_on_grid, pad_ps_grid and pass_b_on_grid on one padded grid
    (the JAX build_padded_grid's, handed to both as numpy): the same
    per-slot sums, and the same cell-major slots from build_padded_grid."""
    (js, jp), (ts, tp) = _scenes(512, "cellwise", enable_spring=True)
    diam = float(np.asarray(jp.diameter))
    pos, vel, alive = _random(24, 512, p_alive=0.9)
    noise = _noise(25, 512, diam)
    jgrid, jpslot, jover = jcw.build_padded_grid(*_j(pos, vel, alive, noise), js)
    tgrid, tpslot, tover = tcw.build_padded_grid(*_t(pos, vel, alive, noise), ts)
    np.testing.assert_array_equal(tgrid.numpy(), np.asarray(jgrid))
    np.testing.assert_array_equal(tpslot.numpy(), np.asarray(jpslot))
    assert int(tover) == int(jover) == 0

    grid = np.array(jgrid)
    d, ss, tpr, ip, sob = _coefs(jp)
    ref_a = jcw.pass_a_on_grid(jnp.asarray(grid), d, ip)
    got_a = tcw.pass_a_on_grid(torch.as_tensor(grid), *(_coefs(tp)[i] for i in (0, 3)))
    for name, g, r in zip(("cp", "s_acc", "cnt"), got_a, ref_a):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-5,
                                   atol=1e-5 * max(float(np.abs(r).max()), 1.0), err_msg=name)
    assert float(got_a[2].max()) >= 4
    # Pass B on the JAX pass A's outputs, so that each pass is held alone.
    cp, s_acc, cnt = (np.asarray(r) for r in ref_a)
    ps = np.asarray(jcw.pad_ps_grid(*_j(cp, s_acc)))
    np.testing.assert_array_equal(tcw.pad_ps_grid(*_t(cp, s_acc)).numpy(), ps)
    ref_b = np.asarray(jcw.pass_b_on_grid(*_j(grid, ps, cp, s_acc, cnt), d, ss, tpr, sob))
    t = _coefs(tp)
    got_b = tcw.pass_b_on_grid(*_t(grid, ps, cp, s_acc, cnt), t[0], t[1], t[2], t[4]).numpy()
    assert got_b.shape == ref_b.shape and not got_b[-1].any()
    for col in range(10):
        r = ref_b[:, col]
        np.testing.assert_allclose(got_b[:, col], r, rtol=1e-5,
                                   atol=1e-5 * max(float(np.abs(r).max()), 1.0), err_msg=col)


def test_gather_matches_jax_and_cellwise():
    """The gather at noise 0 equals the JAX gather (its K = 20 lists), and
    below the cap, where the lists hold every neighbor, the port's own
    cellwise sums within the suite's PairSums tolerance."""
    (js, jp), (ts, tp) = _scenes(512, "gather")
    jp = jp._replace(collider_noise_level=jnp.float32(0.0))
    tp = tp._replace(collider_noise_level=torch.tensor(0.0))
    pos, vel, alive = _random(26, 512, span=0.15, p_alive=0.9)
    ref = jphys.neighbor_forces_gather(*_j(pos, vel, alive), jax.random.key(0), jp, js)
    gen = torch.Generator().manual_seed(0)
    got = neighbor_forces_gather(*_t(pos, vel, alive), gen, tp, ts)
    _assert_sums(got, ref)
    assert 4 <= float(got.nbr_cnt.max()) < ts.max_neighbors

    cell = tcw.neighbor_forces_cellwise(*_t(pos, vel, alive), torch.zeros(512, 2),
                                        *_coefs(tp), ts)
    assert torch.equal(cell.nbr_cnt, got.nbr_cnt)
    for name in FLOAT_FIELDS:
        torch.testing.assert_close(getattr(got, name), getattr(cell, name), rtol=3e-3, atol=3e-3)


@pytest.mark.parametrize("mode", ["cellwise", "gather"])
def test_step_matches_jax(mode):
    """One tick of the bodies world (every body kind, ~780 particles),
    noise off, through both packages' Crates: uid-aligned positions and
    velocities at tests/test_pmajor.py:371-374's tolerance, the same alive
    set, overflow and non-finite count; gather keeps slot order."""
    raw = copy.deepcopy(BODIES)
    raw["world"]["coefficients"]["collider_noise_level"] = 0.0
    jc = JaxCrate(jax_load_config_dict(copy.deepcopy(raw)).world_config, forces_mode=mode)
    tc = Crate(load_config_dict(copy.deepcopy(raw)).world_config, forces_mode=mode,
               device="cpu")
    jstate, jdiag = jphys.step(jc.state, jc.params, jc.scene)
    tdiag = tc.run(1)
    tstate = tc.state
    ia = np.argsort(np.asarray(jstate.uid))
    ib = np.argsort(tstate.uid.numpy())
    alive = np.asarray(jstate.alive)[ia]
    assert alive.sum() > 700
    np.testing.assert_array_equal(tstate.alive.numpy()[ib], alive)
    for name in ("pos", "vel"):
        np.testing.assert_allclose(
            getattr(tstate, name).numpy()[ib][alive],
            np.asarray(getattr(jstate, name))[ia][alive],
            rtol=2e-3, atol=2e-4, err_msg=name,
        )
    for name in ("particle_count", "neighbor_overflow", "non_finite"):
        assert int(getattr(tdiag, name)) == int(getattr(jdiag, name)), name
    if mode == "gather":
        assert torch.equal(tstate.uid, torch.arange(tc.scene.capacity, dtype=torch.int32))

