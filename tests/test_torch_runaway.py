"""The cause of the 1M dam break's p-major runaways (chip_smoke phase (l),
ROADMAP queue 3), on the CPU against the JAX package.

Both packages' hard-wall fix moves every particle near both walls of a
corner onto one point, so a pile forms in the corner cell; on such a pile
the exact pair set (p-major, in both packages, and cellwise with room for
the pile) gives pressures and kicks several times those of a grid of 16
slots a cell, which clips the pile.
"""

import copy

import jax.numpy as jnp
import numpy as np
import torch

from bench import dam_break_world as jax_dam_break_world
from sand_crate_tpu import cellwise as jcw
from sand_crate_tpu import load_config_dict as jax_load_config_dict
from sand_crate_tpu import physics as jphys
from sand_crate_tpu.ops import pmajor as jpm
from sand_crate_tpu.scene import build_scene as jax_build_scene
from sand_crate_tpu.state import Params as JaxParams
from sand_crate_tpu_torch import cellwise as tcw
from sand_crate_tpu_torch import load_config_dict
from sand_crate_tpu_torch.bench import dam_break_world
from sand_crate_tpu_torch.ops import pmajor as tpm
from sand_crate_tpu_torch.physics import _ghost_core
from sand_crate_tpu_torch.scene import build_scene
from sand_crate_tpu_torch.state import Params
from test_torch_cellwise_gather import _j, _t
from test_torch_dense_chunked import BODIES, FLOAT_FIELDS, _assert_sums, _coefs

torch.set_num_threads(1)


def test_corner_pile_exact_vs_capped_sums():
    """The 1M dam break's runaways (chip_smoke phase (l)) come from a pile of
    particles in the box's corner cell, which every backend forms; the
    exact pair set (p-major) sums the whole pile, a cell capacity clips it.
    On a pile of 60 particles in one cell among 120 others, noise off: the
    port's p-major equals the JAX package's p-major (its Pallas kernel in
    interpret mode), and the port's cellwise equals p-major when its
    capacity holds the pile (64 slots); at 16 slots, as the slot-grid and
    cell-grid backends run at 1M, both packages' cellwise agree with each
    other and the pile's pressure and tension shrink several fold."""
    raw = copy.deepcopy(BODIES)
    raw["world"]["coefficients"]["particle_radius"] = 0.05  # 13 x 16 cells
    raw["world"]["coefficients"]["collider_noise_level"] = 0.0
    jworld = jax_load_config_dict(copy.deepcopy(raw)).world_config
    tworld = load_config_dict(copy.deepcopy(raw)).world_config
    jscenes, tscenes = {}, {}
    for mode, M in (("pmajor", 16), ("cellwise", 16), ("cellwise", 64)):
        jscenes[mode, M] = jax_build_scene(jworld, capacity=256, forces_mode=mode, cell_capacity=M)
        tscenes[mode, M] = build_scene(tworld, capacity=256, forces_mode=mode, cell_capacity=M,
                                       device="cpu")
    jp = JaxParams.from_coefficients(jworld.coefficients)
    tp = Params.from_coefficients(tworld.coefficients, "cpu")
    rng = np.random.default_rng(31)
    pile = 0.012 + rng.random((60, 2)) * 0.07  # one 0.1-wide cell at the corner
    around = 0.1 + rng.random((120, 2)) * 0.5
    pos = np.concatenate([pile, around]).astype(np.float32)
    pos = np.concatenate([pos, np.zeros((256 - len(pos), 2), np.float32)])
    vel = ((rng.random((256, 2)) - 0.5) * 0.1).astype(np.float32)
    alive = np.arange(256) < 180
    zero = np.zeros((256, 2), np.float32)

    jargs = (*_j(pos, vel, alive), jnp.float32(0.0), jnp.int32(0), *_coefs(jp))
    targs = (*_t(pos, vel, alive), torch.tensor(0.0), torch.tensor(0, dtype=torch.int32),
             *_coefs(tp))
    ref = jpm.neighbor_forces_pmajor(*jargs, jscenes["pmajor", 16])
    exact = tpm.neighbor_forces_pmajor(*targs, tscenes["pmajor", 16])
    _assert_sums(exact, ref, tol=3e-3)
    assert int(exact.nbr_cnt[:60].min()) >= 59  # the pile sees itself whole

    wide = tcw.neighbor_forces_cellwise(*_t(pos, vel, alive, zero), *_coefs(tp),
                                        tscenes["cellwise", 64])
    assert int(wide.overflow) == 0 and torch.equal(wide.nbr_cnt, exact.nbr_cnt)
    for name in ("p_i", "dv_tension", "pressure_real", "visc_vsum"):  # spring off
        torch.testing.assert_close(getattr(wide, name), getattr(exact, name), rtol=3e-3,
                                   atol=3e-3 * float(getattr(exact, name).abs().max()))

    capped = tcw.neighbor_forces_cellwise(*_t(pos, vel, alive, zero), *_coefs(tp),
                                          tscenes["cellwise", 16])
    _assert_sums(capped, jcw.neighbor_forces_cellwise(*_j(pos, vel, alive, zero), *_coefs(jp),
                                                      jscenes["cellwise", 16]))
    assert int(capped.overflow) == 60 - 16
    for name, ratio in (("p_i", 2.0), ("dv_tension", 3.0)):
        e = getattr(exact, name)[:60].abs().max()
        c = getattr(capped, name)[:60].abs().max()
        assert float(e) > ratio * float(c), (name, float(e), float(c))


def test_corner_hard_wall_fix_piles_particles_in_both_packages():
    """Why the 1M dam break forms a corner pile on every backend: the hard
    wall projection (reference crate.py:202-211) moves a particle within one
    radius of both walls of a corner to one radius from each, so every such
    particle lands on the same point.  Both packages' ghost phase map 64
    particles of the 1M world's bottom-left corner onto one point."""
    jworld, tworld = jax_dam_break_world(1_000_000), dam_break_world(1_000_000)
    js = jax_build_scene(jworld, capacity=128, forces_mode="pmajor")
    ts = build_scene(tworld, capacity=128, forces_mode="pmajor", device="cpu")
    jp = JaxParams.from_coefficients(jworld.coefficients)
    tp = Params.from_coefficients(tworld.coefficients, "cpu")
    r = float(tp.particle_radius)
    rng = np.random.default_rng(41)
    pos = np.stack([rng.uniform(0.05, 0.95, 64) * r,
                    1.0 - rng.uniform(0.05, 0.95, 64) * r], -1).astype(np.float32)
    pos = np.concatenate([pos, np.full((64, 2), 0.5, np.float32)])
    alive = np.ones(128, bool)
    ref = jphys._ghost_core(*_j(pos, alive), js.segments0, js.init_lin_vel, js.init_ang_vel,
                            jp, js)
    got = _ghost_core(*_t(pos, alive), ts.segments0, ts.init_lin_vel, ts.init_ang_vel, tp, ts)
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(ref.pos), rtol=0, atol=1e-7)
    corner = got.pos[:64].double()
    assert float((corner - corner.mean(dim=0)).abs().max()) < 1e-6
    np.testing.assert_allclose(corner.mean(dim=0).numpy(), [r, 1.0 - r], atol=1e-6)
