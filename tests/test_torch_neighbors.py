"""The port's neighbor search (``neighbors.py``) against the JAX package's:
the twins of tests/test_neighbors.py's seven tests.

Each builds its points with numpy and runs both packages' ``neighbor_list``
(or ``cell_ids`` / ``build_cell_table``) on them: the neighbor *sets* per
particle, the masks' counts and the overflow must be equal, and the test's
own property must hold for the port.  The points have no ties at the K-th
nearest distance, where ``torch.topk`` and ``lax.top_k`` may order equal
scores differently.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sand_crate_tpu.neighbors import build_cell_table as jax_build_cell_table
from sand_crate_tpu.neighbors import cell_ids as jax_cell_ids
from sand_crate_tpu.neighbors import neighbor_list as jax_neighbor_list
from sand_crate_tpu_torch.neighbors import build_cell_table, cell_ids, neighbor_list
from sand_crate_tpu_torch.state import Scene
from test_neighbors import make_scene as make_jax_scene

torch.set_num_threads(1)


def make_scene(capacity, cell_size, max_neighbors=20, cell_capacity=16, extent=40.0):
    """The port's twin of test_neighbors.make_scene, on the CPU."""
    nx = int(np.ceil(extent / cell_size)) + 3
    z = torch.zeros
    return Scene(
        segments0=z((1, 2, 2)),
        seg_body=z((1,), dtype=torch.int64),
        seg_valid=z((1,), dtype=torch.bool),
        body_kind=z((1,), dtype=torch.int32),
        body_center=z((1, 2)),
        motor_lin=z((1, 2, 4)),
        motor_ang=z((1, 4)),
        init_lin_vel=z((1, 2)),
        init_ang_vel=z((1,)),
        src_position=z((1, 2)),
        src_velocity=z((1, 2)),
        src_radius=z((1,)),
        src_flow=z((1,)),
        src_noise=z((1,)),
        src_active_ticks=z((1,), dtype=torch.int32),
        capacity=capacity,
        num_bodies=1,
        num_sources=0,
        max_neighbors=max_neighbors,
        cell_size=float(cell_size),
        grid_nx=nx,
        grid_ny=nx,
        cell_capacity=cell_capacity,
        max_spawn=8,
    )


def _sets(idx, mask):
    return [set(idx[i][mask[i]].tolist()) for i in range(len(idx))]


def neighbors_of(pos, diameter, alive=None, **kwargs):
    """The port's neighbor sets and overflow, held equal to the JAX
    package's on the same points."""
    pos = np.asarray(pos, np.float32)
    n = len(pos)
    alive = np.ones(n, bool) if alive is None else np.asarray(alive)
    nbr = neighbor_list(torch.as_tensor(pos), torch.as_tensor(alive),
                        torch.tensor(diameter, dtype=torch.float32),
                        make_scene(n, cell_size=diameter, **kwargs))
    ref = jax_neighbor_list(jnp.asarray(pos), jnp.asarray(alive),
                            jnp.asarray(diameter, jnp.float32),
                            make_jax_scene(n, cell_size=diameter, **kwargs))
    got_sets = _sets(nbr.idx.numpy(), nbr.mask.numpy())
    assert got_sets == _sets(np.asarray(ref.idx), np.asarray(ref.mask))
    np.testing.assert_array_equal(nbr.mask.numpy().sum(1), np.asarray(ref.mask).sum(1))
    # Invalid entries point at the particle itself, as in JAX.
    idx, mask = nbr.idx.numpy(), nbr.mask.numpy()
    assert (idx[~mask] == np.nonzero(~mask)[0]).all()
    assert int(nbr.overflow) == int(ref.overflow)
    return got_sets, int(nbr.overflow)


@pytest.mark.parametrize("diameter,min_n,max_n", [(0.5, 0, 0), (1.0, 1, 2), (2.0, 2, 4)])
def test_row_neighbors(diameter, min_n, max_n):
    """Particles on an integer row (reference tests/test_distance.py:38-48)."""
    pos = np.array([[i, 0.0] for i in range(35)])
    nbrs, overflow = neighbors_of(pos, diameter)
    assert overflow == 0
    counts = [len(s) for s in nbrs]
    assert min(counts) == min_n and max(counts) == max_n
    for i, s in enumerate(nbrs):
        for j in s:
            assert abs(i - j) <= diameter


@pytest.mark.parametrize("diameter,min_n,max_n", [(0.5, 0, 0), (1.0, 2, 4), (2.0, 5, 12)])
def test_grid_neighbors(diameter, min_n, max_n):
    """Integer grid (reference tests/test_distance.py:51-58)."""
    side = 12
    pos = np.array(list(itertools.product(range(side), range(side))), float)
    nbrs, overflow = neighbors_of(pos, diameter)
    assert overflow == 0
    counts = [len(s) for s in nbrs]
    assert min(counts) == min_n and max(counts) == max_n


def test_random_points_match_bruteforce():
    """Every within-diameter pair found, none beyond (stronger than the
    reference's 3x-diameter envelope check, tests/test_distance.py:61-70)."""
    rng = np.random.default_rng(0)
    pos = rng.random((200, 2)).astype(np.float32)
    diameter = 0.1
    nbrs, _ = neighbors_of(pos, diameter, cell_capacity=64)
    d = np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)
    expect = (d <= diameter) & ~np.eye(len(pos), dtype=bool)
    for i in range(len(pos)):
        want = set(np.where(expect[i])[0].tolist())
        if len(want) <= 20:
            assert nbrs[i] == want, i
        else:  # capped: the K kept must all be true neighbors
            assert nbrs[i] <= want and len(nbrs[i]) == 20


def test_symmetry_below_cap():
    rng = np.random.default_rng(1)
    pos = rng.random((100, 2)).astype(np.float32)
    nbrs, _ = neighbors_of(pos, 0.08, cell_capacity=64)
    for i, s in enumerate(nbrs):
        for j in s:
            assert i in nbrs[j]


def test_dead_particles_excluded():
    pos = np.array([[0.5, 0.5], [0.505, 0.5], [0.51, 0.5]], np.float32)
    nbrs, _ = neighbors_of(pos, 0.02, alive=[True, False, True], extent=1.0)
    assert nbrs[0] == {2}
    assert nbrs[1] == set()  # a dead particle has no neighbors itself


def test_overflow_counting():
    """More coincident particles than the cell capacity: overflow counted,
    and the table holds the first four (in index order) in that cell."""
    pos = np.full((10, 2), 0.5, np.float32)
    alive = np.ones(10, bool)
    scene = make_scene(10, cell_size=0.1, cell_capacity=4, extent=1.0)
    cid = cell_ids(torch.as_tensor(pos), torch.as_tensor(alive), scene)
    table, overflow = build_cell_table(cid, scene)
    jscene = make_jax_scene(10, cell_size=0.1, cell_capacity=4, extent=1.0)
    jcid = jax_cell_ids(jnp.asarray(pos), jnp.asarray(alive), jscene)
    jtable, joverflow = jax_build_cell_table(jcid, jscene)
    np.testing.assert_array_equal(cid.numpy(), np.asarray(jcid))
    np.testing.assert_array_equal(table.numpy(), np.asarray(jtable))
    assert int(overflow) == int(joverflow) == 6
    assert table[int(cid[0])].tolist() == [0, 1, 2, 3]


def test_nearest_kept_when_capped():
    """With K smaller than the true neighbor count, the nearest are kept."""
    pos = np.array([[0.5 + 0.001 * i, 0.5] for i in range(10)], np.float32)
    nbrs, _ = neighbors_of(pos, 0.05, max_neighbors=3, cell_capacity=16, extent=1.0)
    assert nbrs[0] == {1, 2, 3}  # the three closest to particle 0
