"""Pair-sum container, cell ids, slot bookkeeping, the cell-grid pair
scheme and the dense all-pairs backend: the counterpart of
``sand_crate_tpu/cellwise.py`` in plain torch.

The cell-grid scheme (``forces_mode="cellwise"``) places every alive
particle into a slot of a padded (ny + 2, nx + 2, M, 7) cell-major grid
(M = ``scene.cell_capacity``), then for each of the 9 stencil offsets
sums every self slot against every slot of the neighbor cell as dense
(ny, nx, M, M) planes, with no per-pair gather: pass A gives pressure,
surface normals and counts, pass B the tension, pressure, spring and
viscosity sums.  Particles past a cell's capacity hold no slot; they read
their rank % M cellmate's sums and are counted in the overflow.  The
collider noise is one (P, 2) jitter per particle, drawn by the caller.
``pass_a_on_grid`` / ``pad_ps_grid`` / ``pass_b_on_grid`` keep the JAX
names and arguments, so a caller that fills the pad ring with another
band's edge rows (the JAX spatial engine's halo) can call them alike.

The dense backend here (:func:`neighbor_forces_dense`, passes
:func:`dense_pass_a` and :func:`dense_pass_b`) is the plain twin of the
dense pair kernels (D1, ``csrc/pair_batch.cu``); the tick calls
``ops/pair_batch.neighbor_forces_dense``, which launches them on the card."""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .state import Scene

EPS = 1e-12


class PairSums(NamedTuple):
    """Per-particle neighbor-interaction accumulators consumed by step().

    All reductions are over the particle's within-diameter neighbor set,
    matching the per-particle loops of the reference crate.py:261-358.
    """

    p_i: torch.Tensor  # (P,)  particle pressure (crate.py:261-275)
    dv_tension: torch.Tensor  # (P,2) surface-tension kick, dt applied by step()
    pressure_real: torch.Tensor  # (P,2) sum m*(p_i+p_j)*nhat  (crate.py:301-303)
    spring_real: torch.Tensor  # (P,2) sum m*(balance-w)*nhat  (crate.py:330-332)
    visc_vsum: torch.Tensor  # (P,2) sum m*v_j_snapshot       (crate.py:322)
    nbr_cnt: torch.Tensor  # (P,)  neighbor count
    overflow: torch.Tensor  # ()    int32 particles past a cell's slot capacity


def cell_ids_grid(pos: torch.Tensor, alive: torch.Tensor, scene: Scene) -> torch.Tensor:
    """Flat row-major cell id per particle (int32); dead -> the NC sentinel."""
    nx, ny = scene.grid_nx, scene.grid_ny
    c = torch.floor(pos / scene.cell_size).to(torch.int32) + 1
    cx = torch.clamp(c[:, 0], 0, nx - 1)
    cy = torch.clamp(c[:, 1], 0, ny - 1)
    return torch.where(alive, cy * nx + cx, nx * ny).to(torch.int32)


def slot_assignment(sorted_cid: torch.Tensor, M: int, NC: int):
    """Slot bookkeeping over cell-sorted ids (the JAX ``slot_assignment``).

    Returns (rank, in_cap, slot_sorted, gather_slot, overflow), all int32
    but ``in_cap`` (bool): ``rank`` is the particle's place in its cell's
    run; ``slot_sorted`` the flat ``cell * M + rank`` grid slot (NC * M when
    dead or over capacity); ``gather_slot`` where the particle reads its
    pair sums — an over-cap particle reads its cell's slot ``rank % M``, a
    cellmate's, rather than zeros; ``overflow`` counts the over-cap alive
    particles.  The rank is the distance to the cell's run start, found by
    searching each id in the sorted ids (the JAX package takes a running
    max over run starts; torch's cummax scan took 2.6 ms a tick at 1M
    particles on an H100, profile_tick.py)."""
    P = sorted_cid.shape[0]
    iota = torch.arange(P, dtype=torch.int32, device=sorted_cid.device)
    run_start = torch.searchsorted(sorted_cid, sorted_cid, out_int32=True)
    rank = iota - run_start
    alive = sorted_cid < NC
    in_cap = (rank < M) & alive
    over = (rank >= M) & alive
    overflow = over.sum(dtype=torch.int32)
    slot_sorted = torch.where(in_cap, sorted_cid * M + rank, NC * M)
    gather_slot = torch.where(
        in_cap, slot_sorted, torch.where(over, sorted_cid * M + rank % M, NC * M)
    )
    return rank, in_cap, slot_sorted.to(torch.int32), gather_slot.to(torch.int32), overflow


def cell_slots(pos: torch.Tensor, alive: torch.Tensor, scene: Scene):
    """(order, slot_sorted, pslot, overflow): the cell-major slot of every
    particle in particle order (the JAX ``cell_slots``).  ``order`` is the
    stable cell-id sort, ``slot_sorted`` the grid slot of the k-th sorted
    particle (NC * M when it holds none), ``pslot`` where particle i reads
    its pair sums (over-cap particles: their rank % M cellmate's slot)."""
    P = pos.shape[0]
    M = scene.cell_capacity
    NC = scene.num_cells
    cid = cell_ids_grid(pos, alive, scene)
    sorted_cid, order = torch.sort(cid, stable=True)
    _, _, slot_sorted, gather_slot, overflow = slot_assignment(sorted_cid, M, NC)
    pslot = torch.full((P,), NC * M, dtype=torch.int32, device=pos.device)
    pslot[order] = gather_slot
    return order, slot_sorted, pslot, overflow


def _grid_geometry(grid: torch.Tensor, diameter: torch.Tensor):
    """((ny, nx, M), views, pair_geometry) of a padded cell-major grid, shared
    by both passes.  ``views(g, dy, dx)`` is the (ny, nx, ...) block of the
    cells one stencil offset away; ``pair_geometry(nb, dy, dx)`` gives the
    (ny, nx, M_self, M_nb) planes of that offset: the pair mask (as floats),
    the noisy unit direction's x and y, and the overlap weight w.  The mask
    uses the exact positions (columns 0-1), the direction and w the
    neighbor's jittered position (columns 2-3)."""
    nyp, nxp, M = grid.shape[0], grid.shape[1], grid.shape[2]
    ny, nx = nyp - 2, nxp - 2
    dtype = grid.dtype
    cx = grid[1:-1, 1:-1, :, 0, None]
    cy = grid[1:-1, 1:-1, :, 1, None]
    calive = grid[1:-1, 1:-1, :, 6, None] > 0
    not_self = ~torch.eye(M, dtype=torch.bool, device=grid.device)
    diam = torch.clamp(diameter, min=EPS)

    def views(g, dy, dx):
        return g[1 + dy: 1 + dy + ny, 1 + dx: 1 + dx + nx]

    def pair_geometry(nb, dy, dx):
        rx = cx - nb[:, :, None, :, 0]
        ry = cy - nb[:, :, None, :, 1]
        d2 = rx * rx + ry * ry
        del rx, ry
        mb = (d2 <= diam * diam) & calive & (nb[:, :, None, :, 6] > 0)
        del d2
        if dy == 0 and dx == 0:
            mb &= not_self
        nhx = cx - nb[:, :, None, :, 2]
        nhy = cy - nb[:, :, None, :, 3]
        dist = torch.sqrt(torch.clamp(nhx * nhx + nhy * nhy, min=0.0))
        den = torch.clamp(dist, min=EPS)
        nhx = nhx / den
        nhy = nhy / den
        del den
        w = torch.where(mb, 1.0 - torch.clamp(dist / diam, 0.0, 1.0), 0.0)
        return mb.to(dtype), nhx, nhy, w

    return (ny, nx, M), views, pair_geometry


OFFSETS = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]


def pass_a_on_grid(grid: torch.Tensor, diameter: torch.Tensor, ignored_pressure: torch.Tensor):
    """Pass A on a padded grid: (cp, s_acc, cnt), shaped (ny, nx, M),
    (ny, nx, M, 2) and (ny, nx, M).  Each offset's planes are dropped before
    the next offset's are built (at the 1M dam break one plane is 2.4 GB)."""
    (ny, nx, M), views, pair_geometry = _grid_geometry(grid, diameter)
    zeros = grid.new_zeros((ny, nx, M))
    w_sum, sx, sy, cnt = zeros, zeros, zeros, zeros
    for dy, dx in OFFSETS:
        m, nhx, nhy, w = pair_geometry(views(grid, dy, dx), dy, dx)
        w_sum = w_sum + w.sum(dim=3)
        coeff = (1.0 - w) * w
        del w
        sx = sx + (coeff * nhx).sum(dim=3)
        sy = sy + (coeff * nhy).sum(dim=3)
        del coeff, nhx, nhy
        cnt = cnt + m.sum(dim=3)
        del m
    cp = torch.where(cnt > 0, torch.clamp(w_sum - ignored_pressure, min=0.0), 0.0)
    return cp, torch.stack([sx, sy], dim=-1), cnt


def pad_ps_grid(cp: torch.Tensor, s_acc: torch.Tensor) -> torch.Tensor:
    """Padded (ny + 2, nx + 2, M, 3) [p | s] neighbor operand of pass B; the
    pad ring is zero (a caller may fill it with a neighbor band's rows)."""
    return F.pad(torch.cat([cp[..., None], s_acc], dim=-1), (0, 0, 0, 0, 1, 1, 1, 1))


def pass_b_on_grid(
    grid: torch.Tensor,
    ps_grid: torch.Tensor,  # (ny + 2, nx + 2, M, 3) from pad_ps_grid
    cp: torch.Tensor,
    s_acc: torch.Tensor,
    cnt: torch.Tensor,
    diameter: torch.Tensor,
    surface_smoothing: torch.Tensor,
    target_pressure: torch.Tensor,
    spring_overlap_balance: torch.Tensor,
) -> torch.Tensor:
    """Pass B: the packed per-slot results, (ny * nx * M + 1, 10) in PairSums
    order (p, dv_tension, pressure_real, spring_real, visc_vsum, count),
    with a trailing zero row that dead particles read."""
    (ny, nx, M), views, pair_geometry = _grid_geometry(grid, diameter)
    cps = cp[..., :, None]
    sxs = s_acc[..., 0, None]
    sys_ = s_acc[..., 1, None]
    # dv_tension, pressure_real, spring_real, visc_vsum: x and y each
    acc = [grid.new_zeros((ny, nx, M)) for _ in range(8)]

    def add(i, term):
        acc[i] = acc[i] + term.sum(dim=3)

    for dy, dx in OFFSETS:
        nb = views(grid, dy, dx)
        m, nhx, nhy, w = pair_geometry(nb, dy, dx)
        nb_ps = views(ps_grid, dy, dx)
        p_nb = nb_ps[:, :, None, :, 0]
        align = ((sxs - nb_ps[:, :, None, :, 1]) * nhx
                 + (sys_ - nb_ps[:, :, None, :, 2]) * nhy) * surface_smoothing
        t = m * (align + (p_nb + cps - 2.0 * target_pressure))
        del align
        add(0, t * nhx)
        add(1, t * nhy)
        t = m * (cps + p_nb)
        add(2, t * nhx)
        add(3, t * nhy)
        t = m * (spring_overlap_balance - w)
        del w
        add(4, t * nhx)
        add(5, t * nhy)
        del t, nhx, nhy
        add(6, m * nb[:, :, None, :, 4])
        add(7, m * nb[:, :, None, :, 5])
        del m
    packed = torch.stack([cp, *acc, cnt], dim=-1).reshape(ny * nx * M, 10)
    return torch.cat([packed, packed.new_zeros((1, 10))])


def pair_passes_on_grid(
    grid: torch.Tensor,  # (ny + 2, nx + 2, M, 7) padded cell-major particle grid
    diameter: torch.Tensor,
    surface_smoothing: torch.Tensor,
    target_pressure: torch.Tensor,
    ignored_pressure: torch.Tensor,
    spring_overlap_balance: torch.Tensor,
) -> torch.Tensor:
    """Both pair passes on a padded grid of one device (the ps pad ring
    stays zero: nothing lies beyond the domain walls)."""
    cp, s_acc, cnt = pass_a_on_grid(grid, diameter, ignored_pressure)
    return pass_b_on_grid(grid, pad_ps_grid(cp, s_acc), cp, s_acc, cnt, diameter,
                          surface_smoothing, target_pressure, spring_overlap_balance)


def _place(packed_p: torch.Tensor, slot_sorted: torch.Tensor, scene: Scene) -> torch.Tensor:
    """The padded (ny + 2, nx + 2, M, 7) grid with sorted particle k's row of
    ``packed_p`` in slot ``slot_sorted[k]``; slot NC * M is a dump row, dropped."""
    M, nx, ny = scene.cell_capacity, scene.grid_nx, scene.grid_ny
    flat = packed_p.new_zeros((ny * nx * M + 1, 7))
    flat[slot_sorted.long()] = packed_p
    return F.pad(flat[:-1].reshape(ny, nx, M, 7), (0, 0, 0, 0, 1, 1, 1, 1))


def _packed_particles(pos, vel, alive, noise):
    """(P, 7) rows [pos | pos + noise | vel | alive] placed into the grid."""
    return torch.cat([pos, pos + noise, vel, alive.to(pos.dtype)[:, None]], dim=-1)


def build_padded_grid(
    pos: torch.Tensor, vel: torch.Tensor, alive: torch.Tensor, noise: torch.Tensor, scene: Scene
):
    """(padded grid (ny + 2, nx + 2, M, 7), pslot, overflow) of particles in
    particle order."""
    order, slot_sorted, pslot, overflow = cell_slots(pos, alive, scene)
    grid = _place(_packed_particles(pos, vel, alive, noise)[order], slot_sorted, scene)
    return grid, pslot, overflow


def sums_from_packed(packed: torch.Tensor, pslot: torch.Tensor, overflow, nc_m: int) -> PairSums:
    """Each particle's row of the packed per-slot results (dead: the zero row)."""
    mine = packed[torch.clamp(pslot, max=nc_m).long()]
    return PairSums(
        p_i=mine[:, 0],
        dv_tension=mine[:, 1:3],
        pressure_real=mine[:, 3:5],
        spring_real=mine[:, 5:7],
        visc_vsum=mine[:, 7:9],
        nbr_cnt=mine[:, 9],
        overflow=overflow,
    )


def neighbor_forces_cellwise(
    pos: torch.Tensor,
    vel: torch.Tensor,
    alive: torch.Tensor,
    noise: torch.Tensor,  # (P, 2) per-particle collider jitter (may be zeros)
    diameter: torch.Tensor,
    surface_smoothing: torch.Tensor,
    target_pressure: torch.Tensor,
    ignored_pressure: torch.Tensor,
    spring_overlap_balance: torch.Tensor,
    scene: Scene,
) -> PairSums:
    """Cell-grid pair sums of particles in particle order."""
    grid, pslot, overflow = build_padded_grid(pos, vel, alive, noise, scene)
    packed = pair_passes_on_grid(grid, diameter, surface_smoothing, target_pressure,
                                 ignored_pressure, spring_overlap_balance)
    return sums_from_packed(packed, pslot, overflow, scene.num_cells * scene.cell_capacity)


def neighbor_forces_cellwise_sorted(
    pos: torch.Tensor,  # all inputs pre-sorted by cell id (sorted-state step)
    vel: torch.Tensor,
    alive: torch.Tensor,
    sorted_cid: torch.Tensor,
    noise: torch.Tensor,
    diameter: torch.Tensor,
    surface_smoothing: torch.Tensor,
    target_pressure: torch.Tensor,
    ignored_pressure: torch.Tensor,
    spring_overlap_balance: torch.Tensor,
    scene: Scene,
) -> PairSums:
    """Cell-grid pair sums over pre-sorted operands, returned in the same
    sorted order (no permutation, no inverse scatter)."""
    nc_m = scene.num_cells * scene.cell_capacity
    _, _, slot_sorted, gather_slot, overflow = slot_assignment(
        sorted_cid, scene.cell_capacity, scene.num_cells)
    grid = _place(_packed_particles(pos, vel, alive, noise), slot_sorted, scene)
    packed = pair_passes_on_grid(grid, diameter, surface_smoothing, target_pressure,
                                 ignored_pressure, spring_overlap_balance)
    return sums_from_packed(packed, gather_slot, overflow, nc_m)


def _dense_geometry(pos: torch.Tensor, alive: torch.Tensor, noise: torch.Tensor,
                    diameter: torch.Tensor):
    """The (P, P) planes of both dense passes: the pair mask (bool), the
    noisy unit direction's x and y, and the overlap weight w.  A pair (i, j)
    counts when both are alive, i != j and their distance is at most one
    diameter; its direction and weight use j's position plus ``noise[j]``.
    The weight is selected by the mask, as the JAX package's compiled step
    takes ``m * (1 - clip(..))`` (XLA rewrites a product with a converted
    mask to a select): a dead slot at a NaN position leaves ``p_i`` finite."""
    P = pos.shape[0]
    diam = torch.clamp(diameter, min=EPS)
    px, py = pos[:, 0], pos[:, 1]
    rx = px[:, None] - px[None, :]
    ry = py[:, None] - py[None, :]
    d2 = rx * rx + ry * ry
    del rx, ry
    eye = torch.eye(P, dtype=torch.bool, device=pos.device)
    mb = (d2 <= diam * diam) & alive[:, None] & alive[None, :] & ~eye
    del d2, eye
    qx = px + noise[:, 0]
    qy = py + noise[:, 1]
    nx = px[:, None] - qx[None, :]
    ny = py[:, None] - qy[None, :]
    dist = torch.sqrt(torch.clamp(nx * nx + ny * ny, min=0.0))
    den = torch.clamp(dist, min=EPS)
    nx = nx / den
    ny = ny / den
    del den
    w = torch.where(mb, 1.0 - torch.clamp(dist / diam, 0.0, 1.0), 0.0)
    return mb, nx, ny, w


def _dense_a(mb, nx, ny, w, ignored_pressure):
    """Pass A's sums from the planes -> (p_i, s, cnt)."""
    cnt = mb.to(w.dtype).sum(dim=1)
    p_i = torch.where(cnt > 0, torch.clamp(w.sum(dim=1) - ignored_pressure, min=0.0), 0.0)
    coeff = (1.0 - w) * w
    s = torch.stack([(coeff * nx).sum(dim=1), (coeff * ny).sum(dim=1)], dim=-1)
    return p_i, s, cnt


def _dense_b(mb, nx, ny, w, vel, p_i, s, surface_smoothing, target_pressure,
             spring_overlap_balance, spring: bool):
    """Pass B's sums from the planes -> (dv_tension, pressure_real,
    spring_real, visc_vsum).  Each term is selected by the mask, as the
    compiled JAX step takes ``m * (..)``, then multiplied by the direction;
    the neighbour velocities are multiplied by the mask (the compiled step
    keeps that product, so a NaN velocity of a dead slot reaches the sum)."""
    sx, sy = s[:, 0], s[:, 1]
    align = ((sx[:, None] - sx[None, :]) * nx + (sy[:, None] - sy[None, :]) * ny) * (
        surface_smoothing
    )
    t = torch.where(mb, align + (p_i[None, :] + p_i[:, None] - 2.0 * target_pressure), 0.0)
    del align
    dv_tension = torch.stack([(t * nx).sum(dim=1), (t * ny).sum(dim=1)], dim=-1)
    t = torch.where(mb, p_i[:, None] + p_i[None, :], 0.0)
    pressure_real = torch.stack([(t * nx).sum(dim=1), (t * ny).sum(dim=1)], dim=-1)
    if spring:
        t = torch.where(mb, spring_overlap_balance - w, 0.0)
        spring_real = torch.stack([(t * nx).sum(dim=1), (t * ny).sum(dim=1)], dim=-1)
    else:
        spring_real = torch.zeros_like(vel)
    del t
    m = mb.to(vel.dtype)
    visc_vsum = torch.stack([(m * vel[None, :, 0]).sum(dim=1), (m * vel[None, :, 1]).sum(dim=1)],
                            dim=-1)
    return dv_tension, pressure_real, spring_real, visc_vsum


def dense_pass_a(pos: torch.Tensor, alive: torch.Tensor, noise: torch.Tensor,
                 diameter: torch.Tensor, ignored_pressure: torch.Tensor):
    """Dense pass A alone -> (p_i (P,), s (P, 2), cnt (P,)): the neighbor
    count, the pressure ``where(cnt > 0, max(0, sum w - ignored_pressure),
    0)`` and the surface-normal sums ``sum (1 - w) w nhat``."""
    return _dense_a(*_dense_geometry(pos, alive, noise, diameter), ignored_pressure)


def dense_pass_b(pos: torch.Tensor, vel: torch.Tensor, alive: torch.Tensor, noise: torch.Tensor,
                 p_i: torch.Tensor, s: torch.Tensor, diameter: torch.Tensor,
                 surface_smoothing: torch.Tensor, target_pressure: torch.Tensor,
                 spring_overlap_balance: torch.Tensor, spring: bool):
    """Dense pass B alone, from pass A's ``p_i`` and ``s`` -> (dv_tension,
    pressure_real, spring_real, visc_vsum), each (P, 2); ``spring_real`` is
    zero unless ``spring``.  It builds the planes anew (a pass timed on its
    own, as D1's pass B runs)."""
    return _dense_b(*_dense_geometry(pos, alive, noise, diameter), vel, p_i, s,
                    surface_smoothing, target_pressure, spring_overlap_balance, spring)


def neighbor_forces_dense(
    pos: torch.Tensor,
    vel: torch.Tensor,
    alive: torch.Tensor,
    noise: torch.Tensor,
    diameter: torch.Tensor,
    surface_smoothing: torch.Tensor,
    target_pressure: torch.Tensor,
    ignored_pressure: torch.Tensor,
    spring_overlap_balance: torch.Tensor,
    scene: Scene,
) -> PairSums:
    """All-pairs masked (P, P) pair sums: no sort, no grid (the JAX
    ``neighbor_forces_dense``, sand_crate_tpu/cellwise.py:334-392, as its
    compiled step computes it).

    The plain twin of the dense kernels (D1, ``csrc/pair_batch.cu``): the
    tick reaches it through ``ops/pair_batch.neighbor_forces_dense``, which
    runs it on CPU tensors and launches the kernels on CUDA ones.  A pair
    (i, j) counts when both are alive, i != j and their distance is at most
    one diameter; its direction and weight use j's position plus
    ``noise[j]`` (the collider jitter, drawn by the caller).  Every term is
    the JAX function's, in its order, on x and y planes kept apart, so that
    no (P, P, 2) tensor is built (at a batch of 1024 crates of 640 slots one
    f32 plane is 1.68 GB); both passes read one set of planes.  Nothing is
    read back to the host, so the function vmaps over a leading crate axis.
    ``spring_real`` is zero unless ``scene.enable_spring`` (the step reads it
    only then)."""
    planes = _dense_geometry(pos, alive, noise, diameter)
    p_i, s, cnt = _dense_a(*planes, ignored_pressure)
    dv_tension, pressure_real, spring_real, visc_vsum = _dense_b(
        *planes, vel, p_i, s, surface_smoothing, target_pressure, spring_overlap_balance,
        scene.enable_spring)
    return PairSums(
        p_i=p_i,
        dv_tension=dv_tension,
        pressure_real=pressure_real,
        spring_real=spring_real,
        visc_vsum=visc_vsum,
        nbr_cnt=cnt,
        overflow=torch.zeros((), dtype=torch.int32, device=pos.device),
    )
