"""Spatial bands: one crate split across shards by cell rows.

The PyTorch counterpart of ``sand_crate_tpu/spatial.py``.  The cell grid is
split into D horizontal bands, one per shard.  Each shard keeps the full
particle capacity (dead slots masked) and owns the particles inside its
band; every tick it

* **migrates** the particles that left its band to the neighbor shard (one
  hop a tick, ``mig_cap`` movers per direction, the rest deferred): a uid
  swap, so the global uid multiset never changes;
* **exchanges halos** with its neighbors so the pair sums see across the
  band edges (pairs reach one cell row), and
* can **rebalance** the band edges to density quantiles (``rebalance=True``:
  the edges are recomputed in the step from a psum'd row histogram).

The shards talk through a member of a group of ``collectives.py``:
``LocalGroup`` (every shard in this process, one thread each, on one
device) or ``DistGroup`` (one shard per ``torch.distributed`` process).
Both give the same bits.  On a LocalGroup of the card the step is
compiled as the JAX one is jitted: one CUDA graph a tick holds every
shard's band tick (:class:`SpatialStep`, ``graphs.BandGraph``).

The tick (:func:`spatial_step`) keeps the JAX band order, which is not
``physics.step``'s: spawn (the sources inside the band, against the psum'd
global count), cull, migrate, bodies, the ghost pass on the unsorted
state (no cell sort is carried and no ghost pass recomputed), the band's
pair sums, the kicks in reference order, CCD, integrate, and the stats.
The pair sums take one of three routes:

* **pmajor** (:func:`_band_sums_pmajor`): the band sorted by global cell
  id, its feature rows (``pair_prep``'s slab A, without ranges) keyed by
  its own sorted index, its top and bottom
  edge-row runs (at most :func:`_halo_cap` each; the spill is counted)
  sent to the neighbors, the slab spliced ``[above halo | band | below
  halo]``, K1 (``pm_pass`` "a") over it with exact ``candidate_ranges``,
  the halo columns' pass-A sums exchanged, K2 ("b"), the band's columns
  kept.  The port's ranges are exact, so the overflow is the halo spill
  alone (the JAX window loss is 0 here).
* **pallas** (:func:`_band_sums_pallas`): the slab-order route of the
  port's own pallas tick, not the JAX band route (which places the slot
  grid with K3 and runs grid-mode K6+K7): the band's cell-sorted slab in
  global rows, spliced with the in-cap particles of the neighbors' edge
  rows (global rows lo - 1 and hi, with their owners' cell ranks), K4+K5
  (``pair_pass_a``) over it, the halo columns' pass-A sums exchanged,
  K8+K9 (``pair_pass_b_emit``), the band's columns back to slot order.
  Because the slab's rows are global, the kernels' noise row offset is 0
  and each hashes the jitter of the single-device slab.  Every slot pair
  is summed; the overflow counts the particles past the cell capacity.
* **cellwise** (every other forces mode): the band's padded cell grid,
  its pad rows filled from the neighbors' edge rows, ``pass_a_on_grid``,
  a second halo exchange of ``pad_ps_grid``, ``pass_b_on_grid``,
  ``sums_from_packed`` (plain torch, as XLA in JAX).  Its (P, 2) collider
  jitter comes from the shard's generator, so with noise on it matches
  JAX in its invariants only.

The random draws come from one generator per shard
(:func:`collectives.shard_generator`).  Band edges under rebalance stay
device tensors; nothing in the step reads a tensor back to the host.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from . import graphs
from .cellwise import (
    PairSums,
    pad_ps_grid,
    pass_a_on_grid,
    pass_b_on_grid,
    slot_assignment,
    sums_from_packed,
)
from .collectives import DistGroup, LocalGroup, shard_generator
from .ops import kick, pair_kernel, placement
from .ops import pmajor as pm
from .ops.pallas_forces import pair_sums_from_planes
from .physics import (
    _ghost_core,
    _particle_noise,
    advance_bodies,
    cull_particles,
    gravity_on_free_bodies,
    spawn_particles,
)
from .state import CrateState, Params, Scene

__all__ = ["initial_band_edges", "make_spatial_step", "merge_state", "split_state"]

# Edge-recompute subsample (JAX spatial.py:72-77): the row histogram of the
# rebalanced step takes every stride-th slot, stride = capacity // 16384.
EDGE_SAMPLE_TARGET = 16384

I32 = torch.int32


def band_rows(scene: Scene, n_shards: int) -> int:
    """Rows per band of the uniform split."""
    if scene.grid_ny % n_shards:
        raise ValueError(f"grid_ny {scene.grid_ny} is not a multiple of {n_shards} shards")
    return scene.grid_ny // n_shards


def _edge_sample_stride(capacity: int) -> int:
    return max(1, capacity // EDGE_SAMPLE_TARGET)


def max_band_rows(scene: Scene, n_shards: int) -> int:
    """Static per-shard grid height of the rebalanced path: the whole grid,
    so a band can span almost all of it (JAX spatial.py:63-71).  The height
    does not depend on ``n_shards``; the argument keeps the JAX signature."""
    del n_shards
    return scene.grid_ny


def _i32(x, device) -> torch.Tensor:
    """A 0-d int32 tensor of ``x`` (an int, or a tensor kept on its device).
    ``torch.full`` writes an int with a kernel, so no host copy waits."""
    if isinstance(x, torch.Tensor):
        return x.to(I32)
    return torch.full((), int(x), dtype=I32, device=device)


def _clip(a: torch.Tensor, lo, hi) -> torch.Tensor:
    """``jnp.clip`` with int or 0-d tensor bounds: min(max(a, lo), hi)."""
    return torch.clamp(a, min=_i32(lo, a.device), max=_i32(hi, a.device))


def _row_of(pos_y: torch.Tensor, scene: Scene) -> torch.Tensor:
    return torch.clamp(
        torch.floor(pos_y / scene.cell_size).to(I32) + 1, 0, scene.grid_ny - 1
    )


def shard_of(pos_y: torch.Tensor, scene: Scene, n_shards: int, edges=None) -> torch.Tensor:
    """Owning shard per particle from its cell row (as the cell ids clip
    it).  ``edges`` (n_shards + 1,) int32 row boundaries select
    variable-height bands (shard d owns rows [edges[d], edges[d + 1]));
    None is the uniform split."""
    gy = _row_of(pos_y, scene)
    if edges is None:
        return gy // band_rows(scene, n_shards)
    edges = torch.as_tensor(edges, device=gy.device).to(I32)
    return torch.searchsorted(edges[1:-1].contiguous(), gy, right=True, out_int32=True)


def _clamp_edges(targets, prev, ny: int, n_shards: int, bh_max: int) -> torch.Tensor:
    """Monotonic feasible band edges from raw quantile targets: every band
    1 <= height <= bh_max, covering [0, ny]; with ``prev`` each interior
    edge moves at most one row a tick (JAX spatial.py:114-132)."""
    new = [torch.zeros((), dtype=I32, device=targets.device)]
    for k in range(1, n_shards):
        e = targets[k - 1]
        if prev is not None:
            e = _clip(e, prev[k] - 1, prev[k] + 1)
        e = _clip(e, new[k - 1] + 1, new[k - 1] + bh_max)
        e = _clip(e, ny - (n_shards - k) * bh_max, ny - (n_shards - k))
        new.append(e.to(I32))
    new.append(torch.full((), ny, dtype=I32, device=targets.device))
    return torch.stack(new)


def _edges_from_hist(hist, prev, ny: int, n_shards: int, bh_max: int) -> torch.Tensor:
    """Quantile band edges from a global per-row particle histogram."""
    cum = torch.cumsum(hist, 0, dtype=I32)
    total = cum[-1]
    k = torch.arange(1, n_shards, dtype=I32, device=hist.device)
    tgt = (total * k) // n_shards
    targets = torch.searchsorted(cum, tgt, out_int32=True) + 1
    return _clamp_edges(targets, prev, ny, n_shards, bh_max)


def _row_hist(pos_y, alive, scene: Scene) -> torch.Tensor:
    gy = _row_of(pos_y, scene)
    hist = torch.zeros((scene.grid_ny,), dtype=I32, device=pos_y.device)
    return hist.scatter_add_(0, gy.long(), alive.to(I32))


def initial_band_edges(state: CrateState, scene: Scene, n_shards: int) -> torch.Tensor:
    """Quantile edges from the full initial density (no hysteresis), on the
    state's device: the first edges of the rebalanced step and the matching
    :func:`split_state` assignment."""
    hist = _row_hist(state.pos[:, 1], state.alive, scene)
    return _edges_from_hist(hist, None, scene.grid_ny, n_shards, max_band_rows(scene, n_shards))


def _recompute_edges(pos_y, alive, scene: Scene, comm, edges, bh_max: int) -> torch.Tensor:
    """Next tick's band edges from a strided subsample; the psum makes every
    shard compute the same edges."""
    stride = _edge_sample_stride(pos_y.shape[0])
    hist = comm.psum(_row_hist(pos_y[::stride], alive[::stride], scene))
    return _edges_from_hist(hist, edges, scene.grid_ny, comm.size, bh_max)


PARTICLE_LEAVES = ("pos", "vel", "alive", "pressure", "uid")


def split_state(
    state: CrateState, scene: Scene, n_shards: int, edges=None
) -> CrateState:
    """Re-lay a single-crate state into per-shard blocks (D * P, ...), on
    the state's device (host-side arithmetic, as in JAX).

    Each shard keeps the full capacity P, its particles first; the
    replicated leaves are untouched.  Dead slots get per-shard disjoint uid
    ranges above every live uid, so the global uid multiset starts free of
    duplicates (migration only swaps uids, and a spawn revives a slot with
    its parked uid).  ``edges`` selects variable-height bands
    (:func:`initial_band_edges`); None is the uniform split."""
    P_cap = scene.capacity
    dev = state.pos.device
    pos, vel = state.pos.cpu().numpy(), state.vel.cpu().numpy()
    alive, pressure = state.alive.cpu().numpy(), state.pressure.cpu().numpy()
    uid = state.uid.cpu().numpy()
    owner = shard_of(state.pos[:, 1], scene, n_shards, edges).cpu().numpy()

    new_pos = np.zeros((n_shards, P_cap, 2), pos.dtype)
    new_vel = np.zeros((n_shards, P_cap, 2), vel.dtype)
    new_alive = np.zeros((n_shards, P_cap), bool)
    new_pressure = np.zeros((n_shards, P_cap), pressure.dtype)
    uid_base = uid.dtype.type(max(int(uid.max(initial=0)) + 1, P_cap))
    new_uid = (
        uid_base
        + np.arange(n_shards, dtype=uid.dtype)[:, None] * uid.dtype.type(P_cap)
        + np.arange(P_cap, dtype=uid.dtype)[None, :]
    )
    for d in range(n_shards):
        sel = alive & (owner == d)
        n = int(sel.sum())
        new_pos[d, :n] = pos[sel]
        new_vel[d, :n] = vel[sel]
        new_alive[d, :n] = True
        new_pressure[d, :n] = pressure[sel]
        new_uid[d, :n] = uid[sel]
    return state._replace(
        pos=torch.as_tensor(new_pos.reshape(-1, 2), device=dev),
        vel=torch.as_tensor(new_vel.reshape(-1, 2), device=dev),
        alive=torch.as_tensor(new_alive.reshape(-1), device=dev),
        pressure=torch.as_tensor(new_pressure.reshape(-1), device=dev),
        uid=torch.as_tensor(new_uid.reshape(-1), device=dev),
    )


def merge_state(state: CrateState, scene: Scene, n_shards: int) -> CrateState:
    """Collapse a split state back to the single-crate layout (host-side),
    on the state's device.  Past the capacity (a spawn overshoot of the
    psum'd budget) it warns and keeps the first particles."""
    P_cap = scene.capacity
    dev = state.pos.device
    pos = state.pos.cpu().numpy().reshape(n_shards, P_cap, 2)
    vel = state.vel.cpu().numpy().reshape(n_shards, P_cap, 2)
    alive = state.alive.cpu().numpy().reshape(n_shards, P_cap)
    pressure = state.pressure.cpu().numpy().reshape(n_shards, P_cap)
    uid = state.uid.cpu().numpy().reshape(n_shards, P_cap)
    out_pos = np.zeros((P_cap, 2), pos.dtype)
    out_vel = np.zeros((P_cap, 2), vel.dtype)
    out_alive = np.zeros(P_cap, bool)
    out_pressure = np.zeros(P_cap, pressure.dtype)
    out_uid = np.arange(P_cap, dtype=uid.dtype)
    total_alive = int(alive.sum())
    if total_alive > P_cap:
        warnings.warn(
            f"merge_state: {total_alive} alive particles exceed single-crate "
            f"capacity {P_cap}; truncating {total_alive - P_cap}",
            stacklevel=2,
        )
    n = 0
    for d in range(n_shards):
        sel = alive[d]
        k = min(int(sel.sum()), P_cap - n)
        out_pos[n:n + k] = pos[d][sel][:k]
        out_vel[n:n + k] = vel[d][sel][:k]
        out_pressure[n:n + k] = pressure[d][sel][:k]
        out_uid[n:n + k] = uid[d][sel][:k]
        out_alive[n:n + k] = True
        n += k
    return state._replace(
        pos=torch.as_tensor(out_pos, device=dev),
        vel=torch.as_tensor(out_vel, device=dev),
        alive=torch.as_tensor(out_alive, device=dev),
        pressure=torch.as_tensor(out_pressure, device=dev),
        uid=torch.as_tensor(out_uid, device=dev),
    )


def _set_dropped(buf: torch.Tensor, slots: torch.Tensor, value) -> torch.Tensor:
    """``buf.at[slots].set(value, mode="drop")``: slot P (one past the end)
    is a dropped write, swallowed by a padding row that is sliced off.  A
    Python ``value`` is made on the device (a host value is copied in,
    which a graph capture refuses)."""
    pad = torch.cat([buf, buf.new_zeros((1,) + tuple(buf.shape[1:]))])
    if not isinstance(value, torch.Tensor):
        value = buf.new_full((), value)
    pad[slots.long()] = value
    return pad[:-1]


def _migrate(pos, vel, alive, uid, scene: Scene, comm, mig_cap: int, edges=None):
    """Send out-of-band particles to the adjacent shard (one hop a tick).

    Identity travels with the particle: the payload carries its uid, and
    the destination's displaced dead-slot uid comes *back* to the sender,
    which parks it in the vacated slot, so every migration is a uid swap
    between two slots.  A dropped arrival (full shard) returns its own uid.
    Movers past ``mig_cap`` stay alive in the edge band and retry next tick.
    Returns (pos, vel, alive, uid, dropped, deferred)."""
    d, n_shards = comm.rank, comm.size
    P_cap = pos.shape[0]
    iota = torch.arange(P_cap, dtype=I32, device=pos.device)
    owner = shard_of(pos[:, 1], scene, n_shards, edges)
    go_up = alive & (owner < d)
    go_down = alive & (owner > d)

    def pack(mask):
        # Highest score = lowest index among movers; a zero score is no mover
        # (its order among ties does not matter: ``sel`` masks it).
        score = torch.where(mask, P_cap - iota, 0)
        top, idx = torch.topk(score, mig_cap, sorted=True)
        sel = top > 0
        payload = torch.cat([pos[idx], vel[idx], sel.to(pos.dtype)[:, None]], dim=-1)
        payload = torch.where(sel[:, None], payload, 0.0)  # (K, 5): pos | vel | valid
        uids = torch.where(sel, uid[idx], 0)
        deferred = mask.sum(dtype=I32) - sel.sum(dtype=I32)
        return payload, uids, torch.where(sel, idx, P_cap), deferred

    up_buf, up_uid, up_slots, up_def = pack(go_up)
    down_buf, down_uid, down_slots, down_def = pack(go_down)
    # Kill only the slots packed and sent.
    alive = _set_dropped(alive, up_slots, False)
    alive = _set_dropped(alive, down_slots, False)

    # up_buf travels to shard d-1, down_buf to d+1; the wrap-around arrivals
    # are invalid by construction (their valid flags are 0).
    (from_above, uid_above), (from_below, uid_below) = comm.exchange(
        [down_buf, down_uid], [up_buf, up_uid]
    )
    incoming = torch.cat([from_above, from_below])  # (2K, 5)
    inc_uid = torch.cat([uid_above, uid_below])
    inc_ok = incoming[:, 4] > 0

    # Free destination slots, not counting the slots vacated this tick (so
    # the uid swap-back never targets a slot an arrival just claimed); a
    # zero score is a live slot: the arrival is dropped and counted.
    vacated = _set_dropped(torch.zeros_like(alive), up_slots, True)
    vacated = _set_dropped(vacated, down_slots, True)
    free_score = torch.where(alive | vacated, 0, P_cap - iota)
    top_free, free_idx = torch.topk(free_score, incoming.shape[0], sorted=True)
    has_free = top_free > 0
    accepted = inc_ok & has_free
    slot = torch.where(accepted, free_idx, P_cap)
    dropped = (inc_ok & ~has_free).sum(dtype=I32)
    displaced = torch.where(accepted, uid[torch.clamp(free_idx, max=P_cap - 1)], inc_uid)
    pos = _set_dropped(pos, slot, incoming[:, 0:2])
    vel = _set_dropped(vel, slot, incoming[:, 2:4])
    uid = _set_dropped(uid, slot, inc_uid)
    alive = _set_dropped(alive, slot, True)

    # The displaced uids ride back the way their particles came: my up_buf
    # became d-1's second half (back on the forward ring), my down_buf d+1's
    # first half (back on the backward ring).
    (ret_up,), (ret_down,) = comm.exchange([displaced[mig_cap:]], [displaced[:mig_cap]])
    uid = _set_dropped(uid, up_slots, ret_up)
    uid = _set_dropped(uid, down_slots, ret_down)
    return pos, vel, alive, uid, dropped, up_def + down_def


def _exchange_row_halo(arr: torch.Tensor, comm, axis: int = 0, last_row=None) -> torch.Tensor:
    """Fill a row-padded array's pad rows from the neighbors' edge rows.

    ``arr`` has interior rows 1..R and pad rows 0 / R + 1 along ``axis``;
    after the exchange row 0 holds shard d-1's bottom interior row and row
    R + 1 shard d+1's row 1; the boundary shards keep zero pads.
    ``last_row`` is the bottom interior row: None for the allocation's last
    (uniform bands), a 0-d device tensor under variable-height bands."""
    d, n_shards = comm.rank, comm.size
    n = arr.shape[axis]
    first_int = arr.narrow(axis, 1, 1)
    if last_row is None:
        last_int = arr.narrow(axis, n - 2, 1)
    else:
        last_int = arr.index_select(axis, last_row.reshape(1).long())
    (top,), (bot,) = comm.exchange([last_int], [first_int])
    if d == 0:
        top = torch.zeros_like(top)
    if d == n_shards - 1:
        bot = torch.zeros_like(bot)
    if last_row is None:
        return torch.cat([top, arr.narrow(axis, 1, n - 2), bot], dim=axis)
    zero = torch.zeros((1,), dtype=torch.long, device=arr.device)
    arr = arr.index_copy(axis, zero, top)
    return arr.index_copy(axis, (last_row + 1).reshape(1).long(), bot)


class Band(NamedTuple):
    """One shard's rows: global rows [lo, hi) on a grid allocated with
    ``bh_alloc`` rows.  ``last`` is the bottom interior padded-row index of
    the halo exchange: None on the uniform path (bh_alloc), the band height
    (a device tensor) under variable-height bands."""

    lo: torch.Tensor | int
    hi: torch.Tensor | int
    bh_alloc: int
    last: torch.Tensor | None


def _cell_xy(pos, scene: Scene, band: Band):
    """(cx, gy): the cell column and the global cell row clipped to the band
    (a particle nudged over the band edge mid-tick bins at the edge row)."""
    c = torch.floor(pos / scene.cell_size).to(I32) + 1
    cx = torch.clamp(c[:, 0], 0, scene.grid_nx - 1)
    gy = _clip(c[:, 1], band.lo, band.hi - 1)
    return cx, gy


def _band_cids(pos, alive, scene: Scene, band: Band) -> torch.Tensor:
    """Band-local flat cell ids; dead -> bh_alloc * nx."""
    nx = scene.grid_nx
    cx, gy = _cell_xy(pos, scene, band)
    ly = gy - band.lo
    return torch.where(alive, ly * nx + cx, band.bh_alloc * nx).to(I32)


def _global_cids(pos, alive, scene: Scene, band: Band) -> torch.Tensor:
    """Global flat cell ids, rows clipped to the band; dead -> nx * ny."""
    cx, gy = _cell_xy(pos, scene, band)
    return torch.where(alive, gy * scene.grid_nx + cx, scene.num_cells).to(I32)


def _halo_cap(scene: Scene) -> int:
    """Static per-edge halo buffer of the banded p-major path: ~4x the mean
    population of a slab row (JAX spatial.py:496-500); a spill is counted
    into the overflow."""
    est = 4 * scene.capacity // max(scene.grid_ny, 1)
    return min(scene.capacity, max(256, ((est + 127) // 128) * 128))


def _band_sums_pmajor(pos, vel, alive, scene: Scene, comm, tick, params: Params, band: Band,
                      capture=None) -> tuple[PairSums, torch.Tensor]:
    """The band's pair sums through K1/K2 on the spliced slab
    ``[above halo | band | below halo | dead]`` (module docstring).

    The halo runs are the first and last edge rows' particles of the
    neighbors' cell-sorted slabs with their owners' jittered features, so a
    shared particle carries one jittered position into both shards'
    kernels.  The above-halo's unused entries carry the sort-safe cid
    lo * nx - 1 with zero features, the below-halo's the dead cid nx * ny:
    an alive self sits at ALIVE_OFFSET or more from a zero candidate, so no
    such entry passes the pair mask.  Symm (two-sided jitter, never halved
    pairs) follows ``pmajor.schedule()`` as on one device.  Returns (sums,
    sent): sent holds the top and bottom edge-row runs before the clamp to
    the halo cap, so a spill shows beside its cause."""
    symm = scene.pmajor_symm and pm.schedule() == "default"
    fold = scene.fold_pairs and not scene.enable_spring
    nx, ny = scene.grid_nx, scene.grid_ny
    NC = nx * ny
    P = pos.shape[0]
    dev = pos.device
    hc = _halo_cap(scene)
    d, n_shards = comm.rank, comm.size
    lo, hi = _i32(band.lo, dev), _i32(band.hi, dev)

    cid = _global_cids(pos, alive, scene, band)
    sorted_cid, order = torch.sort(cid, stable=True)
    alive_s = alive[order]
    n_alive = alive.sum(dtype=I32)
    slab, _ = pm.pair_prep(pos[order], vel[order], alive_s, sorted_cid,
                           params.diameter * params.collider_noise_level, tick, scene, symm=symm,
                           ranges=False)

    # -- edge runs (contiguous in the sorted slab) ------------------------------
    top_end = torch.searchsorted(sorted_cid, ((lo + 1) * nx).reshape(1), out_int32=True)[0]
    bot_start = torch.searchsorted(sorted_cid, ((hi - 1) * nx).reshape(1), out_int32=True)[0]
    hidx = torch.arange(hc, dtype=I32, device=dev)
    # Padded so a run near the slab's end never reads past it.
    slab_p = torch.cat([slab, slab.new_zeros((hc, pm.SLAB_F))])
    cid_p = torch.cat([sorted_cid, torch.full((hc,), NC, dtype=I32, device=dev)])

    def run_buf(start, n_valid, invalid_cid):
        j = (start + hidx).long()
        ok = hidx < n_valid
        return (torch.where(ok[:, None], slab_p[j, :6], 0.0),
                torch.where(ok, cid_p[j], invalid_cid))

    # My top run goes to d-1 (its below halo); its unused entries take the
    # dead cid.  My bottom run goes to d+1 (its above halo); its unused
    # entries take my last cid, hi * nx - 1 (the receiver's lo * nx - 1).
    top_f, top_c = run_buf(0, torch.clamp(top_end, max=hc), NC)
    bot_f, bot_c = run_buf(bot_start, torch.clamp(n_alive - bot_start, max=hc), hi * nx - 1)
    halo_spill = (torch.clamp(top_end - hc, min=0)
                  + torch.clamp(n_alive - bot_start - hc, min=0))
    (above_f, above_c), (below_f, below_c) = comm.exchange([bot_f, bot_c], [top_f, top_c])
    if d == 0:  # nothing above shard 0 or below shard D-1
        above_f, above_c = torch.zeros_like(above_f), torch.zeros_like(above_c) + (lo * nx - 1)
    if d == n_shards - 1:
        below_f, below_c = torch.zeros_like(below_f), torch.full_like(below_c, NC)

    # -- splice: [above halo | band | below halo | dead] ------------------------
    E = hc + P + hc
    below_at = (hc + n_alive + hidx).long()
    ext_cid = torch.full((E,), NC, dtype=I32, device=dev)
    ext_cid[:hc] = above_c
    ext_cid[hc:hc + P] = sorted_cid
    ext_cid[below_at] = below_c
    ext = slab.new_zeros((E, pm.SLAB_F))
    ext[:hc, :6] = above_f
    ext[hc:hc + P] = slab
    ext[below_at] = F.pad(below_f, (0, pm.SLAB_F - 6))
    ext[:, pm.A_ROW] = torch.clamp(ext_cid // nx, 0, ny).to(torch.float32)
    # Only the band's own alive particles are selves (the halo columns' sums
    # come from their owners).
    selves = torch.zeros((E,), dtype=torch.bool, device=dev)
    selves[hc:hc + P] = alive_s
    ranges = pm.candidate_ranges(ext_cid, selves, nx, ny)
    coef = pm.coef_stack(params.diameter, params.target_pressure, params.spring_overlap_balance)
    out_a = pm.pm_pass(ext, ranges, coef, "a", symm=symm)
    cp = pm.finalize_cp(out_a[0], out_a[3], params.ignored_pressure)

    # -- second exchange: the halo columns' pass-A sums (cp | sx | sy) ---------
    asums = torch.stack([cp, out_a[1], out_a[2]])
    top_a = asums[:, hc:2 * hc].clone()  # sent: asums changes below
    bot_a = asums[:, (hc + bot_start + hidx).long()]
    (above_a,), (below_a,) = comm.exchange([bot_a], [top_a])
    if d == 0:
        above_a = torch.zeros_like(above_a)
    if d == n_shards - 1:
        below_a = torch.zeros_like(below_a)
    asums[:, :hc] = above_a
    asums[:, below_at] = below_a

    cp_row = asums[0] * (1.0 + params.pressure_amplifier) if fold else asums[0]
    slab_b = pm.pass_b_slab(ext, asums, cp_row, params.surface_smoothing)
    out_b = pm.pm_pass(slab_b, ranges, coef, "b", fold=fold, spring=scene.enable_spring,
                       symm=symm)
    if capture is not None:
        capture.update(cid=ext_cid, slab_a=ext, slab_b=slab_b, ranges=ranges, coef=coef,
                       symm=symm, fold=fold, spring=scene.enable_spring, hc=hc, lo=lo,
                       out_a=out_a, out_b=out_b)

    # -- the band's own columns, dead-masked, back to slot order -----------------
    n_b = 2 if fold else (6 if scene.enable_spring else 4)
    own = slice(hc, hc + P)
    rows = torch.cat([asums[0:1, own], out_b[:n_b, own], out_a[4:6, own], out_a[3:4, own]])
    rows = rows * alive_s.to(torch.float32)[None]
    rows_u = torch.empty_like(rows)
    rows_u[:, order] = rows
    rows_u = rows_u.to(pos.dtype)
    zeros2 = pos.new_zeros(()).expand(P, 2)  # one element: the update reads it for every slot
    v0 = 1 + n_b
    return PairSums(
        p_i=rows_u[0],
        dv_tension=rows_u[1:3].T,
        pressure_real=zeros2 if fold else rows_u[3:5].T,
        spring_real=rows_u[5:7].T if scene.enable_spring else zeros2,
        visc_vsum=rows_u[v0:v0 + 2].T,
        nbr_cnt=rows_u[v0 + 2],
        overflow=halo_spill.to(I32),
    ), torch.stack([top_end, n_alive - bot_start]).to(I32)


def _edge_row_columns(sorted_cid, row, nx: int, m_slots: int):
    """The slab columns of the in-cap particles of global cell row ``row``
    (0-d int32), packed: (cols (nx * M,) int64, valid (nx * M,), count).
    Entry s < count is the s-th in-cap particle of the row in slab order
    (cell by cell, rank by rank)."""
    dev = sorted_cid.device
    keys = row * nx + torch.arange(nx + 1, dtype=I32, device=dev)
    starts = torch.searchsorted(sorted_cid, keys, out_int32=True)
    cnt = torch.clamp(starts[1:] - starts[:-1], max=m_slots)
    incl = torch.cumsum(cnt, 0, dtype=I32)
    s = torch.arange(nx * m_slots, dtype=I32, device=dev)
    cell = torch.clamp(torch.searchsorted(incl, s, right=True, out_int32=True), max=nx - 1)
    count = incl[-1]
    valid = s < count
    cols = torch.where(valid, starts[cell] + s - (incl[cell] - cnt[cell]), 0)
    return cols.long(), valid, count


def _band_sums_pallas(pos, vel, alive, scene: Scene, comm, tick, params: Params, band: Band,
                      capture=None) -> tuple[PairSums, torch.Tensor]:
    """The band's pair sums through the slab-order grid kernels K4+K5 and
    K8+K9 on the band's slab spliced with its neighbors' edge rows (module
    docstring).  The slab keeps global rows and ``row_start`` spans the
    whole grid, so the halo rows are rows lo - 1 and hi, and the collider
    noise is keyed by the global padded slot as on one device (row offset
    0).  A halo carries at most nx * M in-cap particles, so nothing
    spills.  Returns (sums, sent): the in-cap particles of the top and
    bottom edge rows, the runs the neighbors receive."""
    M = scene.cell_capacity
    nx, ny = scene.grid_nx, scene.grid_ny
    P = pos.shape[0]
    dev = pos.device
    d, n_shards = comm.rank, comm.size
    lo, hi = _i32(band.lo, dev), _i32(band.hi, dev)
    noise_amp = params.diameter * params.collider_noise_level

    sorted_cid, order = torch.sort(_global_cids(pos, alive, scene, band), stable=True)
    slab, row_start, _, overflow = placement.slab_from_sorted(
        pos[order], alive[order], vel[order], sorted_cid, M, nx, ny
    )
    p_pad = slab.shape[1]
    n_alive = row_start[ny]
    top_cols, top_ok, n_top = _edge_row_columns(sorted_cid, lo, nx, M)
    bot_cols, bot_ok, n_bot = _edge_row_columns(sorted_cid, hi - 1, nx, M)
    (above, n_above), (below, n_below) = comm.exchange(
        [torch.where(bot_ok[None], slab[:, bot_cols], 0.0), n_bot.reshape(1)],
        [torch.where(top_ok[None], slab[:, top_cols], 0.0), n_top.reshape(1)],
    )
    n_above = n_above[0] if d > 0 else torch.zeros_like(n_top)
    n_below = n_below[0] if d < n_shards - 1 else torch.zeros_like(n_bot)

    # -- splice: [above row | band | below row | zeros] -------------------------
    H = nx * M
    width = p_pad + 2 * H
    j = torch.arange(width, dtype=I32, device=dev)
    band_end = n_above + n_alive
    total = band_end + n_below
    ext = torch.where(
        j < n_above, above[:, torch.clamp(j, max=H - 1).long()],
        torch.where(j < band_end, slab[:, torch.clamp(j - n_above, 0, p_pad - 1).long()],
                    torch.where(j < total, below[:, torch.clamp(j - band_end, 0, H - 1).long()],
                                0.0)))
    keys = torch.where(j < total, ext[pair_kernel.ROW].to(I32) * nx + ext[pair_kernel.CX].to(I32),
                       nx * ny)
    ext_rows = torch.searchsorted(
        keys, torch.arange(ny + 1, dtype=I32, device=dev) * nx, out_int32=True)

    ps = pair_kernel.pair_pass_a(ext, ext_rows, M, nx, params.diameter, noise_amp, tick)

    # -- the halo columns' pass-A sums from their owners ------------------------
    (ps_above,), (ps_below,) = comm.exchange(
        [torch.where(bot_ok[None], ps[:, n_above + bot_cols], 0.0)],
        [torch.where(top_ok[None], ps[:, n_above + top_cols], 0.0)],
    )
    s = torch.arange(H, dtype=I32, device=dev)
    ps = torch.cat([ps, ps.new_zeros((pair_kernel.NUM_A, 1))], dim=1)
    ps[:, torch.where(s < n_above, s, width).long()] = ps_above
    ps[:, torch.where(s < n_below, band_end + s, width).long()] = ps_below
    ps = ps[:, :width].contiguous()

    out = pair_kernel.pair_pass_b_emit(
        ext, ps, ext_rows, M, nx, params.diameter, params.surface_smoothing,
        params.target_pressure, params.spring_overlap_balance, params.ignored_pressure,
        noise_amp, tick, enable_spring=scene.enable_spring,
    )
    if capture is not None:
        capture.update(slab=ext, row_start=ext_rows, ps=ps, out=out, lo=lo, hi=hi,
                       noise_amp=noise_amp)

    # -- the band's own columns back to slot order ---------------------------------
    p = torch.arange(P, dtype=I32, device=dev)
    mine = torch.where(p[None] < n_alive, out[:, (n_above + p).long()], 0.0)
    planes = torch.empty_like(mine)
    planes[:, order] = mine
    return (pair_sums_from_planes(planes, scene.enable_spring, overflow, pos.dtype),
            torch.stack([n_top, n_bot]).to(I32))


def _local_grid(pos, vel, alive, noise, scene: Scene, comm, band: Band):
    """The band's packed cell grid with its halo ring: (grid (bh + 2, nx + 2,
    M, 7), pslot (P,), overflow (), sent (2,)).  Rows 1..bh are the band's
    own cell rows; rows 0 and bh + 1 arrive from the neighbors' edge rows.
    sent counts the particles of the two edge rows this band sends."""
    M, nx, bh = scene.cell_capacity, scene.grid_nx, band.bh_alloc
    cid = _band_cids(pos, alive, scene, band)
    sorted_cid, order = torch.sort(cid, stable=True)
    _, _, slot_sorted, gather_slot, overflow = slot_assignment(sorted_cid, M, bh * nx)
    pslot = torch.full((pos.shape[0],), bh * nx * M, dtype=I32, device=pos.device)
    pslot[order] = gather_slot
    packed = torch.cat([pos, pos + noise, vel, alive.to(pos.dtype)[:, None]], dim=-1)
    flat = packed.new_zeros((bh * nx * M + 1, 7))
    flat[slot_sorted.long()] = packed[order]
    padded = F.pad(flat[:-1].reshape(bh, nx, M, 7), (0, 0, 0, 0, 0, 0, 1, 1))
    row_alive = padded[..., 6].sum(dim=(1, 2))
    # A 0-d index tensor would be read back to the host (a capture refuses it).
    last = (row_alive[-2] if band.last is None
            else row_alive.index_select(0, band.last.reshape(1).long())[0])
    sent = torch.stack([row_alive[1], last]).to(I32)
    grid = _exchange_row_halo(padded, comm, axis=0, last_row=band.last)
    return F.pad(grid, (0, 0, 0, 0, 1, 1)), pslot, overflow, sent


def _band_sums_cellwise(pos, vel, alive, scene: Scene, comm, params: Params, band: Band,
                        generator) -> tuple[PairSums, torch.Tensor]:
    """The band's pair sums on its padded cell grid, in plain torch: pass A,
    a second halo exchange of ``pad_ps_grid`` (cross-band neighbors bring
    their true pressures and normals), pass B, one gather.  Returns (sums,
    sent) as :func:`_local_grid` counts sent."""
    diam = params.diameter
    noise = _particle_noise(pos, generator, params)
    grid, pslot, overflow, sent = _local_grid(pos, vel, alive, noise, scene, comm, band)
    cp, s_acc, cnt = pass_a_on_grid(grid, diam, params.ignored_pressure)
    ps_grid = _exchange_row_halo(pad_ps_grid(cp, s_acc), comm, axis=0, last_row=band.last)
    packed = pass_b_on_grid(grid, ps_grid, cp, s_acc, cnt, diam, params.surface_smoothing,
                            params.target_pressure, params.spring_overlap_balance)
    return sums_from_packed(packed, pslot, overflow,
                            band.bh_alloc * scene.grid_nx * scene.cell_capacity), sent


def spatial_step(
    state: CrateState,
    params: Params,
    scene: Scene,
    comm,
    mig_cap: int,
    generator: torch.Generator,
    edges: torch.Tensor | None = None,
    bh_alloc: int | None = None,
    capture: dict | None = None,
):
    """One tick of this shard (``comm``: its group member); ``state`` holds
    this shard's particle leaves (capacity P) and the replicated ones.

    ``edges`` ((D + 1,) int32, replicated) selects variable-height bands on
    a grid of ``bh_alloc`` rows a shard; the stats then carry next tick's
    edges in "band_edges".  ``capture``, a dict, receives the pmajor or
    pallas route's kernel operands (for checks that hold a kernel against
    its plain version on a band's slab).  Returns (state, stats): the
    psum'd particle_count, neighbor_overflow, migration_dropped,
    migration_deferred, spawn_truncated and non_finite, and the gathered
    shard_alive, shard_overflow and shard_sent ((D, 2): the particles of
    each shard's top and bottom edge rows that its band route sends the
    neighbors; the p-major runs before the clamp to the halo cap, which
    also counts toward shard 0's top and shard D-1's bottom run, as JAX
    counts them into the spill)."""
    d, n_shards = comm.rank, comm.size
    dev = state.pos.device
    if edges is None:
        bh_u = band_rows(scene, n_shards)
        band = Band(lo=d * bh_u, hi=(d + 1) * bh_u, bh_alloc=bh_u, last=None)
    else:
        lo, hi = edges[d], edges[d + 1]
        band = Band(lo=lo, hi=hi, bh_alloc=bh_alloc, last=hi - lo)

    # -- lifecycle: spawn only the sources inside my band, against the global count
    if scene.num_sources:
        my_src = shard_of(scene.src_position[:, 1], scene, n_shards, edges) == d
        local_count = state.alive.sum(dtype=I32)
        global_count = comm.psum(local_count)
        gated = dataclasses.replace(scene, src_flow=torch.where(my_src, scene.src_flow, 0.0))
        # spawn_particles budgets against this shard's own count: shift the
        # cap by the other shards' population.
        budget = params._replace(
            max_particles=params.max_particles - (global_count - local_count))
        tmp, spawn_truncated = spawn_particles(state, budget, gated, generator)
        state = state._replace(pos=tmp.pos, vel=tmp.vel, alive=tmp.alive)
    else:
        spawn_truncated = torch.zeros((), dtype=I32, device=dev)
    state = cull_particles(state, params)

    # -- migration (positions from the last integrate) --------------------------
    pos, vel, alive, uid, mig_dropped, mig_deferred = _migrate(
        state.pos, state.vel, state.alive, state.uid, scene, comm, mig_cap, edges)
    state = state._replace(pos=pos, vel=vel, alive=alive, uid=uid)

    # -- rigid bodies (replicated, deterministic), ghosts and the hard wall ------
    state = advance_bodies(state, params, scene)
    ghost = _ghost_core(state.pos, state.alive, state.segments, state.body_lin_vel,
                        state.body_ang_vel, params, scene)
    pos, vel, alive = ghost.pos, state.vel, state.alive

    # -- the band's pair sums --------------------------------------------------------
    if scene.forces_mode == "pmajor":
        sums, sent = _band_sums_pmajor(pos, vel, alive, scene, comm, state.tick, params, band,
                                       capture)
    elif scene.forces_mode == "pallas":
        sums, sent = _band_sums_pallas(pos, vel, alive, scene, comm, state.tick, params, band,
                                       capture)
    else:
        sums, sent = _band_sums_cellwise(pos, vel, alive, scene, comm, params, band, generator)

    # -- kicks in reference order, CCD, integrate: one velocity update --------------
    body_lin_vel = gravity_on_free_bodies(state, params, scene)
    out = kick.velocity_update(kick.fused(scene.enable_spring, norms=False), vel, pos, alive,
                               sums, ghost, state.segments, params, scene.seg_valid)
    pos = out.pos
    vel = torch.where(alive[:, None], out.vel, state.vel)
    new_state = state._replace(
        pos=pos, vel=vel, alive=alive, pressure=out.pressure,
        body_lin_vel=body_lin_vel, tick=state.tick + 1,
    )

    # -- stats: one psum, one all_gather ---------------------------------------------
    local_alive = alive.sum(dtype=I32)
    overflow = sums.overflow.to(I32)
    totals = comm.psum(torch.stack([
        local_alive, overflow, mig_dropped, mig_deferred, spawn_truncated.to(I32),
        out.non_finite,
    ]))
    per_shard = comm.all_gather(torch.cat([torch.stack([local_alive, overflow]), sent]))
    stats = {
        "particle_count": totals[0],
        "neighbor_overflow": totals[1],
        "migration_dropped": totals[2],
        "migration_deferred": totals[3],
        "spawn_truncated": totals[4],
        "non_finite": totals[5],
        "shard_alive": per_shard[:, 0],
        "shard_overflow": per_shard[:, 1],
        "shard_sent": per_shard[:, 2:4],
    }
    if edges is not None:
        stats["band_edges"] = _recompute_edges(pos[:, 1], alive, scene, comm, edges, bh_alloc)
    return new_state, stats


def shard_slice(state: CrateState, rank: int, capacity: int) -> CrateState:
    """Shard ``rank``'s state out of a split (D * P, ...) state (views)."""
    part = slice(rank * capacity, (rank + 1) * capacity)
    return state._replace(**{k: getattr(state, k)[part] for k in PARTICLE_LEAVES})


class SpatialStep:
    """A band step over a group (see :func:`make_spatial_step`).

    On a LocalGroup it keeps a :class:`~sand_crate_tpu_torch.graphs.BandGraph`
    (static buffers: the split state, the Params, the input edges), made on
    the first call.  A call copies its inputs in, runs every shard's tick
    over the shard views of the split state (:meth:`_tick`) and returns
    fresh copies of the new state and of the stats: the JAX step does not
    donate, and callers keep a state or the stats across ticks.  On a CUDA
    group the tick is one replay of a graph that holds every shard's band
    tick in the order the turns enqueue it (the first call of a key runs
    eagerly and captures; :meth:`key`).  Two calls stay eager on purpose:
    one with ``capture=`` (its dicts receive live tensors), and any call
    on a DistGroup (gloo cannot be captured; NCCL is one shard per process,
    so no one process holds every shard's tick).  On the CPU the same body
    runs eagerly."""

    def __init__(self, group, scene: Scene, mig_cap: int, rebalance: bool, seed: int) -> None:
        self.group = group
        self.scene = scene
        self.n_shards = group.size
        self.mig_cap = mig_cap
        self.rebalance = rebalance
        self.bh_alloc = max_band_rows(scene, group.size) if rebalance else None
        if not rebalance:
            band_rows(scene, group.size)  # raises on an uneven split
        ranks = range(group.size) if isinstance(group, LocalGroup) else [group.rank]
        self.generators = {r: shard_generator(seed, r, group.device) for r in ranks}
        self.graph: graphs.BandGraph | None = None

    def key(self) -> graphs.BandKey:
        """What the capture is specific to: the shard count, ``mig_cap``,
        ``rebalance``, ``bh_alloc``, the Scene object, the pair schedule,
        the shard generators (by identity), the device and the capacity."""
        return graphs.BandKey(
            self.n_shards, self.mig_cap, self.rebalance, self.bh_alloc, id(self.scene),
            pm.schedule(), tuple(id(self.generators[r]) for r in sorted(self.generators)),
            self.group.device, self.scene.capacity)

    def _one(self, comm, state, params, edges, capture):
        return spatial_step(state, params, self.scene, comm, self.mig_cap,
                            self.generators[comm.rank], edges, self.bh_alloc, capture)

    def _tick(self, state: CrateState, params: Params, edges, capture=None) -> dict:
        """Every shard's band tick on the split ``state`` (shard r's slots
        are a view of it), the new state written back into it: the
        particle leaves shard by shard, the replicated ones from shard 0.
        Returns the stats."""
        D, P = self.n_shards, self.scene.capacity
        views = [shard_slice(state, r, P) for r in range(D)]
        outs = self.group.run(
            lambda comm, st, cap: self._one(comm, st, params, edges, cap),
            views, capture if capture is not None else [None] * D,
        )
        for view, (new, _) in zip(views, outs):
            for k in PARTICLE_LEAVES:
                getattr(view, k).copy_(getattr(new, k))
        for k in state._fields:
            if k not in PARTICLE_LEAVES:
                getattr(state, k).copy_(getattr(outs[0][0], k))
        return outs[0][1]

    def __call__(self, state: CrateState, params: Params, edges=None, capture=None):
        """(state, params[, edges]) -> (state, stats).  On a LocalGroup the
        state is the split (D * P, ...) state of :func:`split_state` and
        ``capture`` a list of D dicts; on a DistGroup it is this process's
        shard (P, ...) and ``capture`` one dict."""
        if self.rebalance != (edges is not None):
            raise TypeError("a rebalanced step takes (state, params, edges); a uniform one "
                            "(state, params)")
        if isinstance(self.group, DistGroup):
            return self._one(self.group, state, params, edges, capture)
        D, P = self.n_shards, self.scene.capacity
        if state.pos.shape[0] != D * P:
            raise ValueError(f"expected a split state of {D} x {P} slots, got {state.pos.shape[0]}")
        g = self.graph
        if g is None:
            g = self.graph = graphs.BandGraph(state, params, edges)
        else:
            g.load(state, params, edges)
        if capture is not None:
            stats = self._tick(g.state, g.params, g.edges, capture)
        else:
            stats = g.step(self.key(), self._tick, self.generators.values())
        return graphs.clone(g.state), {k: v.clone() for k, v in stats.items()}


def make_spatial_step(
    group,
    scene: Scene,
    mig_cap: int | None = None,
    rebalance: bool = False,
    *,
    seed: int = 0,
    device="cuda",
) -> SpatialStep:
    """The band step over ``group``: a LocalGroup or a DistGroup, or an int
    D for ``LocalGroup(D, device)`` (the card unless the caller asks for
    the CPU).

    ``rebalance=True`` gives a step ``(state, params, edges) -> (state,
    stats)`` over variable-height bands: seed ``edges`` with
    :func:`initial_band_edges` (and pass the same edges to
    :func:`split_state`), then thread ``stats["band_edges"]`` back in each
    tick.  ``mig_cap`` defaults to the JAX rule, min(1024, max(64,
    capacity // 16)) movers per direction a tick.  Shard r draws from
    ``collectives.shard_generator(seed, r)``.  On a LocalGroup of the card
    every call replays one captured CUDA graph (:class:`SpatialStep`):
    hold one step across a loop, since a new step captures anew."""
    if isinstance(group, int):
        group = LocalGroup(group, device=device)
    if scene.segments0.device.type != group.device.type:
        raise ValueError(f"the scene is on {scene.segments0.device}, the group on {group.device}")
    mig_cap = mig_cap or min(1024, max(64, scene.capacity // 16))
    if 2 * mig_cap > scene.capacity:
        raise ValueError(f"mig_cap {mig_cap}: the arrivals of both directions (2 x mig_cap) "
                         f"must fit the capacity {scene.capacity}")
    return SpatialStep(group, scene, mig_cap, rebalance, seed)
