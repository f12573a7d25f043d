"""The physics tick as one functional step on tensors.

The PyTorch counterpart of ``sand_crate_tpu/physics.py``, on all six of
its force backends.  Tick order (must match the reference
crate.py:91-129):

  1.  spawn from sources, cull out-of-box particles
  2.  advance rigid bodies
  3.  virtual colliders (boundary ghosts) on pre-fix positions, then the
      hard wall projection (ops/boundary.py; the sorted backends take the
      fixed positions alone here)
  4.  stable cell-id sort of (vel, pre-fix pos, uid), ghost pass recomputed
      on the sorted order, then the pair sums (ops/pmajor.py: feature rows
      -> pass A -> cell pressure -> pass B; ops/pallas_forces.py: slab
      -> slot grid -> pass A -> pass B emitted in sorted order;
      ops/chunked.py: fixed windows of the sorted slab, on the card the
      window kernel; or the cell grid of cellwise.py); the dense backend
      skips the sort and sums all pairs (ops/pair_batch.py: on the card the
      dense kernel, its plain twin cellwise.neighbor_forces_dense), the
      gather backend skips it and sums over fixed-K neighbor lists
      (:func:`neighbor_forces_gather`)
  5.  tension, gravity, pressure, spring (flag-gated), viscosity, wall
      bounce, continuous collision kicks
  6.  integrate positions
  (5 and 6 are one velocity update, ops/kick.py: on the card one kernel;
  the JAX package's public per-kick functions apply_tension ...
  apply_continuous_collision run one stage of it each)

The sorted backends keep the state permanently cell-sorted (``uid``
carries identity), as in the JAX package.  The dense, cellwise and gather
backends draw their collider noise from the crate's generator (the JAX
package from its tick key), so with noise on they match it in their
invariants only.  Nothing here reads a tensor
back to the host, so on the card the tick is captured as a CUDA graph and
replayed (graphs.py; :func:`rollout`, :func:`trajectory`), and on the
dense and chunked backends the step vmaps over a leading crate axis
(``sweep.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import geometry as geo
from . import graphs
from .cellwise import (
    PairSums,
    cell_ids_grid,
    neighbor_forces_cellwise_sorted,
)
from .config import BODY_FIXED, BODY_FREE, BODY_MOTORED
from .neighbors import neighbor_list
from .ops import boundary, kick, pair_batch
from .ops.chunked import neighbor_forces_chunked_sorted
from .ops.pallas_forces import neighbor_forces_pallas_sorted
from .ops.pmajor import neighbor_forces_pmajor_sorted
from .ops.stage_mark import mark
from .state import NUM_FORCES, CrateState, Diagnostics, Params, Scene

EPS = 1e-12


class _TorchNamespace:
    """The numpy-named functions an ExprMotor may call, on tensors.

    Numbers among the arguments become tensors like the first tensor
    argument (0-d f32 on the CPU if there is none), since several torch
    functions take tensors only."""

    _ALIASES = {"power": torch.pow, "absolute": torch.abs}

    def __getattr__(self, name):
        if name == "cbrt":
            fn = lambda x: torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)  # noqa: E731
        else:
            fn = self._ALIASES.get(name) or getattr(torch, name)

        def call(*args):
            like = next((a for a in args if isinstance(a, torch.Tensor)), None)
            if like is None:
                return fn(*(torch.as_tensor(a) for a in args))
            # A number becomes a fill on the tensor's device, never a copy
            # from the host (which a CUDA graph capture refuses).
            return fn(*(a if isinstance(a, torch.Tensor) else like.new_full((), a)
                        for a in args))

        return call


TORCH_XP = _TorchNamespace()


def neighbor_forces_gather(
    pos: torch.Tensor,
    vel: torch.Tensor,
    alive: torch.Tensor,
    generator: torch.Generator | None,
    params: Params,
    scene: Scene,
) -> PairSums:
    """Reference-closest pair sums over fixed-K neighbor lists
    (neighbors.py): the reference's 20-neighbor cap and a collider jitter
    per directed edge (crate.py:168-170), drawn from ``generator`` (the JAX
    package draws it from its tick key)."""
    diam = params.diameter
    nbr = neighbor_list(pos, alive, diam, scene)
    idx, mask = nbr.idx, nbr.mask  # (P, K)
    mask_f = mask.to(pos.dtype)
    noise = (
        (torch.rand(idx.shape + (2,), generator=generator, device=pos.device, dtype=pos.dtype)
         - 0.5)
        * diam
        * params.collider_noise_level
    )
    rel = pos[:, None, :] - (pos[idx] + noise)  # (P, K, 2)
    ndist = torch.sqrt(torch.clamp(rel[..., 0] * rel[..., 0] + rel[..., 1] * rel[..., 1],
                                   min=0.0))
    nhat = rel / torch.clamp(ndist, min=EPS)[..., None]
    vel_snap = vel[idx]  # (P, K, 2) snapshot for viscosity (crate.py:175)

    # pressures (crate.py:261-284)
    w = (1.0 - torch.clamp(ndist / torch.clamp(diam, min=EPS), 0.0, 1.0)) * mask_f
    p_i = torch.clamp(w.sum(dim=1) - params.ignored_pressure, min=0.0)
    p_i = torch.where(mask.any(dim=1) & alive, p_i, 0.0)
    p_j = p_i[idx] * mask_f

    # surface tension (crate.py:335-358)
    s = (((1.0 - w) * w)[..., None] * nhat * mask_f[..., None]).sum(dim=1)
    align = ((s[:, None, :] - s[idx]) * nhat).sum(dim=-1) * params.surface_smoothing
    tpf = p_j + p_i[:, None] - 2.0 * params.target_pressure
    return PairSums(
        p_i=p_i,
        dv_tension=((mask_f * (align + tpf))[..., None] * nhat).sum(dim=1),
        pressure_real=((mask_f * (p_i[:, None] + p_j))[..., None] * nhat).sum(dim=1),
        spring_real=((mask_f * (params.spring_overlap_balance - w))[..., None] * nhat).sum(dim=1),
        visc_vsum=(mask_f[..., None] * vel_snap).sum(dim=1),
        nbr_cnt=mask_f.sum(dim=1),
        overflow=nbr.overflow,
    )


def motor_value(motor: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Evaluate ``offset + amp * cos(freq * t + phase)`` motors.

    ``motor``: (..., 4) = (amplitude, frequency, phase, offset)."""
    amp, freq, phase, offset = (motor[..., i] for i in range(4))
    return offset + amp * torch.cos(freq * t + phase)


# --------------------------------------------------------------------------
# 1. particle lifecycle
# --------------------------------------------------------------------------


def spawn_particles(
    state: CrateState, params: Params, scene: Scene, generator: torch.Generator
) -> tuple[CrateState, torch.Tensor]:
    """Emit from every active source into free slots (crate.py:138-147).

    Spawn count per source is Binomial(flow, dt) clamped by the remaining
    ``max_particles`` budget, applied sequentially across sources; free slots
    are assigned in ascending index order.  The draws come from ``generator``
    (not the JAX package's PRNG), so spawn positions differ from it.

    Returns ``(state, truncated)`` where ``truncated`` counts emissions lost
    to the static per-tick ``max_spawn`` bound (mean + 6 sigma, scene.py).
    """
    device = state.pos.device
    if scene.num_sources == 0:
        return state, torch.zeros((), dtype=torch.int32, device=device)
    P = scene.capacity
    ns = scene.max_spawn
    pos, vel, alive = state.pos, state.vel, state.alive

    # Ascending free-slot list (sentinel P afterwards), shared by all sources:
    # dead slot i scores P - i (> 0), alive slots -1, so the largest scores
    # are the lowest dead indices.
    n_slots = min(P, scene.num_sources * ns)
    iota = torch.arange(P, dtype=torch.int32, device=device)
    score = torch.where(alive, -1, P - iota)
    top = torch.topk(score, n_slots).values
    free_slots = torch.where(top > 0, P - top, P)
    free_slots = torch.cat(
        [free_slots, torch.full((ns,), P, dtype=torch.int32, device=device)]
    )

    budget = torch.clamp(params.max_particles - state.particle_count, min=0)
    offset = torch.zeros((), dtype=torch.int64, device=device)
    truncated = torch.zeros((), dtype=torch.int32, device=device)
    lane = torch.arange(ns, device=device)
    pos = torch.cat([pos, pos.new_zeros((1, 2))])  # row P swallows dropped writes
    vel = torch.cat([vel, vel.new_zeros((1, 2))])
    alive = torch.cat([alive, alive.new_zeros((1,))])
    p = torch.clamp(params.dt.to(torch.float32), 0.0, 1.0)
    for z in range(scene.num_sources):
        active = state.tick < scene.src_active_ticks[z]
        # The count takes p's shape (and, under vmap, its crate axis), so
        # each crate draws its own count into an output of its own size.
        n_raw = torch.binomial(
            torch.zeros_like(p) + scene.src_flow[z].to(torch.float32), p, generator=generator
        ).to(torch.int32)
        want = torch.minimum(torch.where(active, n_raw, 0), budget).to(torch.int32)
        n = torch.clamp(want, max=ns)
        truncated = truncated + (want - n)

        # Clamped start, as lax.dynamic_slice clamps in the JAX package.
        start = torch.clamp(offset, max=free_slots.shape[0] - ns)
        slots = free_slots[start + lane].long()
        slots = torch.where(lane < n, slots, P)  # P = out of bounds -> dropped

        u_pos = torch.rand((ns, 2), generator=generator, device=device)
        u_vel = torch.rand((ns, 2), generator=generator, device=device)
        pos[slots] = scene.src_position[z] + (u_pos - 0.5) * scene.src_radius[z]
        vel[slots] = scene.src_velocity[z] + (u_vel - 0.5) * scene.src_noise[z]
        alive[slots] = alive.new_ones(())  # a device value: a host one is copied in
        budget = budget - n
        offset = offset + n
    return (
        state._replace(pos=pos[:P], vel=vel[:P], alive=alive[:P]),
        truncated,
    )


def cull_particles(state: CrateState, params: Params) -> CrateState:
    """Kill particles outside [-r, 1+r]^2 (crate.py:149-159) by mask flip."""
    r = params.particle_radius
    inside = ((state.pos >= -r) & (state.pos <= 1.0 + r)).all(dim=-1)
    return state._replace(alive=state.alive & inside)


# --------------------------------------------------------------------------
# 2. rigid bodies
# --------------------------------------------------------------------------


def body_point_velocity(points, body_idx, body_center, body_lin_vel, body_ang_vel):
    """Linearized rigid velocity field v = v_c + w * rot90cw(p - c)
    (rigid_body.py:28-34).  ``points``: (..., 2), ``body_idx``: (...)."""
    c = body_center[body_idx]
    lin = body_lin_vel[body_idx]
    ang = body_ang_vel[body_idx]
    return lin + ang[..., None] * geo.rot90_cw(points - c)


def advance_bodies(state: CrateState, params: Params, scene: Scene) -> CrateState:
    """apply_bodies_velocity (crate.py:95,363-365 + rigid_body.py:42-68).

    Motored bodies re-evaluate their motors at the advanced time; fixed
    bodies never move; free bodies keep integrating their center velocity.
    """
    t_new = state.time + params.dt
    motored = scene.body_kind == BODY_MOTORED
    lin = torch.where(
        motored[:, None], motor_value(scene.motor_lin, t_new), state.body_lin_vel
    )
    ang = torch.where(motored, motor_value(scene.motor_ang, t_new), state.body_ang_vel)
    if scene.motor_exprs:
        lin, ang = lin.clone(), ang.clone()
    for b, ch, fn in scene.motor_exprs:
        val = fn(t_new, xp=TORCH_XP)
        if isinstance(val, torch.Tensor) and val.device == lin.device:
            val = val.to(lin.dtype)
        else:  # a constant: a fill on the device, not a copy from the host
            val = lin.new_full((), float(val))
        if ch == 2:
            ang[b] = val
        else:
            lin[b, ch] = val

    moving = (scene.body_kind != BODY_FIXED)[scene.seg_body]  # (S,)
    ends_vel = body_point_velocity(
        state.segments, scene.seg_body[:, None], scene.body_center, lin, ang
    )  # (S, 2, 2)
    segments = torch.where(
        moving[:, None, None], state.segments + ends_vel * params.dt, state.segments
    )
    return state._replace(
        segments=segments, body_lin_vel=lin, body_ang_vel=ang, time=t_new
    )


# --------------------------------------------------------------------------
# 3. the tick phases
# --------------------------------------------------------------------------


# The backends that keep slot order (neighbor_stage); every other backend
# sorts the state by cell each tick.
SLOT_ORDER_MODES = ("gather", "dense")


class GhostInfo(NamedTuple):
    """Boundary-ghost reductions shared by the later force phases."""

    pos: torch.Tensor  # (P, 2) hard-wall-corrected positions
    g_cnt: torch.Tensor | None  # (P,)   ghosts per particle
    gsum: torch.Tensor | None  # (P, 2) sum of mirror ghost vectors
    gvel_sum: torch.Tensor | None  # (P, 2) sum of ghost contact velocities


def ghost_sums(prepos, alive, segments, body_lin_vel, body_ang_vel, params, scene):
    """The (g_cnt, gsum, gvel_sum) reductions of ghost_phase, standalone
    (plain torch: no tick calls it)."""
    nx_, ny_, gm, gvx, gvy = boundary.ghost_geom(prepos, alive, segments,
                                                 params.particle_radius, scene.seg_valid)
    gvelx, gvely = boundary.ghost_vel(nx_, ny_, body_lin_vel, body_ang_vel, scene.seg_body,
                                      scene.body_center)
    return boundary.ghost_reductions(gm, gvx, gvy, gvelx, gvely)


def _ghost_core(
    prepos, alive, segments, body_lin_vel, body_ang_vel, params, scene
) -> GhostInfo:
    """Hard-wall-corrected position plus the three ghost reductions
    (crate.py:97-99, 202-243): ``ops/boundary.ghost_pass`` (on the card the
    ghost kernel of ``csrc/boundary.cu``).

    A pure per-particle function of the PRE-fix position (the S-axis
    reduction order is fixed), so re-running it on a permutation of prepos
    gives the permuted outputs: the sort carries only prepos and this is
    recomputed after it."""
    return GhostInfo(*boundary.ghost_pass(
        prepos, alive, segments, body_lin_vel, body_ang_vel, params.particle_radius,
        scene.seg_valid, scene.seg_body, scene.body_center,
    ))


def ghost_phase(state: CrateState, params: Params, scene: Scene) -> GhostInfo:
    """Virtual colliders on pre-fix positions + hard wall projection
    (reference "Virtual Colliders" phase, crate.py:97-99, 202-243).

    The sorted backends read only the fixed positions here (their cell
    sort's keys; neighbor_stage runs the full pass again on the sorted
    order), so they take the positions-only pass and the sums are None."""
    if scene.forces_mode not in SLOT_ORDER_MODES:
        pos = boundary.ghost_pos(state.pos, state.alive, state.segments,
                                 params.particle_radius, scene.seg_valid)
        return GhostInfo(pos, None, None, None)
    return _ghost_core(
        state.pos, state.alive, state.segments, state.body_lin_vel,
        state.body_ang_vel, params, scene,
    )


def _particle_noise(pos: torch.Tensor, generator, params: Params) -> torch.Tensor:
    """The (P, 2) collider jitter of the dense and cellwise backends:
    uniform in [-0.5, 0.5) * diameter * collider_noise_level."""
    u = torch.rand(pos.shape, generator=generator, device=pos.device, dtype=pos.dtype)
    return (u - 0.5) * params.diameter * params.collider_noise_level


class TickOperands(NamedTuple):
    """Per-particle operands of the force phases in cell-sorted order, plus
    their pair sums."""

    pos: torch.Tensor
    vel: torch.Tensor
    alive: torch.Tensor
    uid: torch.Tensor
    ghost: GhostInfo
    sums: PairSums


def neighbor_stage(
    vel: torch.Tensor,
    alive: torch.Tensor,
    uid: torch.Tensor,
    ghost: GhostInfo,
    tick: torch.Tensor,
    params: Params,
    scene: Scene,
    *,
    prepos: torch.Tensor,
    segments: torch.Tensor,
    body_lin_vel: torch.Tensor,
    body_ang_vel: torch.Tensor,
    generator: torch.Generator | None = None,
    live_rows: int | None = None,
) -> TickOperands:
    """Neighbor detection + collider population + pressures (crate.py:102-108)
    on the scene's backend.

    The sorted backends (p-major, the slot grid "pallas", chunked and
    cellwise) share one stable sort by cell id, which permutes (vel,
    prepos, uid); the hard-wall-fixed position and the ghost sums are
    recomputed on the sorted pre-fix positions (_ghost_core), which gives
    the permuted values exactly.  Dead particles sort last (cell id NC), so
    ``alive == sorted_cid < NC``.  The dense and gather backends keep slot
    order.  Dense and cellwise draw their collider noise, one (P, 2)
    uniform array, from ``generator``; gather draws one per directed edge.
    ``live_rows`` bounds the chunked sweep (ops/chunked.py).  The sorted
    backends mark the end of their sort (ops/stage_mark.py)."""
    diam = params.diameter
    if scene.forces_mode in SLOT_ORDER_MODES:
        if scene.forces_mode == "gather":
            sums = neighbor_forces_gather(ghost.pos, vel, alive, generator, params, scene)
        else:
            sums = pair_batch.neighbor_forces_dense(
                ghost.pos, vel, alive, _particle_noise(ghost.pos, generator, params), diam,
                params.surface_smoothing, params.target_pressure, params.ignored_pressure,
                params.spring_overlap_balance, scene,
            )
        return TickOperands(pos=ghost.pos, vel=vel, alive=alive, uid=uid, ghost=ghost,
                            sums=sums)
    cid = cell_ids_grid(ghost.pos, alive, scene)
    sorted_cid, order = torch.sort(cid, stable=True)
    vel, prepos, uid = vel[order], prepos[order], uid[order]
    alive = sorted_cid < scene.num_cells
    ghost = _ghost_core(
        prepos, alive, segments, body_lin_vel, body_ang_vel, params, scene
    )
    mark(tick, "sort")
    args = (
        ghost.pos,
        vel,
        alive,
        sorted_cid,
        diam * params.collider_noise_level,
        tick,
        diam,
        params.surface_smoothing,
        params.target_pressure,
        params.ignored_pressure,
        params.spring_overlap_balance,
        scene,
    )
    if scene.forces_mode == "cellwise":
        sums = neighbor_forces_cellwise_sorted(
            ghost.pos, vel, alive, sorted_cid, _particle_noise(ghost.pos, generator, params),
            *args[6:],
        )
    elif scene.forces_mode == "pallas":
        sums = neighbor_forces_pallas_sorted(*args)
    elif scene.forces_mode == "chunked":
        sums = neighbor_forces_chunked_sorted(*args, live_rows=live_rows)
    else:
        # Enables the folded tension+pressure pass-B sum when
        # scene.fold_pairs is set.
        sums = neighbor_forces_pmajor_sorted(
            *args, pressure_amplifier=params.pressure_amplifier
        )
    return TickOperands(pos=ghost.pos, vel=vel, alive=alive, uid=uid, ghost=ghost, sums=sums)


def gravity_on_free_bodies(state: CrateState, params: Params, scene: Scene):
    """Gravity integrates into free bodies' center velocity (crate.py:311-314)."""
    free = scene.body_kind == BODY_FREE
    return torch.where(
        free[:, None], state.body_lin_vel + params.dt * params.gravity[None, :],
        state.body_lin_vel,
    )


def finish_tick(
    state: CrateState,
    ops: TickOperands,
    out: kick.KickOut,
    body_lin_vel,
    spawn_truncated,
) -> tuple[CrateState, Diagnostics]:
    """The new state and the diagnostics from the velocity update ``out``
    (its vel, integrated pos, pressure, norms and reductions; crate.py:
    360-361) in the operands' (sorted) order.  Dead slots' velocities are
    untouched by every force phase but for a +0 added (-0 becomes +0)."""
    new_state = state._replace(
        pos=out.pos,
        vel=out.vel,
        alive=ops.alive,
        pressure=out.pressure,
        uid=ops.uid,
        body_lin_vel=body_lin_vel,
        tick=state.tick + 1,
    )
    diag = Diagnostics(
        force_dv=kick.force_dv(out.norms, out.cnt),
        particle_count=new_state.particle_count,
        neighbor_overflow=ops.sums.overflow,
        max_speed=out.max_speed,
        non_finite=out.non_finite,
        spawn_truncated=spawn_truncated,
    )
    assert diag.force_dv.shape == (NUM_FORCES,)
    return new_state, diag


def step(
    state: CrateState,
    params: Params,
    scene: Scene,
    generator: torch.Generator,
    live_rows: int | None = None,
) -> tuple[CrateState, Diagnostics]:
    """One physics tick: (state, params, scene) -> (state, diagnostics).

    ``generator`` supplies the random draws (a torch.Generator on the
    state's device): the emitters', then the dense backend's collider
    noise.  ``live_rows`` is the chunked backend's sweep bound for batched
    crates, an upper bound on this crate's alive count that is the same for
    every crate of a vmapped batch (ops/chunked.py; other backends ignore
    it); sweep.BatchedCrates computes it for each ``run``.  The ends of
    the lifecycle, the sort and the pair stage are marked on the stream
    (ops/stage_mark.py; the tick's own end is marked by graphs.StepGraph)."""
    # -- lifecycle ---------------------------------------------------------
    state, spawn_truncated = spawn_particles(state, params, scene, generator)
    state = cull_particles(state, params)
    state = advance_bodies(state, params, scene)

    # -- boundary ghosts + hard wall (crate.py:97-99) ------------------------
    ghost = ghost_phase(state, params, scene)
    mark(state.tick, "lifecycle")

    # -- cell sort + pair sums (crate.py:102-108, 161-358) --------------------
    ops = neighbor_stage(
        state.vel, state.alive, state.uid, ghost, state.tick, params, scene,
        prepos=state.pos, segments=state.segments,
        body_lin_vel=state.body_lin_vel, body_ang_vel=state.body_ang_vel,
        generator=generator, live_rows=live_rows,
    )
    mark(state.tick, "pairs")

    # -- kicks, wall bounce, CCD and integrate (crate.py:109-129, 177-200) ------
    # ops/kick.py: the kicks (tension, gravity, pressure, the spring when the
    # scene enables it, viscosity; crate.py:286-358), the wall bounce
    # (crate.py:245-259), the clamp (crate.py:177-200) and the integrate, in
    # the reference's order; on the card the one kernel of csrc/kick.cu
    body_lin_vel = gravity_on_free_bodies(state, params, scene)
    out = kick.velocity_update(kick.fused(scene.enable_spring), ops.vel, ops.pos, ops.alive,
                               ops.sums, ops.ghost, state.segments, params, scene.seg_valid)
    return finish_tick(state, ops, out, body_lin_vel, spawn_truncated)


def rollout(
    state: CrateState,
    params: Params,
    scene: Scene,
    num_ticks: int,
    generator: torch.Generator,
    live_rows: int | None = None,
) -> tuple[CrateState, Diagnostics]:
    """Run ``num_ticks`` steps; returns the final state and the last tick's
    diagnostics, both on the device (the JAX package's jitted ``lax.scan``).

    On a CUDA state the tick is a replayed CUDA graph (graphs.py): the
    state and params are copied into its static buffers once, the graph is
    replayed ``num_ticks`` times with no host work between ticks, and
    fresh copies come back, so a returned state is never overwritten by a
    later call.  On a CPU state it is a loop of :func:`step`.
    ``live_rows``: the chunked sweep bound, as in :func:`step`."""
    if state.pos.device.type != "cuda" or num_ticks < 1:
        diag = None
        for _ in range(num_ticks):
            state, diag = step(state, params, scene, generator, live_rows)
        return state, diag
    g = graphs.rollout_graph(state, params, step)
    for _ in range(num_ticks):
        diag = g.step(scene, generator, live_rows)
    return graphs.clone(g.state), graphs.clone(diag)


def trajectory(
    state: CrateState,
    params: Params,
    scene: Scene,
    num_frames: int,
    generator: torch.Generator,
    ticks_per_frame: int = 1,
) -> tuple[CrateState, dict]:
    """Run ``num_frames * ticks_per_frame`` steps, sampling one frame after
    every ``ticks_per_frame`` ticks (the JAX ``trajectory``).

    Returns (final_state, frames): frames is a dict of stacked device
    tensors pos (F, P, 2), alive (F, P), pressure (F, P), segments
    (F, S, 2, 2) and force_dv (F, NUM_FORCES), the last tick's of each
    frame.  On a CUDA state a frame is ``ticks_per_frame`` replays of the
    captured tick, its fields copied out of the static state before the
    next replay (graphs.StepGraph.frames); on a CPU state it is a loop of
    :func:`rollout`."""
    if state.pos.device.type == "cuda" and num_frames > 0:
        g = graphs.rollout_graph(state, params, step)
        frames = g.frames(scene, generator, num_frames, ticks_per_frame)
        return graphs.clone(g.state), frames
    keys = graphs.FRAME_FIELDS + ("force_dv",)
    frames = {k: [] for k in keys}
    for _ in range(num_frames):
        state, diag = rollout(state, params, scene, ticks_per_frame, generator)
        for k in keys[:-1]:
            frames[k].append(getattr(state, k))
        frames["force_dv"].append(diag.force_dv)
    return state, {k: torch.stack(v) for k, v in frames.items()}


# --------------------------------------------------------------------------
# 4. the kicks one at a time (the JAX package's public per-kick functions)
# --------------------------------------------------------------------------
# Each runs one stage of ops/kick.py's velocity update alone (on the card one
# launch of csrc/kick.cu's kernel, counted as "velocity_update_stage", the
# clamp as "ccd") and returns (vel, mean |dv| over the alive slots), as
# sand_crate_tpu/physics.py:680-750 does; physics.step runs them all in one
# launch instead.


def apply_tension(vel, alive, sums: PairSums, params: Params):
    """Surface tension kick (crate.py:335-358)."""
    return kick.single_stage(kick.TENSION, params, vel=vel, alive=alive,
                             dv_tension=sums.dv_tension)


def apply_gravity(vel, alive, params: Params):
    """Gravity on particles (crate.py:309-310)."""
    return kick.single_stage(kick.GRAVITY, params, vel=vel, alive=alive)


def apply_pressure_force(vel, alive, sums: PairSums, ghost: GhostInfo, params: Params):
    """Pressure force incl. ghost push-off (crate.py:286-307)."""
    return kick.single_stage(
        kick.PRESSURE, params, vel=vel, alive=alive, p_i=sums.p_i,
        pressure_real=sums.pressure_real, gsum=ghost.gsum)


def apply_spring(vel, alive, sums: PairSums, ghost: GhostInfo, params: Params):
    """Spring force (crate.py:325-333; the reference ships it disabled)."""
    return kick.single_stage(
        kick.SPRING, params, vel=vel, alive=alive, spring_real=sums.spring_real,
        nbr_cnt=sums.nbr_cnt, g_cnt=ghost.g_cnt, gsum=ghost.gsum)


def apply_viscosity(vel, alive, sums: PairSums, params: Params):
    """Viscosity: stale v_j snapshot, fresh v_i (crate.py:316-323)."""
    return kick.single_stage(
        kick.VISCOSITY, params, vel=vel, alive=alive, visc_vsum=sums.visc_vsum,
        nbr_cnt=sums.nbr_cnt)


def apply_wall_bounce(vel, alive, ghost: GhostInfo, params: Params):
    """Wall bounce against the moving-wall contact velocity (crate.py:245-259)."""
    return kick.single_stage(
        kick.WALL_BOUNCE, params, vel=vel, alive=alive, g_cnt=ghost.g_cnt, gsum=ghost.gsum,
        gvel_sum=ghost.gvel_sum)


def apply_continuous_collision(pos, vel, alive, segments, params: Params, scene: Scene):
    """Continuous collision velocity clamp (crate.py:177-200)."""
    return kick.single_stage(
        kick.CCD, params, scene.seg_valid, vel=vel, alive=alive, pos=pos, segments=segments)
