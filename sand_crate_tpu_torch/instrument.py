"""Opt-in per-phase instrumented tick — the reference's on-screen phase timer.

The counterpart of ``sand_crate_tpu/instrument.py``: the reference wraps
every tick phase in its wall-clock Timer and shows the per-phase ms
breakdown in the live overlay (crate.py:97-124 via utils/timer.py:37-48).
This tick runs the same phase helpers that :func:`physics.step` composes,
in the same order (so the math cannot drift from the fused step), each
under a :class:`~sand_crate_tpu_torch.diagnostics.PhaseTimer` phase named as
in the JAX package.  On a CUDA device each phase ends in
``torch.cuda.synchronize``, so the timer attributes the device time of the
phase's kernels to it; the synchronisation costs the overlap of host and
device, so this mode is for interactive profiling, not benching.
"""

from __future__ import annotations

import torch

from . import physics
from .state import NUM_FORCES, CrateState, Diagnostics, Params, Scene


def instrumented_tick(
    state: CrateState,
    params: Params,
    scene: Scene,
    generator: torch.Generator,
    timer,
) -> tuple[CrateState, Diagnostics]:
    """One tick as timed phases; the same result as :func:`physics.step`.

    ``timer`` is a :class:`~sand_crate_tpu_torch.diagnostics.PhaseTimer`;
    phase names follow the reference tick (crate.py:97-124)."""
    device = state.pos.device

    def sync() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    with timer("Lifecycle"):
        state, truncated = physics.spawn_particles(state, params, scene, generator)
        state = physics.cull_particles(state, params)
        state = physics.advance_bodies(state, params, scene)
        sync()
    with timer("Virtual Colliders"):
        ghost = physics.ghost_phase(state, params, scene)
        sync()
    with timer("Collisions"):
        ops = physics.neighbor_stage(
            state.vel, state.alive, state.uid, ghost, state.tick, params, scene,
            prepos=state.pos, segments=state.segments,
            body_lin_vel=state.body_lin_vel, body_ang_vel=state.body_ang_vel,
            generator=generator,
        )
        sync()
    vel, alive, ghost, sums = ops.vel, ops.alive, ops.ghost, ops.sums
    kicks = [
        ("tension", lambda v: physics.apply_tension(v, alive, sums, params)),
        ("gravity", lambda v: physics.apply_gravity(v, alive, params)),
        ("pressure", lambda v: physics.apply_pressure_force(v, alive, sums, ghost, params)),
        ("spring", lambda v: physics.apply_spring(v, alive, sums, ghost, params)),
        ("viscosity", lambda v: physics.apply_viscosity(v, alive, sums, params)),
        ("wall_bounce", lambda v: physics.apply_wall_bounce(v, alive, ghost, params)),
        ("continuous_collision", lambda v: physics.apply_continuous_collision(
            ops.pos, v, alive, state.segments, params, scene)),
    ]
    dv_log = []
    for name, kick in kicks:
        if name == "spring" and not scene.enable_spring:
            dv_log.append(torch.zeros((), dtype=vel.dtype, device=device))
            continue
        with timer(name):
            vel, dv = kick(vel)
            sync()
        dv_log.append(dv)
    with timer("Integrate"):
        body_lin_vel = physics.gravity_on_free_bodies(state, params, scene)
        new_state, diag = physics.finish_tick(
            state, ops, vel, body_lin_vel, dv_log, truncated, params
        )
        sync()
    assert diag.force_dv.shape == (NUM_FORCES,)
    return new_state, diag
