"""Opt-in per-phase instrumented tick — the reference's on-screen phase timer.

The counterpart of ``sand_crate_tpu/instrument.py``: the reference wraps
every tick phase in its wall-clock Timer and shows the per-phase ms
breakdown in the live overlay (crate.py:97-124 via utils/timer.py:37-48).
This tick runs the same phase helpers that :func:`physics.step` composes,
in the same order (so the math cannot drift from the fused step; each kick
phase and Integrate is one stage of the step's velocity update), each
under a :class:`~sand_crate_tpu_torch.diagnostics.PhaseTimer` phase named as
in the JAX package.  On a CUDA device each phase ends in
``torch.cuda.synchronize``, so the timer attributes the device time of the
phase's kernels to it; the synchronisation costs the overlap of host and
device, so this mode is for interactive profiling, not benching.

The JAX package jits every phase and fetches a scalar after each, so its
timer shows compiled phase time.  The counterpart here is
:class:`PhaseGraphs`, which ``Crate(instrument=True)`` runs: on the card
each phase is one captured CUDA graph, replayed under its timer phase and
closed by a synchronize.  :func:`instrumented_tick` is the same phases run
eagerly (on the CPU, and on the card for comparison: its times hold the
host's launches).
"""

from __future__ import annotations

from typing import Callable

import torch

from . import diagnostics, graphs, physics
from .ops import kick, pmajor
from .state import NUM_FORCES, CrateState, Diagnostics, Params, Scene

# The phases that draw from the generator: the emitters' spawn and the
# dense or cellwise collider jitter.
DRAWS = ("Lifecycle", "Collisions")

# A phase reads and updates the tick's carry: a dict that starts with the
# state, params, scene and generator, and ends with new_state and diag.
Phase = Callable[[dict], None]


def _lifecycle(c: dict) -> None:
    state, c["truncated"] = physics.spawn_particles(c["state"], c["params"], c["scene"],
                                                    c["generator"])
    state = physics.cull_particles(state, c["params"])
    c["state"] = physics.advance_bodies(state, c["params"], c["scene"])


def _ghosts(c: dict) -> None:
    c["ghost"] = physics.ghost_phase(c["state"], c["params"], c["scene"])


def _collisions(c: dict) -> None:
    state = c["state"]
    ops = physics.neighbor_stage(
        state.vel, state.alive, state.uid, c["ghost"], state.tick, c["params"], c["scene"],
        prepos=state.pos, segments=state.segments,
        body_lin_vel=state.body_lin_vel, body_ang_vel=state.body_ang_vel,
        generator=c["generator"],
    )
    c["ops"], c["vel"], c["norms"] = ops, ops.vel, []


KICKS = ("tension", "gravity", "pressure", "spring", "viscosity", "wall_bounce",
         "continuous_collision")
# Each kick phase is one stage of the tick's velocity update (ops/kick.py).
STAGES = dict(zip(KICKS, kick.KICKS))


def _update(c: dict, stages: int) -> kick.KickOut:
    ops = c["ops"]
    return kick.velocity_update(stages, c["vel"], ops.pos, ops.alive, ops.sums, ops.ghost,
                                c["state"].segments, c["params"], c["scene"].seg_valid)


def _kick(name: str) -> Phase:
    def kick_phase(c: dict) -> None:
        out = _update(c, STAGES[name] | kick.NORMS)
        c["vel"] = out.vel
        c["norms"].append(out.norms)
    return kick_phase


def _integrate(c: dict) -> None:
    state, scene, params = c["state"], c["scene"], c["params"]
    out = _update(c, kick.INTEGRATE)
    body_lin_vel = physics.gravity_on_free_bodies(state, params, scene)
    c["new_state"], c["diag"] = physics.finish_tick(
        state, c["ops"], out._replace(norms=torch.cat(c["norms"])), body_lin_vel,
        c["truncated"])


def tick_phases(scene: Scene) -> list[tuple[str, Phase]]:
    """The tick's phases in order, named as the reference tick's
    (crate.py:97-124): Lifecycle, Virtual Colliders, Collisions, the kicks
    (the spring only with ``scene.enable_spring``), Integrate."""
    kicks = [k for k in KICKS if k != "spring" or scene.enable_spring]
    return ([("Lifecycle", _lifecycle), ("Virtual Colliders", _ghosts),
             ("Collisions", _collisions)]
            + [(k, _kick(k)) for k in kicks] + [("Integrate", _integrate)])


def _carry(state, params, scene, generator) -> dict:
    return {"state": state, "params": params, "scene": scene, "generator": generator}


def instrumented_tick(
    state: CrateState,
    params: Params,
    scene: Scene,
    generator: torch.Generator,
    timer,
) -> tuple[CrateState, Diagnostics]:
    """One tick as timed phases, run eagerly; the same result as
    :func:`physics.step`.

    ``timer`` is a :class:`~sand_crate_tpu_torch.diagnostics.PhaseTimer`;
    phase names follow the reference tick (crate.py:97-124)."""
    device = state.pos.device
    c = _carry(state, params, scene, generator)
    for name, phase in tick_phases(scene):
        with timer(name):
            phase(c)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    assert c["diag"].force_dv.shape == (NUM_FORCES,)
    return c["new_state"], c["diag"]


class PhaseGraphs(graphs.GraphSet):
    """The instrumented tick over static buffers (a Crate hands over its
    own state and Params, its StepGraph's buffers), as one CUDA graph a
    phase: the counterpart of the JAX package's jitted phase programs.

    A key's first call runs the tick eagerly on a side stream (its real
    tick, timed as :func:`instrumented_tick` times it), then captures the
    phases in tick order into one shared memory pool: each phase reads
    the previous phases' static outputs, the static state and the Params,
    and the last copies the new state into the static state.  The
    generator is registered with the phases that draw (DRAWS).  Later
    calls replay the graphs in the same order, each under its timer phase
    and closed by a synchronize.  The key (``graphs.GraphKey``) is
    StepGraph's: the Scene object (a regrid captures anew), the schedule,
    the generator, the buffers; a coefficient edit reaches the next replay
    through the static Params.  On the CPU the phases run eagerly."""

    def __init__(self, state: CrateState, params: Params) -> None:
        super().__init__()
        self.state = state
        self.params = params

    @property
    def device(self) -> torch.device:
        return self.state.pos.device

    def key(self, scene: Scene, generator) -> graphs.GraphKey:
        pos = self.state.pos
        return graphs.GraphKey(id(scene), pmajor.schedule(), None, id(generator), 1,
                               pos.device, pos.dtype, pos.shape[-2])

    def _eager(self, scene, generator, timer) -> Diagnostics:
        new, diag = instrumented_tick(self.state, self.params, scene, generator, timer)
        graphs.copy_into(self.state, new)
        return diag

    def step(self, scene: Scene, generator: torch.Generator, timer) -> Diagnostics:
        """Advance the static state one tick as timed phases.  Returns the
        tick's Diagnostics (on the card the last graph's static ones)."""
        dev = self.device
        if dev.type != "cuda":
            return self._eager(scene, generator, timer)
        key = self.key(scene, generator)
        caps = self._lookup(key)
        if caps is None:
            self._make_room()
            with diagnostics.span("graph.capture"):
                diag = graphs.warm_up(dev, lambda: self._eager(scene, generator, timer))
                self._keep(key, self._capture(scene, generator))
            return diag
        for name, cap in caps:
            with timer(name):
                carry = graphs.launch(cap)
                torch.cuda.synchronize(dev)
        return carry["diag"]

    def _capture(self, scene, generator) -> list:
        """(name, captured phase) in tick order; each keeps the carry of
        static outputs as its output."""
        pool = torch.cuda.graph_pool_handle()
        c = _carry(self.state, self.params, scene, generator)
        phases = tick_phases(scene)
        caps = []
        for i, (name, phase) in enumerate(phases):
            def body(phase=phase, last=i == len(phases) - 1):
                phase(c)
                if last:
                    graphs.copy_into(self.state, c["new_state"])
                return c

            draws = (generator,) if name in DRAWS else ()
            caps.append((name, graphs.record(self.device, body, draws, (scene, generator),
                                             pool=pool)))
        return caps
