"""Host-side simulation handle — the reference ``Crate`` API on the port.

The counterpart of ``sand_crate_tpu/engine.py``: ``physics_tick()``,
``run()``, ``stream_frames()``, ``editable_coefficients()``, attribute-style
coefficient get/set (the playback layer's live-editing contract, reference
playback.py:221-226), a grid rebuild when a radius edit outgrows the cell
size, and the ``particles`` / ``particle_velocities`` /
``particles_pressure`` / ``segments`` / ``debug_prints`` / ``debug_arrows``
views (playback.py:77-81), while the state lives on ``device`` as a
:class:`~sand_crate_tpu_torch.state.CrateState` advanced by the functional
step.  ``device`` defaults to "cuda": without a card the constructor raises,
and the caller asks for the CPU with ``device="cpu"``.  The emitters (and
the dense backend's collider noise) draw from a ``torch.Generator`` on the
same device, seeded from ``seed``.

Two execution modes, as in the JAX package:
* ``physics_tick()`` — one step per call, for interactive playback; with
  ``instrument=True`` it runs the phase-timed tick of ``instrument.py``
  (on the card one replayed graph a phase, ``instrument.PhaseGraphs``, as
  the JAX package jits each phase).
* ``run()`` / ``stream_frames()`` — ticks queued on the device with no host
  read inside; ``stream_frames`` copies each chunk's frames to the host
  while the next chunk runs.

The crate owns a :class:`~sand_crate_tpu_torch.graphs.StepGraph` whose
static buffers are the crate's ``state`` and ``params`` (the counterpart of
the JAX ``Crate._step_fn``, ``jax.jit(step, donate_argnums=(0,))``): on the
card every tick of ``physics_tick``, ``run`` and ``stream_frames`` is a
replay of a captured CUDA graph, and the state is advanced in place.  So a
coefficient edit, an assignment to ``crate.state`` or ``crate.params`` and
a checkpoint restore copy into those buffers (the captured graph reads
them), and a reference to ``crate.state`` sees the next tick's values, as
the JAX crate's donated state is gone after its next step.

``save_checkpoint`` / ``restore_checkpoint`` write and read one npz
(``recording.py``): state, coefficients and the generator state, so a
resumed crate continues exactly as an uninterrupted one.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Iterator, Optional

import numpy as np
import torch

from .config import COEFFICIENT_NAMES, Config, WorldConfig
from .diagnostics import (FRAMES, ForceMonitor, PhaseTimer, host_read, next_unit, span,
                          yaml_block)
from .graphs import StepGraph, clone
from .instrument import PhaseGraphs
from .physics import step
from .recording import load_checkpoint, save_checkpoint
from .scene import build_scene, init_state
from .state import FORCE_LABELS, Diagnostics, Params, resolve_device

# The read counters' sites of the state views (diagnostics.host_read).
_READ_SITES = {f: "engine." + f for f in ("alive", "pos", "vel", "pressure", "segments")}

class Crate:
    """The reference Crate (crate.py:19-371) on the PyTorch port."""

    _ENGINE_ATTRS = {
        "world_config",
        "scene",
        "state",
        "params",
        "generator",
        "debug_timer",
        "force_monitor",
        "debug_prints",
        "debug_arrows",
        "velocity_arrows_every",
        "instrument",
        "graph",
        "phases",
        "_coeff_overrides",
    }

    def __init__(
        self,
        world_config: WorldConfig,
        *,
        seed: int = 0,
        capacity: Optional[int] = None,
        enable_spring: bool = False,
        forces_mode: str = "auto",
        max_neighbors: int = 20,
        cell_capacity: Optional[int] = None,
        chunk_halo: Optional[int] = None,
        chunk_cs: int = 256,
        pmajor_symm: Optional[bool] = None,
        instrument: bool = False,
        device="cuda",
    ) -> None:
        device = resolve_device(device, "Crate")
        scene = build_scene(
            world_config,
            capacity=capacity,
            enable_spring=enable_spring,
            forces_mode=forces_mode,
            max_neighbors=max_neighbors,
            cell_capacity=cell_capacity,
            chunk_halo=chunk_halo,
            chunk_cs=chunk_cs,
            pmajor_symm=pmajor_symm,
            # Instrumented runs want the true per-force monitor split, so
            # they keep tension and pressure as separate pair sums.
            fold_pairs=False if instrument else None,
            device=device,
        )
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
        state = init_state(world_config, scene, seed=seed)
        params = Params.from_coefficients(world_config.coefficients, device)
        for name, value in dict(
            world_config=world_config,
            scene=scene,
            state=state,
            params=params,
            graph=StepGraph(state, params, step),
            phases=PhaseGraphs(state, params),
            generator=generator,
            debug_timer=PhaseTimer(),
            force_monitor=ForceMonitor(FORCE_LABELS),
            debug_prints="",
            debug_arrows=[],
            velocity_arrows_every=0,
            instrument=instrument,
            _coeff_overrides={},
        ).items():
            object.__setattr__(self, name, value)

    # -- coefficient surface (playback live-editing contract) ---------------

    def editable_coefficients(self) -> list[str]:
        """Reference: crate.py:59-60 — every coefficient is editable."""
        return list(COEFFICIENT_NAMES)

    def __getattr__(self, name: str):
        # Called only when normal lookup fails: map coefficient names to params.
        if name in COEFFICIENT_NAMES:
            params = object.__getattribute__(self, "params")
            host_read("engine.coefficient")
            value = getattr(params, name).cpu().numpy()
            return value if value.ndim else value.item()
        raise AttributeError(name)

    def __setattr__(self, name: str, value) -> None:
        if name in COEFFICIENT_NAMES:
            if name == "particle_radius":
                self._maybe_regrid(float(np.asarray(value)))
            # Into the captured Params tensor (its identity kept): the next
            # tick, replayed or eager, reads the new value; no new capture.
            old = getattr(self.params, name)
            new = torch.as_tensor(np.asarray(value), dtype=old.dtype)
            if new.shape != old.shape:
                raise ValueError(f"{name}: shape {tuple(new.shape)} != {tuple(old.shape)}")
            old.copy_(new)
            self._coeff_overrides[name] = value
        elif name in ("state", "params"):
            self.graph.load(**{name: value})  # into the static buffers
        elif name in self._ENGINE_ATTRS:
            object.__setattr__(self, name, value)
        else:
            raise AttributeError(f"Unknown attribute {name!r}")

    def _maybe_regrid(self, radius: float) -> None:
        """Rebuild the neighbor grid when a live radius edit outgrows it
        (JAX engine.py:131-167).

        The grid backends search the 3x3 cell stencil (chunked: rows within
        one of each other), which covers the cutoff only while diameter <=
        cell_size; the cell dims are static Scene fields while
        particle_radius is a live coefficient.  When an edit pushes 2 *
        radius past cell_size, the Scene is rebuilt around the new diameter
        with the same options (the chunked halo follows the new grid, as in
        the JAX package); the state needs nothing, since every tick sorts it
        anew.  The dense backend has no stencil and keeps its scene."""
        scene = self.scene
        if scene.forces_mode == "dense" or 2.0 * radius <= scene.cell_size:
            return
        world = self.world_config
        coeff = dict(world.coefficients)
        coeff["particle_radius"] = radius
        new_scene = build_scene(
            dataclasses.replace(world, coefficients=coeff),
            capacity=scene.capacity,
            enable_spring=scene.enable_spring,
            forces_mode=scene.forces_mode,
            max_neighbors=scene.max_neighbors,
            cell_capacity=scene.cell_capacity,
            chunk_cs=scene.chunk_cs,
            fold_pairs=scene.fold_pairs,
            pmajor_symm=scene.pmajor_symm,
            device=scene.segments0.device,
            dtype=scene.segments0.dtype,
        )
        object.__setattr__(self, "scene", new_scene)

    @property
    def diameter(self) -> float:
        host_read("engine.diameter")
        return 2.0 * float(self.params.particle_radius)

    # -- state views (playback read contract, playback.py:77-81) -------------

    def _host(self, name: str) -> np.ndarray:
        """The state's field ``name`` read back to the host."""
        host_read(_READ_SITES[name])
        return getattr(self.state, name).cpu().numpy()

    def _alive_np(self) -> np.ndarray:
        return self._host("alive")

    @property
    def particles(self) -> np.ndarray:
        return self._host("pos")[self._alive_np()]

    @property
    def particle_velocities(self) -> np.ndarray:
        return self._host("vel")[self._alive_np()]

    @property
    def particles_pressure(self) -> np.ndarray:
        return self._host("pressure")[self._alive_np()]

    @property
    def segments(self) -> np.ndarray:
        host_read("engine.seg_valid")
        valid = self.scene.seg_valid.cpu().numpy()
        return self._host("segments")[valid]

    @property
    def particle_count(self) -> int:
        host_read("engine.particle_count")
        return int(self.state.particle_count)

    @property
    def tick(self) -> int:
        host_read("engine.tick")
        return int(self.state.tick)

    # -- stepping -------------------------------------------------------------

    def physics_tick(self) -> None:
        """Advance one tick (interactive path; reference crate.py:91-129).

        With ``instrument=True`` the tick runs as timed phases (on the
        card a replay of each phase's graph over the crate's buffers), so
        ``debug_timer`` shows the reference-style per-phase breakdown
        (crate.py:97-124) in the overlay; the default is the whole step.
        Spans (diagnostics.span): ``tick.launch``, ``tick.readback``,
        ``tick.monitor``, ``tick.prints``.  A tick makes 19 synchronising
        reads (diagnostics.READS): ``force_dv``, the tick, 4 diagnostics
        scalars and the 13 coefficients of the overlay."""
        next_unit()
        if self.instrument:
            with span("tick.launch"):
                diag = self.phases.step(self.scene, self.generator, self.debug_timer)
            with span("tick.readback"):
                host_read("engine.force_dv")
                force_dv = diag.force_dv.cpu().numpy()
        else:
            with self.debug_timer("Step", "tick.launch"):
                diag = self.graph.step(self.scene, self.generator)
            with self.debug_timer("Sync", "tick.readback"):
                host_read("engine.force_dv")
                force_dv = diag.force_dv.cpu().numpy()
        with span("tick.monitor"):
            self.force_monitor.update(force_dv)
        with span("tick.prints"):
            self.set_debug_prints(diag)
        if self.velocity_arrows_every:
            self.update_velocity_arrows(self.velocity_arrows_every)

    def update_velocity_arrows(self, every: int = 25, scale: float = 0.02) -> None:
        """Fill ``debug_arrows`` with sampled per-particle velocity vectors
        (the debug overlay channel of reference crate.py:34,94 and
        playback.py:95-107)."""
        pts = self.particles[::every]
        vecs = self.particle_velocities[::every] * scale
        object.__setattr__(self, "debug_arrows", list(zip(pts, vecs)))

    def run(self, num_ticks: int) -> Diagnostics:
        """Advance ``num_ticks`` on the device (on the card, ``num_ticks``
        replays of the crate's graph: one program, no host work between
        ticks); reads the last tick's diagnostics back once, at the end,
        and returns a copy of them.  Spans: ``run.launch``, ``run.readback``,
        ``run.prints``."""
        next_unit()
        with span("run.launch"):
            for _ in range(num_ticks):
                diag = self.graph.step(self.scene, self.generator)
            diag = clone(diag)
        with span("run.readback"):
            host_read("engine.force_dv")
            force_dv = diag.force_dv.cpu().numpy()
        self.force_monitor.update(force_dv)
        with span("run.prints"):
            self.set_debug_prints(diag)
        return diag

    def stream_frames(
        self, num_frames: int, ticks_per_frame: int = 1, chunk_frames: int = 16
    ) -> Iterator[dict]:
        """Yield render frames (dicts of numpy arrays: pos, alive, pressure,
        segments, force_dv) while stepping in chunks of ``chunk_frames``.

        A frame is ``ticks_per_frame`` replays of the crate's graph; its
        fields are copied out of the static state into the
        chunk's own device tensors on the compute stream before the next
        replay (graphs.StepGraph.frames), so no replay overwrites a frame.
        Double-buffered on a CUDA device: each chunk's frames are copied to
        pinned host memory on a side stream, behind an event recorded after
        the chunk's frame copies, and the next chunk is dispatched before
        the previous one's frames are waited for and yielded, so recording
        never stalls the step loop.  On the CPU the same ticks run eagerly.

        Spans: ``frames.dispatch`` (a chunk's replays and frame copies
        enqueued), ``frames.copy_issue`` (its copies to pinned memory
        enqueued), ``frames.wait`` (the wait for the chunk before it) and
        ``frames.yield`` (one a frame: its host views made; the consumer's
        own time lies outside every span).  Each frame is a unit;
        diagnostics.FRAMES counts the frames and bytes."""
        cuda = self.state.pos.device.type == "cuda"
        copy_stream = torch.cuda.Stream(self.state.pos.device) if cuda else None
        pending = None  # (host frames, copy-done event, device frames) of a chunk
        frames_left = num_frames
        while frames_left > 0 or pending is not None:
            ready = None
            if frames_left > 0:
                n = min(chunk_frames, frames_left)
                frames_left -= n
                with span("frames.dispatch"):
                    frames = self.graph.frames(self.scene, self.generator, n, ticks_per_frame)
                FRAMES["frames"] += n
                FRAMES["bytes"] += sum(v.nbytes for v in frames.values())
                if cuda:
                    with span("frames.copy_issue"):
                        computed = torch.cuda.Event()
                        computed.record()
                        with torch.cuda.stream(copy_stream):
                            copy_stream.wait_event(computed)
                            host = {
                                k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True).copy_(
                                    v, non_blocking=True)
                                for k, v in frames.items()
                            }
                            done = torch.cuda.Event()
                            done.record(copy_stream)
                    # The device frames stay referenced until the copy is done.
                    ready = (host, done, frames)
                else:
                    ready = (frames, None, None)
            if pending is not None:
                host, done, _ = pending
                with span("frames.wait"):
                    if done is not None:
                        done.synchronize()
                for i in range(host["pos"].shape[0]):
                    next_unit()
                    with span("frames.yield"):
                        frame = {k: v[i].numpy() for k, v in host.items()}
                    yield frame
            pending = ready

    def save_checkpoint(self, path) -> Path:
        """Snapshot the state, the coefficients and the emitters' generator
        to one npz file (recording.save_checkpoint)."""
        return save_checkpoint(path, self.state, self.params, self.generator)

    def restore_checkpoint(self, path) -> None:
        """Resume exactly from a :meth:`save_checkpoint` snapshot (or a JAX
        package checkpoint, whose emitter key is ignored) on this crate's
        device.

        The checkpoint's capacity must match this crate's scene: the scene
        comes from the config; only dynamic state, coefficients and the
        generator are stored.  The state and coefficients are copied into
        the crate's static buffers and the generator's state is set, which
        the next replay reads: the graphs already captured stay valid."""
        device = self.state.pos.device
        state, params, gen_state = load_checkpoint(path, device)
        if state.pos.shape[0] != self.scene.capacity:
            raise ValueError(
                f"checkpoint capacity {state.pos.shape[0]} != scene capacity "
                f"{self.scene.capacity}; rebuild the crate with matching capacity"
            )
        if gen_state is not None:
            self.generator.set_state(gen_state)
        self.graph.load(state, params)

    # -- observability ---------------------------------------------------------

    def set_debug_prints(self, diag=None) -> None:
        """Same overlay text layout as the reference (crate.py:131-136)."""
        text = f"Tick: {self.tick}\n"
        if diag is not None:
            host_read("engine.particle_count")
            count = int(diag.particle_count)
        else:
            count = self.particle_count
        text += f"Particles: {count}\n"
        if diag is not None:
            host_read("engine.non_finite")
            bad = int(diag.non_finite)
            host_read("engine.neighbor_overflow")
            dropped = int(diag.neighbor_overflow)
            host_read("engine.spawn_truncated")
            truncated = int(diag.spawn_truncated)
            if bad:
                text += f"WARNING non-finite particles: {bad}\n"
            if dropped:
                text += f"pair overflow: {dropped}\n"
            if truncated:
                text += f"emission truncated: {truncated}\n"
        text += self.debug_timer.report()
        text += f"\n\n{self.force_monitor.report()}"
        with span("tick.prints.coefficients"):
            text += f"\n\n{self.get_coefficient_debug()}"
        self.debug_prints = text

    def get_coefficient_debug(self) -> str:
        """Live coefficient dump (crate.py:367-371)."""
        items = []
        for name in self.editable_coefficients():
            host_read("engine.coefficients")
            v = getattr(self.params, name).cpu().numpy()
            items.append({name: v.tolist() if v.ndim else v.item()})
        return yaml_block(items)

    def current_coefficients(self) -> dict:
        return self.params.to_coefficients()


def crate_from_config(config: Config, **kwargs) -> Crate:
    return Crate(config.world_config, **kwargs)
