"""Host-side simulation handle — the reference ``Crate`` API on the port.

The counterpart of ``sand_crate_tpu/engine.py``: ``physics_tick()``,
``run()``, ``editable_coefficients()``, attribute-style coefficient get/set
(the playback layer's live-editing contract, reference playback.py:221-226)
and the ``particles`` / ``particle_velocities`` / ``particles_pressure`` /
``segments`` / ``debug_prints`` views (playback.py:77-81), while the state
lives on ``device`` as a :class:`~sand_crate_tpu_torch.state.CrateState`
advanced by the functional step.  ``device`` defaults to "cuda": without a
card the constructor raises, and the caller asks for the CPU with
``device="cpu"``.  The emitters draw from a ``torch.Generator`` on the same
device, seeded from ``seed``.

Not ported yet (ROADMAP queue 1 items 6 and 10): grid rebuilds on a radius
edit past the cell size, ``stream_frames``, checkpoints and
``instrument=True``; each raises NotImplementedError.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .config import COEFFICIENT_NAMES, WorldConfig
from .diagnostics import ForceMonitor, PhaseTimer, yaml_block
from .physics import rollout, step
from .scene import build_scene, init_state
from .state import FORCE_LABELS, Diagnostics, Params


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
        cell_capacity: Optional[int] = None,
        pmajor_symm: Optional[bool] = None,
        instrument: bool = False,
        device="cuda",
    ) -> None:
        if instrument:
            raise NotImplementedError(
                "instrument=True is not ported yet (ROADMAP queue 1 item 10)"
            )
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Crate runs on the CUDA device by default and none is available; "
                "pass device='cpu' to run on the CPU"
            )
        scene = build_scene(
            world_config,
            capacity=capacity,
            enable_spring=enable_spring,
            forces_mode=forces_mode,
            cell_capacity=cell_capacity,
            pmajor_symm=pmajor_symm,
            device=device,
        )
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
        for name, value in dict(
            world_config=world_config,
            scene=scene,
            state=init_state(world_config, scene, seed=seed),
            params=Params.from_coefficients(world_config.coefficients, device),
            generator=generator,
            debug_timer=PhaseTimer(),
            force_monitor=ForceMonitor(FORCE_LABELS),
            debug_prints="",
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
            value = getattr(params, name).cpu().numpy()
            return value if value.ndim else value.item()
        raise AttributeError(name)

    def __setattr__(self, name: str, value) -> None:
        if name in COEFFICIENT_NAMES:
            if name == "particle_radius":
                self._maybe_regrid(float(np.asarray(value)))
            old = getattr(self.params, name)
            new = torch.as_tensor(np.asarray(value), dtype=old.dtype, device=old.device)
            object.__setattr__(self, "params", self.params._replace(**{name: new}))
            self._coeff_overrides[name] = value
        elif name in self._ENGINE_ATTRS:
            object.__setattr__(self, name, value)
        else:
            raise AttributeError(f"Unknown attribute {name!r}")

    def _maybe_regrid(self, radius: float) -> None:
        """A live radius edit is safe while the diameter fits the cell size
        (the 3x3 cell stencil still covers the cutoff); rebuilding the grid
        past it is not ported yet."""
        if 2.0 * radius > self.scene.cell_size:
            raise NotImplementedError(
                "a particle_radius edit past the grid's cell size needs a grid "
                "rebuild, which is not ported yet (ROADMAP queue 1 item 6)"
            )

    # -- state views (playback read contract, playback.py:77-81) -------------

    def _alive_np(self) -> np.ndarray:
        return self.state.alive.cpu().numpy()

    @property
    def particles(self) -> np.ndarray:
        return self.state.pos.cpu().numpy()[self._alive_np()]

    @property
    def particle_velocities(self) -> np.ndarray:
        return self.state.vel.cpu().numpy()[self._alive_np()]

    @property
    def particles_pressure(self) -> np.ndarray:
        return self.state.pressure.cpu().numpy()[self._alive_np()]

    @property
    def segments(self) -> np.ndarray:
        valid = self.scene.seg_valid.cpu().numpy()
        return self.state.segments.cpu().numpy()[valid]

    @property
    def particle_count(self) -> int:
        return int(self.state.particle_count)

    @property
    def tick(self) -> int:
        return int(self.state.tick)

    # -- stepping -------------------------------------------------------------

    def physics_tick(self) -> None:
        """Advance one tick (interactive path; reference crate.py:91-129)."""
        with self.debug_timer("Step"):
            self.state, diag = step(self.state, self.params, self.scene, self.generator)
        with self.debug_timer("Sync"):
            force_dv = diag.force_dv.cpu().numpy()
        self.force_monitor.update(force_dv)
        self.set_debug_prints(diag)

    def run(self, num_ticks: int) -> Diagnostics:
        """Advance ``num_ticks`` on the device; reads the last tick's
        diagnostics back once, at the end, and returns them."""
        self.state, diag = rollout(
            self.state, self.params, self.scene, num_ticks, self.generator
        )
        self.force_monitor.update(diag.force_dv.cpu().numpy())
        self.set_debug_prints(diag)
        return diag

    def stream_frames(self, *args, **kwargs):
        raise NotImplementedError(
            "stream_frames waits for the recording port (ROADMAP queue 1 item 6)"
        )

    def save_checkpoint(self, path):
        raise NotImplementedError("checkpoints are not ported yet (ROADMAP queue 1 item 6)")

    def restore_checkpoint(self, path):
        raise NotImplementedError("checkpoints are not ported yet (ROADMAP queue 1 item 6)")

    # -- observability ---------------------------------------------------------

    def set_debug_prints(self, diag=None) -> None:
        """Same overlay text layout as the reference (crate.py:131-136)."""
        text = f"Tick: {self.tick}\n"
        count = int(diag.particle_count) if diag is not None else self.particle_count
        text += f"Particles: {count}\n"
        if diag is not None:
            bad = int(diag.non_finite)
            dropped = int(diag.neighbor_overflow)
            truncated = int(diag.spawn_truncated)
            if bad:
                text += f"WARNING non-finite particles: {bad}\n"
            if dropped:
                text += f"pair overflow: {dropped}\n"
            if truncated:
                text += f"emission truncated: {truncated}\n"
        text += self.debug_timer.report()
        text += f"\n\n{self.force_monitor.report()}"
        text += f"\n\n{self.get_coefficient_debug()}"
        self.debug_prints = text

    def get_coefficient_debug(self) -> str:
        """Live coefficient dump (crate.py:367-371)."""
        items = []
        for name in self.editable_coefficients():
            v = getattr(self.params, name).cpu().numpy()
            items.append({name: v.tolist() if v.ndim else v.item()})
        return yaml_block(items)
