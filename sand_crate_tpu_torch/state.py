"""Core containers: simulation parameters, static scene, dynamic crate state.

The PyTorch counterparts of ``sand_crate_tpu/state.py``.  The step stays
functional — ``step(state, params, scene) -> (state, diagnostics)`` — so the
three pieces are plain containers of tensors, not ``nn.Module``s:

* :class:`Params` — the 13 live-editable physics coefficients as 0-d (or
  (2,) for gravity) tensors on the crate's device, so an edit is a tensor
  swap and the step never reads a coefficient back to the host.
* :class:`Scene` — immutable scene description (bodies, motors, emitters) as
  tensors, plus the static integers and flags the step branches on.
* :class:`CrateState` — the dynamic state advanced by ``step``.  Unlike the
  JAX state it carries no PRNG key: the port's random numbers come from a
  ``torch.Generator`` that the ``Crate`` holds and hands to the step.

``params_from_numpy`` / ``scene_from_numpy`` / ``state_from_numpy`` take the
JAX package's pytrees leaf by leaf (as numpy arrays) into the port, and
:func:`to_numpy` takes any of these containers back out; every parity test
feeds the JAX state through them.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch


class Params(NamedTuple):
    """Live-editable coefficients (reference: crate.py:42-57).

    All leaves are f32 0-d tensors except ``gravity`` (2,) and
    ``max_particles`` (int32).
    """

    dt: torch.Tensor
    particle_radius: torch.Tensor
    wall_collision_decay: torch.Tensor
    spring_overlap_balance: torch.Tensor
    spring_amplifier: torch.Tensor
    pressure_amplifier: torch.Tensor
    ignored_pressure: torch.Tensor
    collider_noise_level: torch.Tensor
    viscosity: torch.Tensor
    max_particles: torch.Tensor
    surface_smoothing: torch.Tensor
    target_pressure: torch.Tensor
    gravity: torch.Tensor

    @property
    def diameter(self) -> torch.Tensor:
        return self.particle_radius * 2.0

    def to_coefficients(self) -> dict:
        """Back to the reference coefficient dict (host floats and lists)."""
        out = {}
        for name in self._fields:
            v = getattr(self, name).cpu().numpy()
            out[name] = v.tolist() if v.ndim else float(v)
        out["max_particles"] = int(self.max_particles)
        return out

    @staticmethod
    def from_coefficients(
        coefficients: dict, device="cuda", dtype=torch.float32
    ) -> "Params":
        """Params on ``device`` (the card unless the caller asks for the CPU)."""
        c = coefficients
        device = resolve_device(device, "Params.from_coefficients")
        return params_from_numpy(
            {
                name: np.asarray(
                    c[name], np.int32 if name == "max_particles" else np.float64
                )
                for name in Params._fields
            },
            device,
            dtype,
        )


@dataclasses.dataclass(frozen=True)
class Scene:
    """Immutable scene: rigid bodies, motors, emitters, and static sizes.

    Tensor fields live on the crate's device; the trailing int/float/bool
    fields are host values the step branches on.  The JAX Scene's
    TPU-tactic fields ``row_block``, ``pmajor_w``, ``pmajor_cs`` and
    ``pmajor_split`` have no counterpart: the port's p-major kernel visits
    every candidate and the grid kernels need no row block.
    """

    # --- rigid bodies (reference: rigid_body.py:36-40) ---------------------
    segments0: torch.Tensor  # (S, 2, 2) f32 — initial world-space segments
    seg_body: torch.Tensor  # (S,) int64 — owning body per segment
    seg_valid: torch.Tensor  # (S,) bool — False for padding rows
    body_kind: torch.Tensor  # (B,) int32 — 0 fixed / 1 motored / 2 free
    body_center: torch.Tensor  # (B, 2) f32 — rotation centers
    motor_lin: torch.Tensor  # (B, 2, 4) f32 — (amp, freq, phase, offset)
    motor_ang: torch.Tensor  # (B, 4) f32
    init_lin_vel: torch.Tensor  # (B, 2) f32
    init_ang_vel: torch.Tensor  # (B,) f32

    # --- emitters (reference: particle_source.py:9-15) ---------------------
    src_position: torch.Tensor  # (Z, 2) f32
    src_velocity: torch.Tensor  # (Z, 2) f32
    src_radius: torch.Tensor  # (Z,) f32
    src_flow: torch.Tensor  # (Z,) f32
    src_noise: torch.Tensor  # (Z,) f32
    src_active_ticks: torch.Tensor  # (Z,) int32

    # --- static sizes and flags -------------------------------------------
    capacity: int = 1024
    num_bodies: int = 0
    num_sources: int = 0
    cell_size: float = 0.01
    grid_nx: int = 104
    grid_ny: int = 104
    max_spawn: int = 64
    enable_spring: bool = False
    # Neighbor-force backend: "pmajor" (the grid-free sorted-slab pair
    # kernels, ops/pmajor.py), "pallas" (the padded slot grid,
    # ops/pallas_forces.py), "cellwise" (the cell grid in plain torch,
    # cellwise.py), "dense" (masked all-pairs, cellwise.py), "chunked"
    # (fixed-halo windows of the sorted slab, ops/chunked.py) or "gather"
    # (fixed-K neighbor lists, neighbors.py and physics.py).
    forces_mode: str = "pmajor"
    # Neighbors kept per particle by the "gather" backend (the reference's
    # MAX_ALLOWED_NEIGHBORS, collision_detector.py:6): the nearest K.
    max_neighbors: int = 20
    # Slots per grid cell of the "pallas" and "cellwise" backends (M of the
    # slot grid) and of the "gather" backend's cell table.  It changes
    # results: particles past rank M in a cell take their rank % M
    # cellmate's sums (gather: are no one's candidate) and are counted in
    # the overflow.
    cell_capacity: int = 16
    # The "chunked" backend's candidate halo (sorted-slab positions on each
    # side of a self chunk; a pair further apart is lost and counted into
    # the overflow) and its self-chunk width (JAX state.py:142, 149).
    chunk_halo: int = 384
    chunk_cs: int = 256
    # Fold tension and pressure into one pass-B force sum (see the JAX
    # Scene.fold_pairs): the PairSums then carry the combined kick in
    # dv_tension and zeros in pressure_real.
    fold_pairs: bool = False
    # Pair-antisymmetric collider noise: both positions of a pair are
    # jittered (amp scaled by 1/sqrt(2)), so pair forces are exactly
    # equal and opposite (see the JAX Scene.pmajor_symm).
    pmajor_symm: bool = False
    # Expression motors: ((body_idx, channel, ExprMotor), ...), channel
    # 0=vx / 1=vy / 2=angular (config.ExprMotor).
    motor_exprs: tuple = ()

    @property
    def num_segments(self) -> int:
        return self.segments0.shape[0]

    @property
    def num_cells(self) -> int:
        return self.grid_nx * self.grid_ny


SCENE_ARRAYS = tuple(
    f.name for f in dataclasses.fields(Scene) if f.type == "torch.Tensor"
)
SCENE_STATICS = tuple(
    f.name for f in dataclasses.fields(Scene) if f.name not in SCENE_ARRAYS
)


class CrateState(NamedTuple):
    """Dynamic state advanced by one physics tick.

    Dead particle slots stay frozen (masked writes); ``alive`` is the only
    source of truth for liveness.  The step keeps the state cell-sorted, so
    slot index is not identity; ``uid`` is.
    """

    pos: torch.Tensor  # (P, 2) f32
    vel: torch.Tensor  # (P, 2) f32
    alive: torch.Tensor  # (P,) bool
    pressure: torch.Tensor  # (P,) f32 — last tick's pressure, for rendering
    uid: torch.Tensor  # (P,) int32 — stable particle identity
    segments: torch.Tensor  # (S, 2, 2) f32 — current world segments
    body_lin_vel: torch.Tensor  # (B, 2) f32
    body_ang_vel: torch.Tensor  # (B,) f32
    time: torch.Tensor  # () f32 — motor time_from_start
    tick: torch.Tensor  # () int32

    @property
    def particle_count(self) -> torch.Tensor:
        return self.alive.sum(dtype=torch.int32)


class Diagnostics(NamedTuple):
    """Per-tick observability, as device tensors (the JAX Diagnostics)."""

    force_dv: torch.Tensor  # (NUM_FORCES,) f32 — mean ||dv|| over alive
    particle_count: torch.Tensor  # () int32
    # () int32 — pallas, cellwise, gather: particles past a cell's capacity;
    # chunked: candidate slots past the halo and alive rows past the sweep
    # bound; pmajor, dense: 0
    neighbor_overflow: torch.Tensor
    max_speed: torch.Tensor  # () f32
    non_finite: torch.Tensor  # () int32 — alive particles with NaN/inf
    spawn_truncated: torch.Tensor  # () int32 — emissions past max_spawn


FORCE_LABELS = (
    "tension",
    "gravity",
    "pressure",
    "spring",
    "viscosity",
    "wall_bounce",
    "continuous_collision",
)
NUM_FORCES = len(FORCE_LABELS)


def resolve_device(device, who: str) -> torch.device:
    """``device`` as a torch.device.  An entry point runs on the card unless
    the caller asks for the CPU: asked for CUDA without a card, it raises
    rather than falling back."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who} runs on the CUDA device by default and none is available; "
            "pass device='cpu' to run on the CPU"
        )
    return device


def _tensor(value, device, dtype):
    """One leaf to a tensor: floats to ``dtype``, ints to int32, bools kept."""
    a = np.array(value)  # a writable copy
    if a.dtype.kind == "f":
        return torch.as_tensor(a, dtype=dtype, device=device)
    if a.dtype.kind in "iu":
        return torch.as_tensor(a.astype(np.int32), device=device)
    return torch.as_tensor(a, device=device)


def params_from_numpy(arrays: dict, device="cuda", dtype=torch.float32) -> Params:
    """Params from ``{field: array}`` (e.g. the JAX Params leaves), on
    ``device`` (the card unless the caller asks for the CPU).  Stacked
    Params (every leaf with a leading crate axis, as ``sweep`` batches
    them) carry over leaf by leaf in the same way."""
    device = resolve_device(device, "params_from_numpy")
    return Params(**{k: _tensor(arrays[k], device, dtype) for k in Params._fields})


def scene_from_numpy(fields: dict, device="cuda", dtype=torch.float32) -> Scene:
    """Scene from ``{field: value}``: tensor fields from arrays on ``device``
    (the card unless the caller asks for the CPU), static fields as given.
    Keys that the port's Scene has no field for (the JAX Scene's TPU-tactic
    fields) are ignored."""
    device = resolve_device(device, "scene_from_numpy")
    arrays = {k: _tensor(fields[k], device, dtype) for k in SCENE_ARRAYS}
    arrays["seg_body"] = arrays["seg_body"].long()
    return Scene(**arrays, **{k: fields[k] for k in SCENE_STATICS if k in fields})


def state_from_numpy(arrays: dict, device="cuda", dtype=torch.float32) -> CrateState:
    """CrateState from ``{field: array}`` (e.g. the JAX CrateState leaves;
    its ``key`` has no counterpart and is ignored), on ``device`` (the card
    unless the caller asks for the CPU)."""
    device = resolve_device(device, "state_from_numpy")
    return CrateState(
        **{k: _tensor(arrays[k], device, dtype) for k in CrateState._fields}
    )


def to_numpy(x) -> dict:
    """Params / Scene / CrateState / Diagnostics / PairSums -> {field: numpy}.

    Static Scene fields come back as they are."""
    if dataclasses.is_dataclass(x):
        items = {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}
    else:
        items = x._asdict()
    return {
        k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
        for k, v in items.items()
    }
