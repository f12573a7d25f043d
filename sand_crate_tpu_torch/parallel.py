"""Data parallel over devices along the crate axis.

The PyTorch counterpart of ``sand_crate_tpu/parallel.py``.  Batched crates
(``sweep.py``) are independent, so the crate axis splits over devices with
no communication: each device runs the vmapped step (``torch.func.vmap`` of
``physics.step``, as ``sweep.BatchedCrates``) on its block of crates with a
generator of its own.

The JAX mesh also has a "space" axis, which splits the particle axis under
plain GSPMD and exists to exercise that sharding for correctness; splitting
one crate is ``spatial.py``'s job, so the port does not run it.
:func:`make_mesh` keeps the JAX axis sizes in ``Mesh.shape`` (crates x
space over n devices), and the crates go over every device of the mesh.
Every backend of the vmapped step runs (dense, chunked, cellwise, gather,
pmajor and pallas; the JAX mesh test's is cellwise).  With no random draw
that matters (no emitter; no collider noise on dense, cellwise and gather,
while pmajor, pallas and chunked hash theirs from the slot and the tick),
the sharded step equals the unsharded vmap; otherwise each device's
generator draws other numbers than one generator over the whole batch, and
the two agree in their invariants.

Every entry point runs on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .state import CrateState, Params, Scene, resolve_device
from .sweep import _batched_rollout


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Devices laid out as the JAX (crates, space) mesh: ``devices`` an
    (n_crates, n_space) object array of torch devices, ``shape`` the axis
    sizes.  The crate axis runs over ``flat``, every device in row order."""

    devices: np.ndarray
    shape: dict

    @property
    def flat(self) -> list[torch.device]:
        return list(self.devices.reshape(-1))


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A (crates x space) mesh over the first ``n_devices`` of ``devices``
    (default: every CUDA device; without a card it raises).  The space axis
    is 2 when the count is even and at least 2, else 1 (JAX
    parallel.py:35-47)."""
    if devices is None:
        resolve_device("cuda", "make_mesh")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"make_mesh: {n_devices} devices asked, {len(devices)} given")
        devices = devices[:n_devices]
    n = len(devices)
    n_space = 2 if n % 2 == 0 and n >= 2 else 1
    n_crates = n // n_space
    grid = np.empty((n_crates, n_space), dtype=object)
    for i, dev in enumerate(devices[: n_crates * n_space]):
        grid[i // n_space, i % n_space] = dev
    return Mesh(devices=grid, shape={"crates": n_crates, "space": n_space})


def state_pspecs() -> CrateState:
    """Which leaves of a batched CrateState split along the crate axis: all
    of them, on their leading axis (the JAX specs also split the particle
    leaves over "space", which the port does not run)."""
    return CrateState(*([("crates",)] * len(CrateState._fields)))


def params_pspecs() -> Params:
    """Every coefficient is per crate (the vmapped sweep axis)."""
    return Params(*([("crates",)] * len(Params._fields)))


@dataclasses.dataclass
class ShardedBatch:
    """A batch split along its crate axis: ``parts[i]`` is device i's
    block (a CrateState or Params), ``devices[i]`` its device."""

    parts: list
    devices: list

    def gather(self, device=None):
        """The whole batch again, on ``device`` (default: the first part's)."""
        device = device or self.devices[0]
        cls = type(self.parts[0])
        return cls(*(torch.cat([leaf.to(device) for leaf in leaves])
                     for leaves in zip(*self.parts)))


def _blocks(n: int, k: int) -> list[slice]:
    """k contiguous blocks of n crates, the first n % k one crate longer."""
    sizes = [n // k + (i < n % k) for i in range(k)]
    starts = np.cumsum([0] + sizes)
    return [slice(int(a), int(b)) for a, b in zip(starts[:-1], starts[1:])]


def shard_batched(mesh: Mesh, state: CrateState, params: Params):
    """Split a batched (state, params) along the crate axis over the mesh's
    devices: (ShardedBatch of states, ShardedBatch of params, the specs)."""
    devices = mesh.flat
    n = int(state.pos.shape[0])
    if n < len(devices):
        raise ValueError(f"shard_batched: {n} crates for {len(devices)} devices")
    parts = _blocks(n, len(devices))
    s_parts = [CrateState(*(leaf[b].to(dev) for leaf in state)) for b, dev in zip(parts, devices)]
    p_parts = [Params(*(leaf[b].to(dev) for leaf in params)) for b, dev in zip(parts, devices)]
    return (ShardedBatch(s_parts, devices), ShardedBatch(p_parts, devices),
            (state_pspecs(), params_pspecs()))


def sharded_batched_step(mesh: Mesh, scene: Scene, *, seed: int = 0):
    """The batched step over the mesh: ``fn(states, params) -> (states,
    diagnostics)`` on ShardedBatches, each device's block advanced one tick
    by the vmapped step on that device (its scene copy, its generator,
    seeded ``seed + i``), on the scene's backend, any that
    ``sweep.batched_step`` takes.  The blocks are replaced, never written in place
    (the JAX step's ``donate`` has nothing to do here)."""
    devices = mesh.flat
    scenes, generators = {}, []
    for i, dev in enumerate(devices):
        if dev not in scenes:
            scenes[dev] = _scene_to(scene, dev)
        g = torch.Generator(device=dev)
        g.manual_seed(seed + i)
        generators.append(g)

    def step_fn(states: ShardedBatch, params: ShardedBatch):
        out, diags = [], []
        for st, pr, dev, g in zip(states.parts, params.parts, devices, generators):
            new, diag = _batched_rollout(st, pr, scenes[dev], 1, g)
            out.append(new)
            diags.append(diag)
        return ShardedBatch(out, devices), diags

    return step_fn


def _scene_to(scene: Scene, device: torch.device) -> Scene:
    """The scene with its tensors on ``device``."""
    moved = {
        f.name: getattr(scene, f.name).to(device)
        for f in dataclasses.fields(scene)
        if isinstance(getattr(scene, f.name), torch.Tensor)
    }
    return dataclasses.replace(scene, **moved)
