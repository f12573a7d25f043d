"""Batched crates: vmapped parameter sweeps and data generation.

The PyTorch counterpart of ``sand_crate_tpu/sweep.py``.  The reference's
sweep runs its coefficient variants one after another (main.py:21-36).
Because the step is a pure function of (state, params), the variants become
a leading crate axis instead: ``torch.func.vmap`` of the port's own
``physics.step`` advances every crate at once on one device.  This is the
batched datagen mode of BASELINE.json config #5 (1024 crates, randomized
coefficients).  Params and states are stacked (every leaf gains the crate
axis), so every coefficient can differ per crate; the scene is shared.

Every backend of the JAX package's vmapped step vmaps here too: dense,
chunked, cellwise, gather, pmajor and pallas.  None reads a tensor back to
the host (the chunked sweep bound is a host int that is the same for every
crate), and each pair kernel takes a crate axis through a custom operator
whose vmap rule launches it once for every crate of the batch (ops/
pair_batch.py: D1, D2; ops/pmajor.py: K1/K2, and K10 under
``SAND_CRATE_PMSUB=1``; ops/pair_kernel.py: K4+K5, K8+K9).  The emitters and the dense, cellwise and
gather collider noise draw from one ``torch.Generator`` with
``randomness="different"``, so every crate draws numbers of its own; the
JAX package draws from ``jax.random``, so there the two agree in their
invariants and ranges, not in their draws.  pmajor and pallas hash their
noise from the slot and tick as JAX does.

On the card the vmapped tick is captured once as a CUDA graph over static
buffers and replayed (graphs.py), the counterpart of the JAX package's
jitted ``vmap(scan(step))``; on the CPU the same body runs eagerly.

Every entry point runs on the card unless the caller asks for the CPU
(``device="cpu"``); without a card it raises.
"""

from __future__ import annotations

import itertools
from pathlib import Path
from typing import Iterable, Optional

import numpy as np
import torch

from .config import Config
from .diagnostics import host_read, next_unit, span
from .graphs import StepGraph, clone, rollout_graph
from .physics import step
from .recording import TrajectoryWriter
from .scene import build_scene, default_capacity, init_state
from .state import CrateState, Diagnostics, Params, Scene, resolve_device

# The largest capacity BatchedCrates runs on the dense backend by default;
# larger crates take the chunked windows (JAX sweep.py:92-94).
DENSE_MAX_CAPACITY = 1024


def stack_params(params_list: Iterable[Params]) -> Params:
    """Stack per-crate Params along a new leading axis."""
    return Params(*(torch.stack(leaves) for leaves in zip(*params_list)))


def stack_states(states: Iterable[CrateState]) -> CrateState:
    return CrateState(*(torch.stack(leaves) for leaves in zip(*states)))


def grid_params(base: Params, options: dict) -> Params:
    """Cartesian-product coefficient grid -> stacked Params (main.py:26-36),
    in ``itertools.product`` order over ``options``' keys."""
    keys = list(options)
    variants = []
    for values in itertools.product(*(options[k] for k in keys)):
        override = {
            k: torch.as_tensor(v, dtype=getattr(base, k).dtype, device=getattr(base, k).device)
            for k, v in zip(keys, values)
        }
        variants.append(base._replace(**override))
    return stack_params(variants)


def random_params(
    generator: torch.Generator, base: Params, ranges: dict[str, tuple[float, float]], n: int
) -> Params:
    """``n`` crates with each coefficient of ``ranges`` uniform in its
    (lo, hi), drawn from ``generator`` (on ``base``'s device); the others
    are ``base``'s."""
    device = base.dt.device
    overrides = {}
    for name, (lo, hi) in ranges.items():
        u = torch.rand((n,), generator=generator, device=device)
        lo_t = torch.tensor(lo, dtype=torch.float32, device=device)
        hi_t = torch.tensor(hi, dtype=torch.float32, device=device)
        overrides[name] = lo_t + u * (hi_t - lo_t)
    tiled = Params(*(x.expand((n,) + x.shape).clone() for x in base))
    return tiled._replace(**overrides)


class BatchedCrates:
    """N independent crates advanced in lockstep with a vmapped step.

    All crates share one Scene (geometry, capacity); params and state carry
    a leading crate axis.  ``run`` queues its ticks on the device (on the
    card, replays of one captured vmapped tick over the batch's static
    buffers ``state`` and ``params``, advanced in place); crate i starts
    from ``init_state(seed=seed + i)``, and the crates' random draws come
    from one generator seeded with ``seed``."""

    def __init__(
        self,
        config: Config,
        batched_params: Params,
        *,
        seed: int = 0,
        scene: Optional[Scene] = None,
        device="cuda",
        **scene_kwargs,
    ) -> None:
        world = config.world_config
        if scene is None:
            device = resolve_device(device, "BatchedCrates")
            # Small crates vmap best as dense (P, P) planes; past ~1k
            # particles those planes grow too large and the chunked
            # backend's fixed windows take over.
            cap = scene_kwargs.get("capacity") or default_capacity(
                int(world.coefficients["max_particles"])
            )
            scene_kwargs.setdefault(
                "forces_mode", "dense" if cap <= DENSE_MAX_CAPACITY else "chunked"
            )
            scene = build_scene(world, device=device, **scene_kwargs)
        self.scene = scene
        device = scene.segments0.device
        params = Params(*(x.to(device) for x in batched_params))
        self.n = int(params.dt.shape[0])
        state = stack_states([init_state(world, scene, seed=seed + i) for i in range(self.n)])
        self.graph = StepGraph(state, params, batched_step, overflow_max=True)
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(seed)

    @property
    def state(self) -> CrateState:
        """The batch's static state buffers, advanced in place by ``run``;
        assigning a state copies it into them."""
        return self.graph.state

    @state.setter
    def state(self, value: CrateState) -> None:
        self.graph.load(state=value)

    @property
    def params(self) -> Params:
        """The batch's static coefficient buffers; assigning copies into them."""
        return self.graph.params

    @params.setter
    def params(self, value: Params) -> None:
        self.graph.load(params=value)

    def live_rows(self, num_ticks: int) -> int | None:
        """The chunked sweep bound for the next ``num_ticks`` ticks (None on
        the dense backend): the largest alive count of any crate now, plus
        a 6-sigma bound on the whole call's Binomial(flow, dt) emissions,
        at most the capacity (JAX sweep.py:103-123).  The same for every
        crate; a spawn run past it is counted into the overflow."""
        if self.scene.forces_mode != "chunked":
            return None
        sc = self.scene
        host_read("sweep.alive_count")
        cur = int(self.state.alive.sum(dim=1).max())
        host_read("sweep.src_flow")
        flow = float(sc.src_flow.sum())
        host_read("sweep.dt")
        exp = flow * float(self.params.dt.max()) * num_ticks
        slack = min(int(exp + 6.0 * exp**0.5 + 16), num_ticks * sc.num_sources * sc.max_spawn)
        return min(sc.capacity, cur + slack)

    def run(self, num_ticks: int) -> Diagnostics:
        """Advance all crates ``num_ticks``; returns stacked Diagnostics of
        the last tick, but ``neighbor_overflow``, each crate's largest over
        the call's ticks (a static running max, reset here): on pallas the
        alive particles past their cell's capacity, on pmajor 0 (its ranges
        are exact).  The sweep bound ``live_rows`` is computed once per
        call, and a new bound captures the tick anew.  Spans
        (diagnostics.span): ``batch.live_rows``, ``batch.launch``,
        ``batch.clone``."""
        if num_ticks < 1:
            raise ValueError(f"num_ticks must be at least 1, got {num_ticks}")
        next_unit()
        with span("batch.live_rows"):
            live_rows = self.live_rows(num_ticks)
        with span("batch.launch"):
            self.graph.reset_overflow()
            for _ in range(num_ticks):
                diag = self.graph.step(self.scene, self.generator, live_rows)
        with span("batch.clone"):
            return clone(diag)

    def particle_counts(self) -> np.ndarray:
        host_read("sweep.particle_counts")
        return self.state.alive.sum(dim=1).cpu().numpy()

    def positions(self) -> np.ndarray:
        host_read("sweep.positions")
        return self.state.pos.cpu().numpy()


def batched_step(state, params, scene, generator, live_rows=None):
    """One tick of every crate: ``physics.step`` vmapped over the crate
    axis, each crate drawing numbers of its own.  ``live_rows`` is a host
    int, the same for every crate.  Every backend vmaps, the pmajor
    backend on each of its pair schedules (``pmajor.schedule()``, read at
    each call as the solo step reads it)."""

    def one(st, pr):
        return step(st, pr, scene, generator, live_rows)

    return torch.func.vmap(one, randomness="different")(state, params)


def _batched_rollout(state, params, scene, num_ticks: int, generator, live_rows=None):
    """``num_ticks`` batched steps, functional: on the card replays of
    the captured :func:`batched_step` on static buffers that ``state`` and
    ``params`` are copied into, fresh copies returned (graphs.rollout_graph);
    on the CPU the same ticks eagerly.  The overflow is reduced with a max
    over the ticks: the last tick's alone would hide one in the middle."""
    if num_ticks < 1:
        raise ValueError(f"num_ticks must be at least 1, got {num_ticks}")
    g = rollout_graph(state, params, batched_step, overflow_max=True)
    g.reset_overflow()
    for _ in range(num_ticks):
        diag = g.step(scene, generator, live_rows)
    return clone(g.state), clone(diag)


# Default coefficient ranges for randomized datagen crates (spans around the
# shipped scene values, configs/stirring_cup.yaml; JAX sweep.py:159-166).
DEFAULT_RANDOM_RANGES = {
    "viscosity": (2.0, 12.0),
    "pressure_amplifier": (10.0, 60.0),
    "surface_smoothing": (20.0, 150.0),
    "target_pressure": (-6.0, 3.0),
    "ignored_pressure": (0.05, 0.4),
}


def run_datagen(
    config: Config,
    n_crates: int,
    ticks: int,
    sample_every: int,
    out_dir,
    *,
    seed: int = 0,
    ranges: Optional[dict] = None,
    forces_mode: Optional[str] = None,
    device="cuda",
) -> dict:
    """Batched trajectory data generation (BASELINE.json config #5).

    ``n_crates`` crates with randomized coefficients advance in lockstep;
    every ``sample_every`` ticks one batched frame (pos, alive, pressure,
    segments of every crate) streams to npz shards, and the per-crate
    coefficients are saved beside them as labels (``params.npz``).
    ``forces_mode`` None lets BatchedCrates pick.  Returns the frame and
    crate counts, the directory, and the largest overflow and non-finite
    count of any crate over the run."""
    device = resolve_device(device, "run_datagen")
    base = Params.from_coefficients(config.world_config.coefficients, device)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    batched = random_params(generator, base, ranges or DEFAULT_RANDOM_RANGES, n_crates)
    kw = {} if forces_mode is None else {"forces_mode": forces_mode}
    crates = BatchedCrates(config, batched, seed=seed, device=device, **kw)
    out_dir = Path(out_dir)
    writer = TrajectoryWriter(out_dir, shard_frames=8)
    np.savez_compressed(
        out_dir / "params.npz",
        **{name: getattr(batched, name).cpu().numpy() for name in Params._fields},
    )
    n_frames = ticks // sample_every
    overflow = non_finite = 0
    for i in range(n_frames):
        diag = crates.run(sample_every)
        st = crates.state
        writer.append(dict(pos=st.pos, alive=st.alive, pressure=st.pressure,
                           segments=st.segments))
        host_read("sweep.neighbor_overflow")
        overflow = max(overflow, int(diag.neighbor_overflow.max()))
        host_read("sweep.non_finite")
        non_finite = max(non_finite, int(diag.non_finite.max()))
        print(f"datagen frame {i + 1}/{n_frames} (tick {(i + 1) * sample_every})")
    path = writer.close(meta={"crates": n_crates, "sample_every": sample_every})
    print(f"wrote {n_frames} batched frames x {n_crates} crates -> {path}")
    return {"frames": n_frames, "crates": n_crates, "dir": str(path),
            "overflow": overflow, "non_finite": non_finite}


def run_vmapped_sweep(config: Config, options: dict, ticks: int = 400, device="cuda") -> dict:
    """Run the reference's coefficient sweep as one vmapped batch."""
    device = resolve_device(device, "run_vmapped_sweep")
    base = Params.from_coefficients(config.world_config.coefficients, device)
    batched = grid_params(base, options)
    crates = BatchedCrates(config, batched, device=device)
    print(f"Running {crates.n} crates x {ticks} ticks vmapped on one device...")
    diag = crates.run(ticks)
    counts = crates.particle_counts()
    keys = list(options)
    print(f"{'variant':<8} " + " ".join(f"{k[:12]:>12}" for k in keys) + "  particles")
    for i, values in enumerate(itertools.product(*(options[k] for k in keys))):
        print(f"{i:<8} " + " ".join(f"{v:>12}" for v in values) + f"  {counts[i]}")
    return {"particle_counts": counts, "diagnostics": diag}
