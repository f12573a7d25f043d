"""The entry points of ``__graft_entry__.py``, in the port.

* :func:`entry` -> (fn, example_args): one physics step of the flagship
  scene (stirring_cup), ``fn(state, params) -> (pos, force_dv)``.
* :func:`dryrun_multichip` (n_devices): the five multi-device legs on tiny
  shapes, as the JAX dry run: the batched crates split along the crate axis
  over an n-device mesh (``parallel.py``; the ``chunked`` backend, capacity
  128, 2 crates a mesh row), then one crate split into y-bands
  (``spatial.py``, capacity 256): cellwise, pallas and pmajor bands, and
  cellwise over rebalanced bands.  The band legs run on a ``LocalGroup``
  of one device (n threads), two ticks each (on the card the first runs
  eagerly and captures, the second replays, as the JAX dry run runs a
  compiled program), and the particle count must hold between them; the
  mesh repeats that device when the host has fewer.

Both run on the card unless the caller asks for the CPU (``device="cpu"``);
without a card they raise.  The scene is ``configs/stirring_cup.yaml``.
"""

from __future__ import annotations

import torch

from .config import CONFIGS_DIR, InitialParticlesConfig, load_config
from .state import resolve_device


def _stirring_cup():
    return load_config(CONFIGS_DIR / "stirring_cup.yaml")


def entry(device="cuda"):
    """(fn, (state, params)): one step of stirring_cup at its defaults."""
    from .physics import step
    from .scene import build_all

    scene, state, params = build_all(_stirring_cup(), device=device)
    generator = torch.Generator(device=scene.segments0.device)
    generator.manual_seed(0)

    def fn(state, params):
        new_state, diag = step(state, params, scene, generator)
        return new_state.pos, diag.force_dv

    return fn, (state, params)


def _mesh_devices(n_devices: int, device: torch.device) -> list[torch.device]:
    """n devices of ``device``'s type: the card's own when there are enough,
    else ``device`` repeated."""
    if device.type == "cuda" and torch.cuda.device_count() >= n_devices:
        return [torch.device("cuda", i) for i in range(n_devices)]
    return [device] * n_devices


def _band_tick(band, t: int, args):
    """One call of a band step; prints which path it took (on the card the
    first call of a step runs eagerly and captures, a later one replays)."""
    from . import graphs

    before = dict(graphs.LAUNCHES)
    out = band(*args)
    rose = {k: graphs.LAUNCHES[k] - before[k] for k in before}
    path = ("eager + capture" if rose["capture"] else "replay" if rose["replay"]
            else "eager")
    print(f"  band tick {t + 1}: {path}")
    return out


def _same_count(name: str, counts: list) -> None:
    if counts[0] != counts[1]:
        raise RuntimeError(f"dryrun {name}: {counts[1]} particles after the second band "
                           f"tick, {counts[0]} after the first")


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """The five legs; prints one line each, returns their particle counts
    (and the rebalanced edges)."""
    from .collectives import LocalGroup
    from .parallel import make_mesh, shard_batched, sharded_batched_step
    from .scene import build_scene, init_state
    from .spatial import initial_band_edges, make_spatial_step, split_state
    from .state import Params
    from .sweep import stack_params, stack_states

    device = resolve_device(device, "dryrun_multichip")
    world = _stirring_cup().world_config
    world.coefficients = dict(world.coefficients)
    world.coefficients["max_particles"] = 64
    # chunked: what BatchedCrates runs past its dense ceiling, so the batched
    # leg dry-runs the backend of real batched runs (as the JAX dry run).
    scene = build_scene(world, capacity=128, forces_mode="chunked", device=device)

    mesh = make_mesh(n_devices, devices=_mesh_devices(n_devices, device))
    n_batch = mesh.shape["crates"] * 2
    base = Params.from_coefficients(world.coefficients, device)
    params = stack_params([base] * n_batch)
    states = stack_states([init_state(world, scene, seed=i) for i in range(n_batch)])
    sh_states, sh_params, _ = shard_batched(mesh, states, params)
    new_states, _ = sharded_batched_step(mesh, scene)(sh_states, sh_params)
    merged = new_states.gather(device)
    if merged.pos.shape != states.pos.shape:
        raise RuntimeError(f"dryrun_multichip: {merged.pos.shape} != {states.pos.shape}")
    out = {"batched": int(merged.alive.sum())}
    print(f"dryrun_multichip OK: mesh={dict(mesh.shape)} batch={n_batch} "
          f"capacity={scene.capacity} tick executed")

    # One crate's particles split into y-bands over the shards, with halo
    # exchange and migration.
    world.initial_particles = [
        InitialParticlesConfig(x0=0.3, y0=0.2, x1=0.7, y1=0.7, spacing=0.03, jitter=0.0)
    ]
    sscene = build_scene(world, capacity=256, forces_mode="cellwise", device=device)
    n_space = n_devices - (n_devices % 2) if n_devices > 1 else 1
    while sscene.grid_ny % n_space:
        n_space //= 2
    group = LocalGroup(n_space, device=device)
    sparams = Params.from_coefficients(world.coefficients, device)
    try:
        legs = (
            ("spatial", sscene, "halo+migration executed"),
            ("spatial-pallas", build_scene(world, capacity=256, forces_mode="pallas",
                                           device=device), "pallas pair passes executed"),
            ("spatial-pmajor", build_scene(world, capacity=256, forces_mode="pmajor",
                                           device=device), "p-major band passes executed"),
        )
        for name, sc, what in legs:
            st = split_state(init_state(world, sc, seed=0), sc, n_space)
            band = make_spatial_step(group, sc)
            counts = []
            for t in range(2):
                st, stats = _band_tick(band, t, (st, sparams))
                counts.append(int(stats["particle_count"]))
            _same_count(name, counts)
            out[name] = counts[-1]
            print(f"dryrun {name} OK: shards={n_space} particles={out[name]} {what}")

        # Load-balanced bands: density-quantile edges, recomputed in the step.
        b0 = init_state(world, sscene, seed=0)
        edges = initial_band_edges(b0, sscene, n_space)
        bstate = split_state(b0, sscene, n_space, edges)
        band = make_spatial_step(group, sscene, rebalance=True)
        counts = []
        for t in range(2):
            bstate, bstats = _band_tick(band, t, (bstate, sparams, edges))
            edges = bstats["band_edges"]
            counts.append(int(bstats["particle_count"]))
        _same_count("spatial-rebalance", counts)
        out["spatial-rebalance"] = counts[-1]
        out["band_edges"] = [int(e) for e in edges]
        print(f"dryrun spatial-rebalance OK: shards={n_space} "
              f"particles={out['spatial-rebalance']} edges={out['band_edges']}")
    finally:
        group.close()
    return out


if __name__ == "__main__":
    fn, (state, params) = entry()
    pos, dv = fn(state, params)
    print("entry OK:", tuple(pos.shape), tuple(dv.shape))
    dryrun_multichip(max(1, torch.cuda.device_count()))
