"""Per-shard load of the spatial (y-band) split (``tools/spatial_balance.py``).

Runs a dam-break block (noise 0, no sources, the cellwise backend at 8
slots a cell) in bands on a ``collectives.LocalGroup`` of one device (the
card unless the caller asks for the CPU) in place of the JAX CPU mesh, and
prints each band's alive count every tenth of the run (the step's
``shard_alive``) with max/mean.  Settled fluid piles into the bottom bands
while every shard keeps the full capacity; ``--rebalance`` runs the
variable-height bands (density-quantile edges recomputed in the step),
``--fine`` ~4x the particles on a ~2x finer grid.

Usage: python -m sand_crate_tpu_torch.tools.spatial_balance [n_shards] [ticks] [--rebalance] [--fine]
"""

from __future__ import annotations

import sys

from ..collectives import LocalGroup
from ..config import CONFIGS_DIR, InitialParticlesConfig, load_config
from ..scene import build_scene, init_state
from ..spatial import initial_band_edges, make_spatial_step, split_state
from ..state import Params


def toy_world(spacing: float, radius: float, cap: int):
    """The dam break's world without noise or sources: one unjittered block
    at ``spacing``, ``radius`` and ``cap`` max particles."""
    w = load_config(CONFIGS_DIR / "dam_break.yaml").world_config
    w.coefficients = dict(w.coefficients)
    w.coefficients["collider_noise_level"] = 0.0
    w.particle_sources = []
    w.initial_particles = [
        InitialParticlesConfig(x0=0.02, y0=0.10, x1=0.42, y1=0.98, spacing=spacing, jitter=0.0)
    ]
    w.coefficients["particle_radius"] = radius
    w.coefficients["max_particles"] = cap
    return w


def main(n_shards: int = 8, ticks: int = 300, rebalance: bool = False, fine: bool = False,
         device="cuda") -> list[tuple[int, list[int]]]:
    """Run the bands; returns the printed samples as (tick, shard_alive)."""
    spacing, radius, cap = (0.011, 0.006, 4096) if fine else (0.022, 0.012, 2048)
    w = toy_world(spacing, radius, cap)
    # the cellwise path; 8 slots a cell keep the dense pair blocks small
    # (the overflow does not bear on the question).
    scene = build_scene(w, capacity=cap, forces_mode="cellwise", cell_capacity=8, device=device)
    while scene.grid_ny % n_shards:
        n_shards //= 2
    state0 = init_state(w, scene, seed=0)
    params = Params.from_coefficients(w.coefficients, device)
    group = LocalGroup(n_shards, device)
    try:
        if rebalance:
            edges = initial_band_edges(state0, scene, n_shards)
            state = split_state(state0, scene, n_shards, edges)
            spatial = make_spatial_step(group, scene, rebalance=True)
        else:
            edges = None
            state = split_state(state0, scene, n_shards)
            spatial = make_spatial_step(group, scene)

        print(f"shards={n_shards} grid_ny={scene.grid_ny} "
              f"capacity/shard={scene.capacity} rebalance={rebalance}")
        print(f"{'tick':>5}  per-shard alive (top band -> bottom band)   max/mean")
        samples = []
        for t in range(1, ticks + 1):
            if rebalance:
                state, stats = spatial(state, params, edges)
                edges = stats["band_edges"]
            else:
                state, stats = spatial(state, params)
            if t % (ticks // 10) == 0:
                shard = stats["shard_alive"].tolist()
                imb = max(shard) / max(sum(shard) / n_shards, 1)
                extra = ("  edges=" + ",".join(str(e) for e in edges.tolist())
                         if rebalance else "")
                print(f"{t:>5}  {' '.join(f'{s:>5}' for s in shard)}   {imb:.2f}x{extra}",
                      flush=True)
                samples.append((t, shard))
        shard = stats["shard_alive"].tolist()
        print(f"final: total={sum(shard)} max_band={max(shard)} "
              f"imbalance={max(shard) / max(sum(shard) / n_shards, 1):.2f}x (ideal 1.0)")
        return samples
    finally:
        group.close()


if __name__ == "__main__":
    a = [int(x) for x in sys.argv[1:] if not x.startswith("--")]
    main(*a, rebalance="--rebalance" in sys.argv[1:], fine="--fine" in sys.argv[1:])
