"""Mid-scale gates of the rebalanced (variable-height) band path
(``tools/rebalance_midscale.py``).

A >= 64k-particle dam break (noise 0, no sources, the cellwise backend at
8 slots a cell, as the JAX tool runs it) where the edge-recompute
subsample is strided (``spatial.EDGE_SAMPLE_TARGET``) and row quantization
binds.  Three legs: the single-device baseline, a single-device control
from positions perturbed by ``PERTURB`` (~1 ulp), and ``n_shards``
rebalanced bands on a ``collectives.LocalGroup`` of one device (the card
unless the caller asks for the CPU).  A collapsing dam break is chaotic:
the bands sum pairs in another f32 order, and that rounding grows at the
flow's Lyapunov rate, so the gates, checked per particle by uid, are:

1. short-window exactness: at the first sample (``SAMPLE_EVERY`` ticks)
   the bands' positions are within ``EXACT_TOL`` of the baseline;
2. chaos envelope: at every sample the bands' divergence from the baseline
   stays within ``ENVELOPE_FACTOR`` x the control's (or 1e-4);
3. conservation: ``migration_dropped == 0``, the alive count and the uid
   set kept;
4. settled imbalance: after ``settle_ticks`` more ticks, per-band
   max/mean alive <= 1.7.

The edge subsample must be strided (stride > 1), else the run does not
test what it is for.  Each broken gate is printed and the tool exits 1.

Usage: python -m sand_crate_tpu_torch.tools.rebalance_midscale [--particles 65536]
         [--eq-ticks 40] [--settle-ticks 240]
"""

from __future__ import annotations

import argparse
import math
import sys
import time

import numpy as np
import torch

from .. import spatial
from ..collectives import LocalGroup
from ..physics import rollout
from ..scene import build_scene, init_state
from ..spatial import initial_band_edges, make_spatial_step, merge_state, split_state
from ..state import Params
from .spatial_balance import toy_world

SAMPLE_EVERY = 8
PERTURB = 1e-7  # ~1 ulp at coordinates O(0.5)
ENVELOPE_FACTOR = 8.0  # shard divergence must stay within this of the control
EXACT_TOL = 5e-5  # f32 gate at the first sample, before chaos amplifies
IMBALANCE_GATE = 1.7


def _by_uid(state):
    """(sorted uids, positions in that order) of the alive particles."""
    alive = state.alive.cpu().numpy()
    uid = state.uid.cpu().numpy()[alive]
    pos = state.pos.cpu().numpy()[alive]
    order = np.argsort(uid)
    return uid[order], pos[order]


def _divergence(base, other):
    """max and rms per-particle |dpos| between uid-matched snapshots, or
    None when the uid sets differ."""
    ua, pa = base
    ub, pb = other
    if not np.array_equal(ua, ub):
        return None
    d = np.linalg.norm(pa - pb, axis=1)
    return float(d.max()), float(np.sqrt((d**2).mean()))


def main(particles: int = 65536, eq_ticks: int = 40, settle_ticks: int = 240,
         n_shards: int = 8, device="cuda") -> int:
    area = (0.42 - 0.02) * (0.98 - 0.10)
    spacing = math.sqrt(area / particles)
    cap = 1 << (int(particles * 1.05) - 1).bit_length()
    w = toy_world(spacing, spacing * 0.55, cap)
    scene = build_scene(w, capacity=cap, forces_mode="cellwise", cell_capacity=8, device=device)
    state0 = init_state(w, scene, seed=0)
    params = Params.from_coefficients(w.coefficients, device)
    n0 = int(state0.alive.sum())
    stride = spatial._edge_sample_stride(scene.capacity)
    ticks_sampled = list(range(SAMPLE_EVERY, eq_ticks + 1, SAMPLE_EVERY))
    exact_ticks = ticks_sampled[0]
    print(
        f"N={n0} capacity={scene.capacity} grid={scene.grid_nx}x{scene.grid_ny} "
        f"shards={n_shards} edge_sample_stride={stride} "
        f"(subsampling {'BINDS' if stride > 1 else 'off'})"
    )
    if stride <= 1:
        print(f"FAILED: stride {stride}: pick a capacity > EDGE_SAMPLE_TARGET for this check")
        return 1
    failed = []

    def run_single(s, label):
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        snaps = {}
        t0 = time.perf_counter()
        for t in range(1, eq_ticks + 1):
            s, _ = rollout(s, params, scene, 1, gen)  # the JAX tool's jitted step
            if t in ticks_sampled:
                snaps[t] = _by_uid(s)
        print(f"{label} {eq_ticks} ticks: {time.perf_counter() - t0:.1f}s", flush=True)
        return snaps

    # ---- leg 1: single-device baseline -------------------------------------
    base = run_single(state0, "single-device baseline")

    # ---- leg 2: single-device, 1-ulp perturbed (the chaos control) ----------
    rng = np.random.default_rng(1)
    pos0 = state0.pos.cpu().numpy()
    pert_pos = pos0 + rng.normal(0.0, PERTURB, pos0.shape).astype(np.float32)
    ctrl = run_single(state0._replace(pos=torch.as_tensor(pert_pos, device=device)),
                      "perturbed control")

    # ---- leg 3: n_shards rebalanced bands ------------------------------------
    group = LocalGroup(n_shards, device)
    try:
        edges = initial_band_edges(state0, scene, n_shards)
        s_split = split_state(state0, scene, n_shards, edges)
        spatial_step = make_spatial_step(group, scene, rebalance=True)
        shard_snaps, dropped = {}, 0  # dropped: summed on the device, read at the end
        t0 = time.perf_counter()
        for t in range(1, eq_ticks + 1):
            s_split, stats = spatial_step(s_split, params, edges)
            edges = stats["band_edges"]
            dropped = dropped + stats["migration_dropped"]
            if t in ticks_sampled:
                shard_snaps[t] = _by_uid(merge_state(s_split, scene, n_shards))
        print(f"{n_shards}-shard rebalanced {eq_ticks} ticks: "
              f"{time.perf_counter() - t0:.1f}s", flush=True)

        # ---- gates -------------------------------------------------------------
        print(f"\n{'tick':>5} {'shard max|dp|':>14} {'ctrl max|dp|':>13} "
              f"{'shard rms':>10} {'ctrl rms':>10}")
        for t in ticks_sampled:
            if len(shard_snaps[t][0]) != n0:
                failed.append(f"tick {t}: alive {len(shard_snaps[t][0])} != {n0}")
                continue
            div_shard = _divergence(base[t], shard_snaps[t])
            div_ctrl = _divergence(base[t], ctrl[t])
            if div_shard is None or div_ctrl is None:
                failed.append(f"tick {t}: uid sets diverged")
                continue
            (d_shard, r_shard), (d_ctrl, r_ctrl) = div_shard, div_ctrl
            print(f"{t:>5} {d_shard:>14.3e} {d_ctrl:>13.3e} {r_shard:>10.3e} {r_ctrl:>10.3e}")
            if t == exact_ticks and d_shard > EXACT_TOL:
                failed.append(f"short-window exactness: {d_shard:.3e} > {EXACT_TOL} at tick {t}")
            if d_shard > max(ENVELOPE_FACTOR * d_ctrl, 1e-4):
                failed.append(f"tick {t}: sharded divergence {d_shard:.3e} outside the 1-ulp "
                              f"chaos envelope ({d_ctrl:.3e} x {ENVELOPE_FACTOR})")
        if not failed:
            print(f"exactness @ {exact_ticks} ticks + chaos envelope @ all samples: OK")

        # ---- settled imbalance ---------------------------------------------------
        t0 = time.perf_counter()
        worst = 0.0
        for t in range(eq_ticks, eq_ticks + settle_ticks):
            s_split, stats = spatial_step(s_split, params, edges)
            edges = stats["band_edges"]
            dropped = dropped + stats["migration_dropped"]
            if (t + 1) % 20 == 0:
                shard = stats["shard_alive"].tolist()
                imb = max(shard) / max(sum(shard) / n_shards, 1)
                worst = max(worst, imb)
                print(f"tick {t + 1:>4}  imbalance {imb:.2f}x  "
                      f"edges={','.join(str(e) for e in edges.tolist())}  "
                      f"({time.perf_counter() - t0:.0f}s)", flush=True)
    finally:
        group.close()
    shard = stats["shard_alive"].tolist()
    imb = max(shard) / max(sum(shard) / n_shards, 1)
    print(f"settled imbalance: {imb:.2f}x (worst sampled {worst:.2f}x, ideal 1.0, "
          f"gate <= {IMBALANCE_GATE}x)  bands={shard}")
    if imb > IMBALANCE_GATE:
        failed.append(f"settled imbalance {imb:.2f}x > {IMBALANCE_GATE}x")
    if int(dropped):
        failed.append(f"migration_dropped {int(dropped)} != 0 over the run")
    if failed:
        for f in failed:
            print(f"FAILED gate: {f}")
        return 1
    print("PASS")
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--particles", type=int, default=65536)
    ap.add_argument("--eq-ticks", type=int, default=40)
    ap.add_argument("--settle-ticks", type=int, default=240)
    a = ap.parse_args()
    sys.exit(main(a.particles, a.eq_ticks, a.settle_ticks))
