"""Long-horizon stability soak at scale (``tools/soak.py``, the repository's
stability gate).

Runs the 1M dam break for thousands of ticks in chunks queued on the
device and reports, per chunk: steps/s, neighbor overflow, non-finite
count, max speed, max cell occupancy and the size of the largest
coincident blob (particles within 0.25 diameter of the fullest cell's
first particle).  Exits non-zero if an invariant breaks: non_finite > 0,
duplicate uids among alive, or growing overflow (the second half of the
chunks' overflow summing to more than 4x the first half's, or than 4x the
chunk count).

The port's p-major candidate ranges are exact, so its ``overflow`` is
always 0 and on the main path the growing-overflow rule can only hold; the
rule is kept, and it bites on the grid backends (``mode="pallas"``:
particles past a cell's slots).

Usage: python -m sand_crate_tpu_torch.tools.soak [n_particles] [total_ticks] [chunk] [mode]
"""

from __future__ import annotations

import sys
import time
from typing import Iterator

import torch

from ..cellwise import cell_ids_grid
from ..engine import Crate
from ..physics import rollout
from . import sync
from .perf_probe import dam_break_world


def occupancy_stats(state, scene, diam):
    """(max cell occupancy, largest near-coincident blob) of the alive
    particles.  The cell counts and the blob are computed on the state's
    device; two scalars come back to the host."""
    nc = scene.grid_nx * scene.grid_ny
    cid = cell_ids_grid(state.pos, state.alive, scene).long()  # dead -> nc
    counts = torch.bincount(cid, minlength=nc + 1)[:nc]
    max_occ = int(counts.max())
    if max_occ == 0:
        return 0, 0
    # Largest blob: within the fullest cell (the first of equals), the
    # particles within 0.25 * diam of the cell's first particle.
    cell = counts.argmax()
    members = state.pos[cid == cell]
    d = torch.linalg.vector_norm(members - members[0], dim=-1)
    return max_occ, int((d < 0.25 * diam).sum())


def duplicate_uids(state) -> int:
    """How many alive particles share a uid with another alive one."""
    uid = state.uid[state.alive]
    return int(uid.numel() - torch.unique(uid).numel())


def overflow_growing(history) -> bool:
    """The collapse signature: the second half of a per-chunk overflow
    history sums to more than 4x the first half (or 4x its length)."""
    h = len(history) // 2
    return bool(h) and sum(history[h:]) > 4 * max(sum(history[:h]), len(history))


def soak_chunks(crate: Crate, total: int, chunk: int) -> Iterator[dict]:
    """Advance ``crate`` ``total`` ticks in rollouts of ``chunk``, printing
    the tool's line after each and yielding its record (tick, seconds,
    steps_per_s, overflow, non_finite, max_speed, max_occ, blob, dup_uid,
    alive), with ``crate.state`` at that tick."""
    scene, params = crate.scene, crate.params
    device = crate.state.pos.device
    diam = 2.0 * float(params.particle_radius)
    for t in range(0, total, chunk):
        sync(device)
        t0 = time.perf_counter()
        state, diag = rollout(crate.state, params, scene, chunk, crate.generator)
        sync(device)
        dt = time.perf_counter() - t0
        crate.state = state
        nf = int(diag.non_finite)
        ov = int(diag.neighbor_overflow)
        ms = float(diag.max_speed)
        max_occ, blob = occupancy_stats(state, scene, diam)
        dup = duplicate_uids(state)
        print(
            f"tick {t + chunk:>5}  {chunk / dt:5.1f} steps/s  overflow={ov:<6} "
            f"non_finite={nf} max_speed={ms:7.2f} max_occ={max_occ:<4} "
            f"blob={blob:<4} dup_uid={dup}",
            flush=True,
        )
        yield dict(tick=t + chunk, seconds=dt, steps_per_s=chunk / dt, overflow=ov,
                   non_finite=nf, max_speed=ms, max_occ=max_occ, blob=blob, dup_uid=dup,
                   alive=int(diag.particle_count))


def invariants(records) -> list[str]:
    """The invariants that the chunk records break: non-finite particles,
    duplicate uids, growing overflow."""
    bad = []
    for r in records:
        if r["non_finite"]:
            bad.append(f"non_finite={r['non_finite']} at tick {r['tick']}")
        if r["dup_uid"]:
            bad.append(f"{r['dup_uid']} duplicate uids at tick {r['tick']}")
    ov_hist = [r["overflow"] for r in records]
    if overflow_growing(ov_hist):
        bad.append(f"overflow growing: {ov_hist}")
    return bad


def verdict(records, wall: float) -> int:
    """Print the run's overflow history and verdict; 1 if an invariant
    broke, else 0 (the tool's exit code)."""
    print(f"done in {wall:.0f}s; overflow history: {[r['overflow'] for r in records]}")
    bad = invariants(records)
    if bad:
        print("FAILED: " + "; ".join(bad))
        return 1
    print("OK: all invariants held")
    return 0


def main(n=1_000_000, total=2000, chunk=250, mode="auto", device="cuda") -> int:
    crate = Crate(dam_break_world(n), forces_mode=mode, device=device)
    scene = crate.scene
    print(
        f"soak: N={crate.particle_count:,} cap={scene.capacity:,} "
        f"mode={scene.forces_mode} grid={scene.grid_nx}x{scene.grid_ny} "
        f"total={total} chunk={chunk}",
        flush=True,
    )
    t_all = time.perf_counter()
    records = list(soak_chunks(crate, total, chunk))
    return verdict(records, time.perf_counter() - t_all)


if __name__ == "__main__":
    a = sys.argv[1:]
    sys.exit(
        main(
            int(a[0]) if len(a) > 0 else 1_000_000,
            int(a[1]) if len(a) > 1 else 2000,
            int(a[2]) if len(a) > 2 else 250,
            a[3] if len(a) > 3 else "auto",
        )
    )
