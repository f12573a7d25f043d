"""Cell-occupancy distribution of the 1M dam break over time
(``tools/occupancy_stats.py``).

The pair kernels' cost follows the cells' occupancy.  This prints the
occupancy histogram, percentiles and the occupied rows at several settle
depths.  ``blocks_occ`` and ``nblocks`` count the JAX Pallas pass kernels'
row blocks (of ``scene.row_block`` rows with a one-row halo); the port's
Scene keeps no row block, so they use the rule that sizes the grid
(``scene.row_block``), which gives the JAX Scene's value.

Usage: python -m sand_crate_tpu_torch.tools.occupancy_stats [n_particles] [ticks ...]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..cellwise import cell_ids_grid
from ..engine import Crate
from ..physics import rollout
from ..scene import row_block
from .perf_probe import dam_break_world


def stats(state, scene):
    nx, ny = scene.grid_nx, scene.grid_ny
    cid = cell_ids_grid(state.pos, state.alive, scene).long()
    counts = torch.bincount(torch.clamp(cid, max=nx * ny), minlength=nx * ny + 1)
    counts = counts[:-1].reshape(ny, nx)
    occ = counts[counts > 0].cpu().numpy()
    row_any = (counts.sum(dim=1) > 0).cpu().numpy()
    rows_occ = row_any.sum()
    # row blocks at tr rows with the +-1 halo (what the JAX pass kernels run)
    tr = row_block(nx)
    nb = ny // tr
    idx = np.arange(nb)[:, None] * tr + np.arange(tr + 2)[None, :] - 1
    idx = np.clip(idx, 0, ny - 1)
    blocks_occ = row_any[idx].any(axis=1).sum()
    hist = np.bincount(occ, minlength=18)
    return dict(
        occupied_cells=int(occ.size),
        mean=float(occ.mean()),
        p50=int(np.percentile(occ, 50)),
        p90=int(np.percentile(occ, 90)),
        p99=int(np.percentile(occ, 99)),
        max=int(occ.max()),
        frac_le4=float((occ <= 4).mean()),
        frac_le8=float((occ <= 8).mean()),
        rows_occ=int(rows_occ),
        blocks_occ=int(blocks_occ),
        nblocks=nb,
        hist=hist[:17].tolist(),
    )


def main(n=1_000_000, ticks=(0, 100, 300, 600), device="cuda") -> list[dict]:
    """Print (and return) :func:`stats` after each tick count in ``ticks``."""
    crate = Crate(dam_break_world(n), device=device)
    scene, params, state = crate.scene, crate.params, crate.state
    done, out = 0, []
    for t in ticks:
        # the JAX tool's jitted step: on the card, replays of the captured tick
        state, _ = rollout(state, params, scene, t - done, crate.generator)
        done = t
        s = stats(state, scene)
        print(f"tick {t}: {s}", flush=True)
        out.append(s)
    return out


if __name__ == "__main__":
    a = [int(x) for x in sys.argv[1:]]
    main(a[0] if a else 1_000_000, tuple(a[1:]) if len(a) > 1 else (0, 100, 300, 600))
