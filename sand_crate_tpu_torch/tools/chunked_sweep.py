"""The chunked backend's geometry on the card: chunk_cs x chunk_halo
(``tools/chunked_sweep.py``).

Settles a K-crate wave_machine batch (``sweep.BatchedCrates``, the chunked
backend of ``ops/chunked.py``), then times 20-tick ``run`` chunks for each
(cs, halo) variant from the same settled state, reporting ms/tick,
crate-steps/s and the largest overflow of any crate.

``--fill`` instead runs a 600-tick fill from empty at the default geometry
and prints the per-chunk overflow history: the safety gate for halo
changes (jets + splash must stay overflow 0).

Usage: python -m sand_crate_tpu_torch.tools.chunked_sweep [K] [--fill]
"""

from __future__ import annotations

import sys
import time

import numpy as np

from ..config import CONFIGS_DIR, load_config
from ..state import Params
from ..sweep import BatchedCrates, stack_params
from . import sync

VARIANTS = (
    (128, 640), (256, 640), (512, 640),
    (128, 384), (256, 384), (512, 384),
    (128, 256), (256, 256), (512, 256),
)
RUN_TICKS = 20


def _batch_inputs(K: int, device):
    cfg = load_config(CONFIGS_DIR / "wave_machine.yaml")
    base = Params.from_coefficients(cfg.world_config.coefficients, device)
    return cfg, stack_params([base] * K)


def fill(K: int = 64, chunks: int = 30, device="cuda") -> list[int]:
    """``chunks`` x 20 ticks from empty at the default geometry; returns
    (and prints) the per-chunk overflow history."""
    cfg, params = _batch_inputs(K, device)
    b = BatchedCrates(cfg, params, seed=0, device=device)
    print(f"fill check: K={K} cs={b.scene.chunk_cs} halo={b.scene.chunk_halo}", flush=True)
    hist, t0 = [], time.perf_counter()
    for _ in range(chunks):
        d = b.run(RUN_TICKS)
        hist.append(int(d.neighbor_overflow.max()))
    sync(device)
    print(f"{chunks * RUN_TICKS}-tick fill: wall {time.perf_counter() - t0:.0f}s, final alive "
          f"{np.mean(b.particle_counts()):.0f}, overflow history {hist}", flush=True)
    return hist


def sweep(K: int = 64, variants=VARIANTS, settle_chunks: int = 11, timed: int = 3,
          device="cuda") -> list[dict]:
    """Settle ``settle_chunks`` x 20 ticks, then time each (cs, halo)
    variant from that state; returns one row per variant."""
    cfg, params = _batch_inputs(K, device)
    batch = BatchedCrates(cfg, params, seed=0, device=device)
    t0 = time.perf_counter()
    for _ in range(settle_chunks):
        batch.run(RUN_TICKS)
    sync(device)
    print(f"settle {settle_chunks * RUN_TICKS} ticks (incl build): "
          f"{time.perf_counter() - t0:.0f}s mean alive {np.mean(batch.particle_counts()):.0f}",
          flush=True)
    settled = batch.state

    rows = []
    for cs, halo in variants:
        b = BatchedCrates(cfg, params, seed=0, device=device, chunk_cs=cs, chunk_halo=halo)
        b.state = settled
        t0 = time.perf_counter()
        b.run(RUN_TICKS)
        sync(device)
        compile_s = time.perf_counter() - t0
        walls, ovf = [], 0
        for _ in range(timed):
            t0 = time.perf_counter()
            d = b.run(RUN_TICKS)
            sync(device)
            walls.append(time.perf_counter() - t0)
            ovf = max(ovf, int(d.neighbor_overflow.max()))
        w = min(walls)
        print(f"cs={cs} halo={halo}: {w / RUN_TICKS * 1000:.2f} ms/tick "
              f"({K * RUN_TICKS / w:.0f} crate-steps/s) max overflow={ovf} "
              f"(compile {compile_s:.0f}s)", flush=True)
        rows.append(dict(cs=cs, halo=halo, ms_per_tick=w / RUN_TICKS * 1000,
                         crate_steps_per_s=K * RUN_TICKS / w, max_overflow=ovf))
    return rows


def main(argv=None, device="cuda") -> None:
    argv = sys.argv[1:] if argv is None else argv
    K = int(argv[0]) if argv and argv[0].isdigit() else 64
    if "--fill" in argv:
        fill(K, device=device)
    else:
        sweep(K, device=device)


if __name__ == "__main__":
    main()
