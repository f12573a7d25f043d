"""Headline benchmark of the port: particle-steps/sec on one GPU, dam break.

The counterpart of the repository's ``bench.py`` (which runs the JAX
package).  Prints ONE JSON line, with the same keys and the same baseline:

    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

and, unless ``--json-only``, one ``#`` line on stderr with the step p50,
the mean step and the last tick's overflow.  The world is
``configs/dam_break.yaml`` rescaled as bench.py rescales it
(``tools.perf_probe.dam_break_world``), and the p50 is bench.py's: the
median of ``P50_CHUNKS`` chunks of ``_p50_chunk(n)`` ticks, each closed by
``torch.cuda.synchronize()``.  It
runs on the card (``device="cuda"``) unless the caller asks for the CPU,
and has no fallback: a kernel that fails to build or launch fails the run.
The pair schedule follows the environment as the library does
(``SAND_CRATE_PMSUB=1``: K10; ``SAND_CRATE_PMAJOR_GATE=1``: K1/K2
one-sided).  The ticks run through ``physics.rollout``: on the card,
replays of the tick captured as a CUDA graph (graphs.py), whose capture
falls in the warm-up rollout, as the JAX bench's compile does.

Usage: python -m sand_crate_tpu_torch.bench [--particles N] [--ticks T] [--json-only]
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

from .tools import sync
from .tools.perf_probe import dam_break_world  # the bench's world (one copy)

# bench.py's baseline: the upstream NumPy engine's particle-steps/s at its
# scale ceiling (BASELINE.md "self-measured" row).
REFERENCE_PARTICLE_STEPS_PER_SEC = 10_000.0
P50_CHUNKS = 20

# The shipped scenes as dicts (``bench.DAM_BREAK`` etc.), read from
# configs/ at each access: what ``yaml.safe_load`` gives for the file, on
# every host (config.load_config reads YAML without PyYAML).
SCENE_FILES = {
    "DAM_BREAK": "dam_break.yaml",
    "STIRRING_CUP": "stirring_cup.yaml",
    "WAVE_MACHINE": "wave_machine.yaml",
}


def __getattr__(name: str):
    if name in SCENE_FILES:
        from .config import CONFIGS_DIR, load_config

        return load_config(CONFIGS_DIR / SCENE_FILES[name]).raw
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _p50_chunk(n: int) -> int:
    """Ticks per timed p50 chunk, bench.py's rule."""
    return max(10, 4_000_000 // max(n, 1))


def main(particles: int = 1_000_000, ticks: int = 200, json_only: bool = False,
         device="cuda") -> dict:
    import torch

    from .engine import Crate
    from .ops.pmajor import schedule
    from .physics import rollout

    crate = Crate(dam_break_world(particles), device=device)
    dev = crate.state.pos.device
    n = crate.particle_count

    t0 = time.perf_counter()
    state, _ = rollout(crate.state, crate.params, crate.scene, ticks, crate.generator)
    sync(dev)
    warm_s = time.perf_counter() - t0

    chunk = _p50_chunk(n)
    state, _ = rollout(state, crate.params, crate.scene, chunk, crate.generator)
    sync(dev)
    walls = []
    for _ in range(P50_CHUNKS):
        t0c = time.perf_counter()
        state, _ = rollout(state, crate.params, crate.scene, chunk, crate.generator)
        sync(dev)
        walls.append(time.perf_counter() - t0c)
    step_p50_ms = statistics.median(walls) / chunk * 1000

    t0 = time.perf_counter()
    state, diag = rollout(state, crate.params, crate.scene, ticks, crate.generator)
    sync(dev)
    wall = time.perf_counter() - t0

    steps_per_sec = ticks / wall
    value = steps_per_sec * n
    result = {
        "metric": f"particle-steps/sec/chip@{n}",
        "value": value,
        "unit": "particle-steps/s",
        "vs_baseline": value / REFERENCE_PARTICLE_STEPS_PER_SEC,
    }
    if not json_only:
        card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
        print(
            f"# device={card} schedule={schedule()} N={n:,} ticks={ticks} "
            f"warm-up={warm_s:.1f}s steps/s={steps_per_sec:.2f} "
            f"step_p50={step_p50_ms:.3f}ms (median of {P50_CHUNKS} "
            f"{chunk}-tick chunks) step_mean={wall / ticks * 1000:.3f}ms "
            f"overflow={int(diag.neighbor_overflow)} non_finite={int(diag.non_finite)}",
            file=sys.stderr,
        )
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--particles", type=int, default=1_000_000)
    ap.add_argument("--ticks", type=int, default=200)
    ap.add_argument("--json-only", action="store_true")
    a = ap.parse_args()
    main(particles=a.particles, ticks=a.ticks, json_only=a.json_only)
