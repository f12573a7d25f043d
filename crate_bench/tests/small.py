"""Small crates of the benchmark's configurations for the CPU tests: the
same worlds, cut to a few thousand particles or a few crates."""

from __future__ import annotations

import copy

from crate_bench import registry
from crate_bench.yardstick import dam_break_rescale

BENCH = registry.load_benchmark()


def dam_break(n: int = 2000, forces_mode: str = "pmajor") -> dict:
    """The 1M dam break's configuration rescaled to ``n`` particles, on the
    backend the 1M crate takes (auto picks dense below 4096 slots)."""
    cfg = copy.deepcopy(registry.load_config(BENCH, "dam_break_1m"))
    r = dam_break_rescale(n)
    cfg["world"]["initial_particles"][0]["block"]["spacing"] = r["spacing"]
    for k in ("particle_radius", "max_particles"):
        cfg["world"]["coefficients"][k] = r[k]
    cfg["forces_mode"] = forces_mode
    cfg["jitter"] = "slot_hash" if forces_mode == "pmajor" else "generator"
    return cfg


def stirring_cups(crates: int = 3) -> dict:
    cfg = copy.deepcopy(registry.load_config(BENCH, "stirring_cup_b1024"))
    cfg["crates"] = crates
    return cfg
