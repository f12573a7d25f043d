"""Probe step throughput at various particle counts (``tools/perf_probe.py``).

``dam_break_world(n)`` is ``configs/dam_break.yaml`` rescaled to ``n``
target particles (the bench's world); ``probe`` runs one warm-up rollout
of ``ticks`` ticks (its time is printed as ``compile``: the kernels' build
and first launches), then a timed one, each closed by a synchronize.
``SAND_CRATE_PROBE_SYMM`` (0/1) sets ``pmajor_symm`` as in the JAX tool;
``SAND_CRATE_PROBE_SPLIT`` set the JAX tool's ``pmajor_split``, a TPU
tactic the port does not have: the probe says so and ignores it.

Usage: python -m sand_crate_tpu_torch.tools.perf_probe [n_particles ...]
"""

from __future__ import annotations

import math
import os
import sys
import time

import torch

from ..config import CONFIGS_DIR, load_config
from ..engine import Crate
from ..physics import rollout
from . import sync


def dam_break_world(n_target: int):
    """The dam break's world with the block's spacing set for ``n_target``
    particles, radius 0.55 x spacing, max_particles 1.05 x ``n_target``."""
    w = load_config(CONFIGS_DIR / "dam_break.yaml").world_config
    w.coefficients = dict(w.coefficients)
    # block area = 0.4 * 0.88; spacing for n_target particles
    area = (0.42 - 0.02) * (0.98 - 0.10)
    spacing = math.sqrt(area / n_target)
    w.initial_particles[0].spacing = spacing
    w.coefficients["particle_radius"] = spacing * 0.55
    w.coefficients["max_particles"] = int(n_target * 1.05)
    return w


def probe(
    n_target: int, ticks: int = 50, cell_capacity=None, forces_mode="auto",
    pmajor_symm=None, device="cuda",
):
    if pmajor_symm is None and os.environ.get("SAND_CRATE_PROBE_SYMM"):
        pmajor_symm = os.environ["SAND_CRATE_PROBE_SYMM"] == "1"
    if os.environ.get("SAND_CRATE_PROBE_SPLIT") is not None:
        print("SAND_CRATE_PROBE_SPLIT: pmajor_split is a TPU tactic the port does not have "
              "(not ported); ignored")
    crate = Crate(
        dam_break_world(n_target), cell_capacity=cell_capacity, forces_mode=forces_mode,
        pmajor_symm=pmajor_symm, device=device,
    )
    n = crate.particle_count
    t0 = time.perf_counter()
    state, diag = rollout(crate.state, crate.params, crate.scene, ticks, crate.generator)
    sync(device)
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    state, diag = rollout(state, crate.params, crate.scene, ticks, crate.generator)
    sync(device)
    sps = ticks / (time.perf_counter() - t0)
    print(
        f"N={n:>9,} capacity={crate.scene.capacity:>9,} grid={crate.scene.grid_nx}^2 "
        f"M={crate.scene.cell_capacity} compile={compile_s:5.1f}s "
        f"steps/s={sps:8.2f} particle-steps/s={sps * n:.3e} "
        f"overflow={int(diag.neighbor_overflow)} maxspeed={float(diag.max_speed):.2f}",
        flush=True,
    )
    return sps * n


def main(sizes=(10_000, 100_000), device="cuda") -> None:
    if torch.device(device).type == "cuda" and torch.cuda.is_available():
        print("device:", torch.cuda.get_device_name(0), torch.cuda.device_count())
    for n in sizes:
        probe(n, device=device)


if __name__ == "__main__":
    main([int(x) for x in sys.argv[1:]] or [10_000, 100_000])
