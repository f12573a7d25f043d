"""The repository's engine tools on the port (the counterparts of ``tools/``).

Each module is named after its JAX tool, keeps that tool's functions,
arguments, printed fields and exit codes, and runs as ``python -m
sand_crate_tpu_torch.tools.<name> <the tool's arguments>`` on the card.  A
``device`` keyword (default ``"cuda"``) lets a caller ask for the CPU;
without a card a tool raises unless asked for the CPU.  The tools time
host-clock windows closed by ``torch.cuda.synchronize()`` and read nothing
back to the host inside a rollout.

- ``perf_probe``: the dam break's steps/s at a particle count.
- ``soak``: the long-horizon stability gate (non-finite particles,
  duplicate uids, growing overflow) with per-chunk occupancy.
- ``occupancy_stats``: the cell-occupancy distribution over time.
- ``small_n_probe``: the 10k step floor across backends.
- ``chunked_sweep``: the chunked backend's (cs, halo) sweep and its fill gate.
- ``spatial_balance``: per-band alive counts of the y-band split.
- ``rebalance_midscale``: the rebalanced bands' four gates at 65,536
  particles.
"""

from __future__ import annotations

import torch


def sync(device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
