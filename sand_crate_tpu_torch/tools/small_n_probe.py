"""The 10k step floor across backends (``tools/small_n_probe.py``).

Times the dam break at a small particle count under each backend: the
median (and best) of ``chunks`` rollouts of ``CHUNK`` ticks, each closed by
a synchronize, after one warm-up rollout (printed as ``compile``: the
kernels' build and first launches).  Rows: ``auto`` (p-major at its
defaults, K1/K2), p-major without symmetric halving, ``chunked``, the slot
grid (``pallas``: K4+K5, K8+K9) and the fixed-K ``gather`` lists.  The JAX
tool's ``pmajor w=256`` rows set ``pmajor_w``, a TPU tactic the port does
not have; they are printed as not ported.

Usage: python -m sand_crate_tpu_torch.tools.small_n_probe [n_particles] [chunks]
"""

from __future__ import annotations

import dataclasses
import statistics
import sys
import time

import torch

from ..engine import Crate
from ..physics import rollout
from . import sync
from .perf_probe import dam_break_world

CHUNK = 200


def time_config(label, n_target, chunks, scene_over=None, device="cuda", **crate_kw):
    crate = Crate(dam_break_world(n_target), device=device, **crate_kw)
    scene, params = crate.scene, crate.params
    if scene_over:
        scene = dataclasses.replace(scene, **scene_over)
    state = crate.state
    t0 = time.perf_counter()
    state, _ = rollout(state, params, scene, CHUNK, crate.generator)
    sync(device)
    compile_s = time.perf_counter() - t0
    walls = []
    for _ in range(chunks):
        t0 = time.perf_counter()
        state, _ = rollout(state, params, scene, CHUNK, crate.generator)
        sync(device)
        walls.append(time.perf_counter() - t0)
    p50 = statistics.median(walls) / CHUNK * 1e3
    best = min(walls) / CHUNK * 1e3
    print(
        f"{label:28s} p50 {p50:7.3f} ms/step  best {best:7.3f}  "
        f"compile {compile_s:5.1f}s",
        flush=True,
    )
    return p50


def main(n=10_000, chunks=20, device="cuda") -> dict:
    """Time every row; returns {label: p50 ms/step} of the rows run."""
    card = torch.cuda.get_device_name(0) if torch.device(device).type == "cuda" \
        and torch.cuda.is_available() else str(device)
    print(f"N~{n} device={card}  (median of {chunks} {CHUNK}-tick chunks, synchronized)")
    out = {"auto (pmajor symm)": time_config("auto (pmajor symm)", n, chunks, device=device)}
    print(f"{'pmajor w=256':28s} not ported: pmajor_w is a TPU tactic")
    out["pmajor no-symm"] = time_config("pmajor no-symm", n, chunks, device=device,
                                        pmajor_symm=False)
    print(f"{'pmajor w=256 no-symm':28s} not ported: pmajor_w is a TPU tactic")
    for label, mode in (("chunked", "chunked"), ("pallas grid", "pallas"),
                        ("gather K=20", "gather")):
        out[label] = time_config(label, n, chunks, device=device, forces_mode=mode)
    return out


if __name__ == "__main__":
    a = sys.argv[1:]
    main(int(a[0]) if a else 10_000, int(a[1]) if len(a) > 1 else 20)
