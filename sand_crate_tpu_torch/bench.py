"""Headline benchmark of the port: particle-steps/sec on one GPU, dam break.

The counterpart of the repository's ``bench.py`` (which runs the JAX
package).  Prints ONE JSON line, with the same keys and the same baseline:

    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

and, unless ``--json-only``, one ``#`` line on stderr with the step p50,
the mean step and the last tick's overflow.  The world is
``configs/dam_break.yaml`` (as the dict ``DAM_BREAK``: the card's machine has
no PyYAML; tests hold the two equal) rescaled as bench.py rescales it, and
the p50 is bench.py's: the median of ``P50_CHUNKS`` chunks of
``_p50_chunk(n)`` ticks, each closed by ``torch.cuda.synchronize()``.  It
runs on the card (``device="cuda"``) unless the caller asks for the CPU,
and has no fallback: a kernel that fails to build or launch fails the run.
The pair schedule follows the environment as the library does
(``SAND_CRATE_PMSUB=1``: K10; ``SAND_CRATE_PMAJOR_GATE=1``: K1/K2
one-sided).

Usage: python -m sand_crate_tpu_torch.bench [--particles N] [--ticks T] [--json-only]
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import statistics
import sys
import time

# bench.py's baseline: the upstream NumPy engine's particle-steps/s at its
# scale ceiling (BASELINE.md "self-measured" row).
REFERENCE_PARTICLE_STEPS_PER_SEC = 10_000.0
P50_CHUNKS = 20

# configs/dam_break.yaml as a dict; tests/test_torch_scene.py holds the two
# equal.
DAM_BREAK = {
    "playback": {
        "save_recording": False,
        "ticks_to_record": 600,
        "recording_output_dir_path": "data/recordings",
        "screen_x": 1000,
        "screen_y": 1000,
    },
    "world": {
        "coefficients": {
            "dt": 0.002,
            "particle_radius": 0.0015,
            "wall_collision_decay": 0.2,
            "spring_overlap_balance": 0.5,
            "spring_amplifier": 100,
            "pressure_amplifier": 30,
            "ignored_pressure": 0.3,
            "collider_noise_level": 0.1,
            "viscosity": 8,
            "max_particles": 100000,
            "surface_smoothing": 100,
            "target_pressure": -2,
            "gravity": [0, 9.8],
        },
        "particle_sources": [],
        "initial_particles": [
            {
                "block": {
                    "x0": 0.02,
                    "y0": 0.1,
                    "x1": 0.42,
                    "y1": 0.98,
                    "spacing": 0.00265,
                    "velocity": [0.0, 0.0],
                    "jitter": 0.2,
                }
            }
        ],
        "rigid_bodies": [
            {
                "fixed": {
                    "name": "box",
                    "segments": [
                        [[0.0, 0.0], [0.0, 1.0]],
                        [[0.0, 0.0], [1.0, 0.0]],
                        [[1.0, 0.0], [1.0, 1.0]],
                        [[0.0, 1.0], [1.0, 1.0]],
                    ],
                }
            }
        ],
    },
}


# configs/stirring_cup.yaml as a dict: an emitter and a motored cup, so the
# emitters' generator state matters (chip_smoke's checkpoint phase).
STIRRING_CUP = {
    "playback": {
        "save_recording": True,
        "ticks_to_record": 1200,
        "recording_output_dir_path": "data/recordings",
        "screen_x": 1000,
        "screen_y": 1000,
    },
    "world": {
        "coefficients": {
            "dt": 0.002,
            "particle_radius": 0.005,
            "wall_collision_decay": 0.2,
            "spring_overlap_balance": 0.5,
            "spring_amplifier": 100,
            "pressure_amplifier": 30,
            "ignored_pressure": 0.3,
            "collider_noise_level": 0.1,
            "viscosity": 8,
            "max_particles": 600,
            "surface_smoothing": 100,
            "target_pressure": -2,
            "gravity": [0, 9.8],
        },
        "particle_sources": [
            {
                "radius": 0.05,
                "position": [0.9, 0.1],
                "velocity": [-5.5, 5.0],
                "flow": 2000,
                "noise": 0.5,
                "active_ticks": 200,
            }
        ],
        "rigid_bodies": [
            {
                "fixed": {
                    "name": "edge",
                    "segments": [
                        [[0.0, 0.0], [0.0, 1.0]],
                        [[0.0, 0.0], [1.0, 0.0]],
                        [[1.0, 0.0], [1.0, 1.0]],
                    ],
                }
            },
            {
                "motored": {
                    "name": "moving_cup",
                    "segments": [
                        [[-0.5, -0.5], [-0.5, 0.5]],
                        [[0.5, -0.5], [0.5, 0.5]],
                        [[-0.5, 0.5], [0.5, 0.5]],
                    ],
                    "angular_velocity": {"amplitude": 1.4, "frequency": 5.0},
                    "scale": [0.5, 0.2],
                    "position": [0.5, 0.6],
                }
            },
        ],
    },
}


# configs/wave_machine.yaml as a dict: an emitter and a motored wall, 4000
# particles (capacity 4096), chip_smoke's mid-size crate.
WAVE_MACHINE = {
    "playback": {
        "save_recording": True,
        "ticks_to_record": 3000,
        "recording_output_dir_path": "data/recordings",
        "screen_x": 1000,
        "screen_y": 1000,
    },
    "world": {
        "coefficients": {
            "dt": 0.002,
            "particle_radius": 0.005,
            "wall_collision_decay": 0.2,
            "spring_overlap_balance": 0.5,
            "spring_amplifier": 100,
            "pressure_amplifier": 30,
            "ignored_pressure": 0.3,
            "collider_noise_level": 0.1,
            "viscosity": 8,
            "max_particles": 4000,
            "surface_smoothing": 100,
            "target_pressure": -2,
            "gravity": [0, 9.8],
        },
        "particle_sources": [
            {
                "radius": 0.3,
                "position": [0.05, 0.95],
                "velocity": [3, 0.0],
                "flow": 7000,
                "noise": 0.0,
                "active_ticks": 500,
            }
        ],
        "rigid_bodies": [
            {
                "fixed": {
                    "name": "edge",
                    "segments": [
                        [[0.0, 0.0], [0.0, 1.0]],
                        [[0.0, 0.0], [1.0, 0.0]],
                        [[1.0, 0.0], [1.0, 1.0]],
                        [[0.0, 1.0], [1.0, 1.0]],
                    ],
                }
            },
            {
                "motored": {
                    "name": "moving_wall",
                    "segments": [
                        [[0.0, 0.0], [0.0, -1.0]],
                        [[0.0, 0.0], [-1.0, 0.0]],
                        [[-1.0, 0.0], [-1.0, -1.0]],
                        [[0.0, -1.0], [-1.0, -1.0]],
                    ],
                    "angular_velocity": {"amplitude": 1.5, "frequency": 8.0},
                    "scale": [0.02, 0.9],
                    "rotation": -12,
                    "position": [1.0, 1.3],
                }
            },
        ],
    },
}


def dam_break_world(n_target: int):
    """bench.py's dam_break_world (bench.py:34-47), on the port's parser:
    the block's spacing set for ``n_target`` particles, radius 0.55 x
    spacing, max_particles 1.05 x ``n_target``."""
    from .config import load_config_dict

    w = load_config_dict(copy.deepcopy(DAM_BREAK)).world_config
    area = (0.42 - 0.02) * (0.98 - 0.10)
    spacing = math.sqrt(area / n_target)
    w.initial_particles[0].spacing = spacing
    w.coefficients["particle_radius"] = spacing * 0.55
    w.coefficients["max_particles"] = int(n_target * 1.05)
    return w


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

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    state, _ = rollout(crate.state, crate.params, crate.scene, ticks, crate.generator)
    sync()
    warm_s = time.perf_counter() - t0

    chunk = _p50_chunk(n)
    state, _ = rollout(state, crate.params, crate.scene, chunk, crate.generator)
    sync()
    walls = []
    for _ in range(P50_CHUNKS):
        t0c = time.perf_counter()
        state, _ = rollout(state, crate.params, crate.scene, chunk, crate.generator)
        sync()
        walls.append(time.perf_counter() - t0c)
    step_p50_ms = statistics.median(walls) / chunk * 1000

    t0 = time.perf_counter()
    state, diag = rollout(state, crate.params, crate.scene, ticks, crate.generator)
    sync()
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
