"""The scene of a configuration file, read by the reference alone.

Plain NumPy from the world dict of ``crate_bench/configs/<config>.json``
(the schema of the upstream ``configs/*.yaml``): the rigid bodies' segments
placed scale -> rotate (degrees) -> translate, their motors
``offset + amplitude * cos(frequency * t + phase)``, the emitters, and the
initial blocks of particles.  Nothing here reads the program.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

FIXED, MOTORED, FREE = "fixed", "motored", "free"


def _motor(spec) -> tuple[float, float, float, float]:
    """(amplitude, frequency, phase, offset) of a motor given as a dict or a number."""
    if spec is None:
        return (0.0, 0.0, 0.0, 0.0)
    if isinstance(spec, (int, float)):
        return (0.0, 0.0, 0.0, float(spec))
    return tuple(float(spec.get(k, 0.0)) for k in ("amplitude", "frequency", "phase", "offset"))


@dataclass
class RefWorld:
    coefficients: dict
    segments0: np.ndarray  # (S, 2, 2) placed segments
    seg_body: np.ndarray  # (S,) body index
    body_kind: list  # per body: "fixed" | "motored" | "free"
    body_center: np.ndarray  # (NB, 2)
    motor_lin: np.ndarray  # (NB, 2, 4)
    motor_ang: np.ndarray  # (NB, 4)
    sources: list  # dicts: position, velocity, radius, flow, noise, active_ticks
    blocks: list  # dicts: x0, y0, x1, y1, spacing, velocity, jitter

    @property
    def num_segments(self) -> int:
        return self.segments0.shape[0]

    def max_spawn(self, capacity: int) -> int:
        """Emissions a source may make in one tick: its mean flow x dt plus
        six standard deviations plus 8, rounded up to 8, at most the
        capacity.  The draws of one tick have this size whatever the count."""
        dt = float(self.coefficients["dt"])
        exp = max((s["flow"] * dt for s in self.sources), default=0.0)
        n = int(exp + 6 * exp**0.5 + 8)
        return int(min(capacity, -(-n // 8) * 8))


def read_world(world: dict) -> RefWorld:
    segs, seg_body, kinds, centers, mlin, mang = [], [], [], [], [], []
    for b, entry in enumerate(world.get("rigid_bodies") or []):
        (kind, kw), = entry.items()
        seg = np.asarray(kw["segments"], np.float64) * np.asarray(kw.get("scale", (1.0, 1.0)))
        th = math.radians(float(kw.get("rotation", 0.0)))
        c, s = math.cos(th), math.sin(th)
        seg = seg @ np.array([[c, s], [-s, c]]) + np.asarray(kw.get("position", (0.0, 0.0)))
        segs.append(seg)
        seg_body += [b] * len(seg)
        kinds.append(kind)
        centers.append(kw.get("position", (0.0, 0.0)))
        vm = kw.get("velocity_motor") or {}
        mlin.append([_motor(vm.get("x")), _motor(vm.get("y"))])
        mang.append(_motor(kw.get("angular_velocity")))
    sources = [dict(position=np.asarray(s["position"], float), velocity=np.asarray(s["velocity"], float),
                    radius=float(s["radius"]), flow=float(s["flow"]),
                    noise=float(s.get("noise", 0.05)), active_ticks=int(s["active_ticks"]))
               for s in (world.get("particle_sources") or [])]
    blocks = [dict(e.get("block", e)) for e in (world.get("initial_particles") or [])]
    return RefWorld(
        coefficients=dict(world["coefficients"]),
        segments0=np.concatenate(segs) if segs else np.zeros((0, 2, 2)),
        seg_body=np.asarray(seg_body, np.int64),
        body_kind=kinds,
        body_center=np.asarray(centers, float).reshape(-1, 2),
        motor_lin=np.asarray(mlin, float).reshape(-1, 2, 4),
        motor_ang=np.asarray(mang, float).reshape(-1, 4),
        sources=sources,
        blocks=blocks,
    )


def initial_particles(world: RefWorld, seed: int) -> np.ndarray:
    """(N, 2) positions of the initial blocks: a grid at the block's
    spacing from (x0, y0) up to (x1, y1), each point moved by a uniform
    jitter of ``jitter`` x spacing drawn from NumPy's generator seeded with
    ``seed``, block after block."""
    rng = np.random.default_rng(seed)
    pos = []
    for blk in world.blocks:
        xs = np.arange(blk["x0"], blk["x1"], blk["spacing"])
        ys = np.arange(blk["y0"], blk["y1"], blk["spacing"])
        gx, gy = np.meshgrid(xs, ys, indexing="ij")
        p = np.stack([gx.ravel(), gy.ravel()], axis=-1)
        if blk.get("jitter"):
            p = p + (rng.random(p.shape) - 0.5) * blk["spacing"] * blk["jitter"]
        pos.append(p)
    return np.concatenate(pos) if pos else np.zeros((0, 2))
