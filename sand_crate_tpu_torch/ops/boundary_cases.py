"""Hard inputs for holding the boundary kernels against their plain versions.

``ghost_pass`` (``csrc/boundary.cu``) and ``kick.continuous_collision``
(``csrc/kick.cu``) take a thread per particle and loop over the crate's
segments; their plain versions (``ops/boundary.py``, ``ops/kick.py``)
compute the same terms as (S, P) and (2S, P) planes.  Each case below puts particles where a rounding, a clamp, a NaN or
the launch shape has an edge: a particle at exactly 1.2 r from a wall,
nearest points clamped to a segment's ends, a zero-length segment, a
particle on a wall, moves parallel to a wall and crossings whose
denominator is under EPS, a move ending on a wall and one crossing two,
dead slots holding garbage, alive particles with non-finite values, an
invalid segment, a motored body turning, S = 1, 4, 5 and 8, P under one
block and P not a multiple of it, and three crates at once with radii,
steps and bodies of their own.  Inputs are made from a numpy seed;
``tests/test_torch_boundary.py`` and ``chip_smoke.py`` run every case and
:func:`facts` checks that each holds what it claims.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import geometry as geo

R, DT = 0.01, 1.0 / 512.0  # the cases' radius and step (dt a power of two)
BOX = [[[0.0, 0.0], [0.0, 1.0]], [[0.0, 0.0], [1.0, 0.0]],
       [[1.0, 0.0], [1.0, 1.0]], [[0.0, 1.0], [1.0, 1.0]]]  # the dam break's box
BLOCK = 256  # the kernels' threads a block


def _paddle(center, half, turn):
    """A square of four segments around ``center``, turned by ``turn``."""
    c, s = np.cos(turn), np.sin(turn)
    corners = np.array([[-half, -half], [half, -half], [half, half], [-half, half]])
    corners = corners @ np.array([[c, s], [-s, c]]) + center
    return [[corners[k], corners[(k + 1) % 4]] for k in range(4)]


def _base(rng, n, segments, alive=1.0, speed=3.0):
    """n particles in the unit box (a fifth of them within 2 r of the box
    walls), random velocities, one fixed body at the origin."""
    pos = rng.random((n, 2)) * 0.98 + 0.01
    k = n // 5
    side = rng.integers(0, 4, k)
    d = rng.random(k) * 2 * R
    pos[:k, 0] = np.where(side == 0, d, np.where(side == 2, 1.0 - d, pos[:k, 0]))
    pos[:k, 1] = np.where(side == 1, d, np.where(side == 3, 1.0 - d, pos[:k, 1]))
    S = len(segments)
    return dict(
        prepos=pos, vel=(rng.random((n, 2)) - 0.5) * 2 * speed, alive=rng.random(n) < alive,
        segments=np.asarray(segments, float), lin=np.zeros((1, 2)), ang=np.zeros(1),
        r=R, dt=DT, seg_valid=np.ones(S, bool), seg_body=np.zeros(S, np.int64),
        body_center=np.zeros((1, 2)),
    )


def _threshold(rng):
    c = _base(rng, 1000, BOX)
    thr = np.float32(np.float32(R) * np.float32(1.2))
    on = [thr, np.nextafter(thr, np.float32(1)), np.nextafter(thr, np.float32(0))]
    c["prepos"][:3] = [[0.5, float(y)] for y in on]  # the bottom wall y = 0
    c["prepos"][3:6] = [[float(x), 0.37] for x in on]  # the left wall x = 0
    c["alive"][:6] = True
    return c


def _segment_ends(rng):
    seg = BOX + [[[0.4, 0.5], [0.6, 0.5]]]
    c = _base(rng, 600, seg)
    k = np.arange(40)
    c["prepos"][:40, 0] = np.where(k % 2, 0.6 + rng.random(40) * R, 0.4 - rng.random(40) * R)
    c["prepos"][:40, 1] = 0.5 + (rng.random(40) - 0.5) * 2 * R
    c["alive"][:40] = True
    return c


def _zero_length(rng):
    seg = BOX + [[[0.5, 0.5], [0.5, 0.5]]]
    c = _base(rng, 600, seg)
    ang = rng.random(40) * 2 * np.pi
    c["prepos"][:40] = 0.5 + np.stack([np.cos(ang), np.sin(ang)], 1) * rng.random((40, 1)) * R
    c["alive"][:40] = True
    return c


def _on_wall(rng):
    c = _base(rng, 600, BOX)
    t = rng.random(40)
    c["prepos"][:10] = np.stack([np.zeros(10), t[:10]], 1)
    c["prepos"][10:20] = np.stack([t[10:20], np.zeros(10)], 1)
    c["prepos"][20:30] = np.stack([np.ones(10), t[20:30]], 1)
    c["prepos"][30:40] = np.stack([t[30:40], np.ones(10)], 1)
    c["alive"][:40] = True
    return c


def _parallel(rng):
    # One segment at y = r: its near padded copy lies exactly on y = 0.
    c = _base(rng, 300, [[[0.0, R], [1.0, R]]])
    c["prepos"][:300, 1] = rng.random(300) * 4 * R - 2 * R
    c["vel"][:100, 1] = 0.0  # moves parallel to the wall: den = 0
    # crossings of y = 0 whose den = mvy is under EPS: t from the EPS branch
    tiny = np.float32(2.5e-10)
    c["vel"][100:120] = [[0.0, float(tiny)]] * 20
    c["prepos"][100:120, 1] = -float(np.float32(tiny) * np.float32(DT)) / 2
    c["alive"][:120] = True
    return c


def _ends_on_wall(rng):
    c = _base(rng, 600, BOX)
    # ends exactly on the padded copies of the bottom (y = -r) and left
    # (x = r) walls: a move of 2^-10 from 2^-10 short of the line, exact in f32
    r, step = np.float32(R), np.float32(2.0 ** -10)
    c["prepos"][:10] = np.stack([rng.random(10) * 0.5 + 0.25, np.full(10, -r - step)], 1)
    c["vel"][:10] = [[0.0, step / DT]] * 10
    c["prepos"][10:20] = np.stack([np.full(10, r + step), rng.random(10) * 0.5 + 0.25], 1)
    c["vel"][10:20] = [[-step / DT, 0.0]] * 10
    # through a corner, across two walls
    c["prepos"][20:40] = 0.05 + rng.random((20, 2)) * 0.02
    c["vel"][20:40] = -0.2 / DT
    c["alive"][:40] = True
    return c


def _dead_garbage(rng):
    c = _base(rng, 600, BOX, alive=0.5)
    junk = [1e30, -1e30, np.inf, -np.inf, np.nan, 3.4e38]
    for k, v in enumerate(junk):
        c["prepos"][k::50][:8] = v
        c["vel"][k + 7::50][:8] = junk[-1 - k]
        c["alive"][k::50] = False
        c["alive"][k + 7::50] = False
    return c


def _non_finite_alive(rng):
    c = _base(rng, 600, BOX)
    c["vel"][:10] = np.nan
    c["vel"][10:20, 0] = np.inf
    c["prepos"][20:30] = np.nan  # finite velocities, moving towards the walls
    c["vel"][20:30] = [[-3.0, -3.0]] * 10
    c["alive"][:30] = True
    return c


def _invalid_segment(rng):
    # the no-body scene's one far segment (scene.py), masked out
    c = _base(rng, 300, [[[1e6, 1e6], [1e6 + 1.0, 1e6]]])
    c["prepos"][:100] = np.array([1e6, 1e6]) + rng.random((100, 2)) * [1.0, R]
    c["seg_valid"][:] = False
    c["alive"][:100] = True
    return c


def _motored(rng):
    seg = BOX + _paddle(np.array([0.5, 0.5]), 0.1, 0.4)
    c = _base(rng, 800, seg)
    c["prepos"][:200] = 0.5 + (rng.random((200, 2)) - 0.5) * 0.24
    c["seg_body"] = np.array([0] * 4 + [1] * 4, np.int64)
    c["body_center"] = np.array([[0.0, 0.0], [0.5, 0.5]])
    c["lin"] = np.array([[0.0, 0.0], [0.3, -0.2]])
    c["ang"] = np.array([0.0, 2.5])
    return c


def _small(rng):
    return _base(rng, 100, BOX)


def _batch(rng):
    """Three crates: radii, steps and paddle poses of their own."""
    crates = []
    poses = ((0.01, DT, 0.4), (0.008, DT / 2, 1.1), (0.012, 0.0017, 2.0))
    for b, (r, dt, turn) in enumerate(poses):
        c = _motored(rng)
        c["segments"] = np.asarray(BOX + _paddle(np.array([0.5, 0.5]), 0.1, turn), float)
        c["lin"] = np.array([[0.0, 0.0], [0.3 * b, -0.2]])
        c["ang"] = np.array([0.0, 2.5 - b])
        c["r"], c["dt"] = r, dt
        crates.append(c)
    out = {k: np.stack([np.asarray(c[k]) for c in crates]) for k in PER_CRATE}
    out.update({k: crates[0][k] for k in SHARED})
    return out


PER_CRATE = ("prepos", "vel", "alive", "segments", "lin", "ang", "r", "dt")
SHARED = ("seg_valid", "seg_body", "body_center")
CASES = {
    "threshold": (_threshold, 3, "particles at exactly 1.2 r from a wall (and one ulp either "
                                 "side); P not a multiple of the block"),
    "segment_ends": (_segment_ends, 11, "nearest points clamped to t = 0 and t = 1; S = 5"),
    "zero_length": (_zero_length, 13, "a zero-length segment (denom at its EPS floor)"),
    "on_wall": (_on_wall, 17, "particles on a wall (gnorm 0, at its EPS floor)"),
    "parallel": (_parallel, 19, "moves parallel to a wall (den 0) and crossings with |den| "
                                "under EPS (t from the sign_eps branch); S = 1"),
    "ends_on_wall": (_ends_on_wall, 23, "moves ending on a padded wall (t = 1) and moves "
                                        "across two walls (the least t)"),
    "dead_garbage": (_dead_garbage, 29, "dead slots holding huge, infinite and NaN values"),
    "non_finite_alive": (_non_finite_alive, 31, "alive particles with NaN or infinite "
                                                "velocities, or NaN positions"),
    "invalid_segment": (_invalid_segment, 37, "seg_valid false (the no-body scene's far "
                                              "segment) with particles on it"),
    "motored": (_motored, 41, "a motored body turning, particles on it; S = 8"),
    "small": (_small, 43, "P under one block"),
    "batch": (_batch, 47, "three crates with radii, steps and bodies of their own"),
}


def inputs(case: str, device) -> dict:
    """The case's tensors on ``device``: f32 floats, bool masks, int64
    seg_body; ``r`` and ``dt`` 0-d (the batch case: (3,) and every
    per-crate tensor with a leading crate axis)."""
    build, seed, _ = CASES[case]
    c = build(np.random.default_rng(seed))
    out = {}
    for k, v in c.items():
        v = np.asarray(v)
        dtype = (torch.bool if v.dtype == bool else torch.int64 if k == "seg_body"
                 else torch.float32)
        out[k] = torch.as_tensor(v.astype(np.float32) if dtype == torch.float32 else v,
                                 dtype=dtype, device=device)
    return out


def ghost_args(c: dict) -> tuple:
    """The arguments of ``boundary.ghost_pass`` (and of the plain version
    and the ``sand_crate::ghost_pass`` operator, in order)."""
    return (c["prepos"], c["alive"], c["segments"], c["lin"], c["ang"], c["r"], c["seg_valid"],
            c["seg_body"], c["body_center"])


def ccd_args(c: dict) -> tuple:
    """The arguments of ``kick.continuous_collision`` (positions: the
    case's prepos)."""
    return (c["prepos"], c["vel"], c["alive"], c["segments"], c["r"], c["dt"], c["seg_valid"])


def crate(c: dict, b: int) -> dict:
    """Crate ``b`` of the batch case as a solo case."""
    return {k: (v[b] if k in PER_CRATE else v) for k, v in c.items()}


def facts(case: str, device="cpu") -> dict:
    """What the case's inputs hold, from the plain geometry, and whether
    that is what the case claims (``"holds"``)."""
    c = inputs(case, device)
    if case == "batch":
        per = [facts_of(crate(c, b)) for b in range(c["r"].shape[0])]
        radii = {float(x) for x in c["r"]}
        steps = {float(x) for x in c["dt"]}
        return dict(crates=len(per), holds=len(radii) == len(steps) == len(per)
                    and all(f["contacts"] > 0 and f["crossings"] > 0 for f in per))
    f = facts_of(c)
    holds = {
        "threshold": f["at_threshold"] > 0 and f["P"] % BLOCK != 0,
        "segment_ends": f["t_below_0"] > 0 and f["t_above_1"] > 0 and f["S"] == 5,
        "zero_length": f["zero_length_contacts"] > 0,
        "on_wall": f["on_wall"] > 0,
        "parallel": f["den_zero"] > 0 and f["tiny_den_crossings"] > 0 and f["S"] == 1,
        "ends_on_wall": f["t_one"] > 0 and f["double"] > 0,
        "dead_garbage": f["dead_non_finite"] > 0,
        "non_finite_alive": f["alive_non_finite"] > 0,
        "invalid_segment": f["near_invalid"] > 0 and f["contacts"] == 0,
        "motored": f["contacts_turning"] > 0 and f["S"] == 8,
        "small": f["P"] < BLOCK,
    }[case]
    return dict(f, holds=holds)


def facts_of(c: dict) -> dict:
    pos, vel, alive, seg = c["prepos"], c["vel"], c["alive"], c["segments"]
    px, py = pos[:, 0], pos[:, 1]
    nx, ny, dist = geo.points_to_segments_soa(px, py, seg)
    thr = c["r"] * 1.2
    a, ab = seg[:, 0], seg[:, 1] - seg[:, 0]
    raw_t = (((px[None] - a[:, :1]) * ab[:, :1] + (py[None] - a[:, 1:]) * ab[:, 1:])
             / torch.clamp((ab * ab).sum(1, keepdim=True), min=1e-12))
    valid = c["seg_valid"][:, None]
    contact = (dist <= thr) & valid & alive[None]
    walls = geo.pad_segments(seg, c["r"])
    mvx, mvy = vel[:, 0] * c["dt"], vel[:, 1] * c["dt"]
    crossing, t_hit = geo.segment_crossings_soa(px, py, mvx, mvy, walls)
    crossing = crossing & torch.cat([valid, valid]) & alive[None]
    wx = (walls[:, 1, 0] - walls[:, 0, 0])[:, None]
    wy = (walls[:, 1, 1] - walls[:, 0, 1])[:, None]
    den = wx * mvy[None] - wy * mvx[None]
    zero_len = (ab == 0).all(1)[:, None]
    turning = (c["ang"][c["seg_body"]] != 0)[:, None]
    finite = torch.isfinite(pos).all(1) & torch.isfinite(vel).all(1)
    n = lambda m: int(m.sum())  # noqa: E731
    return dict(
        P=pos.shape[0], S=seg.shape[0], contacts=n(contact),
        at_threshold=n((dist == thr) & valid & alive[None]),
        t_below_0=n(contact & (raw_t < 0)), t_above_1=n(contact & (raw_t > 1)),
        zero_length_contacts=n(contact & zero_len), on_wall=n((dist == 0) & alive[None]),
        den_zero=n((den == 0) & alive[None]),
        tiny_den_crossings=n(crossing & (den.abs() <= 1e-12)),
        crossings=n(crossing), t_one=n(crossing & (t_hit == 1)),
        double=n(crossing.sum(0) >= 2),
        dead_non_finite=n(~alive & ~finite), alive_non_finite=n(alive & ~finite),
        near_invalid=n((dist <= thr) & ~valid & alive[None]),
        contacts_turning=n(contact & turning),
    )
