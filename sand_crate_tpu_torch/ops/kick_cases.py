"""Hard inputs for holding the velocity-update kernel against its plain
version.

``velocity_update`` (``csrc/kick.cu``) takes a thread per slot and applies
every kick, the wall bounce, the CCD clamp and the integrate in registers;
its plain version (``ops/kick.py``) runs them as torch ops over (P, 2)
planes.  Each case below puts slots where a mask, a NaN, a sign of zero,
a stride or the launch shape has an edge: dead slots holding garbage (NaN,
inf and -0), alive slots with a NaN position or a NaN or infinite
velocity, slots in contact with a wall (g_cnt > 0) approaching and
receding from it, moves that cross a padded wall (and two), the spring on
(with slots that have no neighbour and no ghost) and off, the folded sums
(a zero pressure_real plane holding -0 entries) and the split ones, the
p-major layout (sums as transposed views, an expanded zero plane), a crate
of one slot, and three crates at once with coefficients of their own.
Inputs are made from a numpy seed; ``tests/test_torch_kicks.py`` and
``chip_smoke.py`` run every case and :func:`facts` checks that each holds
what it claims.  :func:`apply_call` makes the case's call of each per-kick
function of ``physics`` (``APPLY``), :func:`apply_plain` its single stage
through the plain update.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from . import kick

R, DT = 0.01, 1.0 / 512.0  # the cases' radius and step (dt a power of two)
BOX = [[[0.0, 0.0], [0.0, 1.0]], [[0.0, 0.0], [1.0, 0.0]],
       [[1.0, 0.0], [1.0, 1.0]], [[0.0, 1.0], [1.0, 1.0]]]  # the dam break's box
COEF = dict(dt=DT, gravity=[0.0, 9.8], pressure_amplifier=30.0, spring_amplifier=100.0,
            spring_overlap_balance=0.5, viscosity=8.0, wall_collision_decay=0.2,
            particle_radius=R)
BLOCK = 256  # the kernel's threads a block
SUMS2 = ("dv_tension", "pressure_real", "spring_real", "visc_vsum", "gsum", "gvel_sum")


def _base(rng, n, alive=0.9, speed=3.0):
    """n slots in the unit box, a fifth of them within 2 r of a wall and in
    contact with it (g_cnt 1 or 2, gsum pointing out of the wall), random
    pair sums, the dam break's box."""
    pos = rng.random((n, 2)) * 0.98 + 0.01
    k = n // 5
    side = rng.integers(0, 4, k)
    d = rng.random(k) * 2 * R
    pos[:k, 0] = np.where(side == 0, d, np.where(side == 2, 1.0 - d, pos[:k, 0]))
    pos[:k, 1] = np.where(side == 1, d, np.where(side == 3, 1.0 - d, pos[:k, 1]))
    inward = np.array([[1.0, 0.0], [0.0, 1.0], [-1.0, 0.0], [0.0, -1.0]])[side]
    g_cnt = np.zeros(n)
    g_cnt[:k] = rng.integers(1, 3, k)
    gsum = np.zeros((n, 2))
    gsum[:k] = inward * (2 * d)[:, None] * g_cnt[:k, None] + rng.normal(size=(k, 2)) * 1e-3
    gvel_sum = np.zeros((n, 2))
    gvel_sum[:k] = rng.normal(size=(k, 2)) * 0.3
    f = lambda *s: rng.normal(size=s)  # noqa: E731
    return dict(
        vel=(rng.random((n, 2)) - 0.5) * 2 * speed, pos=pos, alive=rng.random(n) < alive,
        p_i=np.abs(f(n)) * 2, dv_tension=f(n, 2) * 50, pressure_real=f(n, 2) * 5,
        spring_real=f(n, 2), visc_vsum=f(n, 2) * 4, nbr_cnt=rng.integers(0, 9, n).astype(float),
        g_cnt=g_cnt, gsum=gsum, gvel_sum=gvel_sum, segments=np.asarray(BOX, float),
        seg_valid=np.ones(4, bool), **COEF, spring=False,
    )


def _random(rng):
    return _base(rng, 700)


def _dead_slots(rng):
    c = _base(rng, 700, alive=0.5)
    junk = [np.nan, np.inf, -np.inf, 3.4e38, -0.0]
    for k, v in enumerate(junk):
        c["vel"][k::40][:10] = v
        c["pos"][k + 5::40][:10] = v
        c["dv_tension"][k + 10::40][:10] = v
        c["gsum"][k + 15::40][:10] = v
        c["alive"][k::40] = False
        c["alive"][k + 5::40] = False
        c["alive"][k + 10::40] = False
        c["alive"][k + 15::40] = False
    return c


def _nan_position(rng):
    c = _base(rng, 600)
    c["pos"][:10] = np.nan  # moving towards the walls
    c["vel"][:10] = [[-3.0, -3.0]] * 10
    c["alive"][:10] = True
    return c


def _nan_velocity(rng):
    c = _base(rng, 600)
    c["vel"][:10] = np.nan
    c["vel"][10:20, 0] = np.inf
    c["alive"][:20] = True
    return c


def _wall_contact(rng):
    c = _base(rng, 600)
    # the bottom wall (y = 0): contact, half moving into it, half away
    c["pos"][:40] = np.stack([rng.random(40) * 0.8 + 0.1, rng.random(40) * R], 1)
    c["g_cnt"][:40] = 1.0
    c["gsum"][:40] = np.stack([np.zeros(40), 2 * c["pos"][:40, 1]], 1)
    c["vel"][:20, 1] = -np.abs(c["vel"][:20, 1]) - 1.0
    c["vel"][20:40, 1] = np.abs(c["vel"][20:40, 1]) + 1.0
    c["dv_tension"][:40] = 0.0
    c["pressure_real"][:40] = 0.0
    c["visc_vsum"][:40] = 0.0
    c["alive"][:40] = True
    return c


def _crossing(rng):
    c = _base(rng, 600)
    # across the left wall's padded line x = r, and through a corner across two
    c["pos"][:20] = np.stack([np.full(20, R + 2e-4), rng.random(20) * 0.5 + 0.25], 1)
    c["vel"][:20] = [[-1.0 / DT * 1e-3, 0.0]] * 20
    c["pos"][20:40] = 0.012 + rng.random((20, 2)) * 0.004
    c["vel"][20:40] = -0.01 / DT
    for k in ("dv_tension", "pressure_real", "visc_vsum", "g_cnt", "gsum", "gvel_sum"):
        c[k][:40] = 0.0
    c["alive"][:40] = True
    return c


def _spring_on(rng):
    c = _base(rng, 700)
    c["spring"] = True
    c["nbr_cnt"][:30] = 0.0  # no neighbour and no ghost: total 0
    c["g_cnt"][:30] = 0.0
    c["alive"][:30] = True
    return c


def _fold(rng):
    c = _base(rng, 700)
    c["pressure_real"] = np.zeros((700, 2))
    c["pressure_real"][::3] = -0.0
    c["gsum"][100:200] = 0.0  # p_i * gsum = +0: -0 + +0 is +0
    return c


def _one(rng):
    c = _base(rng, 6)
    return {k: (v[5:6] if isinstance(v, np.ndarray) and k not in ("segments", "seg_valid",
                                                                  "gravity") else v)
            for k, v in c.items()} | {"alive": np.array([True]),
                                       "pos": np.array([[R + 1e-4, 0.5]]),
                                       "vel": np.array([[-2.0, 0.5]])}


def _strided(rng):
    c = _base(rng, 900)
    c["layout"] = "pmajor"  # sums as (rows, P) planes read through .T; an expanded zero
    return c


def _batch(rng):
    """Three crates: steps, radii and coefficients of their own."""
    crates = []
    for b in range(3):
        c = _crossing(rng)
        c.update(dt=DT * (1 + b) / 2, particle_radius=R * (0.8 + 0.2 * b),
                 pressure_amplifier=30.0 - 5 * b, viscosity=8.0 + b,
                 wall_collision_decay=0.2 + 0.1 * b, gravity=[0.1 * b, 9.8])
        crates.append(c)
    out = {k: np.stack([np.asarray(c[k]) for c in crates]) for k in PER_CRATE}
    out.update(seg_valid=crates[0]["seg_valid"], spring=False)
    return out


PER_CRATE = kick.PER_CRATE
CASES = {
    "random": (_random, 3, "random slots, a fifth in contact with a wall; P not a multiple of "
                           "the block"),
    "dead_slots": (_dead_slots, 5, "dead slots holding NaN, inf and -0 velocities, positions "
                                   "and sums"),
    "nan_position": (_nan_position, 7, "alive slots with NaN positions moving towards walls"),
    "nan_velocity": (_nan_velocity, 11, "alive slots with NaN or infinite velocities"),
    "wall_contact": (_wall_contact, 13, "slots in contact with a wall (g_cnt > 0), approaching "
                                        "and receding"),
    "crossing": (_crossing, 17, "moves that cross a padded wall, and two through a corner"),
    "spring_on": (_spring_on, 19, "the spring on, slots with no neighbour and no ghost"),
    "fold": (_fold, 23, "the folded sums: a zero pressure_real plane with -0 entries"),
    "one": (_one, 29, "a crate of one slot"),
    "strided": (_strided, 31, "the p-major layout: sums as transposed views, an expanded "
                              "zero plane"),
    "batch": (_batch, 37, "three crates with steps, radii and coefficients of their own"),
}


def inputs(case: str, device) -> dict:
    """The case's tensors on ``device``: f32 floats, bool masks;
    coefficients 0-d, gravity (2,) (the batch case: a leading crate axis on
    every per-crate tensor).  The strided case lays its (P, 2) sums out as
    transposed views of (2, P) planes and pressure_real as an expanded zero."""
    build, seed, _ = CASES[case]
    return _tensors(build(np.random.default_rng(seed)), device)


def random_state(n: int, seed: int, device) -> dict:
    """n random slots as the base of the cases builds them, in the p-major
    layout (a state at the main path's size)."""
    return _tensors(dict(_base(np.random.default_rng(seed), n), layout="pmajor"), device)


def _tensors(c: dict, device) -> dict:
    out = {"spring": bool(c.pop("spring"))}
    layout = c.pop("layout", None)
    for k, v in c.items():
        v = np.asarray(v)
        dtype = torch.bool if v.dtype == bool else torch.float32
        t = torch.as_tensor(v.astype(np.float32) if dtype == torch.float32 else v, dtype=dtype,
                            device=device)
        if layout == "pmajor" and k in SUMS2:
            t = t.T.contiguous().T  # (P, 2) with strides (1, P)
        out[k] = t
    if layout == "pmajor":
        out["pressure_real"] = out["vel"].new_zeros(()).expand(out["vel"].shape)
    return out


def args(c: dict) -> tuple:
    """The operands of ``kick.update`` in order (``PER_CRATE``, then the
    scene's seg_valid)."""
    return tuple(c[k] for k in PER_CRATE) + (c["seg_valid"],)


def stages(c: dict) -> int:
    """The fused stages of the case (the spring as the case sets it)."""
    return kick.fused(c["spring"])


def crate(c: dict, b: int) -> dict:
    """Crate ``b`` of the batch case as a solo case."""
    return {k: (v[b] if k in PER_CRATE else v) for k, v in c.items()}


def facts(case: str, device="cpu") -> dict:
    """What the case's inputs hold, from the plain version, and whether that
    is what the case claims (``"holds"``)."""
    c = inputs(case, device)
    if case == "batch":
        per = [facts_of(crate(c, b)) for b in range(c["dt"].shape[0])]
        steps = {float(x) for x in c["dt"]}
        radii = {float(x) for x in c["particle_radius"]}
        return dict(crates=len(per), holds=len(steps) == len(radii) == len(per)
                    and all(f["contacts"] > 0 and f["clamped"] > 0 for f in per))
    f = facts_of(c)
    holds = {
        "random": f["P"] % BLOCK != 0 and f["contacts"] > 0,
        "dead_slots": f["dead_non_finite"] > 0 and f["dead_neg_zero"] > 0,
        "nan_position": f["alive_nan_pos"] > 0,
        "nan_velocity": f["alive_nan_vel"] > 0 and f["alive_inf_vel"] > 0,
        "wall_contact": f["approaching"] > 0 and f["receding"] > 0,
        "crossing": f["clamped"] > 0 and f["double"] > 0,
        "spring_on": c["spring"] and f["spring_total_zero"] > 0,
        "fold": f["pressure_zero"] and f["pressure_neg_zero"] > 0,
        "one": f["P"] == 1,
        "strided": f["strided"] and f["expanded"],
    }[case]
    return dict(f, holds=holds)


def facts_of(c: dict) -> dict:
    vel, pos, alive = c["vel"], c["pos"], c["alive"]
    into = kick.velocity_update_plain(*args(c), stages(c) & ~(kick.CCD | kick.INTEGRATE))[0]
    # the velocity into the clamp, and what the clamp makes of it
    clamped_vel = kick.continuous_collision_plain(pos, into, alive, c["segments"],
                                                  c["particle_radius"], c["dt"], c["seg_valid"])
    clamp = alive & (clamped_vel != into).any(dim=1)
    # moves that reach past two walls of the box from inside its padded corner
    mv = into * c["dt"]
    end = pos + mv
    r = c["particle_radius"]
    double = alive & ((end < r) | (end > 1 - r)).all(dim=1) & ((pos > r) & (pos < 1 - r)).all(1)
    contact = alive & (c["g_cnt"] > 0)
    normal = c["gsum"] / torch.clamp(c["g_cnt"], min=1.0)[:, None]
    approach = ((vel - c["gvel_sum"] / torch.clamp(c["g_cnt"], min=1.0)[:, None])
                * normal).sum(1)
    finite = torch.isfinite(pos).all(1) & torch.isfinite(vel).all(1) & torch.isfinite(
        c["dv_tension"]).all(1) & torch.isfinite(c["gsum"]).all(1)
    pr = c["pressure_real"]
    n = lambda m: int(m.sum())  # noqa: E731
    return dict(
        P=vel.shape[0], contacts=n(contact), approaching=n(contact & (approach < 0)),
        receding=n(contact & (approach > 0)), clamped=n(clamp), double=n(double & clamp),
        dead_non_finite=n(~alive & ~finite),
        dead_neg_zero=n(~alive & ((vel == 0) & torch.signbit(vel)).any(1)),
        alive_nan_pos=n(alive & torch.isnan(pos).any(1)),
        alive_nan_vel=n(alive & torch.isnan(vel).any(1)),
        alive_inf_vel=n(alive & torch.isinf(vel).any(1)),
        spring_total_zero=n(alive & (c["nbr_cnt"] + c["g_cnt"] == 0)),
        pressure_zero=bool((pr == 0).all()), pressure_neg_zero=n(((pr == 0) & torch.signbit(pr)).any(1)),
        strided=c["dv_tension"].stride() == (1, vel.shape[0]),
        expanded=pr.stride() == (0, 0),
    )


# The per-kick functions of physics.py: name -> (the stage it runs, its
# arguments by name: sums and ghost are the case's PairSums and GhostInfo,
# params and scene namespaces of its coefficients and seg_valid).
APPLY = {
    "tension": (kick.TENSION, ("vel", "alive", "sums", "params")),
    "gravity": (kick.GRAVITY, ("vel", "alive", "params")),
    "pressure_force": (kick.PRESSURE, ("vel", "alive", "sums", "ghost", "params")),
    "spring": (kick.SPRING, ("vel", "alive", "sums", "ghost", "params")),
    "viscosity": (kick.VISCOSITY, ("vel", "alive", "sums", "params")),
    "wall_bounce": (kick.WALL_BOUNCE, ("vel", "alive", "ghost", "params")),
    "continuous_collision": (kick.CCD, ("pos", "vel", "alive", "segments", "params", "scene")),
}


def apply_arguments(name: str, t: dict, sums_type, ghost_type, overflow) -> tuple:
    """The arguments of ``apply_<name>`` from a solo case's arrays ``t``
    (torch or another array type), its sums and ghost as ``sums_type`` and
    ``ghost_type`` (a package's PairSums and GhostInfo)."""
    x = dict(vel=t["vel"], pos=t["pos"], alive=t["alive"], segments=t["segments"],
             sums=sums_type(*(t[k] for k in sums_type._fields[:-1]), overflow=overflow),
             ghost=ghost_type(t["pos"], t["g_cnt"], t["gsum"], t["gvel_sum"]),
             params=SimpleNamespace(**{k: t[k] for k in COEF}),
             scene=SimpleNamespace(seg_valid=t["seg_valid"]))
    return tuple(x[k] for k in APPLY[name][1])


def apply_call(name: str, c: dict):
    """(``physics.apply_<name>``, its arguments) on the solo case ``c``."""
    from .. import physics
    from ..cellwise import PairSums

    t = {k: v for k, v in c.items() if isinstance(v, torch.Tensor)}
    overflow = torch.zeros((), dtype=torch.int32, device=c["vel"].device)
    return (getattr(physics, "apply_" + name),
            apply_arguments(name, t, PairSums, physics.GhostInfo, overflow))


def apply_plain(name: str, c: dict):
    """``apply_<name>``'s single stage through the plain update on the solo
    case ``c`` -> (vel, mean |dv| over the alive slots)."""
    stage = APPLY[name][0]
    named = {k: c[k] for k in PER_CRATE}
    return kick.single_stage(stage, SimpleNamespace(**named), c["seg_valid"], kick.update_plain,
                             **named)
