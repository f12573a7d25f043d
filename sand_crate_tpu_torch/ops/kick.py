"""The tick's velocity update: every kick, the wall bounce, the
continuous-collision clamp and the integrate, as one pass over the slots.

The counterpart of the XLA fusions of ``sand_crate_tpu/physics.py``'s
``apply_tension`` ... ``apply_continuous_collision`` and ``finish_tick``
(l.680-790, crate.py:177-200, 245-361); no ``pl.pallas_call``.  Each stage
is a per-particle function of the slot's velocity, position, pair sums
(``cellwise.PairSums``) and ghost sums (``physics.GhostInfo``).

* :func:`velocity_update_plain` computes the stages as torch ops over
  (P, 2) planes, in ``physics.step``'s order.
* :func:`velocity_update` dispatches on the tensors' device: CPU tensors run
  the plain version; CUDA tensors launch ``kick_kernel`` of
  ``csrc/kick.cu`` (a thread per slot, the stages in registers, built by
  ``nvcc`` at first use) on the current stream, counted in ``LAUNCHES``;
  tensors anywhere else raise.  The kernel gives the plain version's bits
  on the card.

``stages`` is a mask of the stage bits below.  ``physics.step`` and the
band step run every stage in one launch (:func:`fused`; the spring only
where the scene enables it); the instrumented tick runs one stage a launch,
which gives the same bits (an f32 round trip through memory is exact).
With ``NORMS`` every kick writes its masked |dv| as a row of a (K, P) plane
(K the kicks in ``stages``): the force_dv means are :func:`force_dv` of it,
one sum over the rows, which the plain version takes too, so both paths
give the same bits.  With ``INTEGRATE``
the update also returns the new positions and pressures, ``max_speed``,
``non_finite`` and ``cnt`` (the alive count, at least 1: the means'
denominator).

:func:`single_stage` runs one stage alone (the operands it does not read
None) with its norm row and returns the velocity and the mean |dv| over the
alive slots: ``physics.apply_tension`` ... ``apply_continuous_collision``,
the JAX package's per-kick functions, are calls of it (one launch each on
the card).

On the card each launch goes through the custom operator
``torch.ops.sand_crate.velocity_update``, whose kernel takes a leading crate
axis: ``torch.func.vmap`` (batched crates, ``sweep.py``) reaches its vmap
rule, which moves the crate dims to the front and launches once over all
crates.  A solo crate is a batch of one.  ``LAUNCHES`` counts each launch
by its kind (:func:`launch_kind`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import geometry as geo
from . import cuda_build

EPS = 1e-12

TENSION, GRAVITY, PRESSURE, SPRING, VISCOSITY, WALL_BOUNCE, CCD, INTEGRATE = (
    1 << k for k in range(8))
NORMS = 1 << 8  # write each kick's masked |dv| (the force_dv rows)
# The kicks in force_dv's order (state.FORCE_LABELS), each a row of the norms.
KICKS = (TENSION, GRAVITY, PRESSURE, SPRING, VISCOSITY, WALL_BOUNCE, CCD)
KICK_MASK = sum(KICKS)

# Kernel launches since the last reset, counted where the kernel launches,
# by kind: the update of every stage in one launch (physics.step, the band
# step), one stage a launch (the instrumented tick's phases), the clamp alone.
LAUNCHES = {"velocity_update": 0, "velocity_update_stage": 0, "ccd": 0}


def launch_kind(stages: int) -> str:
    """The ``LAUNCHES`` key of a launch over ``stages``: ``ccd`` for the
    clamp alone, ``velocity_update_stage`` for any other single stage,
    ``velocity_update`` for more than one."""
    run = stages & (KICK_MASK | INTEGRATE)
    if run & (run - 1):
        return "velocity_update"
    return "ccd" if run == CCD else "velocity_update_stage"


def fused(enable_spring: bool, norms: bool = True) -> int:
    """Every stage in one launch, as ``physics.step`` runs them: the spring
    only where the scene enables it (the band step drops the norms)."""
    kicks = KICK_MASK if enable_spring else KICK_MASK & ~SPRING
    return kicks | INTEGRATE | (NORMS if norms else 0)


def norm_rows(stages: int) -> int:
    """K: the rows of the norm plane that ``stages`` writes."""
    return bin(stages & KICK_MASK).count("1") if stages & NORMS else 0


class KickOut(NamedTuple):
    """What the update returns; ``None`` where ``stages`` has no stage
    that computes it."""

    vel: torch.Tensor  # (P, 2)
    pos: torch.Tensor | None  # (P, 2) integrated
    pressure: torch.Tensor | None  # (P,) where(alive, p_i, 0)
    norms: torch.Tensor | None  # (K, P) masked |dv| a kick
    max_speed: torch.Tensor | None  # () f32
    non_finite: torch.Tensor | None  # () int32
    cnt: torch.Tensor | None  # () f32, max(alive count, 1)


def force_dv(norms: torch.Tensor, cnt: torch.Tensor) -> torch.Tensor:
    """The force_dv means: each kick's mean |dv| over the alive slots.  A
    plane without the spring's row (a scene that disables the spring: one
    row fewer than KICKS) gets the zero the tick logs for it."""
    means = norms.sum(dim=-1) / cnt[..., None]
    if norms.shape[-2] != len(KICKS) - 1:
        return means
    k = KICKS.index(SPRING)
    return torch.cat([means[..., :k], torch.zeros_like(means[..., :1]), means[..., k:]], dim=-1)


# --------------------------------------------------------------------------
# the plain version
# --------------------------------------------------------------------------

# The operator's operands in order: per crate, then the scene's seg_valid.
PER_CRATE = ("vel", "pos", "alive", "p_i", "dv_tension", "pressure_real", "spring_real",
             "visc_vsum", "nbr_cnt", "g_cnt", "gsum", "gvel_sum", "segments", "dt", "gravity",
             "pressure_amplifier", "spring_amplifier", "spring_overlap_balance", "viscosity",
             "wall_collision_decay", "particle_radius")


def continuous_collision_plain(pos, vel, alive, segments, particle_radius, dt, seg_valid):
    """The continuous collision velocity clamp (crate.py:177-200) -> the
    new velocity (P, 2): each alive particle's move ``vel * dt`` is cut at
    its first crossing of a padded wall it approaches."""
    walls = geo.pad_segments(segments, particle_radius)  # (2S,2,2)
    wall_valid = torch.cat([seg_valid, seg_valid])
    crossing, t_hit = geo.segment_crossings_soa(
        pos[:, 0], pos[:, 1], vel[:, 0] * dt, vel[:, 1] * dt, walls
    )  # (2S, P)
    crossing = crossing & wall_valid[:, None] & alive[None]
    factor = torch.where(crossing, t_hit, torch.inf).amin(dim=0)
    fix = torch.clamp(factor, max=1.0)  # 1 where no crossing
    return vel * fix[:, None]


def _masked_norm(dv, alive):
    """where(alive, |dv|, 0), the squares summed x then y as the kernel does."""
    n = torch.sqrt(torch.clamp(dv[:, 0] * dv[:, 0] + dv[:, 1] * dv[:, 1], min=0.0))
    return torch.where(alive, n, 0.0)


def _wall_bounce_dv(vel, alive, g_cnt, gsum, gvel_sum, wall_collision_decay):
    """Wall bounce against the moving-wall contact velocity (crate.py:245-259)."""
    denom = torch.clamp(g_cnt, min=1.0)[:, None]
    normal = gsum / denom  # mean ghost direction
    contact_vel = gvel_sum / denom
    n_unit, _ = geo.safe_normalize(normal)
    rel_vel = vel - contact_vel
    approach = (rel_vel * n_unit).sum(dim=-1)  # (P,)
    bounce = -approach[:, None] * n_unit * (1.0 + wall_collision_decay)
    hit = alive & (g_cnt > 0) & (approach < 0.0)
    return torch.where(hit[:, None], bounce, 0.0)


def velocity_update_plain(vel, pos, alive, p_i, dv_tension, pressure_real, spring_real,
                          visc_vsum, nbr_cnt, g_cnt, gsum, gvel_sum, segments, dt, gravity,
                          pressure_amplifier, spring_amplifier, spring_overlap_balance, viscosity,
                          wall_collision_decay, particle_radius, seg_valid, stages: int):
    """One crate's update over ``stages`` -> (vel (P, 2), pos (P, 2),
    pressure (P,), norms (K, P), max_speed (1,), non_finite (1,) int32,
    cnt (1,)); pos and pressure have 0 rows, and the last three 0 entries,
    without INTEGRATE.  Operands that ``stages`` does not read may be None."""
    P = vel.shape[0]
    al2 = alive[:, None]
    rows = []

    def kick(vel, dv):
        if stages & NORMS:
            rows.append(_masked_norm(dv, alive))
        return vel + dv

    # the kicks in reference order (crate.py:286-358), each masked to the alive slots
    if stages & TENSION:
        vel = kick(vel, torch.where(al2, dt * dv_tension, 0.0))
    if stages & GRAVITY:
        vel = kick(vel, torch.where(al2, dt * gravity[None, :], 0.0))
    if stages & PRESSURE:  # sum_s m_s * p_i * gvec_s factors as p_i * gsum
        dv = dt * pressure_amplifier * (pressure_real + p_i[:, None] * gsum)
        vel = kick(vel, torch.where(al2, dv, 0.0))
    if stages & SPRING:  # crate.py:325-333; the reference ships it disabled
        total = nbr_cnt + g_cnt
        dv = (dt * spring_amplifier * (spring_real + spring_overlap_balance * gsum)
              / torch.clamp(total, min=1.0)[:, None])
        vel = kick(vel, torch.where(al2 & (total > 0)[:, None], dv, 0.0))
    if stages & VISCOSITY:  # stale v_j snapshot, fresh v_i (crate.py:316-323)
        dv = dt * viscosity * (visc_vsum - nbr_cnt[:, None] * vel)
        vel = kick(vel, torch.where(al2, dv, 0.0))
    if stages & WALL_BOUNCE:
        vel = kick(vel, _wall_bounce_dv(vel, alive, g_cnt, gsum, gvel_sum, wall_collision_decay))
    if stages & CCD:
        new_vel = continuous_collision_plain(pos, vel, alive, segments, particle_radius, dt,
                                             seg_valid)
        if stages & NORMS:
            rows.append(_masked_norm(new_vel - vel, alive))
        vel = new_vel
    norms = torch.stack(rows) if rows else vel.new_zeros((0, P))

    if not stages & INTEGRATE:
        empty = vel.new_zeros((0,))
        return (vel, vel.new_zeros((0, 2)), empty, norms, empty,
                torch.zeros((0,), dtype=torch.int32, device=vel.device), empty)
    # integrate positions (crate.py:360-361) and the tick's diagnostics
    pos = torch.where(al2, pos + dt * vel, pos)
    pressure = torch.where(alive, p_i, 0.0)
    speed2 = vel[:, 0] * vel[:, 0] + vel[:, 1] * vel[:, 1]
    max_speed = torch.sqrt(torch.where(alive, speed2, 0.0).max())
    finite = (torch.isfinite(pos) & torch.isfinite(vel)).all(dim=-1)
    non_finite = (alive & ~finite).sum(dtype=torch.int32)
    cnt = torch.clamp(alive.sum(dtype=torch.int32).to(vel.dtype), min=1.0)
    return vel, pos, pressure, norms, max_speed[None], non_finite[None], cnt[None]


# --------------------------------------------------------------------------
# the kernel
# --------------------------------------------------------------------------


class _F2(ctypes.Structure):
    _fields_ = [("p", ctypes.c_void_p), ("sb", ctypes.c_longlong), ("sp", ctypes.c_longlong),
                ("sc", ctypes.c_longlong)]


class _F1(ctypes.Structure):
    _fields_ = [("p", ctypes.c_void_p), ("sb", ctypes.c_longlong), ("sp", ctypes.c_longlong)]


_F2_FIELDS = ("vel", "pos", "dv_tension", "pressure_real", "spring_real", "visc_vsum", "gsum",
              "gvel_sum")
_F1_FIELDS = ("p_i", "nbr_cnt", "g_cnt")
_COEF_FIELDS = ("dt", "gravity", "pressure_amplifier", "spring_amplifier",
                "spring_overlap_balance", "viscosity", "wall_collision_decay", "particle_radius")
_OUT_FIELDS = ("vel_out", "pos_out", "pressure_out", "norms", "max_speed", "cnt", "non_finite",
               "scratch")


class _Args(ctypes.Structure):
    """csrc/kick.cu's KickArgs, field for field."""

    _fields_ = ([(k, _F2) for k in _F2_FIELDS] + [(k, _F1) for k in _F1_FIELDS]
                + [("alive", ctypes.c_void_p), ("alive_sb", ctypes.c_longlong),
                   ("alive_sp", ctypes.c_longlong), ("segments", ctypes.c_void_p),
                   ("seg_valid", ctypes.c_void_p)]
                + [(k, ctypes.c_void_p) for k in _COEF_FIELDS + _OUT_FIELDS]
                + [(k, ctypes.c_int) for k in ("B", "P", "S", "stages", "K")])


def _needs(stages: int) -> set:
    """The operands a launch of ``stages`` reads."""
    spring = bool(stages & SPRING)
    need = {"vel", "alive", "dt"}
    for name, on in (
        ("pos", stages & (CCD | INTEGRATE)), ("dv_tension", stages & TENSION),
        ("gravity", stages & GRAVITY), ("p_i", stages & (PRESSURE | INTEGRATE)),
        ("pressure_real", stages & PRESSURE), ("pressure_amplifier", stages & PRESSURE),
        ("gsum", stages & (PRESSURE | WALL_BOUNCE) or spring), ("spring_real", spring),
        ("spring_amplifier", spring), ("spring_overlap_balance", spring),
        ("nbr_cnt", stages & VISCOSITY or spring), ("g_cnt", stages & WALL_BOUNCE or spring),
        ("visc_vsum", stages & VISCOSITY), ("viscosity", stages & VISCOSITY),
        ("gvel_sum", stages & WALL_BOUNCE), ("wall_collision_decay", stages & WALL_BOUNCE),
        ("segments", stages & CCD), ("particle_radius", stages & CCD),
        ("seg_valid", stages & CCD),
    ):
        if on:
            need.add(name)
    return need


def _lib():
    lib = cuda_build.load("kick")
    if lib.sc_velocity_update.argtypes is None:  # pointers as c_void_p: never cut to int
        lib.sc_velocity_update.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
        lib.sc_velocity_update.restype = ctypes.c_int
    return lib


def _launch(args: dict, stages: int):
    """The kernel over a leading crate axis B; ``args`` maps the operand
    names to (B, ...) tensors (the scene's seg_valid (S,)) or None."""
    vel = args["vel"]
    B, P = vel.shape[:2]
    f32 = torch.float32
    S = args["segments"].shape[1] if args["segments"] is not None else 0
    shapes = {"vel": (B, P, 2), "pos": (B, P, 2), "alive": (B, P), "segments": (B, S, 2, 2),
              "gravity": (B, 2), "seg_valid": (S,)}
    needs = _needs(stages)
    for name in needs:
        t = args[name]
        if t is None:
            raise ValueError(f"velocity_update: stages {stages:#x} read {name}, given None")
        want = shapes.get(name, (B, P, 2) if name in _F2_FIELDS else
                          (B, P) if name in _F1_FIELDS else (B,))
        dtype = torch.bool if name in ("alive", "seg_valid") else f32
        if t.device != vel.device or t.dtype != dtype or tuple(t.shape) != want:
            raise ValueError(f"velocity_update: {name} must be a {dtype} tensor of shape {want} "
                             f"on {vel.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
        if name in ("segments", "seg_valid") + _COEF_FIELDS:  # read as dense arrays
            args[name] = t.contiguous()
    integrate = bool(stages & INTEGRATE)
    n = P if integrate else 0
    out = dict(vel_out=torch.empty((B, P, 2), dtype=f32, device=vel.device),
               pos_out=torch.empty((B, n, 2), dtype=f32, device=vel.device),
               pressure_out=torch.empty((B, n), dtype=f32, device=vel.device),
               norms=torch.empty((B, norm_rows(stages), P), dtype=f32, device=vel.device),
               max_speed=torch.empty((B, int(integrate)), dtype=f32, device=vel.device),
               cnt=torch.empty((B, int(integrate)), dtype=f32, device=vel.device),
               non_finite=torch.empty((B, int(integrate)), dtype=torch.int32,
                                      device=vel.device),
               scratch=(torch.zeros((B, 5), dtype=torch.int32, device=vel.device)
                        if integrate else None))
    a = _Args(B=B, P=P, S=S, stages=stages, K=norm_rows(stages))
    for name in _F2_FIELDS + _F1_FIELDS:
        t = args[name] if name in needs else None
        if t is not None:
            setattr(a, name, (_F2 if name in _F2_FIELDS else _F1)(t.data_ptr(), *t.stride()))
    alive = args["alive"]
    a.alive, (a.alive_sb, a.alive_sp) = alive.data_ptr(), alive.stride()
    for name in ("segments", "seg_valid") + _COEF_FIELDS:
        t = args[name] if name in needs else None
        setattr(a, name, t.data_ptr() if t is not None else None)
    for name, t in out.items():
        setattr(a, name, t.data_ptr() if t is not None else None)
    with torch.cuda.device(vel.device):  # launch on the tensors' card
        err = _lib().sc_velocity_update(ctypes.byref(a), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"velocity_update kernel failed: cudaError {err}")
    LAUNCHES[launch_kind(stages)] += 1
    return tuple(out[k] for k in ("vel_out", "pos_out", "pressure_out", "norms", "max_speed",
                                  "non_finite", "cnt"))


def _crates_plain(per_crate, seg_valid, stages):
    """The operator's plain version: each crate alone, stacked."""
    n = per_crate[0].shape[0]
    outs = [velocity_update_plain(*(x[b] if x is not None else None for x in per_crate),
                                  seg_valid, stages) for b in range(n)]
    return tuple(torch.stack(o) for o in zip(*outs))


_SCHEMA = ("(" + ", ".join(f"Tensor{'' if k in ('vel', 'alive', 'dt') else '?'} {k}"
                           for k in PER_CRATE)
           + ", Tensor? seg_valid, int stages) -> "
           "(Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)")


@torch.library.custom_op("sand_crate::velocity_update", mutates_args=(), schema=_SCHEMA)
def _op(vel, pos, alive, p_i, dv_tension, pressure_real, spring_real, visc_vsum, nbr_cnt, g_cnt,
        gsum, gvel_sum, segments, dt, gravity, pressure_amplifier, spring_amplifier,
        spring_overlap_balance, viscosity, wall_collision_decay, particle_radius, seg_valid,
        stages):
    """The velocity update over a leading crate axis: per crate (B, ...)
    operands (None where ``stages`` reads none), the scene's seg_valid
    shared."""
    per_crate = (vel, pos, alive, p_i, dv_tension, pressure_real, spring_real, visc_vsum,
                 nbr_cnt, g_cnt, gsum, gvel_sum, segments, dt, gravity, pressure_amplifier,
                 spring_amplifier, spring_overlap_balance, viscosity, wall_collision_decay,
                 particle_radius)
    if vel.device.type == "cuda":
        return _launch(dict(zip(PER_CRATE + ("seg_valid",), per_crate + (seg_valid,))), stages)
    if vel.device.type == "cpu":
        return _crates_plain(per_crate, seg_valid, stages)
    raise ValueError(f"velocity_update: tensors on {vel.device}; expected cpu or cuda")


def _fold(x, dim, n):
    """A per-crate operand under vmap as (n * B, ...): the vmapped dim moved
    to the front (an unbatched operand expanded to the n vmapped crates),
    merged with the operator's own crate axis B.  Strides are kept where
    the merge allows (the kernel reads through them)."""
    if x is None:
        return None
    x = x.unsqueeze(0).expand((n,) + x.shape) if dim is None else x.movedim(dim, 0)
    return x.reshape((-1,) + tuple(x.shape[2:]))


def _vmap_rule(info, in_dims, *args):
    n_per = len(PER_CRATE)
    if in_dims[n_per] is not None:
        raise ValueError("velocity_update: the scene's seg_valid is shared by the crates and "
                         "cannot be vmapped")
    n = info.batch_size
    folded = [_fold(x, d, n) for x, d in zip(args[:n_per], in_dims[:n_per])]
    out = _op(*folded, *args[n_per:])
    return tuple(o.reshape((n, o.shape[0] // n) + tuple(o.shape[1:])) for o in out), (0,) * 7


_op.register_vmap(_vmap_rule)


# --------------------------------------------------------------------------
# the wrappers the tick calls
# --------------------------------------------------------------------------


def _kick_out(stages: int, out) -> KickOut:
    vel, pos, pressure, norms, max_speed, non_finite, cnt = out
    norms = norms if stages & NORMS else None
    if not stages & INTEGRATE:
        return KickOut(vel, None, None, norms, None, None, None)
    return KickOut(vel, pos, pressure, norms, max_speed[0], non_finite[0], cnt[0])


def update_plain(stages: int, *operands) -> KickOut:
    """:func:`update` through the plain version, on any device."""
    return _kick_out(stages, velocity_update_plain(*operands, stages))


def operator_update(stages: int, *operands) -> KickOut:
    """One crate's update through the ``sand_crate::velocity_update``
    operator, as a batch of one (the CUDA branch of :func:`update`; on CPU
    tensors the operator runs the plain version, which the tests use to
    hold its vmap rule)."""
    per_crate = [None if x is None else x.reshape((1,) + tuple(x.shape)) for x in operands[:-1]]
    out = torch.ops.sand_crate.velocity_update(*per_crate, operands[-1], stages)
    return _kick_out(stages, tuple(o[0] for o in out))


def update(stages: int, *operands) -> KickOut:
    """One crate's update over ``stages`` from the operands in
    ``PER_CRATE`` order and the scene's seg_valid (None where ``stages``
    reads none).  CPU tensors run the plain version; CUDA tensors launch
    ``kick_kernel`` of ``csrc/kick.cu`` on the current stream through the
    ``sand_crate::velocity_update`` operator (counted in ``LAUNCHES`` by
    :func:`launch_kind`; under vmap once for all crates);
    tensors elsewhere raise."""
    kind = operands[0].device.type
    if kind == "cpu":
        return update_plain(stages, *operands)
    if kind == "cuda":
        return operator_update(stages, *operands)
    raise ValueError(f"velocity_update: tensors on {operands[0].device}; expected cpu or cuda")


def operands(vel, pos, alive, sums, ghost, segments, params, seg_valid) -> tuple:
    """:func:`update`'s operands from the tick's: ``sums`` a
    ``cellwise.PairSums``, ``ghost`` a ``physics.GhostInfo`` (its sums),
    ``params`` the crate's ``state.Params``."""
    return (vel, pos, alive, sums.p_i, sums.dv_tension, sums.pressure_real, sums.spring_real,
            sums.visc_vsum, sums.nbr_cnt, ghost.g_cnt, ghost.gsum, ghost.gvel_sum, segments,
            params.dt, params.gravity, params.pressure_amplifier, params.spring_amplifier,
            params.spring_overlap_balance, params.viscosity, params.wall_collision_decay,
            params.particle_radius, seg_valid)


def velocity_update(stages: int, vel, pos, alive, sums, ghost, segments, params,
                    seg_valid) -> KickOut:
    """The tick's velocity update over ``stages`` (see :func:`fused`) from
    the tick's operands (:func:`operands`); :func:`update`'s dispatch."""
    return update(stages, *operands(vel, pos, alive, sums, ghost, segments, params, seg_valid))


def single_stage(stage: int, params, seg_valid=None, run=None, **named):
    """One stage of the update alone, with its norm row -> (vel, the mean
    |dv| over the alive slots): the sum of the row over max(alive count, 1),
    as :func:`force_dv` takes it.  The operands the stage reads
    (:func:`_needs`) come from ``named`` (``PER_CRATE`` names: vel, alive,
    pos, the pair and ghost sums, segments), ``params`` (an object with the
    coefficients as attributes, a ``state.Params``) and ``seg_valid``; every
    other one is None.  ``run`` is :func:`update` unless given
    (:func:`update_plain` for a comparison)."""
    need = _needs(stage)
    have = {**named, **{k: getattr(params, k) for k in _COEF_FIELDS if k in need}}
    operands = tuple(have[k] if k in need else None for k in PER_CRATE)
    out = (run or update)(stage | NORMS, *operands, seg_valid if "seg_valid" in need else None)
    cnt = torch.clamp(named["alive"].sum(dtype=torch.int32).to(out.vel.dtype), min=1.0)
    return out.vel, force_dv(out.norms, cnt)[0]


def _ccd_operands(pos, vel, alive, segments, particle_radius, dt, seg_valid):
    return (vel, pos, alive, *(None,) * 9, segments, dt, *(None,) * 6, particle_radius,
            seg_valid)


def continuous_collision(pos, vel, alive, segments, particle_radius, dt, seg_valid):
    """The continuous-collision clamp of one crate -> the new velocity, as
    :func:`continuous_collision_plain`: the update's CCD stage alone."""
    return update(CCD, *_ccd_operands(pos, vel, alive, segments, particle_radius, dt,
                                      seg_valid)).vel


def ccd_operator(pos, vel, alive, segments, particle_radius, dt, seg_valid):
    """:func:`continuous_collision` through the operator (its CUDA branch)."""
    return operator_update(CCD, *_ccd_operands(pos, vel, alive, segments, particle_radius, dt,
                                               seg_valid)).vel
