"""The comparison that decides ``correct``.

A checked tick is a snapshot of the program's state before one tick of the
timed path and after it.  The reference (``reference/step.py``) advances
the snapshot before the tick in float64; the program's state after the
tick is put back into the snapshot's slot order by particle identity
(``uid``: the large-crate backend keeps its state cell-sorted), and each
number below compares the two over the particles the reference does not
flag as decided within rounding:

* ``vel_gap``: the largest |v_program - v_reference|, each over the
  largest of the particle's own velocity change in the tick, the gross
  size of its pair kicks (their terms' magnitudes summed, before they
  cancel: float32 rounds each term) and the median change (at least
  dt |g|);
* ``pos_gap``: the largest position gap, each over the particle's own
  move in the tick or dt times that velocity scale, whichever is larger;
* ``pressure_gap``: the largest pressure gap over the mean pressure;
* ``alive_gap``: slots alive on one side only (exact: limit 0);
* ``body_gap``: the largest gap of a segment end over the diameter;
* ``flagged_share``: the share of alive particles the reference flags
  (reported, not compared: it is the reference's reading of the state);
* ``start_gap``: the state before the first tick against the initial
  blocks and the placed segments that the reference builds from the
  configuration and the seed;
* ``frame_gap`` (where frames are recorded): the largest gap of a recorded
  frame against the state after its tick (exact: limit 0).

A number that is not finite reads as infinite, so it fails its limit.
"""

from __future__ import annotations

import math

import torch

from .reference import step as ref

FRAME_FIELDS = ("pos", "alive", "pressure", "segments")
STATE_FIELDS = ("pos", "vel", "alive", "pressure", "uid", "segments", "body_lin_vel",
                "body_ang_vel", "time", "tick")


def snapshot(state, batched: bool) -> dict:
    """A copy of a program state (a CrateState), with a leading crate axis."""
    out = {}
    for k in STATE_FIELDS:
        v = getattr(state, k).detach().clone()
        out[k] = v if batched else v[None]
    return out


def to_host(snap: dict) -> dict:
    return {k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in snap.items()}


def _finite_max(x: torch.Tensor) -> float:
    if x.numel() == 0:
        return 0.0
    v = float(x.double().max())
    return v if math.isfinite(v) else math.inf


def by_input_slot(before: dict, after: dict) -> dict:
    """``after``'s per-particle fields in ``before``'s slot order, by uid.
    A uid that ``after`` lost maps nowhere and reads as NaN."""
    B, P = before["uid"].shape
    dev = before["uid"].device
    out = {}
    where = torch.full((B, P), -1, dtype=torch.long, device=dev)
    au = after["uid"].long()
    ok_uid = (au >= 0) & (au < P)
    rows = torch.arange(B, device=dev)[:, None].expand(B, P)
    slots = torch.arange(P, device=dev)[None].expand(B, P)
    where[rows[ok_uid], au[ok_uid]] = slots[ok_uid]
    src = where.gather(1, before["uid"].long().clamp(0, P - 1))
    lost = src < 0
    src = src.clamp(min=0)
    for k in ("pos", "vel", "pressure", "alive"):
        v = after[k]
        idx = src.view(B, P, *([1] * (v.dim() - 2))).expand(B, P, *v.shape[2:])
        g = v.gather(1, idx)
        if k == "alive":
            g = g & ~lost
        else:
            g = g.double().masked_fill(lost.view(B, P, *([1] * (v.dim() - 2))), math.nan)
        out[k] = g
    out["out_slot"] = src
    for k in ("segments", "body_lin_vel", "body_ang_vel"):
        out[k] = after[k]
    return out


def jitter_for(kind: str, before: dict, after: dict, generator_state=None) -> ref.Jitter:
    if kind == "slot_hash":
        return ref.Jitter("slot_hash", out_slot=by_input_slot(before, after)["out_slot"])
    return ref.Jitter("generator", generator_state=generator_state)


def numbers(got: dict, want: dict, before: dict, coef: dict) -> dict:
    """The compared numbers of one checked tick: ``got`` (by input slot)
    against the reference's ``want``."""
    flags = want["flags"]
    alive = want["alive"]
    checked = alive & ~flags
    dt = coef["dt"].double().to(alive.device)[:, None]
    g = coef["gravity"].double().to(alive.device)
    dv = (want["vel"] - before["vel"].double()).norm(dim=-1)
    dx = (want["pos"] - before["pos"].double()).norm(dim=-1)
    floor = float((dt[:, 0] * g.norm(dim=-1)).min())
    scale_v = max(float(dv[alive].median()) if alive.any() else 0.0, floor)
    own = torch.maximum(dv, want["gross_dv"]).clamp(min=scale_v)
    vgap = (got["vel"].double() - want["vel"]).norm(dim=-1) / own
    xgap = (got["pos"].double() - want["pos"]).norm(dim=-1) / torch.maximum(dx, dt * own)
    p_scale = max(float(want["pressure"][alive].abs().mean()) if alive.any() else 0.0, 1e-3)
    pgap = (got["pressure"].double() - want["pressure"]).abs() / p_scale
    S = want["segments"].shape[1]
    diam = 2.0 * coef["particle_radius"].double().to(alive.device)[:, None, None, None]
    bgap = (got["segments"][:, :S].double() - want["segments"]).abs() / diam
    n_alive = max(int(alive.sum()), 1)
    return {
        "vel_gap": _finite_max(vgap[checked]),
        "pos_gap": _finite_max(xgap[checked]),
        "pressure_gap": _finite_max(pgap[checked]),
        "alive_gap": float(((got["alive"] != alive) & ~flags).sum()),
        "body_gap": _finite_max(bgap),
        "flagged_share": float((flags & alive).sum()) / n_alive,
    }


def start_gap(start: dict, pos0, segments0, coef: dict) -> float:
    """The program's state before its first tick against the configuration's
    initial blocks ``pos0`` (N, 2), in each crate's first N slots, and its
    placed segments ``segments0`` (S, 2, 2): the largest gap of a position
    or a segment end over the diameter, plus one for each slot alive on
    one side only."""
    n0, S = pos0.shape[0], segments0.shape[0]
    alive = start["alive"]
    gap = float(alive[:, :n0].logical_not().sum() + alive[:, n0:].sum())
    d = (start["segments"][:, :S].double() - torch.as_tensor(segments0).double()[None]).abs()
    if n0:
        d = torch.cat([d.reshape(-1), (start["pos"][:, :n0].double()
                                       - torch.as_tensor(pos0).double()[None]).abs().reshape(-1)])
    return gap + _finite_max(d) / float(2.0 * coef["particle_radius"].double().min())


def frame_gap(frame: dict, state: dict) -> float:
    """Largest difference between a recorded frame and the state after its
    tick, over the fields a frame carries (0 when the copy is faithful)."""
    gap = 0.0
    for k in FRAME_FIELDS:
        a = torch.as_tensor(frame[k]).double().reshape(-1)
        b = state[k][0].cpu().double().reshape(-1)
        if a.shape != b.shape:
            return math.inf
        gap = max(gap, _finite_max((a - b).abs()) if a.numel() else 0.0)
    return gap


def worst(readings: list[dict]) -> dict:
    """Each number's largest reading over the checked ticks of a run."""
    out = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, -math.inf), v)
    return out


def judge(readings: dict, limits: dict) -> bool:
    """Every number read is within its limit (a number not read, such as
    ``frame_gap`` of a cell that records no frames, is not judged)."""
    return all(v <= limits[k] for k, v in readings.items() if k in limits)
