"""Vectorized 2D geometry on tensors (the counterpart of
``sand_crate_tpu/geometry.py``).

Functional equivalents of the reference's geometry_utils.py — 90-degree
rotation (:176-179), the 2D cross product (:136-138), segment inflation
(:146-172), point/segment distance (:7-39) and the crossing tests with the
CCD parameter (:141-143, :182-222) — with division guards, safe on padded
(masked) inputs.  ``points_to_segments``, ``segment_crossings`` and
``crossing_parameter`` take (x, y) on the last axis, as the JAX package's;
the step uses the ``_soa`` forms: (S, P) planes with the segment axis first
and x/y as separate tensors.
"""

from __future__ import annotations

import torch

EPS = 1e-12


def rot90_cw(v: torch.Tensor) -> torch.Tensor:
    """(x, y) -> (y, -x) on the last axis (geometry_utils.py:176-179)."""
    return torch.stack([v[..., 1], -v[..., 0]], dim=-1)


def cross2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """2D scalar cross product on the last axis (geometry_utils.py:136-138)."""
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def points_to_segments(
    points: torch.Tensor, segments: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest point on each segment and its distance, for every particle
    (geometry_utils.py:7-39: the clamped projection, guarded for
    zero-length segments).

    Args:   points: (P, 2);  segments: (S, 2, 2)
    Returns (nearest (P, S, 2), distance (P, S)).
    """
    a = segments[:, 0, :]  # (S, 2)
    ab = segments[:, 1, :] - a
    ap = points[:, None, :] - a[None]  # (P, S, 2)
    denom = torch.clamp((ab * ab).sum(dim=-1), min=EPS)  # (S,)
    t = torch.clamp((ap * ab[None]).sum(dim=-1) / denom[None], 0.0, 1.0)  # (P, S)
    nearest = a[None] + ab[None] * t[..., None]
    d = nearest - points[:, None, :]
    dist = torch.sqrt(torch.clamp((d * d).sum(dim=-1), min=0.0))
    return nearest, dist


def sign(x: torch.Tensor) -> torch.Tensor:
    """The sign of ``x`` as numpy and jnp.sign give it: NaN stays NaN
    (torch.sign gives 0 there), so a NaN orientation never equals another
    and the crossing tests below count it as the reference does."""
    return torch.where(torch.isnan(x), x, torch.sign(x))


def _orient(p: torch.Tensor, q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Orientation sign of the triple (p, q, r), broadcast over points on
    the last axis: sign((q - p) x (r - q)) (geometry_utils.py:212-222)."""
    return sign(cross2(q - p, r - q))


def segment_crossings(move: torch.Tensor, walls: torch.Tensor) -> torch.Tensor:
    """(P,) movement segments against (W,) wall segments -> (P, W) crossing
    map, counting a crossing only when the movement opposes the wall's
    clockwise normal (the approach-side filter, geometry_utils.py:182-209).

    Args:   move: (P, 2, 2), [start, end] per particle;  walls: (W, 2, 2)
    """
    a = move[:, None, 0, :]  # (P, 1, 2)
    b = move[:, None, 1, :]
    c = walls[None, :, 0, :]  # (1, W, 2)
    d = walls[None, :, 1, :]
    approaching = (rot90_cw(d - c) * (b - a)).sum(dim=-1) < 0.0
    straddle1 = _orient(a, b, c) != _orient(a, b, d)
    straddle2 = _orient(c, d, a) != _orient(c, d, b)
    return approaching & straddle1 & straddle2


def crossing_parameter(
    start: torch.Tensor, delta: torch.Tensor, wall_a: torch.Tensor, wall_ab: torch.Tensor
) -> torch.Tensor:
    """Parameter t along ``delta`` where the path crosses the wall line,
    t = cross(start - wall_a, wall_ab) / cross(wall_ab, delta)
    (geometry_utils.py:141-143), guarded against a parallel path (zero
    denominator); broadcasts over leading dims."""
    num = cross2(start - wall_a, wall_ab)
    den = cross2(wall_ab, delta)
    safe = torch.where(den.abs() > EPS, den, torch.where(den >= 0, EPS, -EPS))
    return num / safe


def safe_normalize(v: torch.Tensor, dim: int = -1) -> tuple[torch.Tensor, torch.Tensor]:
    """Return (unit vector, norm) with a zero-safe division."""
    n = torch.sqrt(torch.clamp((v * v).sum(dim=dim, keepdim=True), min=0.0))
    unit = v / torch.clamp(n, min=EPS)
    return unit, n.squeeze(dim)


def pad_segments(segments: torch.Tensor, pad: torch.Tensor) -> torch.Tensor:
    """Inflate each segment into two parallel offset segments (2S, 2, 2).

    First S rows are offset along the clockwise normal keeping a->b order;
    last S rows are the reversed far side, matching geometry_utils.py:146-172
    so each padded copy only blocks approaches from its own side.
    """
    a = segments[:, 0, :]
    b = segments[:, 1, :]
    n = rot90_cw(b - a)
    norm = torch.sqrt(torch.clamp((n * n).sum(dim=-1, keepdim=True), min=EPS))
    offset = n * pad / norm
    near = torch.stack([a + offset, b + offset], dim=1)
    far = torch.stack([b - offset, a - offset], dim=1)
    return torch.cat([near, far], dim=0)


def points_to_segments_soa(
    px: torch.Tensor, py: torch.Tensor, segments: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Nearest point on each segment and its distance, for every particle.

    Args:   px, py: (P,);  segments: (S, 2, 2)
    Returns (nearest_x, nearest_y, dist), each (S, P).
    """
    ax = segments[:, 0, 0][:, None]  # (S, 1)
    ay = segments[:, 0, 1][:, None]
    abx = (segments[:, 1, 0] - segments[:, 0, 0])[:, None]
    aby = (segments[:, 1, 1] - segments[:, 0, 1])[:, None]
    denom = torch.clamp(abx * abx + aby * aby, min=EPS)
    t = torch.clamp(((px[None] - ax) * abx + (py[None] - ay) * aby) / denom, 0.0, 1.0)
    nx = ax + abx * t  # (S, P)
    ny = ay + aby * t
    dx = nx - px[None]
    dy = ny - py[None]
    dist = torch.sqrt(torch.clamp(dx * dx + dy * dy, min=0.0))
    return nx, ny, dist


def segment_crossings_soa(
    px: torch.Tensor,
    py: torch.Tensor,
    mvx: torch.Tensor,
    mvy: torch.Tensor,
    walls: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Movement segments [p, p + mv] against wall segments, with the
    approach-side filter (geometry_utils.py:182-209) and the crossing
    parameter t = cross(start - wall_a, wall_ab) / cross(wall_ab, delta).

    Args:   px, py, mvx, mvy: (P,);  walls: (W, 2, 2)
    Returns (crossing (W, P) bool, t_hit (W, P)).
    """
    cx = walls[:, 0, 0][:, None]  # (W, 1)
    cy = walls[:, 0, 1][:, None]
    wx = (walls[:, 1, 0] - walls[:, 0, 0])[:, None]  # wall direction d - c
    wy = (walls[:, 1, 1] - walls[:, 0, 1])[:, None]
    ax_, ay_ = px[None], py[None]  # (1, P) move start
    bx_, by_ = px[None] + mvx[None], py[None] + mvy[None]  # move end

    # rot90_cw(d - c) . (b - a) < 0  (approach-side filter)
    approaching = (wy * mvx[None] - wx * mvy[None]) < 0.0
    # orient(a, b, c) vs orient(a, b, d): sign((b-a) x (c-b)) etc.
    abx_, aby_ = mvx[None], mvy[None]
    o1 = sign(abx_ * (cy - by_) - aby_ * (cx - bx_))
    o2 = sign(abx_ * (cy + wy - by_) - aby_ * (cx + wx - bx_))
    o3 = sign(wx * (ay_ - cy - wy) - wy * (ax_ - cx - wx))
    o4 = sign(wx * (by_ - cy - wy) - wy * (bx_ - cx - wx))
    crossing = approaching & (o1 != o2) & (o3 != o4)

    num = (ax_ - cx) * wy - (ay_ - cy) * wx  # cross(start - wall_a, wall_ab)
    den = wx * mvy[None] - wy * mvx[None]  # cross(wall_ab, delta)
    sign_eps = torch.where(den >= 0, EPS, -EPS)
    safe = torch.where(den.abs() > EPS, den, sign_eps)
    return crossing, num / safe
