"""Vectorized 2D geometry on tensors (the step's subset of
``sand_crate_tpu/geometry.py``).

Functional equivalents of the reference's geometry_utils.py — 90-degree
rotation (:176-179), segment inflation (:146-172), point/segment distance
(:7-39) and the crossing tests with the CCD parameter (:141-143, :182-222) —
with division guards, safe on padded (masked) inputs.  The point/segment
functions use the SoA layout of the JAX package: (S, P) planes with the
segment axis first and x/y as separate tensors.
"""

from __future__ import annotations

import torch

EPS = 1e-12


def rot90_cw(v: torch.Tensor) -> torch.Tensor:
    """(x, y) -> (y, -x) on the last axis (geometry_utils.py:176-179)."""
    return torch.stack([v[..., 1], -v[..., 0]], dim=-1)


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
    o1 = torch.sign(abx_ * (cy - by_) - aby_ * (cx - bx_))
    o2 = torch.sign(abx_ * (cy + wy - by_) - aby_ * (cx + wx - bx_))
    o3 = torch.sign(wx * (ay_ - cy - wy) - wy * (ax_ - cx - wx))
    o4 = torch.sign(wx * (by_ - cy - wy) - wy * (bx_ - cx - wx))
    crossing = approaching & (o1 != o2) & (o3 != o4)

    num = (ax_ - cx) * wy - (ay_ - cy) * wx  # cross(start - wall_a, wall_ab)
    den = wx * mvy[None] - wy * mvx[None]  # cross(wall_ab, delta)
    sign_eps = torch.where(den >= 0, EPS, -EPS)
    safe = torch.where(den.abs() > EPS, den, sign_eps)
    return crossing, num / safe
