"""Pygame polygon helpers for the debug overlay (the counterpart of
``sand_crate_tpu/utils/pygame_draw.py``).

The reference's arrow (its crate/utils/pygame_utils.py:4-58): a rotated
triangle head plus a body polygon, drawn for per-particle debug vectors
(reference playback.py:95-107).  pygame is imported inside the function.
"""

from __future__ import annotations

import math


def draw_arrow(
    screen,
    color,
    start,
    end,
    body_width: int = 2,
    head_width: int = 4,
    head_height: int = 2,
) -> None:
    """Draw an arrow from start to end (screen px) on a pygame surface."""
    import pygame

    sx, sy = float(start[0]), float(start[1])
    ex, ey = float(end[0]), float(end[1])
    dx, dy = ex - sx, ey - sy
    length = math.hypot(dx, dy)
    if length < 1e-6:
        return
    ux, uy = dx / length, dy / length  # unit along the arrow
    px, py = -uy, ux  # unit perpendicular
    head_height = min(head_height, length)
    bx, by = ex - ux * head_height, ey - uy * head_height  # head base

    head = [
        (ex, ey),
        (bx + px * head_width / 2, by + py * head_width / 2),
        (bx - px * head_width / 2, by - py * head_width / 2),
    ]
    body = [
        (sx + px * body_width / 2, sy + py * body_width / 2),
        (bx + px * body_width / 2, by + py * body_width / 2),
        (bx - px * body_width / 2, by - py * body_width / 2),
        (sx - px * body_width / 2, sy - py * body_width / 2),
    ]
    pygame.draw.polygon(screen, color, body)
    pygame.draw.polygon(screen, color, head)
