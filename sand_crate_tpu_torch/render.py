"""Headless rasterizer for recording frames without a display (the
counterpart of ``sand_crate_tpu/render.py``).

The reference renders with pygame circles and lines (playback.py:178-206)
and captures the surface per frame.  This renders the same picture,
pressure-tinted particles on black and white segments, from numpy arrays:
through the C rasterizer of ``native/`` when it builds, else through the
vectorized numpy rasterizer, which is also the C one's pixel oracle.
:func:`rasterize_lib` says whether the C library loaded.  Colors follow
playback.py:199 ((255 - p*255, 255 - p*255, 255)).
"""

from __future__ import annotations

import numpy as np

from .native import rasterize_lib

__all__ = ["render_frame", "rasterize_lib"]

BACKGROUND = np.zeros(3, np.uint8)
SEGMENT_COLOR = np.array([255, 255, 255], np.uint8)


def _disk_offsets(radius_px: int) -> np.ndarray:
    r = max(radius_px, 0)
    span = np.arange(-r, r + 1)
    ox, oy = np.meshgrid(span, span, indexing="ij")
    mask = ox**2 + oy**2 <= max(r, 1) ** 2 if r > 0 else (ox == 0) & (oy == 0)
    return np.stack([ox[mask], oy[mask]], -1)


def render_frame(
    pos: np.ndarray,
    pressure: np.ndarray,
    segments: np.ndarray,
    *,
    size: tuple[int, int] = (1000, 1000),
    particle_radius: float = 0.005,
    alive: np.ndarray | None = None,
) -> np.ndarray:
    """Render one frame to (H, W, 3) uint8.

    pos: (P, 2) in crate coords [0,1]^2 (x right, y down like the reference's
    screen mapping, playback.py:208-213); pressure: (P,); segments (S,2,2).
    """
    w, h = size
    native = _render_native(pos, pressure, segments, w, h, particle_radius, alive)
    if native is not None:
        return native
    return _render_numpy_reference(
        pos, pressure, segments, w, h, particle_radius, alive
    )


def _render_native(pos, pressure, segments, w, h, particle_radius, alive):
    """The C rasterizer's frame; None when its library is unavailable."""
    lib = rasterize_lib()
    if lib is None:
        return None
    pos = np.ascontiguousarray(pos, np.float32)
    n = len(pos)
    pressure = np.ascontiguousarray(pressure, np.float32)
    if alive is None:
        alive_u8 = np.ones(n, np.uint8)
    else:
        alive_u8 = np.ascontiguousarray(np.asarray(alive)).astype(np.uint8)
    segments = np.ascontiguousarray(segments, np.float32)
    if pos.shape != (n, 2) or pressure.shape != (n,) or alive_u8.shape != (n,):
        raise ValueError(f"render: pos {pos.shape}, pressure {pressure.shape} and alive "
                         f"{alive_u8.shape} do not describe {n} particles")
    if segments.size % 4:
        raise ValueError(f"render: segments {segments.shape} are not (S, 2, 2)")
    out = np.empty((h, w, 3), np.uint8)
    lib.rasterize(pos.ctypes.data, pressure.ctypes.data, alive_u8.ctypes.data, n,
                  segments.ctypes.data, segments.size // 4, w, h, int(w * particle_radius),
                  out.ctypes.data)
    return out


def _render_numpy_reference(pos, pressure, segments, w, h, particle_radius, alive):
    """Vectorized numpy rasterizer: the pixel oracle of the C one, and the
    renderer where the C library does not build."""
    img = np.zeros((h, w, 3), np.uint8)

    pos = np.asarray(pos)
    pressure = np.asarray(pressure)
    if alive is not None:
        pos = pos[np.asarray(alive)]
        pressure = pressure[np.asarray(alive)]

    if len(pos):
        px = np.clip((pos[:, 0] * (w - 1)).astype(np.int32), 0, w - 1)
        py = np.clip((pos[:, 1] * (h - 1)).astype(np.int32), 0, h - 1)
        tint = np.clip(255 - (np.clip(pressure, 0, 1) * 255), 0, 255).astype(
            np.uint8
        )
        r_px = int(w * particle_radius)
        offsets = _disk_offsets(r_px)
        # splat disks: (P, D) pixel coordinates
        xs = np.clip(px[:, None] + offsets[None, :, 0], 0, w - 1).ravel()
        ys = np.clip(py[:, None] + offsets[None, :, 1], 0, h - 1).ravel()
        t = np.repeat(tint, len(offsets))
        img[ys, xs, 0] = t
        img[ys, xs, 1] = t
        img[ys, xs, 2] = 255

    for seg in np.asarray(segments):
        a, b = seg[0], seg[1]
        n = int(max(abs(b[0] - a[0]) * w, abs(b[1] - a[1]) * h, 1)) + 1
        ts = np.linspace(0.0, 1.0, n)
        xs = np.clip(((a[0] + (b[0] - a[0]) * ts) * (w - 1)).astype(np.int32), 0, w - 1)
        ys = np.clip(((a[1] + (b[1] - a[1]) * ts) * (h - 1)).astype(np.int32), 0, h - 1)
        for d in (-1, 0):  # 2px line width like playback.py:185
            img[np.clip(ys + d, 0, h - 1), xs] = SEGMENT_COLOR
    return img
