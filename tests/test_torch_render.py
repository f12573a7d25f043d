"""The port's frame rasterizer (``render.py``, ``native/``).

The C rasterizer, built from the port's own ``native/rasterize.c``, is held
pixel for pixel against the port's numpy rasterizer, and that against the
JAX package's ``_render_numpy_reference`` on the same numpy inputs: points
inside and outside the frame, pressures outside [0, 1], dead particles,
radii of 0, 1 and 5 pixels, long, short and degenerate segments.  The
library builds into the port's ``_build/`` from a copy of the port alone,
and a second call reuses it.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from sand_crate_tpu.render import _render_numpy_reference as jax_render_numpy
from sand_crate_tpu_torch import native, render

REPO = Path(__file__).resolve().parent.parent


def _scene(seed, n=3000):
    rng = np.random.default_rng(seed)
    pos = (rng.random((n, 2)) * 1.1 - 0.05).astype(np.float32)
    pressure = (rng.random(n) * 1.4 - 0.2).astype(np.float32)
    alive = rng.random(n) < 0.8
    segments = np.array([[[0.0, 0.0], [1.0, 1.0]], [[0.1, 0.9], [0.9, 0.9]],
                         [[0.3, 0.3], [0.3, 0.3]], [[-0.2, 0.5], [1.2, 0.52]],
                         [[0.5, 0.0], [0.5, 1.0]]], np.float32)
    return pos, pressure, alive, segments


@pytest.mark.parametrize("radius", [0.0, 0.01, 0.05])
@pytest.mark.parametrize("size", [(200, 200), (160, 120)])
def test_c_rasterizer_equals_numpy(radius, size):
    assert render.rasterize_lib() is not None, native.BUILD_ERROR
    pos, pressure, alive, segments = _scene(int(radius * 100) + size[1])
    w, h = size
    got = render.render_frame(pos, pressure, segments, size=size, particle_radius=radius,
                              alive=alive)
    assert got.shape == (h, w, 3) and got.dtype == np.uint8
    want = render._render_numpy_reference(pos, pressure, segments, w, h, radius, alive)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        want, jax_render_numpy(pos, pressure, segments, w, h, radius, alive))
    assert (got == 255).all(axis=-1).any() and (got[..., 2] == 255).mean() > 0.05
    # No alive mask: every particle is drawn.
    np.testing.assert_array_equal(
        render.render_frame(pos, pressure, segments, size=size, particle_radius=radius),
        render._render_numpy_reference(pos, pressure, segments, w, h, radius, None))


def test_empty_frame_and_bad_shapes():
    empty = render.render_frame(np.zeros((0, 2), np.float32), np.zeros(0, np.float32),
                                np.zeros((0, 2, 2), np.float32), size=(32, 24))
    assert empty.shape == (24, 32, 3) and not empty.any()
    with pytest.raises(ValueError, match="particles"):
        render.render_frame(np.zeros((4, 2), np.float32), np.zeros(3, np.float32),
                            np.zeros((0, 2, 2), np.float32), size=(32, 24))


def test_native_builds_into_the_port_alone(tmp_path):
    """A copy of the port package alone (no sand_crate_tpu/ beside it)
    builds rasterize.c into its own _build/ and writes nothing else (no
    sand_crate_tpu/ appears), and a second call reuses the library: the
    same path, not rewritten, the same loaded handle."""
    pkg = tmp_path / "sand_crate_tpu_torch"
    shutil.copytree(REPO / "sand_crate_tpu_torch", pkg,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    before = {p for p in tmp_path.rglob("*")}
    code = (
        "import os, sand_crate_tpu_torch.native as n\n"
        "so = n.build()\n"
        "stamp = os.stat(so).st_mtime_ns\n"
        "lib = n.rasterize_lib()\n"
        "assert n.build() == so and os.stat(so).st_mtime_ns == stamp\n"
        "assert n.rasterize_lib() is lib is not None\n"
        "print(so)\n"
    )
    env = dict(os.environ, PYTHONDONTWRITEBYTECODE="1")
    env.pop("PYTHONPATH", None)  # import the copy, not the repository's package
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    so = Path(res.stdout.strip())
    assert so.parent == pkg / "_build" and so.name.startswith("librasterize-")
    added = {p for p in tmp_path.rglob("*")} - before
    assert added == {pkg / "_build", so}, added
    assert not (tmp_path / "sand_crate_tpu").exists()
