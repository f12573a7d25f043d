"""The port's playback layer (``playback.py``) on the CPU: the twins of
tests/test_playback.py's ten tests.

The headless loop, recording (with cv2 and PIL installed: the AVI, the
GIF, the trajectory and the checkpoint are written), live coefficient
edits, reset, zoom and pan, the windowed pygame path under SDL's dummy video
output, the screenshot hook, and checkpoint resume.  The crate is asked
for the CPU through ``crate_kwargs``.  The stirring cup is shrunk to 48
particles and an 80 x 80 screen.
"""

import copy
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from sand_crate_tpu_torch import load_config
from sand_crate_tpu_torch.engine import Crate
from sand_crate_tpu_torch.playback import Playback, replay

torch.set_num_threads(1)
os.environ.setdefault("SDL_VIDEODRIVER", "dummy")

REPO = Path(__file__).resolve().parent.parent
CPU = {"device": "cpu"}


@pytest.fixture()
def small_config():
    config = load_config(REPO / "configs" / "stirring_cup.yaml")
    config.world_config.coefficients["max_particles"] = 48
    config.playback_config.ticks_to_record = 6
    config.playback_config.screen_x = 80
    config.playback_config.screen_y = 80
    return copy.deepcopy(config)


def test_headless_run_records(tmp_path, small_config):
    pb = Playback(small_config, recording_dir_path=tmp_path / "rec", headless=True,
                  crate_kwargs=CPU)
    pb.run_live_simulation()
    for name in ("video.avi", "video.gif", "checkpoint.npz", "trajectory/index.json",
                 "trajectory/config.yaml"):
        assert (tmp_path / "rec" / name).exists(), name
    assert pb.crate.tick == 6

    frames = replay(tmp_path / "rec", headless=True, size=(64, 64))
    assert len(frames) == 6
    assert frames[0].shape == (64, 64, 3)


def test_headless_run_no_recording(small_config):
    small_config.playback_config.save_recording = False
    pb = Playback(small_config, headless=True, crate_kwargs=CPU)
    pb.run_live_simulation(max_ticks=3)
    assert pb.crate.tick == 3


def test_edit_physics_changes_coefficient(small_config):
    small_config.playback_config.save_recording = False
    pb = Playback(small_config, headless=True, crate_kwargs=CPU)
    names = pb.crate.editable_coefficients()
    name = names[pb.current_physical_field_index % len(names)]
    before = float(np.asarray(getattr(pb.crate, name)))
    pb.edit_physics(increase=True)
    after = float(np.asarray(getattr(pb.crate, name)))
    assert after == pytest.approx(before * 1.1)
    pb.edit_physics(increase=False)
    assert float(np.asarray(getattr(pb.crate, name))) == pytest.approx(after * 0.9)


def test_reset_rebuilds_crate(small_config):
    small_config.playback_config.save_recording = False
    pb = Playback(small_config, headless=True, crate_kwargs=CPU)
    pb.run_live_simulation(max_ticks=2)
    assert pb.crate.tick == 2
    pb.reset()
    assert pb.crate.tick == 0 and pb.crate.state.pos.device.type == "cpu"


def test_zoom_and_pan_math(small_config):
    pb = Playback(small_config, headless=True, crate_kwargs=CPU)
    x0 = pb.crate_to_screen_coord(0.5, 0.5)
    pb.translate(np.array([10.0, 0.0]))
    x1 = pb.crate_to_screen_coord(0.5, 0.5)
    assert x1[0] != x0[0] and x1[1] == x0[1]


def _windowed_playback(small_config, **kwargs):
    """A Playback with a real (dummy-SDL) pygame display initialized."""
    small_config.playback_config.save_recording = False
    pb = Playback(small_config, headless=False, crate_kwargs=CPU, **kwargs)
    pb.init_display()
    return pb


def test_paused_zoom_redraws(small_config):
    """Zoom/pan events re-render immediately — the paused-simulation case
    (reference playback.py:142-148 draws inside handle_input)."""
    import pygame

    pb = _windowed_playback(small_config)
    try:
        pb.crate.physics_tick()
        pb.draw_scene()
        before = pb.last_frame.copy()
        pb.pause = True  # no tick will redraw; handle_input must
        pygame.event.post(pygame.event.Event(pygame.MOUSEWHEEL, x=0, y=1))
        pb.handle_input()
        assert pb.zoom_factor > 1.0
        assert pb.last_frame is not before  # a fresh frame was rendered
        assert not np.array_equal(pb.last_frame, before)  # zoom moved pixels
    finally:
        pygame.quit()


def test_show_indices_renders_labels(small_config):
    """Index labels add pixels the unlabeled scene doesn't have
    (reference playback.py:187-189,204-206)."""
    import pygame

    pb = _windowed_playback(small_config)
    try:
        pb.crate.physics_tick()
        plain = pb.draw_scene().copy()
        pb.show_indices = True
        labeled = pb.draw_scene().copy()
        assert not np.array_equal(labeled, plain)
    finally:
        pygame.quit()


def test_windowed_screenshot_hook(tmp_path, small_config, monkeypatch):
    """SAND_CRATE_SCREENSHOT saves the live display surface on exit — the
    no-display verification hook for the windowed loop."""
    shot = tmp_path / "shot.png"
    monkeypatch.setenv("SAND_CRATE_SCREENSHOT", str(shot))
    small_config.playback_config.save_recording = False
    pb = Playback(small_config, headless=False, crate_kwargs=CPU)
    pb.run_live_simulation(max_ticks=2)
    assert shot.exists() and shot.stat().st_size > 0
    assert pb.crate.tick == 2


def test_checkpoint_resume_round_trip(tmp_path, small_config):
    pb = Playback(small_config, recording_dir_path=tmp_path / "r", headless=True,
                  crate_kwargs=CPU)
    pb.run_live_simulation()  # writes checkpoint.npz at the end
    ckpt = tmp_path / "r" / "checkpoint.npz"
    assert ckpt.exists()

    fresh = Crate(small_config.world_config, device="cpu")
    assert fresh.tick == 0
    fresh.restore_checkpoint(ckpt)
    assert fresh.tick == pb.crate.tick
    np.testing.assert_array_equal(fresh.particles, pb.crate.particles)

    # The resumed crate continues exactly as the original does.
    fresh.physics_tick()
    pb.crate.physics_tick()
    np.testing.assert_allclose(fresh.particles, pb.crate.particles, rtol=1e-6, atol=1e-7)


def test_restore_checkpoint_capacity_mismatch(tmp_path, small_config):
    crate = Crate(small_config.world_config, device="cpu")
    crate.save_checkpoint(tmp_path / "c.npz")
    other = Crate(small_config.world_config, capacity=crate.scene.capacity * 2, device="cpu")
    with pytest.raises(ValueError, match="capacity"):
        other.restore_checkpoint(tmp_path / "c.npz")
