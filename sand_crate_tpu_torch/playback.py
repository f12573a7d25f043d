"""Interactive playback: a pygame front end with the reference's UX
contract (the counterpart of ``sand_crate_tpu/playback.py``).

The reference Playback (playback.py:32-245) on the port's ``Crate``: the
same key map (arrows tilt gravity, q quit, r reset, w/s select a
coefficient, a/d edit it +/-10%, space pause, n single-step), zoom anchored
at the cursor (playback.py:231-241), drag to pan, pressure-tinted
particles, white segments and the debug/timing/forces overlay.  State comes
to the host through the Crate's numpy views, and frames stream to disk
(TrajectoryWriter/VideoWriter) instead of accumulating in RAM
(playback.py:49,85).

Headless mode (no window) runs the whole simulation through
``Crate.stream_frames``; the windowed mode also runs under
SDL_VIDEODRIVER=dummy.  The crate is built from ``crate_kwargs`` (its
``device`` among them: the card unless the caller asks for the CPU).
pygame, tqdm, cv2 and PIL are imported only by the functions that use them.
"""

from __future__ import annotations

import datetime
import os
from pathlib import Path
from typing import Optional

import numpy as np

from .config import Config, dump_config
from .engine import Crate
from .recording import TrajectoryWriter, VideoWriter
from .render import render_frame

SCROLL_ZOOM_FACTOR = 0.2
TEXT_MARGIN = 6


class Playback:
    """Owns the window, the crate, and the per-tick loop (playback.py:51-65)."""

    def __init__(
        self,
        config: Config,
        recording_dir_path: Optional[Path] = None,
        headless: bool = False,
        crate_kwargs: Optional[dict] = None,
        show_indices: bool = False,
    ) -> None:
        self.config = config
        pc = config.playback_config
        # Per-particle/segment index labels (reference playback.py:187-206;
        # upstream ships the flag off at :78).
        self.show_indices = show_indices
        self.last_frame: Optional[np.ndarray] = None
        if recording_dir_path is None:
            stamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
            recording_dir_path = pc.recording_output_dir_path / stamp
        self.recording_dir_path = Path(recording_dir_path)
        self._crate_kwargs = crate_kwargs or {}
        self.crate = Crate(config.world_config, **self._crate_kwargs)
        self.headless = headless
        self.done = False
        self.pause = False
        self.step_one = False
        self.screen = None
        self.font = None
        self.current_physical_field_index = 0
        self.zoom_factor = 1.0
        self.zoom_center = np.array([pc.screen_x / 2, pc.screen_y / 2], float)
        self._size = (pc.screen_x, pc.screen_y)

    # ------------------------------------------------------------------ loop

    def run_live_simulation(
        self, max_ticks: Optional[int] = None, ticks_per_frame: int = 1
    ) -> None:
        pc = self.config.playback_config
        num_ticks = max_ticks or pc.ticks_to_record
        save = pc.save_recording
        video = VideoWriter(self.recording_dir_path) if save else None
        traj = TrajectoryWriter(self.recording_dir_path / "trajectory") if save else None
        if self.headless:
            # Headless runs have no input loop, so the whole simulation rides
            # the device-resident scan chunks of Crate.stream_frames: physics
            # never waits on the host, frames arrive double-buffered (the
            # async device->host streaming path; the reference steps+renders
            # synchronously every tick, playback.py:54-60).
            try:
                self._run_headless_chunked(num_ticks, ticks_per_frame, video, traj)
            finally:
                if save:
                    video.close()
                    traj.close(config_yaml=dump_config(self.config))
                    self.crate.save_checkpoint(
                        self.recording_dir_path / "checkpoint.npz"
                    )
            return
        self.init_display()
        try:
            # Progress bar around the tick loop, like the reference
            # (playback.py:13,54 wraps it in tqdm.rich).
            try:
                from tqdm.rich import tqdm as _tqdm
            except Exception:
                from tqdm import tqdm as _tqdm
            for _ in _tqdm(range(num_ticks)):
                self.handle_play_control()
                self.handle_input()
                if self.done:
                    break
                self.crate.physics_tick()
                frame = self.draw_scene()
                if save:
                    video.append(frame)
                    # Fixed-capacity arrays + alive mask: frames must stack
                    # into one (T, P, ...) array per shard even as the live
                    # particle count changes tick to tick.
                    state = self.crate.state
                    traj.append(dict(pos=state.pos, alive=state.alive,
                                     pressure=state.pressure, segments=self.crate.segments))
        finally:
            if save:
                video.close()
                traj.close(config_yaml=dump_config(self.config))
                self.crate.save_checkpoint(self.recording_dir_path / "checkpoint.npz")
            if not self.headless:
                import pygame

                # Windowed-path screenshot hook: lets a caller with no real
                # display (SDL_VIDEODRIVER=offscreen) verify the live window
                # rendered — saves the final *display surface*, not the
                # recorder's numpy frame, so it exercises the same surface a
                # user's window shows (ref playback.py:51-73 is the live UX).
                shot = os.environ.get("SAND_CRATE_SCREENSHOT")
                if shot and getattr(self, "screen", None) is not None:
                    pygame.image.save(self.screen, shot)
                pygame.quit()

    def _run_headless_chunked(self, num_ticks, ticks_per_frame, video, traj):
        import time

        if self.crate.instrument:
            # Per-phase timing is the point — run tick-at-a-time through the
            # phase-split programs and print the reference-style report.
            for tick in range(num_ticks):
                self.crate.physics_tick()
                if (tick + 1) % 25 == 0 or tick + 1 == num_ticks:
                    print(f"tick {tick + 1}/{num_ticks}")
                    print(self.crate.debug_timer.report())
            return

        num_frames = max(1, num_ticks // ticks_per_frame)
        radius = float(self.crate.particle_radius)
        seg_valid = self.crate.scene.seg_valid.cpu().numpy()
        t0 = time.time()
        done = 0
        for frame in self.crate.stream_frames(num_frames, ticks_per_frame):
            done += 1
            if done % 25 == 0 or done == num_frames:
                dt = time.time() - t0
                print(
                    f"frame {done}/{num_frames} "
                    f"({done * ticks_per_frame / dt:.1f} ticks/s)",
                    flush=True,
                )
            if video is None:
                continue
            segments = frame["segments"][seg_valid]
            img = render_frame(
                frame["pos"],
                frame["pressure"],
                segments,
                size=self._size,
                particle_radius=radius,
                alive=frame["alive"],
            )
            video.append(img)
            traj.append(dict(pos=frame["pos"], alive=frame["alive"],
                             pressure=frame["pressure"], segments=segments))

    def handle_play_control(self) -> None:
        """Spin while paused (playback.py:87-93)."""
        import time

        while self.pause and not self.done and not self.headless:
            self.handle_input()
            time.sleep(0.01)
            if self.step_one:
                self.step_one = False
                return

    def reset(self) -> None:
        self.crate = Crate(self.config.world_config, **self._crate_kwargs)

    # ------------------------------------------------------------------ draw

    def init_display(self) -> None:
        import pygame

        pygame.init()
        pygame.font.init()
        pygame.display.set_caption("SandCrate")
        self.screen = pygame.display.set_mode(self._size)
        self.font = pygame.font.SysFont("monospace", self._size[0] // 60)

    def draw_scene(self) -> np.ndarray:
        """Draw and return the RGB frame (streamed to the recorder)."""
        if self.headless:
            return render_frame(
                self.crate.particles,
                self.crate.particles_pressure,
                self.crate.segments,
                size=self._size,
                particle_radius=float(self.crate.particle_radius),
            )
        import pygame

        self.screen.fill((0, 0, 0))
        self._draw_particles()
        self._draw_segments()
        self._draw_debug_arrows()
        self._draw_debug_text(self.crate.debug_prints)
        pygame.display.update()
        raw = pygame.image.tostring(self.screen, "RGB", False)
        frame = np.frombuffer(raw, np.uint8).reshape(
            self._size[1], self._size[0], 3
        )
        self.last_frame = frame
        return frame

    def crate_to_screen_coord(self, x: float, y: float) -> tuple[float, float]:
        """Crate [0,1]^2 -> screen px with zoom/pan (playback.py:208-213)."""
        sx, sy = self._size
        p = np.array([x * (sx - 1), y * (sy - 1)], float)
        center = np.array([sx / 2, sy / 2])
        p = (p - self.zoom_center) * self.zoom_factor + center
        return float(p[0]), float(p[1])

    def _draw_particles(self) -> None:
        import pygame

        radius_px = max(
            1, int(self._size[0] * float(self.crate.particle_radius) * self.zoom_factor)
        )
        particles = self.crate.particles
        pressures = np.clip(self.crate.particles_pressure, 0.0, 1.0)
        for i in range(len(particles)):
            tint = int(255 - pressures[i] * 255)
            color = (tint, tint, 255)
            center = self.crate_to_screen_coord(*particles[i])
            pygame.draw.circle(self.screen, color, center, radius_px)
            if self.show_indices:
                # Yellow per-particle labels (reference playback.py:204-206).
                surf = self.font.render(str(i), True, (255, 255, 0))
                self.screen.blit(surf, (center[0] - 5, center[1] - 8))

    def _draw_segments(self) -> None:
        import pygame

        for i, seg in enumerate(self.crate.segments):
            start = self.crate_to_screen_coord(*seg[0])
            pygame.draw.line(
                self.screen,
                (255, 255, 255),
                start,
                self.crate_to_screen_coord(*seg[1]),
                width=2,
            )
            if self.show_indices:
                # Red per-segment labels (reference playback.py:187-189).
                self.screen.blit(self.font.render(str(i), True, (255, 80, 80)), start)

    def _draw_debug_arrows(self) -> None:
        """Debug vector overlay (reference playback.py:95-107): length is
        compressed with a 0.3 power so long vectors stay on screen; NaNs are
        tolerated (skipped) exactly like upstream."""
        from .utils.pygame_draw import draw_arrow

        for start, direction in self.crate.debug_arrows:
            start = np.asarray(start, float)
            direction = np.asarray(direction, float)
            if np.isnan(start).any() or np.isnan(direction).any():
                continue
            direction = direction / np.power(
                np.linalg.norm(direction) + 0.001, 0.3
            )
            draw_arrow(
                self.screen,
                color=(0, 255, 0),
                start=self.crate_to_screen_coord(*start),
                end=self.crate_to_screen_coord(*(start + direction)),
                head_width=4,
                head_height=2,
            )

    def _draw_debug_text(self, text: str) -> None:
        for line, line_text in enumerate(text.split("\n")):
            surf = self.font.render(line_text, True, (255, 255, 255))
            self.screen.blit(
                surf, (TEXT_MARGIN, TEXT_MARGIN + line * self.font.get_linesize())
            )

    # ----------------------------------------------------------------- input

    def handle_input(self) -> None:
        """Reference key map (playback.py:140-173)."""
        import pygame

        for event in pygame.event.get():
            # Zoom/pan re-render immediately — also while paused, where no
            # tick will redraw for us (reference playback.py:142-148 calls
            # draw_scene inside handle_input for exactly these two events).
            if event.type == pygame.MOUSEWHEEL:
                self.scale_zoom(event.y)
                if self.screen is not None:
                    self.draw_scene()
            if event.type == pygame.MOUSEMOTION and event.buttons[0]:
                self.translate(np.array(event.rel, float))
                if self.screen is not None:
                    self.draw_scene()
            if event.type == pygame.KEYDOWN:
                if event.key == pygame.K_RIGHT:
                    self.crate.gravity = np.array([9.81, 0.0])
                if event.key == pygame.K_LEFT:
                    self.crate.gravity = np.array([-9.81, 0.0])
                if event.key == pygame.K_q:
                    self.done = True
                if event.key == pygame.K_w:
                    self.current_physical_field_index -= 1
                if event.key == pygame.K_s:
                    self.current_physical_field_index += 1
                if event.key == pygame.K_a:
                    self.edit_physics(increase=False)
                if event.key == pygame.K_d:
                    self.edit_physics(increase=True)
                if event.key == pygame.K_r:
                    self.reset()
                    self.zoom_factor = 1.0
                    self.zoom_center = np.array(
                        [self._size[0] / 2, self._size[1] / 2], float
                    )
                if event.key == pygame.K_SPACE:
                    self.pause = not self.pause
                if event.key == pygame.K_n:
                    self.step_one = True
            if event.type == pygame.KEYUP:
                self.crate.gravity = np.array([0.0, 9.81])

    def edit_physics(self, increase: bool, change_factor: float = 0.1) -> None:
        """+/-10% on the selected coefficient (playback.py:221-226)."""
        names = self.crate.editable_coefficients()
        name = names[self.current_physical_field_index % len(names)]
        current = getattr(self.crate, name)
        rate = 1 + change_factor if increase else 1 - change_factor
        setattr(self.crate, name, np.asarray(current) * rate)

    def translate(self, relative_motion: np.ndarray) -> None:
        self.zoom_center = self.zoom_center - relative_motion / self.zoom_factor

    def scale_zoom(self, direction: int) -> None:
        """Zoom keeping the point under the mouse fixed (playback.py:231-241)."""
        import pygame

        mouse = np.array(pygame.mouse.get_pos(), float)
        center = np.array([self._size[0] / 2, self._size[1] / 2])
        new_zoom = self.zoom_factor * (1 + direction * SCROLL_ZOOM_FACTOR)
        ratio = new_zoom / self.zoom_factor
        target = (1 - 1 / ratio) * mouse + (1 / ratio) * center
        self.zoom_factor = new_zoom
        self.zoom_center = self.zoom_center + (target - center) / self.zoom_factor


def replay(recording_dir: Path, headless: bool = False, size=(1000, 1000)):
    """Render a recorded trajectory without stepping physics."""
    from .recording import load_trajectory

    frames = []
    for frame in load_trajectory(Path(recording_dir) / "trajectory"):
        img = render_frame(
            frame["pos"],
            frame["pressure"],
            frame["segments"],
            size=size,
            alive=frame.get("alive"),
        )
        frames.append(img)
        if not headless:
            _blit_replay(img, size)
    return frames


def _blit_replay(img: np.ndarray, size) -> None:
    import pygame

    if not pygame.get_init():
        pygame.init()
        pygame.display.set_mode(size)
        pygame.display.set_caption("SandCrate — replay")
    surf = pygame.image.frombuffer(img.tobytes(), (img.shape[1], img.shape[0]), "RGB")
    pygame.display.get_surface().blit(surf, (0, 0))
    pygame.display.update()
