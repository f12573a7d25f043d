"""Trajectory recording, video export and state checkpoints.

The counterpart of ``sand_crate_tpu/recording.py``:

* :class:`TrajectoryWriter` streams raw state frames (positions, pressures,
  alive mask, segments) to compressed npz shards with a JSON index;
  :func:`load_trajectory` and :func:`trajectory_info` read them back.  The
  shard names and the index (``"format": "sand_crate_tpu/trajectory/v1"``)
  are the JAX package's, so each package reads the other's recordings.
* :class:`VideoWriter` streams rendered frames into cv2's MJPG AVI encoder
  and a decimating GIF buffer (bounded memory); cv2 and PIL are imported
  only when a frame is written.
* :func:`save_checkpoint` / :func:`load_checkpoint`: one npz with the
  ``state.<field>`` and ``params.<field>`` arrays of the JAX format, plus the
  emitters' ``torch.Generator`` state (``generator.state``, and the device
  type it belongs to as ``generator.device``).  The loader also reads the
  JAX package's checkpoints: their ``state.key`` (threefry key data) has no
  counterpart and is ignored, so the crate's generator is left as it is.
  The JAX loader does not read the port's files (it would hand the
  generator arrays to its ``Params``).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Iterator, Optional

import numpy as np
import torch

from .diagnostics import host_read
from .state import CrateState, Params, params_from_numpy, state_from_numpy

FRAME_KEYS = ("pos", "alive", "pressure", "segments")
TRAJECTORY_FORMAT = "sand_crate_tpu/trajectory/v1"


def _to_host(x) -> np.ndarray:
    """A frame field as a fresh host array (a tensor copied back)."""
    if isinstance(x, torch.Tensor):
        host_read("recording.frame")
        return x.detach().to("cpu", copy=True).numpy()
    return np.asarray(x)


class TrajectoryWriter:
    """Streams simulation state frames to npz shards under a directory."""

    def __init__(self, directory: str | Path, shard_frames: int = 64) -> None:
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.shard_frames = shard_frames
        self._buffer: list[dict] = []
        self._shards: list[dict] = []
        self._frames = 0

    def append(self, frame: dict) -> None:
        """Add one frame dict (pos (P,2), alive (P,), pressure (P,), segments)
        of numpy arrays or tensors (copied to the host: a tensor may be a
        static buffer that the next tick overwrites; each tensor is one
        read in diagnostics.READS)."""
        self._buffer.append({k: _to_host(frame[k]) for k in FRAME_KEYS if k in frame})
        self._frames += 1
        if len(self._buffer) >= self.shard_frames:
            self._flush()

    def _flush(self) -> None:
        if not self._buffer:
            return
        path = self.directory / f"shard_{len(self._shards):05d}.npz"
        stacked = {k: np.stack([f[k] for f in self._buffer]) for k in self._buffer[0]}
        np.savez_compressed(path, **stacked)
        self._shards.append({"file": path.name, "frames": len(self._buffer)})
        self._buffer = []

    def close(self, config_yaml: Optional[str] = None, meta: Optional[dict] = None) -> Path:
        """Flush shards and write the index (+ optional config.yaml text)."""
        self._flush()
        index = {"format": TRAJECTORY_FORMAT, "frames": self._frames, "shards": self._shards}
        if meta:
            index["meta"] = meta
        with open(self.directory / "index.json", "w") as f:
            json.dump(index, f, indent=2)
        if config_yaml is not None:
            (self.directory / "config.yaml").write_text(config_yaml)
        return self.directory


def load_trajectory(directory: str | Path) -> Iterator[dict]:
    """Yield frames (dicts of numpy arrays) from a recorded trajectory."""
    directory = Path(directory)
    with open(directory / "index.json") as f:
        index = json.load(f)
    for shard in index["shards"]:
        data = np.load(directory / shard["file"])
        for i in range(shard["frames"]):
            yield {k: data[k][i] for k in data.files}


def trajectory_info(directory: str | Path) -> dict:
    with open(Path(directory) / "index.json") as f:
        return json.load(f)


class VideoWriter:
    """Incremental AVI (cv2 MJPG, 50 fps by default) + GIF.

    The AVI streams (O(1) memory).  The GIF buffer is bounded: frames are
    downscaled to ``gif_max_px`` and palettized on append, and when the
    buffer reaches ``gif_max_frames`` every other frame is dropped and the
    sampling stride doubled, so the GIF spans the whole run at a uniform
    cadence; the final stride is :attr:`gif_stride`, printed at close, and
    the frame duration is stride-compensated.
    """

    def __init__(
        self,
        directory: str | Path,
        fps: int = 50,
        write_avi: bool = True,
        write_gif: bool = True,
        gif_max_frames: int = 600,
        gif_max_px: int = 500,
    ) -> None:
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.fps = fps
        self.write_avi = write_avi
        self.write_gif = write_gif
        self.gif_max_frames = max(int(gif_max_frames), 2)
        self.gif_max_px = gif_max_px
        self.gif_stride = 1  # grows 1 -> 2 -> 4 ... as the cap binds
        self._gif_seen = 0  # frames offered to the GIF path
        self._avi = None
        self._gif_frames: list = []

    def append(self, rgb: np.ndarray) -> None:
        """Add one H x W x 3 uint8 RGB frame."""
        if self.write_avi:
            if self._avi is None:
                import cv2

                h, w = rgb.shape[:2]
                self._avi_path = (self.directory / "video.avi").resolve()
                self._avi = cv2.VideoWriter(
                    str(self._avi_path), cv2.VideoWriter_fourcc(*"MJPG"), self.fps, (w, h), 1
                )
            self._avi.write(rgb[:, :, ::-1])  # RGB -> BGR
        if self.write_gif:
            if self._gif_seen % self.gif_stride == 0:
                from PIL import Image

                img = Image.fromarray(rgb)
                if max(img.size) > self.gif_max_px:
                    scale = self.gif_max_px / max(img.size)
                    img = img.resize((max(round(img.size[0] * scale), 1),
                                      max(round(img.size[1] * scale), 1)))
                self._gif_frames.append(img.convert("P", palette=Image.ADAPTIVE))
                if len(self._gif_frames) >= self.gif_max_frames:
                    # The kept frames are those with seen % (2 * stride) == 0,
                    # exactly what the doubled stride admits next.
                    self._gif_frames = self._gif_frames[::2]
                    self.gif_stride *= 2
            self._gif_seen += 1

    def close(self) -> list[Path]:
        out = []
        if self._avi is not None:
            self._avi.release()
            out.append(self._avi_path)
            print("file://" + str(self._avi_path))
        if self.write_gif and self._gif_frames:
            gif_path = (self.directory / "video.gif").resolve()
            self._gif_frames[0].save(
                gif_path,
                format="GIF",
                append_images=self._gif_frames[1:],
                save_all=True,
                duration=max(1000 // self.fps, 10) * self.gif_stride,
                loop=0,
            )
            out.append(gif_path)
            if self.gif_stride > 1:
                print(
                    f"GIF decimated to every {self.gif_stride}th frame "
                    f"({len(self._gif_frames)} of {self._gif_seen} kept; "
                    f"cap {self.gif_max_frames}, duration compensated)"
                )
            print("file://" + str(gif_path))
        return out


# ---------------------------------------------------------------------------
# State checkpoints: the full CrateState, the coefficients and the emitters'
# generator, so that a run resumes exactly where it stopped.
# ---------------------------------------------------------------------------


def save_checkpoint(path: str | Path, state: CrateState, params: Params,
                    generator: torch.Generator) -> Path:
    """Write a CrateState + Params + generator snapshot as one npz file."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {f"state.{k}": v.cpu().numpy() for k, v in state._asdict().items()}
    arrays.update({f"params.{k}": v.cpu().numpy() for k, v in params._asdict().items()})
    arrays["generator.state"] = generator.get_state().numpy()
    arrays["generator.device"] = np.array(generator.device.type)
    np.savez_compressed(path, **arrays)
    return path


def load_checkpoint(path: str | Path, device="cuda"):
    """Load a :func:`save_checkpoint` file, or a JAX package checkpoint, onto
    ``device``: (CrateState, Params, generator state or None).

    The generator state is a CPU uint8 tensor for ``torch.Generator.set_state``
    on a generator of ``device``'s type; None for a JAX checkpoint, whose
    ``state.key`` is ignored.  A file without ``state.uid`` gets fresh ids.
    A generator state of another device type raises ValueError: a CUDA
    generator's (Philox seed and offset) and a CPU generator's (Mersenne
    twister) do not convert into each other."""
    device = torch.device(device)
    data = np.load(Path(path))
    scopes: dict[str, dict] = {"state": {}, "params": {}, "generator": {}}
    for k in data.files:
        scope, name = k.split(".", 1)
        scopes[scope][name] = data[k]
    state_kw, params_kw, gen = scopes["state"], scopes["params"], scopes["generator"]
    state_kw.pop("key", None)  # the JAX package's threefry key
    state_kw.setdefault("uid", np.arange(state_kw["alive"].shape[0], dtype=np.int32))
    gen_state = None
    if gen:
        saved_on = str(gen["device"])
        if saved_on != device.type:
            raise ValueError(
                f"checkpoint {path} holds a {saved_on} generator state, which does not "
                f"convert to a {device.type} generator; restore it on a {saved_on} crate"
            )
        gen_state = torch.from_numpy(gen["state"].copy())
    return state_from_numpy(state_kw, device), params_from_numpy(params_kw, device), gen_state
