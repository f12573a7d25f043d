"""The port's recording layer: trajectory shards, video writers, checkpoints.

The recording cases of tests/test_recording.py on the port's writer; each
package reads the other's recordings; a port checkpoint resumes bit for bit
on the CPU (stirring_cup, whose emitters draw from the generator); the port
loads a JAX package checkpoint and continues as the JAX run does.
"""

import copy
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from sand_crate_tpu import load_config_dict as jax_load_config_dict
from sand_crate_tpu import physics as jphys
from sand_crate_tpu.engine import Crate as JaxCrate
from sand_crate_tpu.recording import TrajectoryWriter as JaxTrajectoryWriter
from sand_crate_tpu.recording import load_trajectory as jax_load_trajectory
from sand_crate_tpu_torch import load_config_dict
from sand_crate_tpu_torch.bench import STIRRING_CUP
from sand_crate_tpu_torch.engine import Crate
from sand_crate_tpu_torch.recording import (
    TrajectoryWriter,
    VideoWriter,
    load_checkpoint,
    load_trajectory,
    trajectory_info,
)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def _frame(p, t):
    rng = np.random.default_rng(t)
    return dict(
        pos=rng.random((p, 2)).astype(np.float32),
        alive=rng.random(p) < 0.8,
        pressure=rng.random(p).astype(np.float32),
        segments=np.zeros((3, 2, 2), np.float32),
    )


def test_trajectory_round_trip(tmp_path):
    w = TrajectoryWriter(tmp_path / "traj", shard_frames=4)
    frames = [_frame(16, t) for t in range(10)]
    for f in frames:
        w.append(f)
    w.close(config_yaml="a: 1\n", meta={"note": "test"})

    info = trajectory_info(tmp_path / "traj")
    assert info["frames"] == 10 and info["format"] == "sand_crate_tpu/trajectory/v1"
    assert len(info["shards"]) == 3  # 4 + 4 + 2
    assert info["meta"]["note"] == "test"
    assert (tmp_path / "traj" / "config.yaml").read_text() == "a: 1\n"
    back = list(load_trajectory(tmp_path / "traj"))
    assert len(back) == 10
    for orig, got in zip(frames, back):
        for k in orig:
            np.testing.assert_array_equal(orig[k], got[k])


def test_trajectory_fixed_capacity_stacks(tmp_path):
    """Frames with the same capacity but different alive counts stack."""
    w = TrajectoryWriter(tmp_path / "t", shard_frames=8)
    for t in range(5):
        f = _frame(32, t)
        f["alive"][:] = False
        f["alive"][: t + 1] = True
        w.append(f)
    w.close()
    frames = list(load_trajectory(tmp_path / "t"))
    assert [int(f["alive"].sum()) for f in frames] == [1, 2, 3, 4, 5]


def test_trajectory_takes_tensors(tmp_path):
    """Frames of torch tensors (Crate.stream_frames' or the state's) are
    written as their numpy values."""
    w = TrajectoryWriter(tmp_path / "t")
    frame = _frame(8, 0)
    w.append({k: torch.as_tensor(v) for k, v in frame.items()})
    w.close()
    (got,) = list(load_trajectory(tmp_path / "t"))
    for k, v in frame.items():
        np.testing.assert_array_equal(got[k], v)


def test_video_writer_outputs(tmp_path):
    vw = VideoWriter(tmp_path, fps=10, gif_max_frames=5)
    for t in range(8):
        vw.append(np.full((32, 48, 3), t * 30, np.uint8))
    out = vw.close()
    assert {p.name for p in out} == {"video.avi", "video.gif"}
    for p in out:
        assert p.stat().st_size > 0


def test_video_writer_gif_bounded_memory(tmp_path, capsys):
    """The GIF buffer stays under its cap, spans the whole run and reports
    its stride (tests/test_recording.py's case)."""
    vw = VideoWriter(tmp_path, write_avi=False, gif_max_frames=8, gif_max_px=16)
    n = 100
    for t in range(n):
        vw.append(np.full((32, 48, 3), t, np.uint8))
    assert len(vw._gif_frames) < 8
    assert vw.gif_stride == 16
    kept = [t for t in range(n) if t % vw.gif_stride == 0]
    assert kept[0] == 0 and n - kept[-1] <= vw.gif_stride
    assert max(vw._gif_frames[0].size) <= 16
    out = vw.close()
    assert [p.name for p in out] == ["video.gif"]
    msg = capsys.readouterr().out
    assert "decimated" in msg and "16" in msg

    from PIL import Image

    im = Image.open(out[0])
    im.seek(len(kept) - 1)
    assert im.info["duration"] >= 10 * vw.gif_stride


def test_load_missing_trajectory_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        list(load_trajectory(tmp_path / "nope"))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_recordings_cross_read(tmp_path, writer):
    """A recording written by either package reads back through the other's
    load_trajectory, frame for frame."""
    write, read = ((TrajectoryWriter, jax_load_trajectory) if writer == "port"
                   else (JaxTrajectoryWriter, load_trajectory))
    w = write(tmp_path / "traj", shard_frames=3)
    frames = [_frame(12, t) for t in range(7)]
    for f in frames:
        w.append(f)
    w.close(meta={"by": writer})
    back = list(read(tmp_path / "traj"))
    assert len(back) == len(frames)
    for orig, got in zip(frames, back):
        for k in orig:
            np.testing.assert_array_equal(orig[k], got[k])


def _stirring_cup():
    return load_config_dict(copy.deepcopy(STIRRING_CUP)).world_config


def test_checkpoint_resume_is_exact(tmp_path):
    """stirring_cup (an emitter and a motored cup): a crate saved at tick T
    and restored into a fresh crate continues, bit for bit, as the crate
    that ran on; the emitters' generator state comes back with it."""
    world = _stirring_cup()
    ran = Crate(world, device="cpu", seed=3)
    ran.run(30)
    path = ran.save_checkpoint(tmp_path / "ckpt.npz")
    ran.run(12)
    resumed = Crate(world, device="cpu", seed=99)  # another seed: the file decides
    resumed.restore_checkpoint(path)
    assert resumed.tick == 30
    resumed.run(12)
    assert ran.tick == resumed.tick == 42
    assert ran.particle_count > 0  # stirring_cup starts empty: every particle was emitted
    for name, a, b in zip(ran.state._fields, ran.state, resumed.state):
        assert torch.equal(a, b), name
    for name, a, b in zip(ran.params._fields, ran.params, resumed.params):
        assert torch.equal(a, b), name


def test_checkpoint_capacity_mismatch_raises(tmp_path):
    world = _stirring_cup()
    path = Crate(world, device="cpu").save_checkpoint(tmp_path / "ckpt.npz")
    other = Crate(world, device="cpu", capacity=1024)
    with pytest.raises(ValueError, match="capacity"):
        other.restore_checkpoint(path)


def test_checkpoint_without_uid_gets_fresh_ids(tmp_path):
    """A checkpoint from before particle ids existed loads with ids 0..P-1."""
    crate = Crate(_stirring_cup(), device="cpu")
    crate.run(5)
    path = crate.save_checkpoint(tmp_path / "ckpt.npz")
    data = dict(np.load(path))
    del data["state.uid"]
    old = tmp_path / "old.npz"
    np.savez_compressed(old, **data)
    state, params, gen = load_checkpoint(old, "cpu")
    assert torch.equal(state.uid, torch.arange(crate.scene.capacity, dtype=torch.int32))
    assert torch.equal(state.pos, crate.state.pos) and gen is not None


def test_checkpoint_generator_of_another_device_raises(tmp_path):
    """A CUDA generator state (Philox seed and offset) does not convert to a
    CPU generator (Mersenne twister): loading it on the CPU raises."""
    crate = Crate(_stirring_cup(), device="cpu")
    path = crate.save_checkpoint(tmp_path / "ckpt.npz")
    data = dict(np.load(path))
    data["generator.device"] = np.array("cuda")
    data["generator.state"] = np.zeros(16, np.uint8)
    np.savez_compressed(tmp_path / "cuda.npz", **data)
    with pytest.raises(ValueError, match="does not convert"):
        load_checkpoint(tmp_path / "cuda.npz", "cpu")


def test_jax_checkpoint_loads_into_the_port(tmp_path):
    """A JAX Crate checkpoint of an emitter-free scene (a ~400-particle dam
    break, p-major) restores into the port's Crate; the next ticks match the
    JAX run's at tests/test_torch_step.py's trajectory tolerance."""
    raw = yaml.safe_load((REPO / "configs" / "dam_break.yaml").read_text())
    spacing = float(np.sqrt((0.42 - 0.02) * (0.98 - 0.10) / 400))
    raw["world"]["initial_particles"][0]["block"]["spacing"] = spacing
    raw["world"]["coefficients"]["particle_radius"] = spacing * 0.55
    raw["world"]["coefficients"]["max_particles"] = 420
    jc = JaxCrate(jax_load_config_dict(copy.deepcopy(raw)).world_config, forces_mode="pmajor")
    jc.run(4)
    path = jc.save_checkpoint(tmp_path / "jax.npz")
    jstate, _ = jphys.rollout(jc.state, jc.params, jc.scene, 4)
    tc = Crate(load_config_dict(copy.deepcopy(raw)).world_config, forces_mode="pmajor",
               device="cpu")
    gen = tc.generator.get_state()
    tc.restore_checkpoint(path)
    assert tc.tick == 4 and torch.equal(tc.generator.get_state(), gen)  # the key is ignored
    tc.run(4)
    ia, ib = np.argsort(np.asarray(jstate.uid)), np.argsort(tc.state.uid.numpy())
    alive = np.asarray(jstate.alive)[ia]
    assert alive.sum() > 300
    np.testing.assert_array_equal(tc.state.alive.numpy()[ib], alive)
    for name in ("pos", "vel"):
        np.testing.assert_allclose(getattr(tc.state, name).numpy()[ib][alive],
                                   np.asarray(getattr(jstate, name))[ia][alive],
                                   rtol=2e-3, atol=2e-4, err_msg=name)
