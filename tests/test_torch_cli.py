"""The port's command line (``cli.py``, ``python -m sand_crate_tpu_torch``):
the twins of tests/test_cli.py's four tests, then each subcommand run on
the CPU with ``--device cpu``.

A ``.json`` scene runs as its ``.yaml`` twin does (JSON is read without
PyYAML, which a GPU host may lack); without a card, a command that
steps a crate and is not asked for the CPU raises.
"""

import copy
import json
from pathlib import Path

import pytest
import torch
import yaml

from sand_crate_tpu_torch import bench, load_config
from sand_crate_tpu_torch.cli import DEFAULT_SWEEP_OPTIONS, build_parser, config_options, main

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CPU = ["--device", "cpu"]


@pytest.fixture()
def parser():
    return build_parser()


@pytest.fixture()
def small_scene(tmp_path):
    """The stirring cup shrunk to 48 particles, as twin .yaml and .json files."""
    raw = yaml.safe_load((REPO / "configs" / "stirring_cup.yaml").read_text())
    raw["world"]["coefficients"]["max_particles"] = 48
    raw.setdefault("playback", {}).update(screen_x=64, screen_y=64)
    (tmp_path / "cup.yaml").write_text(yaml.safe_dump(raw))
    (tmp_path / "cup.json").write_text(json.dumps(raw))
    return tmp_path


def test_run_flags(parser):
    a = parser.parse_args(
        [
            "run",
            "configs/stirring_cup.yaml",
            "--headless",
            "--ticks",
            "50",
            "--output",
            "/tmp/x",
            "--resume",
            "/tmp/x/checkpoint.npz",
            "--ticks-per-frame",
            "5",
        ]
    )
    assert a.command == "run" and a.ticks == 50 and a.ticks_per_frame == 5
    assert a.resume.endswith("checkpoint.npz")
    assert a.device == "cuda"  # the card unless the caller asks for the CPU
    assert parser.parse_args(["run", "c.json", "--device", "cpu"]).device == "cpu"


def test_replay_sweep_datagen_bench(parser):
    assert parser.parse_args(["replay", "/tmp/rec"]).command == "replay"
    s = parser.parse_args(["sweep", "c.yaml", "--vmapped", "--ticks", "9"])
    assert s.vmapped and s.ticks == 9
    d = parser.parse_args(
        ["datagen", "c.yaml", "--crates", "7", "--sample-every", "3"]
    )
    assert d.crates == 7 and d.sample_every == 3
    b = parser.parse_args(["bench", "--particles", "123"])
    assert b.particles == 123


def test_missing_command_errors(parser):
    with pytest.raises(SystemExit):
        parser.parse_args([])


def test_config_options_isolated_variants():
    """The sweep grid matches the reference's 48 variants and each variant is
    an isolated copy (upstream mutates a shared config, main.py:34-35)."""
    config = load_config(REPO / "configs" / "stirring_cup.yaml")
    variants = list(config_options(DEFAULT_SWEEP_OPTIONS, config))
    assert len(variants) == 48  # 2*2*2*2*3 (main.py:10-16)
    v0, v1 = variants[0], variants[1]
    assert v0 is not config
    v0.world_config.coefficients["viscosity"] = 999
    assert v1.world_config.coefficients["viscosity"] != 999


def test_run_json_equals_yaml(small_scene):
    """``run --device cpu --headless`` on the .json scene ends in the state
    the .yaml scene's run ends in, bit for bit."""
    args = ["--headless", "--no-record", "--ticks", "8", "--ticks-per-frame", "2", *CPU]
    a = main(["run", str(small_scene / "cup.yaml"), *args])
    b = main(["run", str(small_scene / "cup.json"), *args])
    assert a.crate.tick == b.crate.tick == 8 and a.crate.particle_count > 0
    for name, x, y in zip(a.crate.state._fields, a.crate.state, b.crate.state):
        assert x.device.type == "cpu" and torch.equal(x, y), name


def test_run_without_a_card_raises(small_scene):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: run defaults to it")
    with pytest.raises(RuntimeError, match="CUDA device.*device='cpu'"):
        main(["run", str(small_scene / "cup.json"), "--headless", "--no-record", "--ticks", "2"])


def test_run_records_then_replay_and_resume(small_scene):
    """run --output records the AVI, GIF, trajectory and checkpoint;
    replay renders its frames; run --resume continues from the checkpoint."""
    out = small_scene / "rec"
    pb = main(["run", str(small_scene / "cup.json"), "--headless", "--ticks", "6",
               "--output", str(out), *CPU])
    for name in ("video.avi", "video.gif", "checkpoint.npz", "trajectory/index.json"):
        assert (out / name).exists(), name
    frames = main(["replay", str(out), "--headless"])
    assert len(frames) == 6 and frames[0].shape == (1000, 1000, 3)  # replay's default size
    resumed = main(["run", str(small_scene / "cup.json"), "--headless", "--no-record",
                    "--ticks", "2", "--resume", str(out / "checkpoint.npz"), *CPU])
    assert resumed.crate.tick == pb.crate.tick + 2


def test_sweep_and_datagen(small_scene):
    """sweep --vmapped runs the 48 variants as one batch; datagen writes its
    batched frames and labels."""
    res = main(["sweep", str(small_scene / "cup.json"), "--vmapped", "--ticks", "2", *CPU])
    assert len(res["particle_counts"]) == 48
    out = small_scene / "dg"
    res = main(["datagen", str(small_scene / "cup.json"), "--crates", "2", "--ticks", "4",
                "--sample-every", "2", "--out", str(out), *CPU])
    assert res["frames"] == 2 and res["crates"] == 2 and res["non_finite"] == 0
    assert (out / "params.npz").exists() and (out / "index.json").exists()


def test_bench_calls_the_port_bench(monkeypatch):
    """bench runs the port's bench entry (not the root bench.py, which is
    JAX) with the flags and the device."""
    calls = []
    monkeypatch.setattr(bench, "main", lambda **kw: calls.append(kw) or {"value": 1.0})
    assert main(["bench", "--particles", "123", "--ticks", "7", *CPU]) == {"value": 1.0}
    assert main(["bench"]) == {"value": 1.0}
    assert calls == [dict(particles=123, ticks=7, device="cpu"),
                     dict(particles=100_000, ticks=100, device="cuda")]


def test_python_dash_m_runs_the_cli(small_scene):
    """``python -m sand_crate_tpu_torch`` is the command line (__main__.py)."""
    import subprocess
    import sys

    res = subprocess.run(
        [sys.executable, "-m", "sand_crate_tpu_torch", "run", str(small_scene / "cup.json"),
         "--headless", "--no-record", "--ticks", "4", "--ticks-per-frame", "2", *CPU],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "frame 2/2" in res.stdout
