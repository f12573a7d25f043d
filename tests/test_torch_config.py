"""The port's scene files without PyYAML, its AoS geometry functions and
its profiler trace.

With ``yaml`` hidden from ``sys.modules`` (as on a host without PyYAML),
``load_config`` reads each shipped ``configs/*.yaml`` into the dict that
``yaml.safe_load`` gives, and ``dump_config`` writes text that reads back
unchanged; ``yaml_subset`` agrees with PyYAML on the forms it reads and
refuses the ones it does not.  ``geometry``'s ``cross2``,
``points_to_segments``, ``_orient``, ``segment_crossings`` and
``crossing_parameter`` equal their JAX twins on seeded inputs, and
``diagnostics.profile`` writes a Chrome trace on the CPU.
"""

import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from sand_crate_tpu import geometry as jgeo
from sand_crate_tpu_torch import bench, geometry, yaml_subset
from sand_crate_tpu_torch.config import dump_config, load_config, load_config_dict
from sand_crate_tpu_torch.diagnostics import profile

REPO = Path(__file__).resolve().parent.parent
CONFIGS = sorted((REPO / "configs").glob("*.yaml"))


@pytest.fixture
def no_pyyaml(monkeypatch):
    """``import yaml`` raises ImportError, as on a host without PyYAML."""
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError):
        import yaml  # noqa: F401


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_config_reads_without_pyyaml(no_pyyaml, path):
    want = yaml.safe_load(path.read_text())
    config = load_config(path)
    assert config.raw == want
    assert config.world_config == load_config_dict(want).world_config


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_dump_load_round_trip_without_pyyaml(no_pyyaml, path, tmp_path):
    config = load_config(path)
    text = dump_config(config)
    assert yaml_subset.load(text) == config.raw
    out = tmp_path / path.name
    out.write_text(text)
    assert load_config(out).raw == config.raw
    assert yaml.safe_load(text) == config.raw  # PyYAML reads the writer's text too


def test_bench_dicts_equal_the_files_without_pyyaml(no_pyyaml):
    for name, raw in (("dam_break", bench.DAM_BREAK), ("stirring_cup", bench.STIRRING_CUP),
                      ("wave_machine", bench.WAVE_MACHINE)):
        assert load_config(REPO / "configs" / f"{name}.yaml").raw == raw, name


SUBSET = [
    "a: 1e-3\nb: 1.0e-3\nc: .5\nd: -.5\ne: ~\nf:\ng: yes\nh: 'it''s'\ni: \"x\\ty\"\n",
    "j: [1, [2, 3,], {k: v, l: [4]},]\nk: 1_000\nl: -.inf\nm: Off\nn: 12.\n",
    "- a\n- b: 1\n  c: 2\n- - x\n  - y\n-\n  z: 1\n",
    "k:\n- 1\n- 2\nm: {a: 1, b: }\n",
    "[1, 2]\n",
    "plain words here\n",
    "---\na: b # c\n# full line\n'q k': 'v # not a comment'\n",
    "top:\n  list: [\n    1,  # one\n    2,\n  ]\n  after: 3\n",
    "w: {amplitude: 1.4,\n    frequency: 5.0}\nv: \"lambda t: np.cos(t * 5) * 1.4\"\n",
]


@pytest.mark.parametrize("text", SUBSET)
def test_subset_reads_as_pyyaml(text):
    want = yaml.safe_load(text)
    assert repr(yaml_subset.load(text)) == repr(want)
    assert repr(yaml_subset.load(yaml_subset.dump(want))) == repr(want)


@pytest.mark.parametrize("text", ["a: 0x10", "a: 010", "a: 1:30", "a: 2001-01-01",
                                  "a: &x 1", "a: *x", "a: !!str 1", "a: |\n  x", "a: [1, 2"])
def test_subset_refuses_other_forms(text):
    with pytest.raises(ValueError):
        yaml_subset.load(text)


def test_subset_writer_keeps_types():
    data = {"f": [1e-5, 1e20, 0.1, -2.5, float("inf"), 3.0],
            "s": ["yes", "1", "", "a b", "x: y", "#c", "null", "data/rec", "1e-3"],
            "n": None, "b": [True, False], "e": {}, "l": [], "d": [{"k": [1, {"x": 2}]}]}
    text = yaml_subset.dump(data)
    assert repr(yaml_subset.load(text)) == repr(data)
    assert repr(yaml.safe_load(text)) == repr(data)
    assert json.loads(json.dumps(yaml_subset.load(text)["s"])) == data["s"]


# ---- geometry: the AoS functions against their JAX twins ---------------------------

def _rng_points(rng, *shape):
    return rng.uniform(-0.2, 1.2, shape).astype(np.float32)


def _close(got: torch.Tensor, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_geometry_aos_equals_jax(seed):
    rng = np.random.default_rng(seed)
    pts = _rng_points(rng, 64, 2)
    segs = _rng_points(rng, 7, 2, 2)
    segs[3, 1] = segs[3, 0]  # a zero-length segment
    move = np.stack([pts, pts + rng.normal(0, 0.3, (64, 2)).astype(np.float32)], axis=1)
    walls = np.concatenate([segs, np.array([[[0.0, 0.0], [1.0, 0.0]]], np.float32)])
    t = torch.as_tensor

    _close(geometry.cross2(t(pts), t(pts[::-1].copy())),
           jgeo.cross2(jnp.asarray(pts), jnp.asarray(pts[::-1])))
    near, dist = geometry.points_to_segments(t(pts), t(segs))
    jnear, jdist = jgeo.points_to_segments(jnp.asarray(pts), jnp.asarray(segs))
    _close(near, jnear)
    _close(dist, jdist)
    a, b, c = (pts[:, None, :], pts[None, :8, :], pts[None, 8:16, :])
    _close(geometry._orient(t(a), t(b), t(c)),
           jgeo._orient(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c)))
    got = geometry.segment_crossings(t(move), t(walls)).numpy()
    want = np.asarray(jgeo.segment_crossings(jnp.asarray(move), jnp.asarray(walls)))
    np.testing.assert_array_equal(got, want)
    assert got.any() and not got.all()
    start, delta = move[:, None, 0, :], (move[:, 1] - move[:, 0])[:, None, :]
    wall_a, wall_ab = walls[None, :, 0, :], (walls[:, 1] - walls[:, 0])[None]
    delta[0] = wall_ab[0, 0]  # a path parallel to a wall: the guarded denominator
    _close(geometry.crossing_parameter(t(start), t(delta), t(wall_a), t(wall_ab)),
           jgeo.crossing_parameter(jnp.asarray(start), jnp.asarray(delta),
                                   jnp.asarray(wall_a), jnp.asarray(wall_ab)))


def test_aos_and_soa_agree():
    """The step's SoA forms and the AoS forms give the same nearest points."""
    rng = np.random.default_rng(3)
    pts, segs = torch.as_tensor(_rng_points(rng, 50, 2)), torch.as_tensor(_rng_points(rng, 5, 2, 2))
    near, dist = geometry.points_to_segments(pts, segs)
    nx, ny, sdist = geometry.points_to_segments_soa(pts[:, 0], pts[:, 1], segs)
    torch.testing.assert_close(near, torch.stack([nx.T, ny.T], dim=-1), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(dist, sdist.T, rtol=1e-6, atol=1e-6)


def test_profile_writes_a_chrome_trace(tmp_path):
    with profile(tmp_path / "trace") as log_dir:
        (torch.ones(64) * 2).sum()
    trace = json.loads((Path(log_dir) / "trace.json").read_text())
    assert trace["traceEvents"]
