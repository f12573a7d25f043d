"""The port's engine tools (``sand_crate_tpu_torch/tools/``) on the CPU.

Each tool against its JAX twin in ``tools/`` where the two compute the
same thing (the dam-break world, the occupancy statistics on one state,
the soak's invariants on a clean run and on injected faults, and the
timing tools' fields on a few ticks.  The band tools are in
test_torch_tools_bands.py.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sand_crate_tpu.scene import build_scene as jax_build_scene
from sand_crate_tpu.scene import init_state as jax_init_state
from sand_crate_tpu_torch.scene import build_scene
from sand_crate_tpu_torch.state import state_from_numpy
from sand_crate_tpu_torch.tools import (
    chunked_sweep,
    occupancy_stats,
    perf_probe,
    small_n_probe,
    soak,
)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def jax_tools(monkeypatch):
    """The JAX tools' modules (they read configs/ relative to the repo root)."""
    monkeypatch.chdir(REPO)
    from tools import occupancy_stats as j_occ
    from tools import perf_probe as j_perf
    from tools import soak as j_soak

    return j_perf, j_soak, j_occ


@pytest.mark.parametrize("n", [10_000, 100_000])
def test_dam_break_world_equals_jax_tool(jax_tools, n):
    j_perf, _, _ = jax_tools
    jw, tw = j_perf.dam_break_world(n), perf_probe.dam_break_world(n)
    assert tw.coefficients == jw.coefficients
    assert dataclasses.asdict(tw.initial_particles[0]) == dataclasses.asdict(
        jw.initial_particles[0])
    js = jax_build_scene(jw, forces_mode="pmajor")
    ts = build_scene(tw, forces_mode="pmajor", device="cpu")
    for field in ("capacity", "grid_nx", "grid_ny", "cell_capacity"):
        assert getattr(ts, field) == getattr(js, field), field


@pytest.fixture
def piled_state(jax_tools):
    """One dam-break state at ~3000 particles with a dead tail and a
    coincident pile, in both packages: (JAX state, JAX scene, port state,
    port scene, diameter)."""
    j_perf, _, _ = jax_tools
    jw = j_perf.dam_break_world(3000)
    js = jax_build_scene(jw, forces_mode="pmajor")
    st = jax_init_state(jw, js, seed=0)
    pos = np.asarray(st.pos).copy()
    alive = np.asarray(st.alive).copy()
    rng = np.random.default_rng(0)
    pos[:40] = np.array([0.3, 0.7], np.float32) + rng.normal(0, 1e-4, (40, 2)).astype(np.float32)
    pos[40:50] = pos[0] + rng.normal(0, 1e-2, (10, 2)).astype(np.float32)
    alive[200:260] = False
    st = st._replace(pos=jnp.asarray(pos), alive=jnp.asarray(alive))
    leaves = {k: np.asarray(v) for k, v in st._asdict().items() if k != "key"}
    ts = build_scene(perf_probe.dam_break_world(3000), forces_mode="pmajor", device="cpu")
    diam = 2.0 * float(jw.coefficients["particle_radius"])
    return st, js, state_from_numpy(leaves, device="cpu"), ts, diam


def test_soak_occupancy_stats_equals_jax(jax_tools, piled_state):
    _, j_soak, _ = jax_tools
    st, js, tst, ts, diam = piled_state
    got = soak.occupancy_stats(tst, ts, diam)
    assert got == j_soak.occupancy_stats(st, js, diam)
    assert got[0] >= 40 and got[1] >= 40  # the pile is found


def test_occupancy_stats_equals_jax(jax_tools, piled_state):
    _, _, j_occ = jax_tools
    st, js, tst, ts, _ = piled_state
    want = j_occ.stats(st, js)
    got = occupancy_stats.stats(tst, ts)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k], k


def test_soak_main_holds_on_a_clean_run(capsys):
    assert soak.main(2000, 40, 20, device="cpu") == 0
    out = capsys.readouterr().out
    assert "OK: all invariants held" in out
    assert out.count("non_finite=0") == 2 and out.count("dup_uid=0") == 2


def _nan_velocity(state):
    i = int(torch.nonzero(state.alive)[0])
    vel = state.vel.clone()
    vel[i] = float("nan")
    return state._replace(vel=vel)


def _duplicate_uid(state):
    a, b = torch.nonzero(state.alive)[:2, 0].tolist()
    uid = state.uid.clone()
    uid[b] = uid[a]
    return state._replace(uid=uid)


@pytest.mark.parametrize("fault,broken", [(_nan_velocity, "non_finite="),
                                          (_duplicate_uid, "duplicate uids")])
def test_soak_main_fails_on_a_fault(monkeypatch, capsys, fault, broken):
    """A fault put into one alive particle before the first chunk's last
    tick (a NaN velocity makes positions NaN at that tick's integrate; a
    copied uid stays) breaks the invariant and main returns 1."""
    real = soak.rollout
    calls = []

    def faulty(state, params, scene, n, generator):
        if calls:
            return real(state, params, scene, n, generator)
        calls.append(n)
        state, _ = real(state, params, scene, n - 1, generator)
        return real(fault(state), params, scene, 1, generator)

    monkeypatch.setattr(soak, "rollout", faulty)
    assert soak.main(2000, 20, 10, device="cpu") == 1
    out = capsys.readouterr().out
    assert "FAILED: " in out and broken in out.split("FAILED: ")[1]


def test_soak_growing_overflow_rule():
    assert soak.overflow_growing([0, 0, 0, 10, 10, 10])  # 30 > 4 * max(0, 6)
    assert soak.overflow_growing([1, 0, 40, 40])  # 80 > 4 * max(1, 4)
    assert not soak.overflow_growing([5, 5, 5, 5, 5, 5])  # flat
    assert not soak.overflow_growing([128, 0, 0, 0, 0, 0, 0, 0])  # the JAX record
    assert not soak.overflow_growing([0, 0, 0, 0])  # the port's p-major
    assert not soak.overflow_growing([7])


def test_timing_tools_print_their_fields(monkeypatch, capsys):
    rate = perf_probe.probe(2000, ticks=2, device="cpu")
    out = capsys.readouterr().out
    for field in ("N=", "capacity=", "grid=", "M=", "compile=", "steps/s=",
                  "particle-steps/s=", "overflow=0", "maxspeed="):
        assert field in out, field
    assert rate > 0

    monkeypatch.setenv("SAND_CRATE_PROBE_SPLIT", "3")
    perf_probe.probe(2000, ticks=1, forces_mode="pmajor", device="cpu")
    assert "pmajor_split is a TPU tactic the port does not have" in capsys.readouterr().out

    monkeypatch.setattr(small_n_probe, "CHUNK", 2)
    p50 = small_n_probe.time_config("pallas grid", 2000, 2, device="cpu", forces_mode="pallas")
    out = capsys.readouterr().out
    assert out.startswith("pallas grid") and "ms/step" in out and "compile" in out and p50 > 0


def test_chunked_sweep_fill_and_one_variant(capsys):
    hist = chunked_sweep.fill(2, chunks=1, device="cpu")
    assert hist == [0]
    assert "20-tick fill" in capsys.readouterr().out
    (row,) = chunked_sweep.sweep(2, variants=((128, 256),), settle_chunks=1, timed=1,
                                 device="cpu")
    assert (row["cs"], row["halo"], row["max_overflow"]) == (128, 256, 0)
    assert "cs=128 halo=256:" in capsys.readouterr().out


def test_tools_run_on_the_card_by_default():
    """Without a card (none is visible to the child) a tool raises rather
    than falling back to the CPU."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(
        [sys.executable, "-m", "sand_crate_tpu_torch.tools.soak", "2000", "20", "10"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert res.returncode != 0
    assert "device='cpu'" in res.stderr
