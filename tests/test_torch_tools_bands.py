"""The port's band tools (``tools/spatial_balance.py`` and
``tools/rebalance_midscale.py`` in ``sand_crate_tpu_torch/tools/``) on the
CPU: ``spatial_balance`` prints the JAX tool's per-band alive counts and
edges, and ``rebalance_midscale``'s gates hold at a reduced size and fail
on a forced dropped migration or an unstrided edge subsample.
"""

from pathlib import Path

import pytest
import torch

from sand_crate_tpu_torch import spatial
from sand_crate_tpu_torch.tools import rebalance_midscale, spatial_balance

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("rebalance", [False, True])
def test_spatial_balance_equals_jax_tool(monkeypatch, capsys, rebalance):
    """The same per-band alive counts (and edges) every second tick over
    20 ticks: the JAX tool on its 8-device CPU mesh, the port's on a
    LocalGroup of 8."""
    monkeypatch.chdir(REPO)
    from tools import spatial_balance as j_sb

    j_sb.main(8, 20, rebalance=rebalance)
    want = capsys.readouterr().out.splitlines()
    samples = spatial_balance.main(8, 20, rebalance=rebalance, device="cpu")
    got = capsys.readouterr().out.splitlines()
    assert got == want
    assert [t for t, _ in samples] == list(range(2, 21, 2))
    assert all(sum(s) == sum(samples[0][1]) for _, s in samples)  # no particle lost


REDUCED = dict(particles=800, eq_ticks=8, settle_ticks=20, n_shards=4)


def test_rebalance_midscale_gates_pass_at_reduced_size(monkeypatch, capsys):
    """At ~800 particles with EDGE_SAMPLE_TARGET lowered so that the edge
    subsample is strided (stride 16), every gate holds."""
    monkeypatch.setattr(spatial, "EDGE_SAMPLE_TARGET", 64)
    assert rebalance_midscale.main(**REDUCED, device="cpu") == 0
    out = capsys.readouterr().out
    assert "edge_sample_stride=16 (subsampling BINDS)" in out and "PASS" in out


def test_rebalance_midscale_fails_on_a_dropped_migration(monkeypatch, capsys):
    monkeypatch.setattr(spatial, "EDGE_SAMPLE_TARGET", 64)
    real = rebalance_midscale.make_spatial_step

    def dropping(*args, **kwargs):
        step_fn = real(*args, **kwargs)

        def one(*a):
            state, stats = step_fn(*a)
            return state, {**stats, "migration_dropped": stats["migration_dropped"] + 1}
        return one

    monkeypatch.setattr(rebalance_midscale, "make_spatial_step", dropping)
    assert rebalance_midscale.main(**{**REDUCED, "settle_ticks": 0}, device="cpu") == 1
    out = capsys.readouterr().out
    assert "FAILED gate: migration_dropped" in out and "PASS" not in out


def test_rebalance_midscale_needs_a_strided_subsample(capsys):
    assert rebalance_midscale.main(**REDUCED, device="cpu") == 1
    assert "FAILED: stride 1" in capsys.readouterr().out
