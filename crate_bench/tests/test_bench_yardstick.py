"""The yardstick's counts on small hand-checked inputs, the frozen
rescale of the dam break, and the per-layer readers on a made-up trace."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from crate_bench import registry, yardstick
from crate_bench.trace import Op, View

BENCH = registry.load_benchmark()


def test_pair_work_counts_ordered_pairs_within_a_diameter():
    # crate 0: a at 0, b at 0.9 d, c at 1.8 d (a-c too far), d dead on b;
    # crate 1: two at exactly d (counted), one far.
    d = 0.01
    pos = torch.tensor([[[0.5, 0.5], [0.5 + 0.9 * d, 0.5], [0.5 + 1.8 * d, 0.5], [0.509, 0.5]],
                        [[0.2, 0.2], [0.2, 0.2 + d], [0.9, 0.9], [0.0, 0.0]]])
    alive = torch.tensor([[True, True, True, False], [True, True, True, False]])
    n, pairs = yardstick.pair_work(pos.double(), alive, torch.tensor([d, d]))
    assert n == 6
    assert pairs == 2 * 2 + 2  # a-b, b-c both ways; the crate-1 pair both ways


def test_pair_work_keeps_crates_apart():
    pos = torch.tensor([[[0.5, 0.5]], [[0.5, 0.5]]]).double()
    alive = torch.ones((2, 1), dtype=torch.bool)
    assert yardstick.pair_work(pos, alive, torch.tensor([0.01, 0.01])) == (2, 0)


def test_bound_takes_the_slower_of_bytes_and_operations():
    t, by = yardstick.bound(3.35e12, 0.0)
    assert t == pytest.approx(1.0) and by == "bytes"
    t, by = yardstick.bound(0.0, 67e12 * 2)
    assert t == pytest.approx(2.0) and by == "operations"
    t, by = yardstick.pair_min_seconds(1_000_000, 5_000_000)
    assert by == "bytes" and t == pytest.approx(40e6 / 3.35e12)


def test_dam_break_rescale_is_the_configuration_file():
    cfg = registry.load_config(BENCH, "dam_break_1m")
    r = yardstick.dam_break_rescale(cfg["rescale"]["n_target"])
    w = cfg["world"]
    blk = w["initial_particles"][0]["block"]
    assert blk["spacing"] == r["spacing"]
    assert w["coefficients"]["particle_radius"] == r["particle_radius"]
    assert w["coefficients"]["max_particles"] == r["max_particles"]
    n = len(np.arange(blk["x0"], blk["x1"], blk["spacing"])) * len(
        np.arange(blk["y0"], blk["y1"], blk["spacing"]))
    assert n == cfg["expect"]["alive"] == 1_001_700
    assert -(-r["max_particles"] // 128) * 128 == cfg["expect"]["capacity"]


def test_random_ranges_are_the_frozen_defaults():
    cfg = registry.load_config(BENCH, "stirring_cup_b1024")
    assert cfg["random_ranges"] == {
        "viscosity": [2.0, 12.0], "pressure_amplifier": [10.0, 60.0],
        "surface_smoothing": [20.0, 150.0], "target_pressure": [-6.0, 3.0],
        "ignored_pressure": [0.05, 0.4]}


def _view():
    us = 1e3  # one tick of 1 ms: pair 0.2 ms, update 0.1, a sort 0.3, a copy 0.1
    ops = [Op("void (anonymous namespace)::pm_kernel<0, 6, true>(...)", "kernel", 0, 0.1 * us),
           Op("void (anonymous namespace)::pm_kernel<1, 2, true>(...)", "kernel", 0.1 * us,
              0.2 * us),
           Op("void (anonymous namespace)::kick_kernel<false>(KickArgs)", "kernel", 0.2 * us,
              0.3 * us),
           Op("cub::DeviceRadixSortOnesweepKernel", "kernel", 0.3 * us, 0.6 * us),
           Op("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 0.6 * us, 0.7 * us)]
    # the traced stretch took 1.6 ms on the host clock, as many units untraced 1 ms
    return View(ops, seconds=1.6e-3, ticks=1, untraced_seconds=1e-3,
                pair_work={"alive": 1000, "pairs": 5000})


def _read(name, view):
    return registry.metric_module(name).read(view)


def test_per_layer_readers():
    v = _view()
    assert _read("launches_per_tick", v) == 5
    assert _read("pair_ms_per_tick", v) == pytest.approx(0.2)
    assert _read("update_ms_per_tick", v) == pytest.approx(0.1)
    assert _read("glue_ms_per_tick", v) == pytest.approx(0.3)
    assert _read("d2h_ms_per_tick", v) == pytest.approx(0.1)
    assert _read("device_idle_share", v) == pytest.approx(30.0)
    assert _read("host_ms_per_tick.live", v) == pytest.approx(0.3)
    least = 1000 * 40 / 3.35e12
    assert _read("pair_roofline_share", v) == pytest.approx(100 * least / 0.2e-3)


def test_a_reader_with_nothing_to_read_returns_nothing():
    v = View([], seconds=1e-3, ticks=1, untraced_seconds=1e-3)
    for m in BENCH["per_layer"]:
        assert _read(m["name"], v) is None
    assert math.isfinite(_read("pair_ms_per_tick", _view()))


def test_breakdown_names_idle_gaps_by_the_operation_before_them():
    from crate_bench.trace import breakdown

    us = 1e3
    ops = [Op("pm_kernel", "kernel", 0, 0.1 * us), Op("kick_kernel", "kernel", 0.05 * us, 0.2 * us),
           Op("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 0.2 * us, 0.25 * us),
           Op("pm_kernel", "kernel", 0.75 * us, 0.85 * us),
           Op("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 0.85 * us, 0.9 * us),
           Op("pm_kernel", "kernel", 1.2 * us, 1.3 * us)]
    b = breakdown(View(ops, seconds=1.3e-3, ticks=2))
    assert b["device_ops"][0] == ["pm_kernel", pytest.approx(0.3e-3)]
    assert b["idle_gaps"] == [["after Memcpy DtoH (Device -> Pageable)", pytest.approx(0.8e-3)]]
