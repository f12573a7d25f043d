"""The plain reference against the port's own CPU tick on small crates,
and the control (the reference in bfloat16) failing the same numbers."""

from __future__ import annotations

import pytest
import torch

from crate_bench import check, traffic
from crate_bench.reference import step as ref
from crate_bench.reference.world import initial_particles, read_world
from crate_bench.tests import small

CPU = torch.device("cpu")


def _ticks(cfg, seed, warm, n, batched):
    """n checked ticks of the port on the CPU after ``warm`` ticks."""
    from sand_crate_tpu_torch import Crate, Params
    from sand_crate_tpu_torch.sweep import BatchedCrates

    coef = traffic.coefficients(cfg, seed, CPU)
    world = traffic.world_config(cfg)
    if batched:
        prog = BatchedCrates(world, Params(**{k: coef[k] for k in Params._fields}), seed=seed,
                             device=CPU)
        advance = prog.run
    else:
        prog = Crate(world.world_config, seed=seed, device=CPU, forces_mode=cfg["forces_mode"])
        advance = lambda k: [prog.physics_tick() for _ in range(k)]  # noqa: E731
    advance(warm)
    out = []
    for _ in range(n):
        before = check.snapshot(prog.state, batched)
        gen = prog.generator.get_state()
        advance(1)
        out.append((before, check.snapshot(prog.state, batched), gen))
    return coef, out


CASES = [
    ("dam_break_pmajor", lambda: small.dam_break(3000, "pmajor"), 40, False),
    ("dam_break_dense", lambda: small.dam_break(2000, "dense"), 40, False),
    ("stirring_cups_spawning", lambda: small.stirring_cups(3), 60, True),
]


@pytest.mark.parametrize("name,make,warm,batched", CASES, ids=[c[0] for c in CASES])
def test_reference_agrees_with_the_port_and_the_control_does_not(name, make, warm, batched):
    cfg = make()
    limits = cfg["limits"]
    coef, ticks = _ticks(cfg, 2**31 + 5, warm, 2, batched)
    world = read_world(cfg["world"])
    for before, after, gen in ticks:
        jit = check.jitter_for(cfg["jitter"], before, after, gen)
        want = ref.step(before, coef, world, jit)
        got = check.numbers(check.by_input_slot(before, after), want, before, coef)
        assert got["flagged_share"] < 0.05
        assert check.judge(got, limits), got
        assert got["vel_gap"] < 0.1 * limits["vel_gap"], got
        low = check.numbers(ref.step(before, coef, world, jit, dtype=torch.bfloat16), want,
                            before, coef)
        assert not check.judge(low, limits), low


def test_start_matches_the_initial_blocks():
    from sand_crate_tpu_torch import Crate

    cfg = small.dam_break(1500)
    seed = 2**31 + 9
    crate = Crate(traffic.world_config(cfg).world_config, seed=seed, device=CPU)
    coef = traffic.coefficients(cfg, seed, CPU)
    start = check.snapshot(crate.state, False)
    world = read_world(cfg["world"])
    p0, s0 = initial_particles(world, seed), world.segments0
    assert check.start_gap(start, p0, s0, coef) < 1e-3
    assert check.start_gap(start, p0 + 1e-3, s0, coef) > cfg["limits"]["start_gap"]
    low = torch.as_tensor(p0).bfloat16().double()
    assert check.start_gap(start, low, s0, coef) > cfg["limits"]["start_gap"]


def test_start_matches_the_placed_cup():
    from sand_crate_tpu_torch import Params
    from sand_crate_tpu_torch.sweep import BatchedCrates

    cfg = small.stirring_cups(2)
    coef = traffic.coefficients(cfg, 3, CPU)
    crates = BatchedCrates(traffic.world_config(cfg), Params(**{k: coef[k] for k in Params._fields}),
                           seed=3, device=CPU)
    start = check.snapshot(crates.state, True)
    world = read_world(cfg["world"])
    p0, s0 = initial_particles(world, 3), world.segments0
    gap = check.start_gap(start, p0, s0, coef)
    low = check.start_gap(start, p0, torch.as_tensor(s0).bfloat16().double(), coef)
    assert gap < 1e-5 < cfg["limits"]["start_gap"] < low
