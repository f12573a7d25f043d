"""Whole runs on the CPU, with the timed path broken underneath, come out
not correct; the same runs unbroken come out correct.

The faults a cell of this benchmark can have: a tick that returns its
state unchanged; half of the batch left out (half of the crates of a
batch, half of the particles of one crate); an answer altered where it is
produced (16 particles' velocities).  The exchange between chips is not
one: every cell runs on one chip.  The run skips only the look for a card
(``run.run_cell`` on the CPU, at a small size)."""

from __future__ import annotations

import pytest
import torch

from crate_bench import registry, run
from crate_bench.tests import small

BENCH = registry.load_benchmark()
CPU = torch.device("cpu")


def _leave_half(state, new, batched):
    if batched:
        B = new.pos.shape[0]
        keep = torch.arange(B, device=new.pos.device) < B // 2
        return type(new)(*(torch.where(keep.view((B,) + (1,) * (n.dim() - 1)), o, n)
                           for o, n in zip(state, new)))
    old_at = torch.argsort(state.uid.long())[new.uid.long()]
    skip = (new.uid % 2 == 0)[:, None]
    return new._replace(pos=torch.where(skip, state.pos[old_at], new.pos),
                        vel=torch.where(skip, state.vel[old_at], new.vel))


def _alter(new, batched):
    vel, alive = (new.vel[0], new.alive[0]) if batched else (new.vel, new.alive)
    idx = torch.nonzero(alive).squeeze(1)[:16]
    vel = vel.clone()
    vel[idx] += 1.0
    return new._replace(vel=torch.cat([vel[None], new.vel[1:]]) if batched else vel)


def _faulty(real, kind, batched):
    def tick(state, params, scene, generator, live_rows=None):
        new, diag = real(state, params, scene, generator, live_rows)
        if kind == "unchanged":
            return state, diag
        if kind == "half":
            return _leave_half(state, new, batched), diag
        return _alter(new, batched), diag
    return tick


CELLS = {"dam_break_1m.live": lambda: small.dam_break(1500),
         "dam_break_1m.record": lambda: small.dam_break(1500),
         "stirring_cup_b1024.datagen": lambda: small.stirring_cups(4)}


@pytest.mark.parametrize("cell", list(CELLS))
@pytest.mark.parametrize("fault", [None, "unchanged", "half", "altered"])
def test_a_broken_tick_is_not_correct(cell, fault, monkeypatch):
    from sand_crate_tpu_torch import engine, sweep

    batched = cell.endswith("datagen")
    if fault is not None:
        mod, name = (sweep, "batched_step") if batched else (engine, "step")
        monkeypatch.setattr(mod, name, _faulty(getattr(mod, name), fault, batched))
    res = run.run_cell(BENCH, cell, 2**31 + 11, 0.2, False, CPU, cfg=CELLS[cell]())
    assert res["correct"] is (fault is None), res["checks"]


def test_a_frame_overwritten_in_flight_is_not_correct(monkeypatch):
    """The recording's fault: a chunk's frames written into the buffer of
    the chunk before, which is still waiting to be yielded."""
    from sand_crate_tpu_torch import graphs

    real, kept = graphs.StepGraph.frames, {}

    def reused(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        if not kept or any(kept[k].shape != v.shape for k, v in out.items()):
            kept.clear()
            kept.update(out)
        else:
            for k, v in out.items():
                kept[k].copy_(v)
        return kept

    monkeypatch.setattr(graphs.StepGraph, "frames", reused)
    cell = "dam_break_1m.record"
    res = run.run_cell(BENCH, cell, 2**31 + 11, 0.2, False, CPU, cfg=CELLS[cell]())
    assert res["correct"] is False and res["checks"]["frame_gap"]["value"] > 0, res["checks"]
