"""On the card, at each cell's own size: a short run is correct, and the
control (the reference in bfloat16 put in the program's place) is not.

    python -m pytest -m cuda crate_bench/tests/test_bench_card.py -q

Skips without an NVIDIA GPU (the fixture decides, at run time)."""

from __future__ import annotations

import pytest

from crate_bench import check, registry, run

BENCH = registry.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    run.clean_environment()
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_at_the_cells_size(card, cell):
    res = run.run_cell(BENCH, cell, 2**31 + 101, 2.0, False, card, control=True)
    limits = registry.load_config(BENCH, registry.workload(BENCH, cell)["config"])["limits"]
    assert res["correct"], res["checks"]
    assert not check.judge(res["control"], limits), res["control"]
