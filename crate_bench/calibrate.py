"""Readings that the limits of ``correct`` are set from, on the card.

    python3 -m crate_bench.calibrate --workload <name> --seconds <s> --seeds <n> [<n> ...]

For each seed, one run of the cell as ``run.py`` makes it (set-up, a
window of ``--seconds``, the checked ticks), in one process, printing one
JSON line: the program's numbers (``program``) and the control's
(``control``: the reference computed in bfloat16, the precision below the
configuration's float32, put in the program's place and compared with the
float64 reference on the same checked ticks).  A limit lies above the
largest program reading over a dozen seeds or more and below the smallest
control reading.  The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    a = ap.parse_args(argv)
    run.clean_environment()
    import torch

    from . import registry

    if not torch.cuda.is_available():
        print("# needs a CUDA device", file=sys.stderr)
        return 2
    bench = registry.load_benchmark()
    device = torch.device("cuda", 0)
    for seed in a.seeds:
        res = run.run_cell(bench, a.workload, seed, a.seconds, False, device, control=True)
        print(json.dumps({"workload": a.workload, "seed": seed, "correct": res["correct"],
                          "program": res["program"], "control": res["control"]}), flush=True)
        torch.cuda.reset_peak_memory_stats(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
