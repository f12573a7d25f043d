"""The pair glue of a traced stretch split by the tick's stage marks.

The tick marks the end of each stage on its stream with an empty kernel,
``stage_mark_kernel<stage::S>`` (``sand_crate_tpu_torch/ops/stage_mark.py``),
S one of lifecycle, sort (the sorted backends only), pairs and tick.  A
device operation belongs to the stage of the next mark after its start;
those after the stretch's last mark belong to the stage that followed that
mark's stage before (the next tick's lifecycle).  Each stage metric sums
the glue operations of its stage: what ``glue_ms_per_tick`` counts (neither
a pair-sum nor an update kernel, nor a copy to the host), the marks left
out, so the stages partition ``glue_ms_per_tick`` less the marks' own time.
"""

from __future__ import annotations

import re

MARK = re.compile(r"stage_mark_kernel<(?:\w+::)*(\w+)>")


def stage_of(op):
    """The stage a mark ends, or None for any other operation."""
    if op.cat != "kernel":
        return None
    m = MARK.search(op.name)
    return m.group(1) if m else None


def is_glue(view, op) -> bool:
    """Whether ``glue_ms_per_tick`` counts ``op``."""
    named = view.metric("pair_ms_per_tick").KERNELS + view.metric("update_ms_per_tick").KERNELS
    return (not (op.cat == "kernel" and any(n in op.name for n in named))
            and not (op.cat == "gpu_memcpy" and "DtoH" in op.name))


def split(view):
    """{stage: glue microseconds} over the stretch, and the marks' own
    operations; (None, []) without a mark."""
    ops = sorted(view.ops, key=lambda o: o.start)
    marks = [(o, stage_of(o)) for o in ops]
    order = [s for _, s in marks if s is not None]
    if not order:
        return None, []
    totals = dict.fromkeys(order, 0.0)
    pending = 0.0
    for o, s in marks:
        if s is not None:
            totals[s] += pending
            pending = 0.0
        elif is_glue(view, o):
            pending += o.end - o.start
    last = order[-1]
    after = order[order.index(last) + 1] if order.index(last) + 1 < len(order) else order[0]
    totals[after] += pending
    return totals, [o for o, s in marks if s is not None]


def ms_per_tick(view, stage: str):
    """Glue milliseconds a tick in ``stage``, or None where no mark of it ran."""
    totals, _ = split(view)
    if not totals or stage not in totals:
        return None
    return totals[stage] * 1e-3 / view.ticks
