"""The card's idle time that no span of the program explains, in %: of
the gaps between the union of the traced stretch's device operations, the
part that no program span (``crate_bench/spans.py``, on the trace's clock)
covers, over all of those gaps.  What is left is the caller's own time
between calls of the port, or host work the port has no span for."""

from crate_bench import spans


def read(view):
    recs = spans.records() if view.ops else None
    if recs is None:
        return None
    cover = spans.span_intervals(recs)
    busy = view.busy()
    gaps = [(end, start) for (_, end, _), (start, _, _) in zip(busy, busy[1:])]
    idle = sum(b - a for a, b in gaps)
    if not cover:
        return None
    if idle <= 0:
        return 0.0
    return 100.0 * (idle - sum(spans.covered(g, cover) for g in gaps)) / idle
