"""Host milliseconds a tick in ``Crate.set_debug_prints`` (the overlay
text: the tick, four diagnostics scalars and thirteen coefficients read
back, the timer and force reports), as the profiled host spends them: the
``tick.prints`` spans of the traced stretch (``crate_bench/spans.py``)
over its ticks.  The profiler's callbacks slow the reads inside the span,
so this reads higher than the same span under ``diagnostics.tracing()``
alone; compare it only with itself."""

from crate_bench import spans


def read(view):
    recs = spans.records() if view.ops else None
    if recs is None or not spans.closed(recs, "tick.prints"):
        return None
    return spans.span_ms(recs, "tick.prints") / view.ticks
