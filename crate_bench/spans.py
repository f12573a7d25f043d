"""What the per-layer metrics read of the program's own tracing.

The port records spans and events (``sand_crate_tpu_torch/diagnostics.py``)
while a ``torch.profiler`` session records, so the traced stretch of a
``--trace 1`` run (``trace.run_traced``) is its latest session: every span
of the entry points (``tick.launch``, ``tick.readback``, ``tick.prints``,
``frames.wait``, ``batch.launch``, ...) and an event a synchronising host
read (``read.<site>``).  Their times are unix nanoseconds; the trace's
``ts`` are microseconds after its base (``diagnostics.trace_base``), so
:func:`span_intervals` puts them on the device operations' clock.

A program that keeps no such store (an older port) gives None here, and
the metrics that read it give nothing.
"""

from __future__ import annotations


def _diagnostics():
    try:
        from sand_crate_tpu_torch import diagnostics
    except ImportError:
        return None
    return diagnostics if hasattr(diagnostics, "session") else None


def records():
    """The program's records of the traced stretch, or None where it keeps
    none (or recorded nothing)."""
    diagnostics = _diagnostics()
    if diagnostics is None:
        return None
    return diagnostics.session() or None


def closed(recs, name=None) -> list:
    """The closed spans of ``recs`` (named ``name``, if given)."""
    return [r for r in recs if r.kind == "span" and r.end >= 0
            and (name is None or r.name == name)]


def span_ms(recs, name: str) -> float:
    """The summed milliseconds of the spans named ``name``."""
    return sum(r.end - r.start for r in closed(recs, name)) * 1e-6


def events(recs, prefix: str) -> list:
    return [r for r in recs if r.kind == "event" and r.name.startswith(prefix)]


def span_intervals(recs) -> list:
    """The union of every closed span's interval, in microseconds on the
    device trace's clock, in order."""
    diagnostics = _diagnostics()
    done = closed(recs)
    if not done or diagnostics is None:
        return []
    base = diagnostics.trace_base(done[0].start)
    out = []
    for s, e in sorted(((r.start - base) / 1e3, (r.end - base) / 1e3) for r in done):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def covered(gap: tuple, intervals: list) -> float:
    """How much of ``gap`` (start, end) the sorted disjoint ``intervals`` cover."""
    s, e = gap
    return sum(max(0.0, min(e, b) - max(s, a)) for a, b in intervals if a < e and b > s)
