"""Synchronising device-to-host reads a tick that the port makes at its
own sites (``diagnostics.host_read``: ``force_dv``, the tick, the
diagnostics scalars and the coefficients of ``Crate.set_debug_prints``,
``BatchedCrates.live_rows``' bounds): the ``read.<site>`` events of the
traced stretch (``crate_bench/spans.py``) over its ticks."""

from crate_bench import spans


def read(view):
    recs = spans.records() if view.ops else None
    if recs is None:
        return None
    return len(spans.events(recs, "read.")) / view.ticks
