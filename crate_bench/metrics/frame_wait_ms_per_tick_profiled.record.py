"""Host milliseconds a tick that ``Crate.stream_frames`` blocks waiting
for a chunk's frames to reach pinned memory (``done.synchronize()``), as
the profiled host spends them: the ``frames.wait`` spans of the traced
stretch (``crate_bench/spans.py``) over its ticks.  The profiler slows the
host's dispatch, so the host waits less here than it does unprofiled;
compare it only with itself."""

from crate_bench import spans


def read(view):
    recs = spans.records() if view.ops else None
    if recs is None or not spans.closed(recs, "frames.wait"):
        return None
    return spans.span_ms(recs, "frames.wait") / view.ticks
