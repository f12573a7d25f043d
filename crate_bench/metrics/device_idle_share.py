"""The card's idle share, in %: 100 x (1 - the union of its kernel, copy
and fill intervals in the traced stretch over the wall time of as many
units run just before it without the profiler).  The traced stretch's own
wall time is not the denominator: the profiler lengthens the host's part
of a tick."""


def read(view):
    if not view.ops or view.untraced_seconds <= 0:
        return None
    return 100.0 * (1.0 - view.busy_seconds() / view.untraced_seconds)
