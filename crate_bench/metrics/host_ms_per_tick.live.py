"""Milliseconds a tick in which the card waits for the host: the wall time
of the units run untraced just before the traced stretch less the union
of the traced stretch's device operations, over its ticks (the same
number of units).  In the live cell each ``Crate.physics_tick()`` ends in
its own read-back, so this is the host's part of a tick: the graph
launch, the ``force_dv`` read-back and ``set_debug_prints``."""


def read(view):
    if not view.ops or view.untraced_seconds <= 0:
        return None
    return (view.untraced_seconds - view.busy_seconds()) * 1e3 / view.ticks
