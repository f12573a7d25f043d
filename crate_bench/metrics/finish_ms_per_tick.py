"""Device milliseconds a tick of the pair glue in the tick's last stage
(``crate_bench/stages.py``): around the velocity update (itself left out),
``finish_tick`` and the copy of the new state into the graph's static
state; the operations up to each ``stage_mark_kernel<stage::tick>``."""

from crate_bench import stages


def read(view):
    return stages.ms_per_tick(view, "tick")
