"""Device milliseconds a tick of the pair glue in the sort stage of the
sorted backends (``crate_bench/stages.py``): the cell ids, the stable sort,
the permutation gathers and the sorted ghost pass's glue; the operations
between the lifecycle mark and each ``stage_mark_kernel<stage::sort>``."""

from crate_bench import stages


def read(view):
    return stages.ms_per_tick(view, "sort")
