"""Device milliseconds a tick of the pair glue in the pair stage
(``crate_bench/stages.py``): the backend's glue around its pair kernels
(p-major ranges and feature rows, noise draws, the vmapped stacks), the
pair kernels themselves left out; the operations up to each
``stage_mark_kernel<stage::pairs>``."""

from crate_bench import stages


def read(view):
    return stages.ms_per_tick(view, "pairs")
