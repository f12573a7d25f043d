"""Device milliseconds a tick of the pair glue in the tick's lifecycle
stage (``crate_bench/stages.py``): spawn (its top-k), cull, the bodies,
the ghost phase's glue, and what the host enqueues between two replays
(the frame copies of ``Crate.stream_frames``, ``BatchedCrates.run``'s
clone); the operations up to each ``stage_mark_kernel<stage::lifecycle>``."""

from crate_bench import stages


def read(view):
    return stages.ms_per_tick(view, "lifecycle")
