"""Stage marks of the tick: a named empty kernel at each stage's end.

A replayed CUDA graph has no host frames, so a device trace alone cannot
say which stage of ``physics.step`` launched a glue operation.  The tick
marks its stage ends on its stream with ``stage_mark_kernel<stage::S>``
(``csrc/kick.cu``, the velocity update's build unit, so set-up builds no
more sources), for S in :data:`STAGES`:

* ``lifecycle``: spawn, cull, the bodies and the ghost phase;
* ``sort``: cell ids, the stable sort, the permutation gathers and the
  sorted ghost recompute (the sorted backends only);
* ``pairs``: the backend's pair stage (ranges, feature rows, noise draws,
  stacks and its pair kernels);
* ``tick``: the velocity update, ``finish_tick`` and the copy into the
  static state (``graphs.StepGraph``).

A device operation belongs to the stage of the next mark on its stream;
what the host enqueues between two replays falls into the next tick's
``lifecycle``.  The marks are captured in every graph, tracing or not (a
capture only while tracing would capture anew inside a traced stretch).

:func:`mark` calls the ``sand_crate::stage_mark`` operator, whose vmap rule
marks once for a vmapped batch.  On a CUDA tensor it launches the mark
(counted in :data:`LAUNCHES`); on the CPU it launches nothing.  Either way,
while tracing is on it records the host event ``mark.<stage>``
(``diagnostics.event``).
"""

from __future__ import annotations

import ctypes

import torch

from .. import diagnostics
from . import cuda_build

STAGES = ("lifecycle", "sort", "pairs", "tick")
# The host event of each mark while tracing is on.
EVENTS = tuple("mark." + s for s in STAGES)
# Marks launched on the card, by stage (graphs.COUNTERS: replays count them).
LAUNCHES = dict.fromkeys(STAGES, 0)


def _lib():
    lib = cuda_build.load("kick")
    if lib.sc_stage_mark.argtypes is None:
        lib.sc_stage_mark.argtypes = [ctypes.c_int, ctypes.c_void_p]
        lib.sc_stage_mark.restype = ctypes.c_int
    return lib


@torch.library.custom_op("sand_crate::stage_mark", mutates_args=())
def _op(anchor: torch.Tensor, stage: int) -> None:
    """Mark the end of ``STAGES[stage]`` on the current stream of
    ``anchor``'s device (its values are not read)."""
    diagnostics.event(EVENTS[stage])
    if anchor.device.type == "cuda":
        with torch.cuda.device(anchor.device):
            err = _lib().sc_stage_mark(stage, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"stage_mark kernel failed: cudaError {err}")
        LAUNCHES[STAGES[stage]] += 1


def _vmap_rule(info, in_dims, anchor, stage):
    _op(anchor, stage)
    return None, None


_op.register_vmap(_vmap_rule)


def mark(anchor: torch.Tensor, stage: str) -> None:
    """Mark the end of ``stage`` (one of :data:`STAGES`) on ``anchor``'s
    device: any tensor of the tick, batched or not."""
    _op(anchor, STAGES.index(stage))
