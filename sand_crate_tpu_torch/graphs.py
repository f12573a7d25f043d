"""The compiled step loop: the physics tick captured once as a CUDA graph
and replayed.

The counterpart of the JAX package's compiled step: ``jax.jit(step,
donate_argnums=(0,))`` in its ``Crate`` (sand_crate_tpu/engine.py:97), the
jitted ``lax.scan`` of ``rollout`` and ``trajectory``
(sand_crate_tpu/physics.py:864-914) and the jitted ``vmap(scan(step))`` of
batched crates (sand_crate_tpu/sweep.py:141-152).  A :class:`StepGraph`
holds the state and the coefficients in static buffers on the card:

* warm-up: the first call of a key runs its ticks eagerly on a side stream
  (they are the call's real ticks).  That call also builds and loads the
  kernels (``ops/cuda_build.load``), whose nvcc and ``ctypes`` load must
  never run inside a capture;
* capture: ``torch.cuda.graph`` records the same ticks on the static
  buffers, each followed by a ``copy_`` of the new state back into the
  static state (the donation).  The call's ``torch.Generator`` is
  registered with the graph, so the emitters' draws and the collider noise
  advance on every replay as they do eagerly;
* replay: the recorded launches, in the recorded order, on the same
  buffers, so a replayed tick gives the eager tick's bits.  It returns the
  graph's static Diagnostics, which the next replay overwrites.

What is static to a capture makes up its key (:meth:`StepGraph.key`): the
Scene object (a regrid builds a new one), the pair schedule the
environment selects (``pmajor.schedule()``, read at each call as the
eager step reads it), the chunked sweep bound ``live_rows``, the
generator, the ticks one replay runs, and the buffers' device, dtype and
capacity.  A new key captures anew; a coefficient edit does not, since
:meth:`StepGraph.load` copies it into the captured Params.  A 1M tick's
private memory pool is GBs (1024 batched chunked crates: ~20 GB), so at
most ``MAX_GRAPHS`` graphs live in the process at once: before a capture
the least recently replayed ones are dropped (their pools freed) and are
captured again at their next call, and a graph superseded by a new
``live_rows`` of the same buffers goes at once.

On the CPU the same body runs eagerly: the ticks, each copied back into
the static buffers; nothing is captured.  A capture that fails raises.

The kernel wrappers count a launch where they launch (``pmajor.LAUNCHES``,
``pair_kernel.LAUNCHES``).  A capture launches nothing, so each counter's
rise over the capture is taken back and added once per replay instead:
the counters go on counting kernels that ran.
"""

from __future__ import annotations

import collections
import weakref
from typing import Callable, NamedTuple

import torch

from .ops import pair_kernel, pmajor
from .state import CrateState, Diagnostics, Params

# Captured graphs alive at once in the process.
MAX_GRAPHS = 4
# Static-buffer sets that rollout / trajectory keep (one per state shape).
MAX_ROLLOUT_BUFFERS = 4

# The kernel launch counters that a replay advances by their capture's rise.
COUNTERS = (pmajor.LAUNCHES, pair_kernel.LAUNCHES)
# Graph launches (one cudaGraphLaunch each) and captures since the last reset.
LAUNCHES = {"replay": 0, "capture": 0}

# The frame fields of a trajectory, taken from the state after each frame.
FRAME_FIELDS = ("pos", "alive", "pressure", "segments")

# (state, params, scene, generator, live_rows) -> (new state, diagnostics)
Tick = Callable[..., "tuple[CrateState, Diagnostics]"]

# (id(owner), key) -> weakref to the owning StepGraph, least recently used first.
_LIVE: collections.OrderedDict = collections.OrderedDict()
# buffer signature -> StepGraph, the rollout / trajectory buffers.
_ROLLOUT: collections.OrderedDict = collections.OrderedDict()


class GraphKey(NamedTuple):
    """What a capture is specific to (the Scene and generator by identity)."""

    scene: int
    schedule: str
    live_rows: int | None
    generator: int
    ticks: int
    device: torch.device
    dtype: torch.dtype
    capacity: int


class _Captured(NamedTuple):
    graph: torch.cuda.CUDAGraph
    diag: Diagnostics  # the graph's static outputs
    rises: tuple  # per counter of COUNTERS: {name: launches per replay}
    pins: tuple  # the scene and generator the key names by id


def clone(tup):
    """A CrateState / Params / Diagnostics of fresh copies of ``tup``'s leaves."""
    return type(tup)(*(x.clone() for x in tup))


def _copy_into(dst, src) -> None:
    for name, d, s in zip(dst._fields, dst, src):
        if tuple(d.shape) != tuple(s.shape):
            raise ValueError(f"{name}: shape {tuple(s.shape)} != the static buffer's "
                             f"{tuple(d.shape)}")
        d.copy_(s)


def _snapshot() -> tuple:
    return tuple(dict(c) for c in COUNTERS)


def _evict(keep: int) -> None:
    """Drop the least recently used graphs until at most ``keep`` live."""
    for ident in [k for k, ref in _LIVE.items() if ref() is None]:
        del _LIVE[ident]
    while len(_LIVE) > keep:
        (_, key), ref = _LIVE.popitem(last=False)
        owner = ref()
        if owner is not None:
            owner._graphs.pop(key, None)


class StepGraph:
    """The static buffers of one crate (or one batch of crates) and the
    graphs captured on them.

    ``state`` and ``params`` are taken as the static buffers (not copied):
    a :class:`~sand_crate_tpu_torch.engine.Crate` hands over its own, so
    its state is advanced in place.  ``tick`` is the step, ``physics.step``
    or a vmapped one.  With ``overflow_max`` a static buffer keeps each
    crate's largest ``neighbor_overflow`` since :meth:`reset_overflow`,
    and the returned Diagnostics carry it."""

    def __init__(self, state: CrateState, params: Params, tick: Tick, *,
                 overflow_max: bool = False) -> None:
        self.state = state
        self.params = params
        self.tick = tick
        self.worst = (torch.zeros(state.tick.shape, dtype=torch.int32, device=state.tick.device)
                      if overflow_max else None)
        self._graphs: dict = {}

    @property
    def device(self) -> torch.device:
        return self.state.pos.device

    def key(self, scene, generator, live_rows=None, ticks: int = 1) -> GraphKey:
        """What a capture is specific to: the Scene object, the pair
        schedule, ``live_rows``, the generator, the ticks a replay runs,
        and the buffers' device, dtype and capacity."""
        pos = self.state.pos
        return GraphKey(id(scene), pmajor.schedule(), live_rows, id(generator), ticks,
                        pos.device, pos.dtype, pos.shape[-2])

    def load(self, state: CrateState | None = None, params: Params | None = None) -> None:
        """Copy ``state`` and/or ``params`` into the static buffers (stream
        ordered: the next tick sees them; no capture is made anew)."""
        if state is not None:
            _copy_into(self.state, state)
        if params is not None:
            _copy_into(self.params, params)

    def reset_overflow(self) -> None:
        self.worst.zero_()

    def drop(self) -> None:
        """Free every graph of these buffers; the next call captures anew."""
        for key in list(self._graphs):
            self._drop(key)

    def _drop(self, key) -> None:
        _LIVE.pop((id(self), key), None)
        del self._graphs[key]

    def _body(self, scene, generator, live_rows, ticks: int) -> Diagnostics:
        for _ in range(ticks):
            new, diag = self.tick(self.state, self.params, scene, generator, live_rows)
            _copy_into(self.state, new)
            if self.worst is not None:
                torch.maximum(self.worst, diag.neighbor_overflow, out=self.worst)
        if self.worst is not None:
            diag = diag._replace(neighbor_overflow=self.worst)
        return diag

    def step(self, scene, generator: torch.Generator, live_rows=None, ticks: int = 1
             ) -> Diagnostics:
        """Advance the static state ``ticks`` ticks: one replay of the
        key's graph, or on its first call the eager ticks and the capture.
        Returns the last tick's Diagnostics (on CUDA, the graph's static
        ones: the next call overwrites them)."""
        if self.device.type != "cuda":
            return self._body(scene, generator, live_rows, ticks)
        key = self.key(scene, generator, live_rows, ticks)
        cap = self._graphs.get(key)
        if cap is None:
            return self._capture(key, scene, generator, live_rows, ticks)
        cap.graph.replay()
        _LIVE.move_to_end((id(self), key))
        for counter, rise in zip(COUNTERS, cap.rises):
            for name, n in rise.items():
                counter[name] += n
        LAUNCHES["replay"] += 1
        return cap.diag

    def _capture(self, key, scene, generator, live_rows, ticks: int) -> Diagnostics:
        # Room before the capture (torch.cuda.graph empties the cache of the
        # pools freed here): a graph of these buffers that differs only in
        # its live_rows is superseded (the bound moves once per run), then
        # the least recently used graphs of the process.
        bound_free = key._replace(live_rows=None)
        for old in [k for k in self._graphs if k._replace(live_rows=None) == bound_free]:
            self._drop(old)
        _evict(MAX_GRAPHS - 1)
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            diag = self._body(scene, generator, live_rows, ticks)  # the warm-up: real ticks
        current.wait_stream(side)
        before = _snapshot()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(generator)
        try:
            with torch.cuda.device(self.device), torch.cuda.graph(graph):
                static = self._body(scene, generator, live_rows, ticks)
            after = _snapshot()
        finally:
            for counter, values in zip(COUNTERS, before):
                counter.update(values)  # nothing ran during the capture
        rises = tuple({k: a[k] - b[k] for k in a if a[k] != b[k]} for a, b in zip(after, before))
        self._graphs[key] = _Captured(graph, static, rises, (scene, generator))
        _LIVE[(id(self), key)] = weakref.ref(self)
        LAUNCHES["capture"] += 1
        return diag

    def frames(self, scene, generator, num_frames: int, ticks_per_frame: int = 1) -> dict:
        """Advance ``num_frames * ticks_per_frame`` ticks, ``ticks_per_frame``
        replays of the 1-tick graph a frame, and copy each frame's
        FRAME_FIELDS out of the static state (and the last tick's
        force_dv) on the compute stream, before the next replay: dict of
        stacked fresh tensors, (F, ...) each.  (One replay of a 2-tick
        graph ran a 1M frame no faster than two of the 1-tick graph, and
        would hold a second memory pool; chip_smoke.py phase (o).)"""
        out = {}
        for f in range(num_frames):
            for _ in range(ticks_per_frame):
                diag = self.step(scene, generator)
            fields = {k: getattr(self.state, k) for k in FRAME_FIELDS}
            fields["force_dv"] = diag.force_dv
            for k, v in fields.items():
                if k not in out:
                    out[k] = v.new_empty((num_frames,) + tuple(v.shape))
                out[k][f].copy_(v)
        return out


def rollout_graph(state: CrateState, params: Params, tick: Tick, *,
                  overflow_max: bool = False) -> StepGraph:
    """The StepGraph whose static buffers have the shapes of ``state`` and
    ``params``, with ``state`` and ``params`` copied into them (the
    functional entry points' copy in).  At most MAX_ROLLOUT_BUFFERS
    buffer sets are kept, least recently used dropped first."""
    sig = (tick, overflow_max) + tuple((tuple(t.shape), t.dtype, t.device)
                                       for t in (*state, *params))
    g = _ROLLOUT.get(sig)
    if g is None:
        g = StepGraph(clone(state), clone(params), tick, overflow_max=overflow_max)
        _ROLLOUT[sig] = g
        while len(_ROLLOUT) > MAX_ROLLOUT_BUFFERS:
            _ROLLOUT.popitem(last=False)[1].drop()
    _ROLLOUT.move_to_end(sig)
    g.load(state, params)
    return g
