"""The compiled step loop: the physics tick captured once as a CUDA graph
and replayed.

The counterpart of the JAX package's compiled step: ``jax.jit(step,
donate_argnums=(0,))`` in its ``Crate`` (sand_crate_tpu/engine.py:97), the
jitted ``lax.scan`` of ``rollout`` and ``trajectory``
(sand_crate_tpu/physics.py:864-914), the jitted ``vmap(scan(step))`` of
batched crates (sand_crate_tpu/sweep.py:141-152), the jitted band step
(``jax.jit(shard_map(spatial_step))``, sand_crate_tpu/spatial.py:988-1057)
and the jitted phase programs of the instrumented tick
(sand_crate_tpu/instrument.py:27-66).  A :class:`GraphSet` holds the
graphs captured on one set of static buffers on the card, by key:

* warm-up: the first call of a key runs its body eagerly on a side stream
  (the call's real work).  That call also builds and loads the kernels
  (``ops/cuda_build.load``), whose nvcc and ``ctypes`` load must never run
  inside a capture;
* capture: ``torch.cuda.graph`` records the same body on the static
  buffers, the new state copied back into the static state (the
  donation).  The call's generators are registered with the graph, so the
  emitters' draws and the collider noise advance on every replay as they
  do eagerly;
* replay: the recorded launches, in the recorded order, on the same
  buffers, so a replay gives the eager body's bits.  It returns the
  graph's static outputs, which the next replay overwrites.

Three kinds of owner: :class:`StepGraph` (a crate's or a batch's tick over
its state and Params), :class:`BandGraph` (``spatial.SpatialStep`` on a
LocalGroup: every shard's band tick in one graph over the split state,
the Params and the input edges) and ``instrument.PhaseGraphs`` (the
instrumented tick: one graph a phase, captured in tick order into one
memory pool and replayed in that order).

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

The band step and the phases have keys of their own (``BandKey``: the
shard count, ``mig_cap``, ``rebalance``, ``bh_alloc``, the Scene, the
schedule and the shard generators).  On the CPU the same body runs
eagerly: the ticks, each copied back into the static buffers; nothing is
captured.  A capture that fails raises.

The kernel wrappers count a launch where they launch (``pmajor.LAUNCHES``,
``pair_kernel.LAUNCHES``, ``boundary.LAUNCHES``, ``kick.LAUNCHES``,
``pair_batch.LAUNCHES``, the stage marks' ``stage_mark.LAUNCHES``).  A capture launches
nothing, so each counter's rise over the capture is taken back and added
once per replay instead: the counters go on counting kernels that ran.
:data:`LAUNCHES` counts replays, captures and evictions; a capture (its
warm-up and record) is the span ``graph.capture`` and an eviction
``graph.evict`` (``diagnostics.span``).  :class:`StepGraph` marks the end
of each tick on the stream (``stage_mark``: ``tick``) after the copy into
the static state.
"""

from __future__ import annotations

import collections
import weakref
from typing import Callable, NamedTuple

import torch

from . import diagnostics
from .ops import boundary, kick, pair_batch, pair_kernel, pmajor, stage_mark
from .state import CrateState, Diagnostics, Params

# Captured graphs alive at once in the process.
MAX_GRAPHS = 4
# Static-buffer sets that rollout / trajectory keep (one per state shape).
MAX_ROLLOUT_BUFFERS = 4

# The kernel launch counters that a replay advances by their capture's rise.
COUNTERS = (pmajor.LAUNCHES, pair_kernel.LAUNCHES, boundary.LAUNCHES, kick.LAUNCHES,
            pair_batch.LAUNCHES, stage_mark.LAUNCHES)
# Graph launches (one cudaGraphLaunch each), captures, and graphs evicted to
# make room for a capture, since the last reset.
LAUNCHES = {"replay": 0, "capture": 0, "evict": 0}

# The frame fields of a trajectory, taken from the state after each frame.
FRAME_FIELDS = ("pos", "alive", "pressure", "segments")

# (state, params, scene, generator, live_rows) -> (new state, diagnostics)
Tick = Callable[..., "tuple[CrateState, Diagnostics]"]

# (id(owner), key) -> weakref to the owning GraphSet, least recently used first.
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


class BandKey(NamedTuple):
    """What a band step's capture is specific to (the Scene and the shard
    generators by identity)."""

    shards: int
    mig_cap: int
    rebalance: bool
    bh_alloc: int | None
    scene: int
    schedule: str
    generators: tuple
    device: torch.device
    capacity: int


class _Captured(NamedTuple):
    graph: torch.cuda.CUDAGraph
    out: object  # the body's static outputs
    rises: tuple  # per counter of COUNTERS: {name: launches per replay}
    pins: tuple  # what the key names by id (the scene, the generators)


def clone(tup):
    """A CrateState / Params / Diagnostics of fresh copies of ``tup``'s leaves."""
    return type(tup)(*(x.clone() for x in tup))


def copy_into(dst, src) -> None:
    """Copy every leaf of ``src`` into the same-shaped leaf of ``dst``."""
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
        if owner is not None and key in owner._graphs:
            with diagnostics.span("graph.evict"):
                del owner._graphs[key]
            LAUNCHES["evict"] += 1


def warm_up(device, body):
    """``body()`` run eagerly on a side stream, the current stream waiting
    for it: the call's real work, which also builds and loads the kernels
    (nvcc and the ``ctypes`` load must never run inside a capture)."""
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        out = body()
    current.wait_stream(side)
    return out


def record(device, body, generators=(), pins=(), pool=None) -> _Captured:
    """Capture ``body()`` into a new CUDA graph (nothing runs), with each
    of ``generators`` registered, in the memory pool ``pool`` (None: a
    private one).  The counters' rise over the capture is taken back and
    kept for the replays.  A capture that fails raises."""
    before = _snapshot()
    graph = torch.cuda.CUDAGraph()
    for generator in generators:
        graph.register_generator_state(generator)
    try:
        with torch.cuda.device(device), torch.cuda.graph(graph, pool=pool):
            out = body()
        after = _snapshot()
    finally:
        for counter, values in zip(COUNTERS, before):
            counter.update(values)  # nothing ran during the capture
    rises = tuple({k: a[k] - b[k] for k in a if a[k] != b[k]} for a, b in zip(after, before))
    LAUNCHES["capture"] += 1
    return _Captured(graph, out, rises, tuple(pins))


def launch(cap: _Captured):
    """One replay of a captured graph; the counters rise by its capture's
    rise.  Returns its static outputs."""
    cap.graph.replay()
    for counter, rise in zip(COUNTERS, cap.rises):
        for name, n in rise.items():
            counter[name] += n
    LAUNCHES["replay"] += 1
    return cap.out


class GraphSet:
    """The graphs captured on one set of static buffers (on the owner's
    ``device``), by key.  Each key holds one memory pool, and at most
    MAX_GRAPHS keys live in the process (least recently used dropped
    first, captured again at their next call)."""

    def __init__(self) -> None:
        self._graphs: dict = {}

    def drop(self) -> None:
        """Free every graph of these buffers; the next call captures anew."""
        for key in list(self._graphs):
            self._drop(key)

    def _drop(self, key) -> None:
        _LIVE.pop((id(self), key), None)
        del self._graphs[key]

    def _lookup(self, key):
        """The key's captured graphs (marked most recently used), or None."""
        caps = self._graphs.get(key)
        if caps is not None:
            _LIVE.move_to_end((id(self), key))
        return caps

    def _make_room(self) -> None:
        """Drop least recently used graphs so that a capture keeps at most
        MAX_GRAPHS live (torch.cuda.graph empties the cache of the pools
        freed here)."""
        _evict(MAX_GRAPHS - 1)

    def _keep(self, key, caps) -> None:
        self._graphs[key] = caps
        _LIVE[(id(self), key)] = weakref.ref(self)

    def run(self, key, body, generators=(), pins=()):
        """``body()``, which reads and writes the static buffers on
        ``self.device`` only and returns static outputs.  On the card: one
        replay of ``key``'s graph, or on the key's first call the eager body
        on a side stream (its result is returned) and then the capture.
        Elsewhere: ``body()``."""
        if self.device.type != "cuda":
            return body()
        cap = self._lookup(key)
        if cap is not None:
            return launch(cap)
        self._make_room()
        with diagnostics.span("graph.capture"):
            out = warm_up(self.device, body)
            self._keep(key, record(self.device, body, generators, pins))
        return out


class StepGraph(GraphSet):
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
        super().__init__()
        self.state = state
        self.params = params
        self.tick = tick
        self.worst = (torch.zeros(state.tick.shape, dtype=torch.int32, device=state.tick.device)
                      if overflow_max else None)

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
            copy_into(self.state, state)
        if params is not None:
            copy_into(self.params, params)

    def reset_overflow(self) -> None:
        self.worst.zero_()

    def _body(self, scene, generator, live_rows, ticks: int) -> Diagnostics:
        for _ in range(ticks):
            new, diag = self.tick(self.state, self.params, scene, generator, live_rows)
            copy_into(self.state, new)
            if self.worst is not None:
                torch.maximum(self.worst, diag.neighbor_overflow, out=self.worst)
            stage_mark.mark(self.state.tick, "tick")
        if self.worst is not None:
            diag = diag._replace(neighbor_overflow=self.worst)
        return diag

    def step(self, scene, generator: torch.Generator, live_rows=None, ticks: int = 1
             ) -> Diagnostics:
        """Advance the static state ``ticks`` ticks: one replay of the
        key's graph, or on its first call the eager ticks and the capture.
        Returns the last tick's Diagnostics (on CUDA, the graph's static
        ones: the next call overwrites them)."""
        key = self.key(scene, generator, live_rows, ticks)
        if self.device.type == "cuda" and key not in self._graphs:
            # A graph of these buffers that differs only in its live_rows is
            # superseded (the bound moves once per run).
            bound_free = key._replace(live_rows=None)
            for old in [k for k in self._graphs if k._replace(live_rows=None) == bound_free]:
                self._drop(old)
        return self.run(key, lambda: self._body(scene, generator, live_rows, ticks),
                        (generator,), (scene, generator))

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


class BandGraph(GraphSet):
    """The static buffers of a band step on a
    :class:`~sand_crate_tpu_torch.collectives.LocalGroup` and the graph
    captured on them (``spatial.SpatialStep``): the split state of D x P
    slots (each shard's slots a view of it), the Params and, for the
    rebalanced step, the input edges, distinct from the output
    ``band_edges`` that the graph writes.  They start as copies of the
    first call's inputs; each later call copies its inputs in."""

    def __init__(self, state: CrateState, params: Params, edges=None) -> None:
        super().__init__()
        self.state = clone(state)
        self.params = clone(params)
        self.edges = None if edges is None else edges.clone()

    @property
    def device(self) -> torch.device:
        return self.state.pos.device

    def load(self, state: CrateState, params: Params, edges=None) -> None:
        """Copy the call's inputs into the static buffers (stream ordered)."""
        copy_into(self.state, state)
        copy_into(self.params, params)
        if edges is not None:
            if edges.shape != self.edges.shape:
                raise ValueError(f"edges: shape {tuple(edges.shape)} != "
                                 f"{tuple(self.edges.shape)}")
            self.edges.copy_(edges)

    def step(self, key: BandKey, tick, generators) -> dict:
        """``tick(state, params, edges)`` over the static buffers: every
        shard's band tick, its new state written back into the split
        state; returns the stats (on the card the graph's static ones).
        On the card one replay a call, or on the key's first call the
        eager tick and the capture, with every shard generator
        registered.  The shards' threads enqueue on the capture stream
        while the calling thread waits for them, under the default
        ``capture_error_mode`` ("global"), whose check their calls pass."""
        generators = tuple(generators)
        return self.run(key, lambda: tick(self.state, self.params, self.edges), generators,
                        generators)


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
