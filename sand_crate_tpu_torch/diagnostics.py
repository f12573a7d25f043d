"""Host-side observability: spans and counters, phase timer, force monitor
and profiler trace.

The counterparts of ``sand_crate_tpu/diagnostics.py`` (reference timer.py:10-48
and force_monitor.py:13-37): the wall-clock timer covers host-visible phases
(dispatch, sync, render), the per-force attribution comes from the
``Diagnostics`` the step returns, and :func:`profile` traces a block with
``torch.profiler``.  Reports are YAML-shaped text written
without PyYAML, so the port runs where PyYAML is not installed.

The port's own tracing lives here too:

* :func:`span` and :func:`event` record a span (name, start and end, the
  enclosing span, the unit) or an instant into :data:`STORE`, a bounded
  store of the latest session.  Tracing is on while a
  ``torch.profiler`` session records (torch's own flag,
  ``torch.autograd.profiler._is_profiler_enabled``, set whatever the
  activities) or inside a :func:`tracing` block.  Off, a site costs one
  flag test and gets the shared :data:`NULL_SPAN`: no clock is read and
  nothing is allocated.
* A session begins with a :func:`tracing` block or :func:`profile`, and
  under a bare ``torch.profiler`` session at the first record after an
  entry point was called with tracing off (:func:`next_unit` notes it):
  two profiler sessions with no call of the port between them are one.
* Times are unix nanoseconds (``time.time_ns``), the clock the profiler's
  Chrome trace is written on: its ``ts`` is ``(unix ns - base) / 1000``
  with ``baseTimeNanoseconds`` (:func:`trace_base`), so a span and the
  card's operations of one trace compare directly.  :func:`profile`
  writes the session's spans into its ``trace.json`` as a process row of
  their own.
* The unit is a host-side call number of an entry point (one a
  ``Crate.physics_tick``, ``Crate.run``, a frame of ``stream_frames``, a
  ``BatchedCrates.run``; :func:`next_unit`), not the device tick, which
  only a synchronising read could give.
* Counters, always on (a dict increment each): :data:`READS` counts every
  synchronising device-to-host read the port makes at its own sites
  (:func:`host_read`, which also records a ``read.<site>`` event when
  tracing is on), whatever the device; :data:`FRAMES` the frames
  ``Crate.stream_frames`` hands to the host and their bytes.  Graph
  captures and evictions count in ``graphs.LAUNCHES``, the stage marks of
  the tick in ``ops/stage_mark.LAUNCHES``.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import Counter, defaultdict, deque
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch.autograd.profiler as _profiler

OUTSIDE_CONTEXT = "Outside"
TIMER_DECAY = 0.9  # reference: timer.py:7
FORCE_DECAY = 0.80  # reference: force_monitor.py:10

# Kineto's Chrome trace writes ts relative to a base rounded down to a
# multiple of this period (a quarter of a year); see trace_base.
TRACE_BASE_PERIOD_NS = 7_889_238 * 10**9
# Records a session keeps at most (the latest are kept past it).
STORE_CAPACITY = 1 << 17
# The process row of the program's spans in a Chrome trace.
TRACE_PID = "sand_crate spans"

# Synchronising device-to-host reads by site, since the process started.
READS: Counter = Counter()
# Frames Crate.stream_frames handed to the host, and their bytes.
FRAMES = {"frames": 0, "bytes": 0}


class Record(NamedTuple):
    """One span or event of a session; times in unix ns (an event's end is
    its start; a span still open has end -1)."""

    index: int  # its place in the session
    kind: str  # "span" or "event"
    name: str
    start: int
    end: int
    parent: int  # the index of the enclosing span, or -1
    unit: int


class SpanStore:
    """The spans and events of one tracing session: the latest ``capacity``
    records, each a list of :class:`Record`'s fields (a span's end is set
    when it closes), and the spans open now."""

    def __init__(self, capacity: int = STORE_CAPACITY) -> None:
        self.held = deque(maxlen=capacity)
        self.open = []  # the records of the spans open now, innermost last
        self.n = 0  # records since the session began
        self.unit = 0  # the current unit id (next_unit)
        self.stale = False  # an entry point ran untraced: the next record begins a session

    def begin(self) -> None:
        """Start a new session: the records so far are dropped."""
        self.held.clear()
        self.open.clear()
        self.n = 0
        self.stale = False

    def add(self, kind: str, name: str) -> list:
        """Record the span or event ``name``, starting now."""
        if self.stale:
            self.begin()
        t = time.time_ns()
        rec = [self.n, kind, name, t, t if kind == "event" else -1,
               self.open[-1][0] if self.open else -1, self.unit]
        self.n += 1
        self.held.append(rec)
        return rec

    def open_span(self, name: str) -> list:
        rec = self.add("span", name)
        self.open.append(rec)
        return rec

    def close_span(self, rec: list) -> None:
        rec[4] = time.time_ns()
        if self.open and self.open[-1] is rec:  # else opened in a session since dropped
            self.open.pop()

    def records(self) -> list[Record]:
        """The session's records still held, in order."""
        return [Record(*r) for r in self.held]


STORE = SpanStore()
_forced = 0  # depth of tracing() blocks


def tracing_on() -> bool:
    """Whether span and event sites record now."""
    return bool(_forced or _profiler._is_profiler_enabled)


class _NullSpan:
    """What a span site gets while tracing is off: enters and exits, nothing else."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None


NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("name", "record")

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self):
        self.record = STORE.open_span(self.name)
        return self

    def __exit__(self, *exc) -> None:
        STORE.close_span(self.record)


def span(name: str):
    """A context manager that records the span ``name`` while tracing is
    on; off, the shared :data:`NULL_SPAN`."""
    if _forced or _profiler._is_profiler_enabled:
        return _Span(name)
    return NULL_SPAN


def event(name: str) -> None:
    """Record the instant ``name`` while tracing is on."""
    if _forced or _profiler._is_profiler_enabled:
        STORE.add("event", name)


def host_read(site: str) -> None:
    """Count one synchronising device-to-host read at ``site`` (call it just
    before the read); while tracing is on, also record the event
    ``read.<site>``."""
    READS[site] += 1
    if _forced or _profiler._is_profiler_enabled:
        STORE.add("event", "read." + site)


def next_unit() -> None:
    """Start the next unit (a call of an entry point): later records carry
    its id.  Called with tracing off, it ends the session: the next record
    begins a new one."""
    STORE.unit += 1
    if not (_forced or _profiler._is_profiler_enabled):
        STORE.stale = True


@contextlib.contextmanager
def tracing():
    """Record spans and events inside the block, profiler or not; the
    outermost block begins a new session."""
    global _forced
    if not _forced:
        STORE.begin()
    _forced += 1
    try:
        yield STORE
    finally:
        _forced -= 1


def session() -> list[Record]:
    """The records of the latest session (see :class:`SpanStore`)."""
    return STORE.records()


def trace_base(unix_ns: int) -> int:
    """The ``baseTimeNanoseconds`` of a Chrome trace written around
    ``unix_ns``: a trace's ``ts`` (us) is ``(unix_ns - base) / 1000``."""
    return unix_ns - unix_ns % TRACE_BASE_PERIOD_NS


def chrome_events(records: list[Record], base_ns: int) -> list:
    """``records`` as Chrome trace events on one process row of their own
    (spans complete events, events instants), ``ts`` in us after ``base_ns``."""
    out = [{"ph": "M", "name": "process_name", "pid": TRACE_PID, "tid": 0,
            "args": {"name": TRACE_PID}}]
    for r in records:
        ev = {"name": r.name, "pid": TRACE_PID, "tid": 0, "ts": (r.start - base_ns) / 1e3,
              "args": {"index": r.index, "parent": r.parent, "unit": r.unit}}
        if r.kind == "span":
            if r.end < 0:
                continue
            ev.update(ph="X", cat="program_span", dur=(r.end - r.start) / 1e3)
        else:
            ev.update(ph="i", cat="program_event", s="t")
        out.append(ev)
    return out


def yaml_block(data, indent: int = 0) -> str:
    """``data`` (nested dicts of scalars, or a list of one-key dicts) as
    block-style YAML text, keys sorted like ``yaml.dump``."""
    pad = "  " * indent
    if isinstance(data, list):
        return "".join(f"{pad}- {yaml_block(item).strip()}\n" for item in data)
    lines = []
    for key in sorted(data):
        value = data[key]
        if isinstance(value, dict):
            lines.append(f"{pad}{key}:\n{yaml_block(value, indent + 1)}")
        else:
            lines.append(f"{pad}{key}: {value}\n")
    return "".join(lines)


class PhaseTimer:
    """EMA wall-clock timer with an implicit 'Outside' bucket.

    Context-manager API compatible with the reference Timer (timer.py:10-48):
    ``with timer("Collisions"): ...``; ``report()`` yields the same shape
    with per-phase ms, percent, and FPS.  Times on ``time.perf_counter``.
    While tracing is on each phase is also a span, named ``name`` if given
    (``timer("Step", "tick.launch")``), else ``phase.<context>``.
    """

    def __init__(self) -> None:
        self._stack: list[str] = []
        self._spans: list = []
        self._starts: dict[str, float] = {OUTSIDE_CONTEXT: time.perf_counter()}
        self._durations: dict[str, float] = defaultdict(float)

    def __call__(self, context: str, name: str | None = None) -> "PhaseTimer":
        self._stack.append(context)
        self._spans.append(span(name or "phase." + context) if tracing_on() else NULL_SPAN)
        return self

    def __enter__(self) -> "PhaseTimer":
        self._spans[-1].__enter__()
        now = time.perf_counter()
        self._starts[self._stack[-1]] = now
        if len(self._stack) == 1:
            self._ema(OUTSIDE_CONTEXT, now - self._starts[OUTSIDE_CONTEXT])
        return self

    def __exit__(self, *exc) -> None:
        ctx = self._stack.pop()
        self._ema(ctx, time.perf_counter() - self._starts[ctx])
        self._spans.pop().__exit__(*exc)
        if not self._stack:
            self._starts[OUTSIDE_CONTEXT] = time.perf_counter()

    def _ema(self, ctx: str, duration: float) -> None:
        self._durations[ctx] = (
            self._durations[ctx] * TIMER_DECAY + (1 - TIMER_DECAY) * duration
        )

    def report(self) -> str:
        total = sum(self._durations.values()) or 1e-9
        phases = {
            ctx: f"{1000 * d:.1f} ms ({100 * d / total:.0f}%)"
            for ctx, d in self._durations.items()
        }
        return yaml_block(
            {"Timing": phases, "FPS": f"{int(1 / total)} ({1000 * total:.1f} ms)"}
        )


class ForceMonitor:
    """EMA of per-force mean ||dv|| fed by the step's Diagnostics output."""

    def __init__(self, labels: tuple[str, ...]) -> None:
        self.labels = labels
        self._ema = defaultdict(float)

    def update(self, force_dv: np.ndarray) -> None:
        for label, value in zip(self.labels, np.asarray(force_dv)):
            self._ema[label] = self._ema[label] * FORCE_DECAY + (
                1 - FORCE_DECAY
            ) * float(value)

    def report(self) -> str:
        rounded = {k: float(f"{1000 * v:.1f}") for k, v in self._ema.items()}
        return yaml_block({"Forces": rounded})


@contextlib.contextmanager
def profile(log_dir):
    """Trace a block with ``torch.profiler`` (host ops, and the card's
    kernels when CUDA is available) and write it as a Chrome trace,
    ``<log_dir>/trace.json`` (chrome://tracing or Perfetto), the program's
    spans and events of the block (a new session) on a process row of
    their own, on the trace's clock; yields ``log_dir``."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    STORE.begin()
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    path = out / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    # a trace without a base writes its ts as unix microseconds
    base = int(trace.get("baseTimeNanoseconds", 0))
    trace.setdefault("traceEvents", []).extend(chrome_events(session(), base))
    path.write_text(json.dumps(trace))
