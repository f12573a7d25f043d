"""The readers of the program's spans and of the tick's stage marks on a
made-up trace: the stage metrics partition ``glue_ms_per_tick`` less the
marks, the host metrics read the span store, and the unexplained idle
share runs from 0 (every gap under a span) to 100 (none)."""

from __future__ import annotations

import pytest

from crate_bench import registry, spans, stages
from crate_bench.trace import Op, View
from sand_crate_tpu_torch import diagnostics
from sand_crate_tpu_torch.diagnostics import Record

US = 1e3  # ms -> us


def _mark(stage, t):
    return Op(f"void stage_mark_kernel<stage::{stage}>()", "kernel", t, t + 0.002 * US)


def _tick(t0, sort=True):
    """One p-major tick starting at t0 (ms): glue in each stage, the pair and
    update kernels, a read-back, and the marks."""
    ms = []

    def op(name, cat, a, b):
        ms.append(Op(name, cat, (t0 + a) * US, (t0 + b) * US))

    op("void at::native::sbtopk::gatherTopK<float>", "kernel", 0.00, 0.03)  # lifecycle
    op("void (anonymous namespace)::ghost_kernel<false>(...)", "kernel", 0.03, 0.04)
    ms.append(_mark("lifecycle", (t0 + 0.04) * US))
    if sort:
        op("cub::DeviceRadixSortOnesweepKernel", "kernel", 0.05, 0.15)
        op("void at::native::index_elementwise_kernel", "kernel", 0.15, 0.20)
        ms.append(_mark("sort", (t0 + 0.20) * US))
    op("void at::native::CatArrayBatchedCopy", "kernel", 0.21, 0.41)
    op("void (anonymous namespace)::pm_kernel<0, 6, true>(...)", "kernel", 0.41, 0.47)
    op("Memset (Device)", "gpu_memset", 0.47, 0.48)
    ms.append(_mark("pairs", (t0 + 0.48) * US))
    op("void (anonymous namespace)::kick_kernel<false>(KickArgs)", "kernel", 0.49, 0.55)
    op("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 0.55, 0.60)
    ms.append(_mark("tick", (t0 + 0.60) * US))
    op("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 0.61, 0.62)
    return ms


def _view(ticks=2, sort=True, tail=True):
    ops = [o for t in range(ticks) for o in _tick(t * 1.0, sort)]
    if tail:  # a frame copy enqueued after the last replay: the next lifecycle
        ops.append(Op("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 2.7 * US, 2.75 * US))
    return View(ops, seconds=2e-3, ticks=ticks, untraced_seconds=2e-3)


def _read(name, view):
    return registry.metric_module(name).read(view)


def test_stage_metrics_partition_the_glue_less_the_marks():
    v = _view()
    got = {m: _read(m, v) for m in ("lifecycle_ms_per_tick", "sort_ms_per_tick",
                                    "pair_prep_ms_per_tick", "finish_ms_per_tick")}
    assert got["lifecycle_ms_per_tick"] == pytest.approx(0.03 + 0.05 / 2)
    assert got["sort_ms_per_tick"] == pytest.approx(0.15)
    assert got["pair_prep_ms_per_tick"] == pytest.approx(0.21)
    assert got["finish_ms_per_tick"] == pytest.approx(0.05)
    _, marks = stages.split(v)
    assert len(marks) == 8
    marks_ms = sum(o.end - o.start for o in marks) * 1e-3 / v.ticks
    glue = _read("glue_ms_per_tick", v)
    assert sum(got.values()) == pytest.approx(glue - marks_ms)


def test_without_a_sort_stage_the_sort_metric_is_silent():
    v = _view(sort=False)
    assert _read("sort_ms_per_tick", v) is None
    parts = [_read(m, v) for m in ("lifecycle_ms_per_tick", "pair_prep_ms_per_tick",
                                   "finish_ms_per_tick")]
    marks_ms = sum(o.end - o.start for o in stages.split(v)[1]) * 1e-3 / v.ticks
    assert sum(parts) == pytest.approx(_read("glue_ms_per_tick", v) - marks_ms)


def test_a_trace_without_marks_gives_no_stage_metric():
    v = View([o for o in _view().ops if stages.stage_of(o) is None], 2e-3, 2, 2e-3)
    for m in ("lifecycle_ms_per_tick", "sort_ms_per_tick", "pair_prep_ms_per_tick",
              "finish_ms_per_tick"):
        assert _read(m, v) is None


BASE = diagnostics.trace_base(1_790_000_000 * 10**9)


def _records(intervals_us, names=None, reads=0):
    """Closed spans over ``intervals_us`` (trace microseconds) and ``reads``
    read events, as the program's store holds them (unix ns)."""
    out = []
    for i, (a, b) in enumerate(intervals_us):
        out.append(Record(len(out), "span", (names or {}).get(i, "tick.launch"),
                          BASE + int(a * 1e3), BASE + int(b * 1e3), -1, i))
    for _ in range(reads):
        out.append(Record(len(out), "event", "read.engine.coefficients", BASE, BASE, -1, 0))
    return out


def _with(monkeypatch, recs):
    monkeypatch.setattr(spans, "records", lambda: recs)


def test_host_metrics_read_the_span_store(monkeypatch):
    v = _view()
    _with(monkeypatch, _records([(0, 400), (400, 900), (2000, 2300), (2300, 2500)],
                                {1: "tick.prints", 2: "frames.wait", 3: "tick.prints"},
                                reads=38))
    assert _read("host_reads_per_tick", v) == pytest.approx(19)
    assert _read("prints_ms_per_tick_profiled.live", v) == pytest.approx((0.5 + 0.2) / 2)
    assert _read("frame_wait_ms_per_tick_profiled.record", v) == pytest.approx(0.3 / 2)


def test_host_metrics_are_silent_without_a_store(monkeypatch):
    v = _view()
    _with(monkeypatch, None)
    for m in ("host_reads_per_tick", "prints_ms_per_tick_profiled.live",
              "frame_wait_ms_per_tick_profiled.record", "idle_unexplained_share"):
        assert _read(m, v) is None
    _with(monkeypatch, _records([(0, 10)]))
    assert _read("host_reads_per_tick", v) == 0.0
    assert _read("prints_ms_per_tick_profiled.live", v) is None


def test_idle_unexplained_share_runs_from_0_to_100(monkeypatch):
    v = _view(tail=False)
    busy = v.busy()
    gaps = [(end, start) for (_, end, _), (start, _, _) in zip(busy, busy[1:])]
    assert gaps
    _with(monkeypatch, _records([(busy[0][0], busy[-1][1])]))
    assert _read("idle_unexplained_share", v) == pytest.approx(0.0, abs=1e-6)
    _with(monkeypatch, _records([(busy[-1][1] + 100, busy[-1][1] + 200)]))
    assert _read("idle_unexplained_share", v) == pytest.approx(100.0)
    # half of the largest gap covered
    a, b = max(gaps, key=lambda g: g[1] - g[0])
    _with(monkeypatch, _records([(a, (a + b) / 2)]))
    idle = sum(e - s for s, e in gaps)
    assert _read("idle_unexplained_share", v) == pytest.approx(
        100.0 * (idle - (b - a) / 2) / idle, rel=1e-6)


def test_spans_of_the_store_land_on_the_trace_clock():
    with diagnostics.tracing():
        with diagnostics.span("tick.launch"):
            pass
    recs = spans.records()
    (a, b), = spans.span_intervals(recs)
    r = recs[0]
    base = r.start - r.start % diagnostics.TRACE_BASE_PERIOD_NS
    assert a == pytest.approx((r.start - base) / 1e3) and b >= a
