"""The port's spans, counters and stage marks (``diagnostics.py``,
``ops/stage_mark.py``).

On the CPU: tracing off records nothing and costs a shared null context;
under ``torch.profiler`` (or a ``diagnostics.tracing()`` block) the entry
points record their spans, nested and unit by unit; every synchronising
read of a live tick is counted by site; a replayed (on the CPU: eager)
tick marks its stages in order, once for a vmapped batch; the exporter
writes the spans into the profiler's own trace on its clock; the overlay
text is as it was.  The cases marked ``cuda`` hold spans and the card's
operations on one clock, the marks of every replayed tick, one capture
span a first call, and replay == eager with the marks (skipped without a
card; the file imports no JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_tracing.py``).
"""

import copy
import json
import re
import time
import tracemalloc
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sand_crate_tpu_torch import Params, diagnostics, load_config, load_config_dict
from sand_crate_tpu_torch.bench import dam_break_world
from sand_crate_tpu_torch.engine import Crate
from sand_crate_tpu_torch.ops import stage_mark
from sand_crate_tpu_torch.physics import step
from sand_crate_tpu_torch.sweep import DEFAULT_RANDOM_RANGES, BatchedCrates, random_params

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SORTED = ("pmajor", "pallas", "chunked", "cellwise")
SLOT_ORDER = ("dense", "gather")
LIVE_READS = {"engine.force_dv": 1, "engine.tick": 1, "engine.particle_count": 1,
              "engine.non_finite": 1, "engine.neighbor_overflow": 1,
              "engine.spawn_truncated": 1, "engine.coefficients": 13}


def _cup_config(max_particles: int = 120):
    raw = copy.deepcopy(load_config(REPO / "configs" / "stirring_cup.yaml").raw)
    raw["world"]["coefficients"]["max_particles"] = max_particles
    return load_config_dict(raw)


def _crate(mode: str = "pmajor", device="cpu", **kw) -> Crate:
    if mode in SLOT_ORDER:
        return Crate(_cup_config().world_config, seed=3, forces_mode=mode, device=device, **kw)
    return Crate(dam_break_world(300), seed=3, forces_mode=mode, device=device, **kw)


def _named(records, kind="span"):
    return [r for r in records if r.kind == kind]


def _marks(records):
    return [r.name[len("mark."):] for r in records
            if r.kind == "event" and r.name.startswith("mark.")]


# --------------------------------------------------------------------------
# tracing off
# --------------------------------------------------------------------------


def test_tracing_off_records_nothing_and_shares_the_null_context():
    crate = _crate()
    crate.physics_tick()
    assert not diagnostics.tracing_on()
    n = diagnostics.STORE.n
    crate.physics_tick()
    for _ in crate.stream_frames(2, chunk_frames=1):
        pass
    assert diagnostics.STORE.n == n
    assert diagnostics.span("tick.launch") is diagnostics.NULL_SPAN
    assert diagnostics.span("other") is diagnostics.NULL_SPAN


def test_tracing_off_sites_allocate_nothing():
    timer = diagnostics.PhaseTimer()

    def sites():
        for _ in range(2000):
            with diagnostics.span("x"):
                diagnostics.event("y")
            with timer("Step", "tick.launch"):
                pass

    sites()  # warm: the timer's phase dict, the lists' first growth
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        sites()
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [s for s in after.compare_to(before, "filename")
             if s.size_diff > 0 and "diagnostics.py" in str(s.traceback)]
    assert not grown, grown


# --------------------------------------------------------------------------
# spans and reads under the profiler
# --------------------------------------------------------------------------


def test_profiler_turns_tracing_on():
    diagnostics.STORE.begin()
    with profile(activities=[ProfilerActivity.CPU]):
        assert diagnostics.tracing_on()
        with diagnostics.span("outer"):
            diagnostics.event("inner")
    assert not diagnostics.tracing_on()
    names = [r.name for r in diagnostics.session()]
    assert names == ["outer", "inner"]


def test_a_profiler_session_after_an_untraced_call_is_a_new_session():
    crate = _crate()
    crate.physics_tick()
    with profile(activities=[ProfilerActivity.CPU]):
        crate.physics_tick()
    first = diagnostics.session()
    crate.physics_tick()  # untraced: the session ends
    with profile(activities=[ProfilerActivity.CPU]):
        crate.physics_tick()
    second = diagnostics.session()
    assert len(second) == len(first) == 28
    assert second[0].index == 0 and second[0].unit == first[0].unit + 2


def test_a_live_tick_records_its_spans_nested_unit_by_unit():
    crate = _crate()
    crate.physics_tick()  # the first tick (on the card: the capture)
    diagnostics.STORE.begin()
    with profile(activities=[ProfilerActivity.CPU]):
        crate.physics_tick()
        crate.physics_tick()
    recs = diagnostics.session()
    spans = _named(recs)
    want = ["tick.launch", "tick.readback", "tick.monitor", "tick.prints",
            "tick.prints.coefficients"]
    assert [r.name for r in spans] == want * 2
    by_index = {r.index: r for r in recs}
    for r in spans:
        assert r.end >= r.start
        if r.name == "tick.prints.coefficients":
            parent = by_index[r.parent]
            assert parent.name == "tick.prints" and parent.unit == r.unit
            assert parent.start <= r.start and r.end <= parent.end
        else:
            assert r.parent == -1
    units = [r.unit for r in spans]
    assert len(set(units[:5])) == 1 and len(set(units[5:])) == 1
    assert units[5] == units[0] + 1
    starts = [r.start for r in recs]
    assert starts == sorted(starts)
    assert all(r.unit == units[0] for r in recs[:len(recs) // 2])


def test_a_live_tick_makes_19_host_reads_by_site():
    crate = _crate()
    crate.physics_tick()
    diagnostics.READS.clear()
    crate.physics_tick()
    assert dict(diagnostics.READS) == LIVE_READS  # counted whether tracing or not
    diagnostics.READS.clear()
    with diagnostics.tracing():
        crate.physics_tick()
    assert dict(diagnostics.READS) == LIVE_READS
    reads = [r.name for r in diagnostics.session() if r.name.startswith("read.")]
    assert len(reads) == 19
    assert {n: reads.count(n) for n in set(reads)} == {
        "read." + k: v for k, v in LIVE_READS.items()}


def test_stream_frames_waits_once_a_chunk_and_counts_its_frames():
    crate = _crate()
    before = dict(diagnostics.FRAMES)
    diagnostics.STORE.begin()
    with profile(activities=[ProfilerActivity.CPU]):
        frames = list(crate.stream_frames(5, chunk_frames=2))
    spans = [r.name for r in _named(diagnostics.session())]
    assert len(frames) == 5
    assert spans.count("frames.wait") == 3 and spans.count("frames.dispatch") == 3
    assert spans.count("frames.yield") == 5
    yields = [r for r in _named(diagnostics.session()) if r.name == "frames.yield"]
    assert len({r.unit for r in yields}) == 5
    nbytes = sum(v.nbytes for v in frames[0].values())
    assert diagnostics.FRAMES["frames"] - before["frames"] == 5
    assert diagnostics.FRAMES["bytes"] - before["bytes"] == 5 * nbytes


def test_stream_frames_leaves_the_consumers_time_outside_its_spans():
    crate = _crate()
    held = []
    diagnostics.STORE.begin()
    with diagnostics.tracing():
        for _ in crate.stream_frames(4, chunk_frames=2):
            t0 = time.time_ns()
            time.sleep(0.002)
            held.append((t0, time.time_ns()))
    spans = _named(diagnostics.session())
    assert len(held) == 4 and all(r.end >= 0 for r in spans)
    for a, b in held:
        assert not [r.name for r in spans if r.start < b and r.end > a]


def test_the_store_keeps_the_latest_records_of_a_session():
    store = diagnostics.SpanStore(capacity=4)
    outer = store.open_span("outer")
    for i in range(5):
        store.add("event", f"e{i}")
    store.close_span(outer)
    recs = store.records()
    assert [r.name for r in recs] == ["e1", "e2", "e3", "e4"]
    assert [r.index for r in recs] == [2, 3, 4, 5] and {r.parent for r in recs} == {0}
    assert outer[4] >= outer[3] and not store.open
    store.begin()
    assert store.records() == [] and store.n == 0


def test_instrumented_phases_record_as_phase_spans():
    crate = _crate(instrument=True)
    crate.physics_tick()
    with diagnostics.tracing():
        crate.physics_tick()
    names = [r.name for r in _named(diagnostics.session())]
    assert names[0] == "tick.launch" and "tick.readback" in names
    phases = [n for n in names if n.startswith("phase.")]
    assert phases and all(n[len("phase."):] in crate.debug_timer.report() for n in phases)


def test_batched_run_records_its_three_spans():
    config = _cup_config()
    base = Params.from_coefficients(config.world_config.coefficients, "cpu")
    gen = torch.Generator()
    gen.manual_seed(1)
    batch = BatchedCrates(config, random_params(gen, base, DEFAULT_RANDOM_RANGES, 2),
                          seed=1, device="cpu")
    diagnostics.STORE.begin()
    with profile(activities=[ProfilerActivity.CPU]):
        batch.run(2)
    spans = _named(diagnostics.session())
    assert [r.name for r in spans] == ["batch.live_rows", "batch.launch", "batch.clone"]
    assert len({r.unit for r in spans}) == 1
    assert _marks(diagnostics.session()) == ["lifecycle", "pairs", "tick"] * 2


# --------------------------------------------------------------------------
# stage marks
# --------------------------------------------------------------------------


@pytest.mark.parametrize("mode", SORTED + SLOT_ORDER)
def test_a_step_graph_tick_marks_its_stages_in_order(mode):
    crate = _crate(mode)
    with diagnostics.tracing():
        crate.run(2)
    want = (["lifecycle", "sort", "pairs", "tick"] if mode in SORTED
            else ["lifecycle", "pairs", "tick"])
    assert _marks(diagnostics.session()) == want * 2
    launch = [r for r in diagnostics.session() if r.name == "run.launch"][0]
    assert all(r.parent == launch.index for r in diagnostics.session()
               if r.name.startswith("mark."))


@pytest.mark.parametrize("mode", ["pmajor", "dense"])
def test_a_vmapped_batch_marks_each_stage_once(mode):
    config = _cup_config()
    base = Params.from_coefficients(config.world_config.coefficients, "cpu")
    gen = torch.Generator()
    gen.manual_seed(2)
    batch = BatchedCrates(config, random_params(gen, base, DEFAULT_RANDOM_RANGES, 3),
                          seed=2, forces_mode=mode, device="cpu")
    with diagnostics.tracing():
        batch.run(1)
    want = ["lifecycle", "sort", "pairs", "tick"] if mode == "pmajor" else [
        "lifecycle", "pairs", "tick"]
    assert _marks(diagnostics.session()) == want


def test_marks_launch_nothing_on_the_cpu():
    before = dict(stage_mark.LAUNCHES)
    crate = _crate()
    crate.run(2)
    assert stage_mark.LAUNCHES == before


# --------------------------------------------------------------------------
# the exporter and the overlay text
# --------------------------------------------------------------------------


def test_profile_writes_the_program_spans_on_the_traces_clock(tmp_path):
    crate = _crate()
    crate.physics_tick()
    with diagnostics.profile(tmp_path / "trace") as log_dir:
        crate.physics_tick()
        crate.physics_tick()
    trace = json.loads((Path(log_dir) / "trace.json").read_text())
    events = trace["traceEvents"]
    ours = [e for e in events if e.get("cat") == "program_span"]
    theirs = [e for e in events if e.get("ph") == "X" and e.get("cat") not in
              ("program_span", "program_event")]
    assert [e["name"] for e in ours][:5] == ["tick.launch", "tick.readback", "tick.monitor",
                                             "tick.prints", "tick.prints.coefficients"]
    reads = [e for e in events if e.get("cat") == "program_event"
             and e["name"].startswith("read.")]
    assert len(reads) == 38
    base = trace["baseTimeNanoseconds"]
    assert base == diagnostics.trace_base(diagnostics.session()[0].start)
    lo = min(e["ts"] for e in theirs)
    hi = max(e["ts"] + e.get("dur", 0) for e in theirs)
    launch = ours[0]
    # the step's own host ops (aten::*) lie inside its span, on one clock
    inside = [e for e in theirs if launch["ts"] <= e["ts"]
              and e["ts"] + e.get("dur", 0) <= launch["ts"] + launch["dur"]]
    assert inside
    for e in ours:
        assert lo - 1e4 <= e["ts"] <= hi + 1e4


def _strip_times(text: str) -> str:
    return re.sub(r"\d+(\.\d+)? ms \(\d+%\)|FPS: .*", "T", text)


def test_debug_prints_text_is_unchanged():
    plain, traced = _crate(), _crate()
    plain.physics_tick()
    with diagnostics.tracing():
        traced.physics_tick()
    a, b = plain.debug_prints, traced.debug_prints
    assert _strip_times(a) == _strip_times(b)
    assert a.startswith("Tick: 1\nParticles: ")
    i = a.index("Particles: ") + 11
    assert int(a[i:a.index("\n", i)]) == plain.particle_count
    assert "Timing:\n  Outside: " in a and "  Step: " in a and "  Sync: " in a
    assert "Forces:" in a and "viscosity: " in a


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _device_trace(tmp_path, fn, activities=(ProfilerActivity.CUDA,)):
    """Run ``fn`` under the profiler -> (the trace's events, its base)."""
    torch.cuda.synchronize()
    diagnostics.STORE.begin()
    with profile(activities=list(activities)) as prof:
        assert diagnostics.tracing_on()
        fn()
        torch.cuda.synchronize()
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    return trace["traceEvents"], trace["baseTimeNanoseconds"]


def _copies(tmp_path, fn, want):
    """``fn`` under a CUDA-only profiler session -> (the DtoH copies, sorted,
    the trace's base); a session that recorded no device operation (CUPTI
    delivered none) is run again, twice at most."""
    for _ in range(3):
        events, base = _device_trace(tmp_path, fn)
        copies = sorted((e for e in events if e.get("cat") == "gpu_memcpy"
                         and "DtoH" in e["name"]), key=lambda e: e["ts"])
        if copies or any(e.get("cat") == "kernel" for e in events):
            break
    assert len(copies) == want, [e.get("cat") for e in events][:20]
    return copies, base


def _us(record, base):
    return (record.start - base) / 1e3, (record.end - base) / 1e3


@pytest.mark.cuda
def test_readback_span_ends_after_its_copy_on_one_clock(cuda, tmp_path):
    """A profiled live tick: the ``force_dv`` copy lies inside
    ``tick.readback`` and the other 18 reads' copies inside ``tick.prints``,
    each to within 20 us, on the trace's clock."""
    crate = _crate("pmajor", cuda)
    crate.physics_tick()
    crate.physics_tick()
    copies, base = _copies(tmp_path, crate.physics_tick, 19)
    assert base == diagnostics.trace_base(diagnostics.session()[0].start)
    spans = {r.name: _us(r, base) for r in diagnostics.session() if r.kind == "span"}
    rows = [(e["ts"], e["ts"] + e["dur"]) for e in copies]
    print("spans", {k: (round(a, 1), round(b, 1)) for k, (a, b) in spans.items()})
    print("copies", [(round(a, 1), round(b, 1)) for a, b in rows])
    start, end = spans["tick.readback"]
    assert start - 20 <= rows[0][0] and rows[0][1] <= end + 20
    lo, hi = spans["tick.prints"]
    assert all(lo - 20 <= a and b <= hi + 20 for a, b in rows[1:])


@pytest.mark.cuda
def test_spans_and_device_copies_share_one_clock(cuda, tmp_path):
    """A small synchronous read on an idle card, 20 times: each copy starts
    after its span opens and ends before it closes, to within 20 us, and
    the spans are short, so the two clocks agree to within their width."""
    x = torch.ones(16, device=cuda)
    torch.cuda.synchronize()

    def reads():
        for _ in range(20):
            with diagnostics.span("probe"):
                x.cpu()

    copies, base = _copies(tmp_path, reads, 20)
    probes = [r for r in diagnostics.session() if r.name == "probe"]
    assert len(probes) == 20
    lead, lag, width = [], [], []
    for c, r in zip(copies, probes):
        s, e = _us(r, base)
        lead.append(c["ts"] - s)
        lag.append(e - (c["ts"] + c["dur"]))
        width.append(e - s)
    print(f"copy start after span start: {min(lead):.1f}-{max(lead):.1f} us; span end after "
          f"copy end: {min(lag):.1f}-{max(lag):.1f} us; span {min(width):.1f}-{max(width):.1f} us")
    assert min(lead) >= -20 and min(lag) >= -20


@pytest.mark.cuda
def test_each_replayed_tick_marks_its_four_stages(cuda, tmp_path):
    crate = _crate("pmajor", cuda)
    crate.run(2)
    before = dict(stage_mark.LAUNCHES)
    events, _ = _device_trace(tmp_path, lambda: crate.run(3))
    names = [e["name"] for e in sorted(events, key=lambda e: e.get("ts", 0))
             if e.get("cat") == "kernel" and "stage_mark_kernel" in e["name"]]
    stages = [re.search(r"stage_mark_kernel<(?:\w+::)*(\w+)>", n).group(1) for n in names]
    assert stages == ["lifecycle", "sort", "pairs", "tick"] * 3
    assert {k: stage_mark.LAUNCHES[k] - before[k] for k in before} == dict.fromkeys(
        stage_mark.STAGES, 3)


@pytest.mark.cuda
def test_a_first_call_records_one_capture_span(cuda):
    crate = _crate("pmajor", cuda)
    with diagnostics.tracing():
        crate.run(1)
        first = [r for r in diagnostics.session() if r.name == "graph.capture"]
        crate.run(1)
        crate.run(1)
    captures = [r for r in diagnostics.session() if r.name == "graph.capture"]
    assert len(first) == 1 and captures == first
    launch = [r for r in diagnostics.session() if r.name == "run.launch"][0]
    assert first[0].parent == launch.index


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["pmajor", "dense"])
def test_replay_equals_eager_with_the_marks(cuda, mode):
    crate = _crate(mode, cuda)
    crate.run(3)
    state = type(crate.state)(*(x.clone() for x in crate.state))
    params = type(crate.params)(*(x.clone() for x in crate.params))
    g0 = crate.generator.get_state()
    crate.run(4)
    crate.generator.set_state(g0)
    for _ in range(4):
        state, _ = step(state, params, crate.scene, crate.generator)
    for name, a, b in zip(state._fields, crate.state, state):
        assert torch.equal(a, b), name
