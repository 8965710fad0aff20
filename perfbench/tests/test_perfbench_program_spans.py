"""The readers of the program's own spans (``capture_s``, ``finalize_s``,
``commit_s``, ``d2h_wait_s``, ``library_idle_pct``) on recorded events, the
clock that puts the program's spans on the profiler's timeline, and the
labels ``perfbench/program_trace.py`` gives the card's idle gaps."""

import importlib
import json
import time

import pytest

from perfbench import harness, program_trace, tracer

# The program's tracer started at wall time 999.5 s, the profiler's ts 0 is
# 1000 s: a program event lies 0.5 s earlier on the profiler's clock.
EPOCH_S, BASE_NS = 999.5, 1000 * 10**9
OFFSET_US = -0.5e6

# (name, tid, trace, start, end) in the profiler's microseconds.
SPANS = [
    ("Snapshot.async_take", 1, "async_take-a1", 0.2e6, 0.4e6),
    ("drain", 4, "async_take-a1", 0.35e6, 4.3e6),
    ("d2h", 4, "async_take-a1", 0.5e6, 0.7e6),
    ("d2h", 4, "async_take-a1", 0.6e6, 0.9e6),
    ("CheckpointManager.restore", 1, "restore-r1", 1.0e6, 3.9e6),
    ("restore.read", 1, "restore-r1", 1.1e6, 2.6e6),
    ("consume.verify", 2, "restore-r1", 1.2e6, 1.8e6),
    ("consume.h2d_overlap", 3, "restore-r1", 1.4e6, 1.6e6),
    ("restore.assemble", 1, "restore-r1", 2.7e6, 3.0e6),
    ("phase.commit", 4, "async_take-a1", 4.0e6, 4.25e6),
    ("CheckpointManager.wait", 1, "async_take-a1", 4.2e6, 4.5e6),
    ("CheckpointManager.finalize", 1, "async_take-a1", 4.4e6, 4.5e6),
    ("Snapshot.async_take", 1, "async_take-a2", 4.6e6, 4.9e6),
    ("drain", 5, "async_take-a2", 4.8e6, 9.9e6),
    ("phase.commit", 5, "async_take-a2", 9.5e6, 9.8e6),
    # A sync take's commit is no drain's; its finalize counts.
    ("phase.commit", 1, "take-t9", 9.92e6, 9.95e6),
    ("CheckpointManager.finalize", 1, "take-t9", 9.95e6, 9.99e6),
]
DEVICE = [(0.0, 1e6), (2e6, 2.5e6), (4e6, 9e6)]  # idle: 1-2, 2.5-4, 9-10 (x 1e6 us)
NOTES = [("cycle", 0.0, 10e6), ("async_save", 0.15e6, 0.45e6), ("restore", 1e6, 4e6),
         ("wait_prev", 4.15e6, 4.55e6), ("async_save", 4.55e6, 4.95e6)]

EXPECTED = {
    "capture_s": (0.2 + 0.3) / 2,
    "finalize_s": (0.1 + 0.0) / 2,  # a2's finalize is after the window; t9's no async take's
    "commit_s": (0.25 + 0.3) / 2,
    "d2h_wait_s": (0.4 + 0.0) / 2,  # the second take staged no D2H
    "library_idle_pct": 100.0 * (1.0 + 1.4) / 10.0,  # the restore's idle, 1-2 and 2.5-3.9
}


def write_traces(directory, spans=SPANS, name="cell"):
    """The program's trace and a profiler trace of one run, as a traced run
    leaves them."""
    events = []
    for i, (span, tid, trace, a, b) in enumerate(spans, start=1):
        for ph, ts in (("b", a), ("e", b)):
            events.append({"name": span, "cat": "snapshot", "ph": ph, "id": i, "tid": tid, "pid": 7,
                           "ts": ts - OFFSET_US, **({"args": {"trace": trace}} if ph == "b" else {})})
    events.sort(key=lambda e: e["ts"])
    spans_path = directory / f"{name}.spans.json"
    spans_path.write_text(json.dumps({"traceEvents": events, "metadata": {"clock_epoch_s": EPOCH_S}}))
    prof = [{"name": "gemm", "cat": "kernel", "ph": "X", "ts": a, "dur": b - a} for a, b in DEVICE]
    prof += [{"name": "perfbench." + n, "cat": "user_annotation", "ph": "X", "ts": a, "dur": b - a}
             for n, a, b in NOTES]
    trace_path = directory / f"{name}.trace.json"
    trace_path.write_text(json.dumps({"schemaVersion": 1, "baseTimeNanoseconds": BASE_NS,
                                      "traceEvents": prof}))
    return spans_path, trace_path


@pytest.fixture
def recorded(tmp_path, monkeypatch):
    monkeypatch.setattr(harness, "OUT_DIR", tmp_path)
    spans_path, trace_path = write_traces(tmp_path)
    return program_trace.context_from_files(spans_path, trace_path)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_recorded_events(name, recorded):
    reader = importlib.import_module(f"perfbench.metrics.{name}")
    assert reader.read(recorded) == pytest.approx(EXPECTED[name], rel=1e-9)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_with_nothing_to_read_returns_none(name, tmp_path, monkeypatch):
    monkeypatch.setattr(harness, "OUT_DIR", tmp_path)
    empty = tracer.Context(job=None, window={}, spans=[], drains=[])
    assert importlib.import_module(f"perfbench.metrics.{name}").read(empty) is None


def test_a_program_without_these_spans_reads_as_nothing(tmp_path, monkeypatch):
    """The parent's program: stage/write/read spans only, which none of the
    five readers reads."""
    monkeypatch.setattr(harness, "OUT_DIR", tmp_path)
    old = [("stage", 4, "async_take-a1", 0.5e6, 0.7e6), ("write", 4, "async_take-a1", 0.7e6, 0.8e6),
           ("Snapshot.restore", 1, "restore-r1", 1.0e6, 3.9e6)]
    ctx = program_trace.context_from_files(*write_traces(tmp_path, old))
    for name in EXPECTED:
        assert importlib.import_module(f"perfbench.metrics.{name}").read(ctx) is None, name


def test_mapping_of_the_program_clock_onto_the_profiler_clock(tmp_path):
    spans_path, trace_path = write_traces(tmp_path)
    assert program_trace.base_time_ns(trace_path) == BASE_NS
    spans, meta = program_trace.read_spans(spans_path)
    mapped = program_trace.to_profiler_us(spans, meta["clock_epoch_s"], BASE_NS)
    for s, (name, tid, trace, a, b) in zip(mapped, SPANS):
        assert (s["name"], s["tid"], s["args"]["trace"]) == (name, tid, trace)
        assert s["a"] == pytest.approx(a, abs=1e-3) and s["b"] == pytest.approx(b, abs=1e-3)
    # (clock_epoch_s, ts) against baseTimeNanoseconds, in plain numbers.
    [one] = program_trace.to_profiler_us([{"t0": 2.0, "t1": 3.5}], 1700000000.25, 1700000001 * 10**9)
    assert one["a"] == pytest.approx(1.25e6, abs=1e-3) and one["b"] == pytest.approx(2.75e6, abs=1e-3)
    # The key is found in the tail too, and a file without it maps nothing.
    tail = tmp_path / "tail.json"
    tail.write_text(json.dumps({"traceEvents": [{"name": "x" * 100}] * 2000, "baseTimeNanoseconds": 5}))
    assert program_trace.base_time_ns(tail) == 5
    (tmp_path / "none.json").write_text(json.dumps({"traceEvents": []}))
    assert program_trace.base_time_ns(tmp_path / "none.json") is None
    assert program_trace.load(spans_path, tmp_path / "none.json") is None


def test_the_program_tracer_lands_on_a_record_function_region(tmp_path):
    """The program's tracer and torch.profiler on the CPU: a span around a
    ``record_function`` region maps onto it within 1 ms (median of five)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from torchsnapshot_tpu_torch import tracing

    tracing.enable(str(tmp_path / "cell.spans.json"))
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for i in range(5):
                with tracing.span(f"region{i}"), record_function(f"perfbench.region{i}"):
                    time.sleep(0.02)
        prof.export_chrome_trace(str(tmp_path / "cell.trace.json"))
    finally:
        tracing.disable()
    program = program_trace.load(tmp_path / "cell.spans.json", tmp_path / "cell.trace.json")
    ctx = program_trace.context_from_files(tmp_path / "cell.spans.json", tmp_path / "cell.trace.json")
    notes = {n["name"]: n for n in ctx.annotations}
    starts = sorted(s["a"] - notes["perfbench." + s["name"]]["ts"] for s in program.spans)
    ends = sorted(s["b"] - notes["perfbench." + s["name"]]["ts"] - notes["perfbench." + s["name"]]["dur"]
                  for s in program.spans)
    assert abs(starts[2]) < 1000.0 and abs(ends[2]) < 1000.0, (starts, ends)


def test_idle_gaps_are_named_by_the_program_on_each_thread(recorded):
    program = program_trace.for_context(recorded)
    assert program.training_tid == 1
    gaps = program_trace.idle_gaps_program(recorded, program)
    assert [g[0] for g in gaps] == [
        "CheckpointManager.restore|drain",  # 2.5-4: after the assemble, in the root alone
        "restore.read|consume.h2d_overlap,consume.verify,drain",  # 1-2
        "outside_program|phase.commit",  # 9-10: a drain's commit beside the steps
    ]
    assert [g[1] for g in gaps] == pytest.approx([1.5, 1.0, 1.0])
    assert program_trace.idle_by_training_label(recorded, program) == pytest.approx(
        {"CheckpointManager.restore": 1.5, "restore.read": 1.0, "outside_program": 1.0})
    named = program_trace.restore_idle_named(recorded, program)
    assert named == pytest.approx({"idle_s": 2.5, "named_below_root_s": 1.0, "share": 0.4})
    slack = program_trace.root_slack_us(recorded, program)
    assert slack["CheckpointManager.restore"] == pytest.approx([0.0, 0.1e6, 1], abs=1e-3)
    assert slack["Snapshot.async_take"] == pytest.approx([0.05e6, 0.05e6, 2], abs=1e-3)
    assert slack["CheckpointManager.wait"] == pytest.approx([0.05e6, 0.05e6, 1], abs=1e-3)


def test_the_newest_matching_trace_is_this_run_s(recorded, tmp_path):
    """Another cell's older trace in the same directory is passed over."""
    other = tmp_path / "other"
    other.mkdir()
    write_traces(other, SPANS[:3], name="older")
    for f in other.iterdir():
        f.rename(tmp_path / f.name)
    assert program_trace.for_context(recorded).training_tid == 1
    assert len(program_trace.for_context(recorded).spans) == len(SPANS)


def test_cli_prints_the_named_gaps(recorded, tmp_path, capsys):
    assert program_trace.main(["cell", "--dir", str(tmp_path)]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["spans"] == len(SPANS) and out["restore_idle_named"]["share"] == pytest.approx(0.4)
    assert out["library_idle_s_window_s"] == pytest.approx([2.4, 10.0])
    assert program_trace.main(["missing", "--dir", str(tmp_path)]) == 2
