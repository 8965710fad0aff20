"""The port's spans inside an async take, its drain, the manager's wait and
a restore: each under its operation's trace id with a ``parent`` naming the
span that caused it; nothing recorded with tracing off; the tracer's clock
against ``torch.profiler``'s; ``FlightRecorder.phase`` as one instrument.
No JAX import."""

import json
import threading
import time
import uuid

import numpy as np
import pytest
import torch

from torchsnapshot_tpu_torch import Snapshot, StateDict, tracing
from torchsnapshot_tpu_torch.manager import CheckpointManager
from torchsnapshot_tpu_torch.telemetry import merge
from torchsnapshot_tpu_torch.telemetry.report import FlightRecorder

# The spans of one async_save -> wait -> restore on memory:// from a CPU
# state, by root. ``d2h`` (CUDA tensors only) is held on the card
# (test_torch_trace_spans_cuda.py); ``consume.pool_wait`` in its own case.
TAKE_SPANS = {
    "Snapshot.async_take", "phase.capture", "phase.prestage", "clone", "drain", "phase.write",
    "stage", "write", "durable", "progress", "phase.commit", "CheckpointManager.wait",
    "drain_join", "CheckpointManager.finalize", "marker", "prune",
}
RESTORE_SPANS = {
    "CheckpointManager.restore", "Snapshot.restore", "restore.plan", "restore.stateful",
    "restore.read", "read", "consume", "consume.verify", "consume.deserialize",
    "consume.h2d_overlap", "assemble", "restore.assemble", "restore.report",
}
# Spans that begin a trace's tree: the operation's root, and the waits that
# adopt a take's id after its root has closed.
ROOTS = {"Snapshot.async_take", "CheckpointManager.wait", "CheckpointManager.restore"}


@pytest.fixture(autouse=True)
def _tracing_off():
    tracing.disable()
    yield
    tracing.disable()


def _state(n=4096):
    rng = np.random.default_rng(5)
    return {
        "m": StateDict(w=torch.from_numpy(rng.standard_normal((n, 8)).astype(np.float32)),
                       b=torch.arange(37, dtype=torch.int64), note={1, 2, 3}),
    }


def _cycle(base):
    manager = CheckpointManager(base, max_to_keep=1)
    state = _state()
    manager.async_save(1, state).wait()
    manager.async_save(2, state).wait()
    fresh = _state()
    fresh["m"]["w"].zero_()
    assert manager.restore(fresh) == 2
    assert torch.equal(fresh["m"]["w"], state["m"]["w"])


def _spans(path):
    with open(path) as f:
        doc = json.load(f)
    begins, ends = {}, {}
    for e in doc["traceEvents"]:
        if e.get("ph") == "b":
            begins[e["id"]] = e
        elif e.get("ph") == "e":
            ends[e["id"]] = e
    assert set(begins) == set(ends)
    return doc, [dict(b, end=ends[i]["ts"], end_args=ends[i].get("args", {})) for i, b in begins.items()]


def _traced_cycle(tmp_path):
    path = str(tmp_path / "trace.json")
    tracing.enable(path)
    try:
        _cycle(f"memory://spans-{uuid.uuid4().hex}/run")
    finally:
        tracing.disable()
    return _spans(path)


def test_every_span_joins_its_root_under_one_trace_id(tmp_path):
    _, spans = _traced_cycle(tmp_path)
    by_id = {s["id"]: s for s in spans}
    names = {s["name"] for s in spans}
    assert TAKE_SPANS | RESTORE_SPANS <= names, sorted((TAKE_SPANS | RESTORE_SPANS) - names)
    traces = {}
    for s in spans:
        trace = s.get("args", {}).get("trace")
        assert trace is not None, s["name"]
        traces.setdefault(trace, set()).add(s["name"])
        parent = s.get("parent")
        if s["name"] in ROOTS:
            assert parent is None, s["name"]
            continue
        assert parent in by_id, s["name"]
        cause = by_id[parent]
        # The cause is of the same operation and had begun; on the same
        # thread it is still open (a drain outlives its take's root).
        assert cause["args"]["trace"] == trace, (s["name"], cause["name"])
        assert cause["ts"] <= s["ts"], (s["name"], cause["name"])
        if cause["tid"] == s["tid"]:
            assert s["end"] <= cause["end"], (s["name"], cause["name"])
    takes = [t for t in traces if t.startswith("async_take-")]
    restores = [t for t in traces if t.startswith("restore-")]
    assert len(takes) == 2 and len(restores) == 1
    for t in takes:
        assert traces[t] == TAKE_SPANS, sorted(traces[t] ^ TAKE_SPANS)
    assert traces[restores[0]] >= RESTORE_SPANS
    # The drain and its phases run on the drain's thread, the waits on the
    # caller's; the drain's parent is its take's root.
    drain = [s for s in spans if s["name"] == "drain"][0]
    assert by_id[drain["parent"]]["name"] == "Snapshot.async_take"
    assert drain["tid"] != by_id[drain["parent"]]["tid"]
    clone = [s for s in spans if s["name"] == "clone"][0]
    assert clone["end_args"] == {"fell_back": False} and clone["args"]["leaves"] == 0


def test_pool_wait_is_a_span_under_the_waiting_thread_s_trace(tmp_path):
    from torchsnapshot_tpu_torch import staging_pool
    from torchsnapshot_tpu_torch.telemetry import consume_profile as cprof

    pool = staging_pool.StagingPool(capacity_bytes=4096, max_wait_s=5.0)
    profile = cprof.ConsumeProfile()
    first = pool.acquire(4096)
    path = str(tmp_path / "trace.json")
    tracing.enable(path)
    try:
        with tracing.trace_scope("restore") as tid, tracing.span("consume"):
            release = threading.Timer(0.05, first.release)
            release.start()

            def consume():
                with cprof.consume_section():
                    return pool.acquire(4096, profile)

            # The consumer runs on an executor thread, as a restore's do.
            second = [None]
            t = threading.Thread(target=tracing.carry(lambda: second.__setitem__(0, consume())))
            t.start()
            t.join(timeout=30)
            release.join(timeout=30)
            assert not t.is_alive() and not release.is_alive()
    finally:
        tracing.disable()
    second[0].release()
    _, spans = _spans(path)
    by_name = {s["name"]: s for s in spans}
    wait = by_name["consume.pool_wait"]
    assert wait["args"] == {"bytes": 4096, "trace": tid}
    assert wait["parent"] == by_name["consume"]["id"] and wait["tid"] != by_name["consume"]["tid"]
    assert profile.summary()["pool_wait"]["count"] == 1


def test_sync_save_finalize_carries_the_take_trace_id(tmp_path):
    path = str(tmp_path / "trace.json")
    tracing.enable(path)
    try:
        CheckpointManager(f"memory://spans-{uuid.uuid4().hex}/run").save(1, _state())
    finally:
        tracing.disable()
    _, spans = _spans(path)
    take = [s for s in spans if s["name"] == "Snapshot.take"][0]
    finalize = [s for s in spans if s["name"] == "CheckpointManager.finalize"][0]
    assert take["args"]["trace"] == finalize["args"]["trace"]
    assert take["args"]["trace"].startswith("take-") and finalize["args"]["step"] == 1
    phases = {s["name"] for s in spans if s["name"].startswith("phase.")}
    assert phases == {"phase.capture", "phase.write", "phase.commit"}


def test_tracing_off_records_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert not tracing.enabled()
    _cycle(f"memory://spans-{uuid.uuid4().hex}/run")
    assert tracing._events is None and tracing.flush() is None
    assert not list(tmp_path.iterdir())
    with tracing.span("nothing", n=1) as end:
        assert end is None
    assert tracing.current_span_id() is None

    def fn():
        return 1

    assert tracing.carry(fn) is fn


def test_carry_and_adopt_give_a_thread_the_trace_and_the_parent(tmp_path):
    path = str(tmp_path / "trace.json")
    tracing.enable(path)
    seen = {}
    try:
        with tracing.trace_scope("restore") as tid, tracing.span("outer"):
            outer = tracing.current_span_id()

            def work():
                seen["trace"] = tracing.current_trace_id()
                with tracing.span("inner"):
                    pass

            t = threading.Thread(target=tracing.carry(work))
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
            # join=True keeps an enclosing scope of the same kind; another
            # kind nests a fresh id.
            with tracing.trace_scope("restore", join=True) as joined:
                assert joined == tid
            with tracing.trace_scope("take", join=True) as other:
                assert other != tid
        with tracing.adopt_trace(tid, parent=outer), tracing.span("adopted"):
            pass
    finally:
        tracing.disable()
    _, spans = _spans(path)
    by_name = {s["name"]: s for s in spans}
    assert seen["trace"] == tid
    assert by_name["inner"]["parent"] == by_name["adopted"]["parent"] == by_name["outer"]["id"]
    assert by_name["inner"]["args"]["trace"] == by_name["adopted"]["args"]["trace"] == tid
    assert "parent" not in by_name["outer"] and "parent" not in by_name["inner"]["args"]


def test_clock_pair_reads_one_instant():
    mono, wall = tracing._clock_pair()
    assert abs(mono - time.monotonic()) < 0.5 and abs(wall - time.time()) < 0.5
    for _ in range(3):
        m0 = time.monotonic()
        mono, wall = tracing._clock_pair()
        w1 = time.time()
        assert m0 <= mono <= time.monotonic() and wall <= w1


def test_port_span_maps_onto_a_record_function_region(tmp_path):
    """A span around a ``torch.profiler.record_function`` region lands on
    it on the profiler's clock: ``clock_epoch_s*1e6 + ts -
    baseTimeNanoseconds/1e3``, within 1 ms at each end (the median of five
    regions)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    path = str(tmp_path / "spans.json")
    tracing.enable(path)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for i in range(5):
                with tracing.span(f"region{i}"), record_function(f"region{i}"):
                    time.sleep(0.02)
        prof.export_chrome_trace(str(tmp_path / "prof.json"))
    finally:
        tracing.disable()
    with open(tmp_path / "prof.json") as f:
        prof_doc = json.load(f)
    base_us = int(prof_doc["baseTimeNanoseconds"]) / 1e3
    regions = {e["name"]: e for e in prof_doc["traceEvents"]
               if e.get("ph") == "X" and str(e.get("name", "")).startswith("region")}
    doc, spans = _spans(path)
    epoch_us = doc["metadata"]["clock_epoch_s"] * 1e6
    starts, ends = [], []
    for s in spans:
        r = regions[s["name"]]
        starts.append(epoch_us + s["ts"] - base_us - r["ts"])
        ends.append(epoch_us + s["end"] - base_us - (r["ts"] + r["dur"]))
    assert abs(float(np.median(starts))) < 1000.0, starts
    assert abs(float(np.median(ends))) < 1000.0, ends


def test_flight_recorder_phase_is_the_span_and_the_report_keys_stay(tmp_path):
    path = str(tmp_path / "trace.json")
    tracing.enable(path)
    try:
        recorder = FlightRecorder(kind="take", path="p", rank=0)
        with recorder.phase("write"):
            pass
        with recorder.phase("write"):
            pass
        with recorder.phase("incremental", "Snapshot.incremental", path="p"):
            pass
        recorder.add_phase("read", 0.5)
        summary = recorder.rank_summary()
    finally:
        tracing.disable()
    assert sorted(summary["phases"]) == ["incremental_s", "read_s", "write_s"]
    assert summary["phases"]["read_s"] == 0.5
    _, spans = _spans(path)
    assert [s["name"] for s in spans] == ["phase.write", "phase.write", "Snapshot.incremental"]
    assert spans[2]["args"] == {"path": "p"}
    # With tracing off the phase is timed all the same.
    recorder = FlightRecorder(kind="take", path="p", rank=0)
    with recorder.phase("commit"):
        pass
    assert list(recorder.rank_summary()["phases"]) == ["commit_s"]


def test_async_take_report_phases_are_unchanged(tmp_path):
    path = str(tmp_path / "snap")
    pending = Snapshot.async_take(path, _state())
    pending.wait()
    with open(f"{path}/.report.json") as f:
        report = json.load(f)
    # The rank summary rides the commit marker, so it closes before commit.
    assert sorted(report["ranks"][0]["phases"]) == ["capture_s", "prestage_s", "write_s"]


def test_merge_namespaces_parents_with_their_ids(tmp_path):
    _, _ = _traced_cycle(tmp_path)
    doc = merge.load_trace(str(tmp_path / "trace.json"))
    merged, _ = merge.merge_traces([doc])
    begins = {e["id"]: e for e in merged["traceEvents"] if e.get("ph") == "b"}
    parents = [e["parent"] for e in begins.values() if "parent" in e]
    assert parents and all(p in begins for p in parents)
