"""snapwatch on the port: live progress records + watch straggler
detection, cross-rank trace merge + critical path, and the anomaly
doctor — the cases of the JAX package's ``tests/test_progress_watch.py``
(all but its ``tools/bench_compare.py`` cases, a benchmark tool the port
does not have), with states of CPU tensors."""

import asyncio
import json
import os
import threading
import time
import uuid

import numpy as np
import pytest
import torch

from torchsnapshot_tpu_torch import Snapshot, telemetry, tracing
from torchsnapshot_tpu_torch.storage_plugin import (
    _MEMORY_STORES,
    set_plugin_wrap_hook,
)
from torchsnapshot_tpu_torch.telemetry import doctor, merge
from torchsnapshot_tpu_torch.telemetry import progress as liveprog
from torchsnapshot_tpu_torch.telemetry import summarize, watch
from torchsnapshot_tpu_torch.utils.test_utils import run_thread_ranks


@pytest.fixture(autouse=True)
def _fresh_registry():
    telemetry.reset()
    yield
    telemetry.reset()


class _Model:
    def __init__(self, params):
        self.params = params

    def state_dict(self):
        return self.params

    def load_state_dict(self, sd):
        self.params = sd


def _rank_state(rank: int, n: int = 8192):
    rng = np.random.RandomState(rank + 1)
    return {"w": torch.from_numpy(rng.randn(n).astype(np.float32))}


# ------------------------------------------------------------ publisher unit


def test_publisher_statusfile_roundtrip(tmp_path):
    pub = liveprog.ProgressPublisher(
        kind="take",
        path="memory://x/y",
        rank=2,
        world_size=4,
        statusfile_dir=str(tmp_path),
        interval_s=0.0,
    )
    pub.set_phase("write")
    pub.add_bytes_total(100)
    pub.pipeline_update("write", 40)
    rec = json.load(open(tmp_path / "rank2.progress.json"))
    assert rec["format_version"] == liveprog.PROGRESS_FORMAT_VERSION
    assert rec["phase"] == "write"
    assert rec["rank"] == 2
    assert rec["world_size"] == 4
    assert rec["bytes_done"] == 40
    assert rec["bytes_total"] == 100
    assert rec["ops"] == {"write": 1}
    assert rec["heartbeat_at"] >= rec["started_at"]
    pub.finish()
    rec = json.load(open(tmp_path / "rank2.progress.json"))
    assert rec["phase"] == liveprog.DONE_PHASE


def test_sync_take_and_restore_publish_statusfiles(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUSNAPSHOT_PROGRESS_DIR", str(tmp_path / "prog"))
    monkeypatch.setenv("TPUSNAPSHOT_PROGRESS_INTERVAL_S", "0")
    model = _Model(_rank_state(0))
    snap = Snapshot.take(str(tmp_path / "snap"), {"m": model})
    rec = json.load(open(tmp_path / "prog" / "rank0.progress.json"))
    assert rec["phase"] == "done"
    assert rec["kind"] == "take"
    assert rec["bytes_done"] == 8192 * 4
    assert rec["bytes_total"] == 8192 * 4
    snap.restore({"m": _Model(_rank_state(0))})
    rec = json.load(open(tmp_path / "prog" / "rank0.progress.json"))
    assert rec["kind"] == "restore"
    assert rec["phase"] == "done"
    assert rec["bytes_done"] == 8192 * 4
    # watch's directory mode renders the statusfiles
    grouped = watch.collect(str(tmp_path / "prog"))
    (records,) = grouped.values()
    out = watch.render_progress(records, stale_after_s=3600)
    assert "restore" in out and "done" in out
    # a finished operation's lingering statusfile renders but does NOT
    # count as in-flight: the scripting contract (exit 1 = idle) holds
    assert watch.main([str(tmp_path / "prog")]) == 1


# -------------------------------------------- acceptance: in-flight 4 ranks


class _GatedWrites:
    """Wrap hook plugin: writes whose path starts with ``prefix`` block
    until the gate opens — a deterministic 'paused in write phase'."""

    def __init__(self, inner, gate: threading.Event, prefix: str) -> None:
        self._inner = inner
        self._gate = gate
        self._prefix = prefix

    async def write(self, io_req):
        if io_req.path.startswith(self._prefix):
            while not self._gate.is_set():
                await asyncio.sleep(0.01)
        await self._inner.write(io_req)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def test_watch_four_rank_inflight_take_flags_straggler(
    monkeypatch, capsys
):
    """Acceptance: an in-flight (paused-in-phase) 4-rank async take —
    watch reports per-rank phase + bytes, and flags the gated rank's
    stale heartbeat as a straggler within the staleness window."""
    monkeypatch.setenv("TPUSNAPSHOT_PROGRESS_INTERVAL_S", "0")
    bucket = f"watchacc-{uuid.uuid4().hex[:10]}"
    url = f"memory://{bucket}/snap"
    gate = threading.Event()
    # Rank 3's payload objects live under "3/…": only they block.
    prev = set_plugin_wrap_hook(
        lambda plugin, u: _GatedWrites(plugin, gate, "3/")
    )
    try:
        def fn(coord, rank):
            return Snapshot.async_take(
                url, {"m": _Model(_rank_state(rank))}, coord=coord
            )

        pendings = run_thread_ranks(4, fn)

        # The drains run in background threads; wait until the expected
        # in-flight picture is observable: rank 3 paused mid-write,
        # ranks 1-2 done (terminal record pre-marker), rank 0 polling
        # markers in its commit phase.
        deadline = time.monotonic() + 30
        records = {}
        while time.monotonic() < deadline:
            ops = watch.collect(url)
            if ops:
                (records,) = ops.values()
                phases = {
                    r: rec.get("phase") for r, rec in records.items()
                }
                if (
                    len(records) == 4
                    and phases.get(3) == "write"
                    and phases.get(1) == "done"
                    and phases.get(2) == "done"
                    and phases.get(0) == "commit"
                ):
                    break
            time.sleep(0.05)
        assert len(records) == 4, f"records: {records.keys()}"

        # Let rank 3's heartbeat age past the staleness window.
        time.sleep(0.5)
        records = next(iter(watch.collect(url).values()))
        out = watch.render_progress(records, stale_after_s=0.3)
        lines = {
            int(line.split()[0]): line
            for line in out.splitlines()
            if line.strip() and line.split()[0].isdigit()
        }
        # Per-rank phase + bytes.
        assert "write" in lines[3] and "STALE" in lines[3]
        assert "done" in lines[1] and "STALE" not in lines[1]
        assert "done" in lines[2]
        assert "commit" in lines[0]
        nbytes = 8192 * 4
        for r in (1, 2):
            assert records[r]["bytes_done"] == nbytes
            assert records[r]["bytes_total"] == nbytes
        assert records[3]["bytes_done"] < nbytes
        assert records[3]["bytes_total"] == nbytes
        # The straggler summary names rank 3 (rank 0 legitimately also
        # reads stale: it is stuck waiting on rank 3's marker).
        straggler = [l for l in out.splitlines() if "STRAGGLER" in l]
        assert straggler and "3" in straggler[0]

        # The CLI renders the same picture and exits 0.
        assert watch.main([url, "--stale-after", "0.3"]) == 0
        cli_out = capsys.readouterr().out
        assert "STALE" in cli_out and "async_take in flight" in cli_out

        # Unblock the straggler: the take commits and every progress
        # object is cleaned at commit.
        gate.set()
        for pending in pendings:
            pending.wait(timeout_s=60)
    finally:
        gate.set()
        set_plugin_wrap_hook(prev)
    store = _MEMORY_STORES[bucket]
    assert "snap/.snapshot_metadata" in store
    assert [k for k in store if ".progress" in k] == []
    # Nothing in flight anymore: watch reports so and exits 1.
    assert watch.main([url]) == 1


# ----------------------------------------------------------- trace metadata


def test_trace_metadata_roundtrip(tmp_path):
    """Satellite: every flushed trace is self-describing — wall-clock
    epoch, rank, hostname — even single-rank ones."""
    import socket

    before = time.time()
    tracing.set_identity(rank=5)
    tracing.enable(str(tmp_path / "t.json"))
    with tracing.span("write", bytes=4):
        pass
    tracing.disable()
    doc = json.load(open(tmp_path / "t.json"))
    meta = doc["metadata"]
    assert before <= meta["clock_epoch_s"] <= time.time()
    assert meta["rank"] == 5
    assert meta["host"] == socket.gethostname()
    assert meta["pid"] == os.getpid()
    # merge's loader reads the same fields back
    loaded = merge.trace_meta(merge.load_trace(str(tmp_path / "t.json")), 0)
    assert loaded["rank"] == 5
    assert loaded["clock_epoch_s"] == meta["clock_epoch_s"]
    tracing.set_identity(rank=0)  # don't leak rank into other tests


def test_store_coordinator_emits_barrier_instants(tmp_path):
    """Barrier exits land in the trace as the merge's skew anchors."""
    from torchsnapshot_tpu_torch.coord import DictStore, StoreCoordinator

    tracing.enable(str(tmp_path / "b.json"))
    try:
        coord = StoreCoordinator(DictStore(), 0, 1, timeout_s=5)
        coord.barrier()
        coord.barrier()
    finally:
        tracing.disable()
    doc = json.load(open(tmp_path / "b.json"))
    gens = [
        e["args"]["gen"]
        for e in doc["traceEvents"]
        if e.get("name") == "barrier_exit"
    ]
    assert len(gens) == 2 and gens[0] != gens[1]


# ------------------------------------------------------------- trace merge


def _synthetic_rank_trace(rank, epoch, write_end_us, skew_s=0.0):
    """One rank's trace: a shared barrier at ts=1ms, then a write span.
    ``skew_s`` shifts the recorded wall clock (a wrong host clock)."""
    events = [
        {
            "name": "barrier_exit",
            "ph": "i",
            "s": "p",
            "ts": 1000.0,
            "pid": 1,
            "tid": 1,
            "args": {"gen": 1},
        },
        {
            "name": "write",
            "ph": "b",
            "id": 1,
            "ts": 2000.0,
            "pid": 1,
            "tid": 1,
            "args": {"bytes": 1 << 20},
        },
        {
            "name": "write",
            "ph": "e",
            "id": 1,
            "ts": float(write_end_us),
            "pid": 1,
            "tid": 1,
        },
    ]
    if rank == 0:
        events.append(
            {
                "name": "metadata_committed",
                "ph": "i",
                "s": "p",
                "ts": float(write_end_us + 500_000),
                "pid": 1,
                "tid": 1,
            }
        )
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "metadata": {
            "clock_epoch_s": epoch + skew_s,
            "rank": rank,
            "host": f"host{rank}",
            "pid": 100 + rank,
        },
    }


def test_merge_four_ranks_monotonic_clock_and_gating_rank(tmp_path, capsys):
    """Acceptance: merge over 4 per-rank traces yields one
    monotonic-clock trace whose critical path names the gating rank;
    the injected clock skew is detected and corrected."""
    epoch = 1_700_000_000.0
    # Rank 2 works 0.9s — the gater; rank 1's host clock is 0.25s fast.
    docs = {
        0: _synthetic_rank_trace(0, epoch, 950_000),
        1: _synthetic_rank_trace(1, epoch, 60_000, skew_s=0.25),
        2: _synthetic_rank_trace(2, epoch, 900_000),
        3: _synthetic_rank_trace(3, epoch, 55_000),
    }
    paths = []
    for rank, doc in docs.items():
        p = tmp_path / f"rank{rank}.json"
        p.write_text(json.dumps(doc))
        paths.append(str(p))
    merged_path = str(tmp_path / "merged.json")
    assert (
        merge.main(paths + ["-o", merged_path, "--json"]) == 0
    )
    info = json.loads(capsys.readouterr().out)
    assert info["skew_s"]["1"] == pytest.approx(0.25, abs=0.01)
    for r in ("0", "2", "3"):
        assert info["skew_s"][r] == pytest.approx(0.0, abs=0.01)
    cp = info["critical_path"]
    # Rank 0's write ends at 0.95s — the gating rank; rank 2 is close
    # behind; skew-corrected rank 1 lands with the short ranks.
    assert cp["gating_rank"] == 0
    assert cp["gating_phase"] == "write"
    slack = {row["rank"]: row["slack_s"] for row in cp["per_rank"]}
    assert slack[0] == 0.0
    assert slack[2] == pytest.approx(0.05, abs=0.01)
    assert slack[1] == pytest.approx(0.89, abs=0.02)

    merged = json.load(open(merged_path))
    assert merged["metadata"]["merged"] is True
    ts = [e["ts"] for e in merged["traceEvents"] if "ts" in e]
    assert all(t >= 0 for t in ts)
    assert ts == sorted(ts)  # one monotonic clock
    # per-rank process naming for Perfetto
    names = {
        e["pid"]: e["args"]["name"]
        for e in merged["traceEvents"]
        if e.get("ph") == "M" and e.get("name") == "process_name"
    }
    assert names[2] == "rank 2 (host2)"
    # span ids are namespaced per rank (no cross-rank begin/end pairing)
    ids = {
        e["id"]
        for e in merged["traceEvents"]
        if e.get("ph") in ("b", "e")
    }
    assert ids == {f"r{r}:1" for r in range(4)}

    # summarize recognizes the merged trace and names the gating rank
    assert summarize.main([merged_path]) == 0
    out = capsys.readouterr().out
    assert "critical path: rank 0 gated the commit" in out
    assert summarize.main([merged_path, "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["cross_rank"]["critical_path"]["gating_rank"] == 0


def test_merge_rejects_duplicate_ranks(tmp_path):
    doc = _synthetic_rank_trace(1, 1000.0, 5000)
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    a.write_text(json.dumps(doc))
    b.write_text(json.dumps(doc))
    assert merge.main([str(a), str(b), "-o", str(tmp_path / "m.json")]) == 2


def test_merge_real_traces_from_two_takes(tmp_path, capsys):
    """End-to-end: two real flushed traces (distinct ranks stamped)
    merge into a loadable, summarizable timeline."""
    for rank in (0, 1):
        tracing.enable(str(tmp_path / f"r{rank}.json"))
        model = _Model(_rank_state(rank, 1024))
        Snapshot.take(str(tmp_path / f"snap{rank}"), {"m": model})
        # Both takes ran as (single-process) rank 0; restamp the second
        # before its flush to simulate a peer rank's trace.
        tracing.set_identity(rank=rank)
        tracing.disable()
    tracing.set_identity(rank=0)
    merged = str(tmp_path / "m.json")
    assert (
        merge.main(
            [str(tmp_path / "r0.json"), str(tmp_path / "r1.json"), "-o", merged]
        )
        == 0
    )
    capsys.readouterr()
    assert summarize.main([merged]) == 0
    out = capsys.readouterr().out
    assert "critical path: rank" in out


# ------------------------------------------------------------------ doctor


def _restore_report(read_s, consume_s, assemble_s=0.0, wall_s=None):
    wall = wall_s if wall_s is not None else read_s + consume_s + assemble_s
    return {
        "format_version": 1,
        "kind": "restore",
        "path": "memory://x/snap",
        "take_id": None,
        "world_size": 1,
        "ranks": [
            {
                "rank": 0,
                "wall_s": wall,
                "phases": {
                    "read_s": read_s,
                    "consume_s": consume_s,
                    "assemble_s": assemble_s,
                },
                "bytes": 209715200,
                "budget": {"high_water_bytes": 0, "stall_s": 0.0},
                "retries": {"total": 0},
            }
        ],
        "totals": {
            "bytes": 209715200,
            "wall_s": wall,
            "retries": 0,
            "faults": 0,
            "stall_s": 0.0,
        },
    }


def test_doctor_flags_bench_r05_consume_dominated_restore():
    """Acceptance: a BENCH_r05-shaped restore report (consume 176.3s vs
    read 0.76s) emits the consume-dominated finding with evidence and a
    remediation hint."""
    report = _restore_report(read_s=0.76, consume_s=176.3, assemble_s=1.21)
    findings = doctor.diagnose_report(report)
    rules = [f.rule for f in findings]
    assert "consume-dominated-restore" in rules
    f = next(x for x in findings if x.rule == "consume-dominated-restore")
    assert f.severity == "critical"
    assert f.evidence["consume_s"] == pytest.approx(176.3)
    assert f.evidence["read_s"] == pytest.approx(0.76)
    assert "deserialization" in f.remediation
    assert "storage is innocent" in f.remediation


def test_doctor_healthy_report_is_silent():
    report = _restore_report(read_s=1.0, consume_s=1.5)
    assert doctor.diagnose_report(report) == []


def test_doctor_read_dominated_restore():
    findings = doctor.diagnose_report(
        _restore_report(read_s=30.0, consume_s=1.0)
    )
    assert [f.rule for f in findings] == ["read-dominated-restore"]


def _take_report(rank_summaries, retries=0):
    return {
        "format_version": 1,
        "kind": "take",
        "path": "memory://x/snap",
        "take_id": "abc",
        "world_size": len(rank_summaries),
        "ranks": rank_summaries,
        "totals": {
            "bytes": sum((s or {}).get("bytes", 0) for s in rank_summaries),
            "wall_s": max(
                ((s or {}).get("wall_s", 0) for s in rank_summaries),
                default=0,
            ),
            "retries": retries,
            "faults": 0,
            "stall_s": sum(
                (s or {}).get("budget", {}).get("stall_s", 0)
                for s in rank_summaries
                if s
            ),
        },
    }


def _rank_summary(rank, wall_s=10.0, nbytes=1 << 26, stall_s=0.0, retries=0):
    return {
        "rank": rank,
        "wall_s": wall_s,
        "phases": {"capture_s": 0.1, "write_s": wall_s - 0.1},
        "bytes": nbytes,
        "budget": {"high_water_bytes": nbytes, "stall_s": stall_s},
        "scheduler_ops": {
            "stage": {"count": 4, "seconds": 0.5, "bytes": nbytes},
            "write": {"count": 4, "seconds": wall_s - 1, "bytes": nbytes},
        },
        "retries": {"total": retries, "backoff_s": 0.0, "by_op": {}},
        "faults": {},
    }


def test_doctor_straggler_and_stripe_and_storm_and_stall():
    report = _take_report(
        [
            _rank_summary(0, wall_s=30.0, nbytes=1 << 28, retries=12),
            _rank_summary(1, wall_s=4.0),
            _rank_summary(2, wall_s=4.2, stall_s=2.0),
            _rank_summary(3, wall_s=4.1),
        ],
        retries=12,
    )
    rules = {f.rule for f in doctor.diagnose_report(report)}
    assert "straggler-rank" in rules
    assert "imbalanced-stripe" in rules
    assert "retry-storm" in rules
    assert "budget-stall-dominated" in rules
    # critical findings sort first
    findings = doctor.diagnose_report(report)
    assert findings[0].severity == "critical"


def test_doctor_missing_rank_summary():
    report = _take_report(
        [_rank_summary(0, wall_s=3.0), None, _rank_summary(2, wall_s=3.0)]
    )
    rules = [f.rule for f in doctor.diagnose_report(report)]
    assert "missing-rank-summary" in rules


def test_doctor_cli_and_inspect(tmp_path, capsys):
    # report-file mode: findings -> exit 1, rendered with remediation
    rp = tmp_path / "report.json"
    rp.write_text(json.dumps(_restore_report(0.76, 176.3)))
    assert doctor.main([str(rp)]) == 1
    out = capsys.readouterr().out
    assert "consume-dominated-restore" in out and "remediation" in out
    assert doctor.main([str(rp), "--json"]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc[0]["rule"] == "consume-dominated-restore"

    # snapshot mode via inspect --doctor: a healthy real snapshot
    from torchsnapshot_tpu_torch.inspect import main as inspect_main

    model = _Model(_rank_state(0, 2048))
    snap = Snapshot.take(str(tmp_path / "snap"), {"m": model})
    snap.restore({"m": _Model(_rank_state(0, 2048))})
    assert inspect_main([str(tmp_path / "snap"), "--doctor"]) == 0
    assert "no findings" in capsys.readouterr().out
    # no report at all -> exit 2
    assert doctor.main([str(tmp_path / "nothing-here")]) == 2


def test_doctor_trace_verdict_bridges_into_findings(tmp_path):
    summary = {
        "verdict": {
            "pipeline": "restore",
            "dominant_phase": "consume",
            "busy_s": 176.3,
            "sibling": "read",
            "sibling_busy_s": 0.76,
            "dominated": True,
        }
    }
    findings = doctor.diagnose([], trace_summary=summary)
    assert [f.rule for f in findings] == ["consume-dominated-restore"]


# ------------------------------------------------------- progress lifecycle


@pytest.mark.faultline
def test_progress_objects_never_survive_commit_or_detected_crash(
    tmp_path, monkeypatch
):
    """Satellite acceptance: .progress/<take_id>/<rank> objects are
    cleaned at commit, and reconcile reclaims the debris of a take that
    crashed mid-drain (the detected-crash arm)."""
    from torchsnapshot_tpu_torch import CheckpointManager
    from torchsnapshot_tpu_torch import faultline as fl

    monkeypatch.setenv("TPUSNAPSHOT_SWEEP_MIN_AGE_S", "0")
    monkeypatch.setenv("TPUSNAPSHOT_PROGRESS_INTERVAL_S", "0")
    base = str(tmp_path / "run")
    mgr = CheckpointManager(base, max_to_keep=3)

    # Commit arm: a clean async save leaves no progress object.
    handle = mgr.async_save(0, {"m": _Model(_rank_state(0, 1024))})
    handle.wait()
    leftovers = [
        os.path.join(dp, f)
        for dp, _, fs in os.walk(base)
        for f in fs
        if ".progress" in os.path.join(dp, f)
    ]
    assert leftovers == []

    # Crash arm: the drain dies mid-payload-write; the published
    # progress record is debris only until reconcile runs.
    sched = fl.FaultSchedule().crash_on(op="write", path="0/m/*")
    with fl.inject(sched):
        handle = mgr.async_save(1, {"m": _Model(_rank_state(1, 1024))})
        with pytest.raises(fl.SimulatedCrash):
            handle.wait()
    debris = [
        os.path.join(dp, f)
        for dp, _, fs in os.walk(base)
        for f in fs
        if ".progress" in os.path.join(dp, f)
    ]
    assert debris, "the crashed drain published a progress record"
    CheckpointManager(base).reconcile(adopt=True)
    debris = [
        os.path.join(dp, f)
        for dp, _, fs in os.walk(base)
        for f in fs
        if ".progress" in os.path.join(dp, f)
    ]
    assert debris == []
    # The committed step survived untouched.
    assert CheckpointManager(base).all_steps() == [0]


@pytest.mark.faultline
def test_reconcile_reclaims_progress_debris_under_committed_step(
    tmp_path, monkeypatch
):
    """A crash between commit and the rank-0 sweep leaves progress
    records under a COMMITTED step — exactly what
    _clean_progress_debris exists for (no sweep revisits a committed
    prefix)."""
    from torchsnapshot_tpu_torch import CheckpointManager

    monkeypatch.setenv("TPUSNAPSHOT_SWEEP_MIN_AGE_S", "0")
    base = str(tmp_path / "run")
    mgr = CheckpointManager(base, max_to_keep=3)
    mgr.save(0, {"m": _Model(_rank_state(0, 1024))})
    debris_dir = os.path.join(base, "step-0", ".progress", "deadbeef")
    os.makedirs(debris_dir)
    with open(os.path.join(debris_dir, "1"), "w") as f:
        json.dump({"rank": 1, "phase": "commit"}, f)
    CheckpointManager(base).reconcile(adopt=True)
    assert not os.path.exists(os.path.join(debris_dir, "1"))
    assert CheckpointManager(base).all_steps() == [0]


@pytest.mark.faultline
def test_reconcile_age_guard_spares_young_progress_records(
    tmp_path, monkeypatch
):
    """An in-flight take's live records must survive reconcile."""
    from torchsnapshot_tpu_torch import CheckpointManager

    monkeypatch.setenv("TPUSNAPSHOT_SWEEP_MIN_AGE_S", "3600")
    base = str(tmp_path / "run")
    mgr = CheckpointManager(base, max_to_keep=3)
    mgr.save(0, {"m": _Model(_rank_state(0, 1024))})
    debris = os.path.join(base, "step-0", ".progress", "live", "0")
    os.makedirs(os.path.dirname(debris))
    with open(debris, "w") as f:
        json.dump({"rank": 0, "phase": "write"}, f)
    CheckpointManager(base).reconcile(adopt=True)
    assert os.path.exists(debris)


def test_delete_removes_progress_debris(tmp_path):
    model = _Model(_rank_state(0, 1024))
    snap = Snapshot.take(str(tmp_path / "snap"), {"m": model})
    debris = tmp_path / "snap" / ".progress" / "dead" / "0"
    debris.parent.mkdir(parents=True)
    debris.write_text("{}")
    snap.delete()
    assert not debris.exists()
