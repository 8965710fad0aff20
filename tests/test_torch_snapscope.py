"""snapscope on the port: runtime sampler, durability-lag (RPO)
accounting, the SLO burn-rate engine, and the unified ops view — the
cases of the JAX package's ``tests/test_snapscope.py``, with states of
CPU tensors.

Covers the live-ops acceptance criteria: ``introspect()`` consistency,
the end-to-end durability-lag chain (per-object histogram → watermark →
flight report → ledger ``tierdown`` event → doctor rule → SLO exit
code), the ``slow_drain`` faultline schedule firing the alerts
deterministically, sampler crash isolation + statusfile/scope-object
lifecycle (never survive delete / detected crash), tier-down progress
records, and the ops CLI exit-code contract (live backlog drains to
zero → 0; stranded drain → nonzero naming the root).
"""

import asyncio
import contextlib
import io as _io
import json
import time
import uuid

import pytest
import torch

from torchsnapshot_tpu_torch import CheckpointManager, Snapshot, StateDict, hottier
from torchsnapshot_tpu_torch import faultline as fl
from torchsnapshot_tpu_torch import telemetry, wiretap
from torchsnapshot_tpu_torch.io_types import IOReq, io_payload
from torchsnapshot_tpu_torch.manager import _step_dir
from torchsnapshot_tpu_torch.storage_plugin import url_to_storage_plugin
from torchsnapshot_tpu_torch.telemetry import metrics as _m
from torchsnapshot_tpu_torch.telemetry import ledger as runledger
from torchsnapshot_tpu_torch.telemetry import ops as scope_ops
from torchsnapshot_tpu_torch.telemetry import sampler as scope_sampler
from torchsnapshot_tpu_torch.telemetry import slo as scope_slo
from torchsnapshot_tpu_torch.telemetry import timeline, watch
from torchsnapshot_tpu_torch.telemetry.doctor import diagnose_report
from torchsnapshot_tpu_torch.telemetry.metrics import REGISTRY

pytestmark = pytest.mark.faultline


@pytest.fixture(autouse=True)
def _fresh_tier():
    # The wire tap is process-wide, and the ops CLI's live rules read it:
    # each test starts with no other test's RPCs.
    wiretap.reset()
    hottier.disable_hot_tier(flush=False)
    hottier.reset_hot_tier()
    yield
    hottier.disable_hot_tier(flush=False)
    hottier.reset_hot_tier()
    wiretap.reset()


def _state(v, n=512, keys=("w",)):
    return {"s": StateDict(**{k: torch.full((n,), float(v)) for k in keys})}


def _mem_root(tag):
    return f"memory://scope-{tag}-{uuid.uuid4().hex[:10]}/snap"


def _objects(url):
    storage = url_to_storage_plugin(url)
    try:
        return sorted(asyncio.run(storage.list_prefix("")) or [])
    finally:
        storage.close()


def _read_json(url, path):
    storage = url_to_storage_plugin(url)
    try:
        io_req = IOReq(path=path)
        asyncio.run(storage.read(io_req))
        return json.loads(bytes(io_payload(io_req)).decode("utf-8"))
    finally:
        storage.close()


def _run_cli(main, argv):
    buf = _io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


# ------------------------------------------------- introspect / at-risk


def test_introspect_tracks_backlog_and_at_risk_bytes():
    root = _mem_root("intro")
    with hottier.hot_tier(rank=0, world=2, k=2, drain="manual"):
        Snapshot.take(root, _state(7))
        intro = hottier.introspect()
        assert intro["queue_depth"] >= 1
        assert intro["pending_objects"] >= 1
        assert intro["at_risk_bytes"] > 0
        assert intro["oldest_pending_age_s"] is not None
        assert root in intro["at_risk_by_root"]
        root_view = intro["roots"][root]
        assert root_view["committed"] and not root_view["tierdown_done"]
        assert root_view["pending_bytes"] == intro["at_risk_bytes"]
        # Per-host occupancy reflects the k replicas.
        assert sum(
            h["used_bytes"] for h in intro["hosts"].values()
        ) == 2 * intro["at_risk_bytes"]
        hottier.drain_now()
        intro = hottier.introspect()
        assert intro["queue_depth"] == 0
        assert intro["at_risk_bytes"] == 0
        assert intro["roots"][root]["tierdown_done"]
        assert intro["roots"][root]["durability_lag_s"] is not None


def test_introspect_at_risk_age_excludes_uncommitted_roots():
    """The RPO-relevant age (oldest_at_risk_age_s) counts COMMITTED
    roots only: an in-flight take's old pending object must not read
    as an acked checkpoint's exposure window."""
    with hottier.hot_tier(rank=0, world=2, k=2, drain="manual") as rt:
        rt.enqueue_drain("memory://scope-phantom/run", "0/s/w")
        intro = hottier.introspect()
        assert intro["oldest_pending_age_s"] is not None
        assert intro["oldest_at_risk_age_s"] is None  # nothing committed
        assert intro["at_risk_bytes"] == 0
        # The live rule stays silent on it, whatever the budget.
        sample = {"hot_tier": intro}
        assert (
            scope_slo.rule_durability_lag_live([sample], budget_s=1e-9)
            is None
        )
        hottier.reset_pending()


def test_slo_live_rules_evaluated_per_rank():
    """A stranded rank must surface even when a healthier rank's
    samples would otherwise shadow it in a flattened series
    (evaluate_live_by_rank)."""
    stranded_sample = {
        "hot_tier": {
            "queue_depth": 0,
            "inflight": 0,
            "oldest_pending_age_s": None,
            "oldest_at_risk_age_s": None,
            "at_risk_bytes": 64,
            "at_risk_by_root": {},
            "stranded_objects": 1,
            "stranded_roots": ["/run/step-3"],
        }
    }
    healthy_sample = {
        "hot_tier": {
            "queue_depth": 0,
            "inflight": 0,
            "oldest_pending_age_s": None,
            "oldest_at_risk_age_s": None,
            "at_risk_bytes": 0,
            "at_risk_by_root": {},
            "stranded_objects": 0,
            "stranded_roots": [],
        }
    }
    findings = scope_slo.evaluate_live_by_rank(
        {0: [stranded_sample], 1: [healthy_sample]}
    )
    assert any(
        f.rule == "stranded-drains" and f.evidence.get("rank") == 0
        for f in findings
    ), findings


def test_introspect_none_when_disabled():
    assert hottier.introspect() is None
    assert hottier.durability_lag_s("/nowhere") is None


# -------------------------------------------- durability lag, end to end


def test_durability_lag_watermark_report_metrics_ledger():
    """The acceptance chain: per-object histogram + per-take value in
    the watermark, the flight report, the metrics, and the ledger."""
    telemetry.reset()
    root = _mem_root("lag")
    with hottier.hot_tier(rank=0, world=2, k=2, drain="manual"):
        Snapshot.take(root, _state(3, keys=("a", "b")))
        hottier.drain_now()
        lag = hottier.durability_lag_s(root)
        assert lag is not None and lag >= 0
    # Watermark carries the per-take window.
    td = _read_json(root, ".tierdown")
    assert td["durability_lag_s"] == pytest.approx(lag)
    assert td["drained_objects"] == 2
    # The committed report was back-filled.
    report = _read_json(root, ".report.json")
    assert report["durability_lag_s"] == pytest.approx(lag)
    # Metrics: one per-object observation per drained object, one
    # per-take observation.
    snap = telemetry.snapshot()
    assert snap[_m.HOT_TIER_OBJECT_LAG]["count"] == 2
    assert snap[_m.HOT_TIER_TAKE_LAG]["count"] == 1
    # Ledger: the take digest holds null (window still open at commit);
    # the drain appended a tierdown event record that closes it.
    records, _ = runledger.read_records(root)
    takes = [r for r in records if r["kind"] == "take"]
    drains = [r for r in records if r["kind"] == "tierdown"]
    assert takes and takes[0]["durability_lag_s"] is None
    assert drains and drains[0]["durability_lag_s"] == pytest.approx(lag)
    assert drains[0]["drained_objects"] == 2


def test_write_through_objects_observe_zero_lag():
    telemetry.reset()
    root = _mem_root("wt")
    with hottier.hot_tier(rank=0, world=2, k=2, drain="manual"):
        hottier.kill_host(1)  # k unreachable: every put degrades
        Snapshot.take(root, _state(5))
        snap = telemetry.snapshot()
        # Durable at ack: the object-lag histogram records ~0.
        hist = snap[_m.HOT_TIER_OBJECT_LAG]
        assert hist["count"] >= 1
        assert hist["sum"] == pytest.approx(0.0, abs=0.05)


# ------------------------------------------------ slow_drain / doctor / SLO


def test_slow_drain_trips_doctor_rule_and_slo_exit(monkeypatch):
    """Acceptance: an injected ``slow_drain`` schedule deterministically
    fires the ``durability-lag-above-budget`` doctor rule and the SLO
    engine's nonzero exit."""
    monkeypatch.setenv(scope_slo.DURABILITY_LAG_ENV_VAR, "0.05")
    root = _mem_root("slow")
    sched = fl.FaultSchedule().slow_drain(seconds=0.12)
    with fl.inject(sched):
        with hottier.hot_tier(rank=0, world=2, k=2, drain="manual"):
            Snapshot.take(root, _state(9))
            hottier.drain_now()
    report = _read_json(root, ".report.json")
    assert report["durability_lag_s"] > 0.1
    rules = [f.rule for f in diagnose_report(report)]
    assert "durability-lag-above-budget" in rules
    rc, out = _run_cli(scope_slo.main, [root])
    assert rc == 1
    assert "durability-lag-above-budget" in out
    # Without the schedule the same take stays inside the budget.
    root2 = _mem_root("fast")
    with hottier.hot_tier(rank=0, world=2, k=2, drain="manual"):
        Snapshot.take(root2, _state(9))
        hottier.drain_now()
    report2 = _read_json(root2, ".report.json")
    assert "durability-lag-above-budget" not in [
        f.rule for f in diagnose_report(report2)
    ]
    rc2, _ = _run_cli(scope_slo.main, [root2])
    assert rc2 == 0


def test_slo_self_test_and_burn_rate_windows():
    assert scope_slo._self_test() == 0
    # Burn-rate shape: one blip in a healthy history never breaches.
    obj = scope_slo.Objective(
        name="durability-lag",
        label="lag",
        kinds=("tierdown",),
        field="durability_lag_s",
        target=1.0,
        direction="max",
    )
    verdict = scope_slo.burn_rates([0.1] * 19 + [9.0], obj)
    assert not verdict["breached"]
    assert verdict["windows"][0]["burn_rate"] == pytest.approx(0.8)


def test_timeline_sentinel_flags_durability_lag_regression(tmp_path):
    def rec(i, lag):
        return {
            "format_version": 1,
            "kind": "tierdown",
            "ts_epoch_s": 1e9 + i,
            "path": f"/r/step-{i}",
            "step": i,
            "take_id": None,
            "durability_lag_s": lag,
            "drained_objects": 4,
            "write_through_objects": 0,
        }

    records = [rec(i, 0.5) for i in range(8)] + [rec(8, 60.0)]
    path = tmp_path / "ledger.jsonl"
    path.write_text(
        "".join(runledger.encode_line(r) + "\n" for r in records)
    )
    rc, out = _run_cli(timeline.main, [str(path)])
    assert rc == 1
    assert "durability lag s" in out and "step 8" in out


# ----------------------------------------------------------- the sampler


def test_sampler_ring_statusfile_and_fields(tmp_path):
    root = _mem_root("sampler")
    with hottier.hot_tier(rank=0, world=2, k=2, drain="manual"):
        Snapshot.take(root, _state(1))
        s = scope_sampler.RuntimeSampler(
            rank=0, statusfile_dir=str(tmp_path), ring=4
        )
        for _ in range(6):
            assert s.sample_once() is not None
        assert len(s.samples()) == 4  # ring is bounded
        latest = s.latest()
        assert latest["hot_tier"]["queue_depth"] >= 1
        assert latest["hot_tier"]["at_risk_bytes"] > 0
        assert set(latest["scheduler"]) == {"write", "read"}
        hottier.drain_now()
    by_rank = scope_sampler.collect_statusfiles(str(tmp_path))
    assert 0 in by_rank and len(by_rank[0]) == 6
    assert by_rank[0][-1]["seq"] == 6


def test_sampler_thread_crash_isolated_and_take_unaffected(
    tmp_path, monkeypatch
):
    """A sampler-thread exception never fails or blocks a take."""

    def _boom():
        raise RuntimeError("sampler injected failure")

    # The sampler reads the tier through the package-level API.
    monkeypatch.setattr(hottier, "introspect", _boom)
    s = scope_sampler.RuntimeSampler(
        rank=0, interval_s=0.05, statusfile_dir=str(tmp_path)
    )
    s.start()
    try:
        before = s.error_count
        root = str(tmp_path / "snap")
        snap = Snapshot.take(root, _state(2))
        target = _state(0)
        snap.restore(target)
        time.sleep(0.2)
        assert s.error_count > before  # it kept running AND kept failing
        assert REGISTRY.counter(_m.SAMPLER_ERRORS).value > 0
    finally:
        s.stop(final_sample=False)
    # The take committed untouched.
    assert float(target["s"]["w"][0]) == 2.0


def test_sampler_scope_objects_never_survive_delete(tmp_path):
    root = _mem_root("scopegc")
    Snapshot.take(root, _state(4))
    s = scope_sampler.RuntimeSampler(rank=0, storage_url=root)
    assert s.sample_once() is not None
    s.stop(final_sample=False)
    assert ".scope/rank0" in _objects(root)
    Snapshot(root).delete(sweep=True)
    assert _objects(root) == []


def test_reconcile_sweeps_crashed_scope_and_sampler_statusfiles(
    tmp_path, monkeypatch
):
    """A detected crash's scope debris is swept (age-guarded) by
    reconcile's debris pass, exactly like progress records."""
    monkeypatch.setenv("TPUSNAPSHOT_SWEEP_MIN_AGE_S", "0")
    base = str(tmp_path / "run")
    mgr = CheckpointManager(base, max_to_keep=None)
    mgr.save(0, _state(1))
    step_root = _step_dir(base, 0)
    s = scope_sampler.RuntimeSampler(rank=0, storage_url=step_root)
    assert s.sample_once() is not None  # "crashed" publisher's debris
    s.stop(final_sample=False)
    assert ".scope/rank0" in _objects(step_root)
    mgr.reconcile()
    assert ".scope/rank0" not in _objects(step_root)
    # The committed snapshot itself is untouched.
    assert ".snapshot_metadata" in _objects(step_root)


def test_reconcile_age_guard_spares_young_scope_records(
    tmp_path, monkeypatch
):
    monkeypatch.setenv("TPUSNAPSHOT_SWEEP_MIN_AGE_S", "3600")
    base = str(tmp_path / "run")
    mgr = CheckpointManager(base, max_to_keep=None)
    mgr.save(0, _state(1))
    step_root = _step_dir(base, 0)
    s = scope_sampler.RuntimeSampler(rank=0, storage_url=step_root)
    assert s.sample_once() is not None
    s.stop(final_sample=False)
    mgr.reconcile()
    assert ".scope/rank0" in _objects(step_root)  # young: spared


# ----------------------------------------- tier-down progress records


def test_background_drain_publishes_tierdown_progress(monkeypatch):
    monkeypatch.setenv("TPUSNAPSHOT_PROGRESS_INTERVAL_S", "0")
    root = _mem_root("tdprog")
    sched = fl.FaultSchedule().slow_drain(seconds=0.15)
    with fl.inject(sched):
        with hottier.hot_tier(rank=0, world=2, k=2, drain="background"):
            Snapshot.take(root, _state(1, keys=("a", "b", "c")))
            seen = None
            deadline = time.monotonic() + 20
            while time.monotonic() < deadline:
                if ".progress/tierdown/0" in _objects(root):
                    seen = _read_json(root, ".progress/tierdown/0")
                    break
                time.sleep(0.01)
            assert seen is not None, "no tierdown progress record"
            assert seen["phase"] == "tierdown"
            assert seen["kind"] == "tierdown"
            assert seen["bytes_total"] > 0
            # watch renders the drain as a live in-flight operation.
            rc, out = _run_cli(watch.main, [root, "--stale-after", "60"])
            assert rc == 0
            assert "tierdown" in out
            assert hottier.wait_drained(timeout_s=30)
    # Retired with the watermark; never outlives the drain.
    objs = _objects(root)
    assert ".tierdown" in objs
    assert ".progress/tierdown/0" not in objs


def test_manual_drain_publishes_no_progress_records():
    """Manual mode is the fault harness's deterministic-op-stream mode:
    no time-rate-limited publications may enter the op stream."""
    root = _mem_root("manual")
    with hottier.hot_tier(rank=0, world=2, k=2, drain="manual"):
        Snapshot.take(root, _state(1))
        hottier.drain_now()
    assert not [o for o in _objects(root) if o.startswith(".progress/")]


# ------------------------------------------------------------ ops view


def test_ops_cli_live_backlog_drains_to_zero_and_exits_zero(monkeypatch):
    """Acceptance: against a live async-acked take with the hot tier
    on, the view shows the drain backlog and exits 0; after the drain
    the backlog reads zero and it still exits 0."""
    root = _mem_root("opslive")
    with hottier.hot_tier(rank=0, world=2, k=2, drain="manual"):
        Snapshot.take(root, _state(6, keys=("a", "b")))
        rc, out = _run_cli(scope_ops.main, [root])
        assert rc == 0, out
        assert "drain backlog 2" in out
        assert "at-risk" in out
        hottier.drain_now()
        rc, out = _run_cli(scope_ops.main, [root])
        assert rc == 0, out
        assert "drain backlog 0" in out


def test_ops_cli_live_async_take_background_drain():
    """The full acceptance shape: a LIVE async take with the hot tier
    on (background drain slowed by ``slow_drain``) — ops exits 0 while
    the backlog is visible, and again once it drained to zero."""
    root = _mem_root("opsasync")
    sched = fl.FaultSchedule().slow_drain(seconds=0.5)
    with fl.inject(sched):
        with hottier.hot_tier(rank=0, world=2, k=2, drain="background"):
            pending = Snapshot.async_take(
                root, _state(4, keys=("a", "b", "c"))
            )
            pending.wait(timeout_s=60)
            # Committed (acked) — but tier-down is still running: the
            # ops view must show the live backlog and stay healthy.
            rc, out = _run_cli(scope_ops.main, [root])
            assert rc == 0, out
            assert "drain backlog" in out
            intro = hottier.introspect()
            assert intro["at_risk_bytes"] > 0  # exposure window open
            assert hottier.wait_drained(timeout_s=60)
            rc, out = _run_cli(scope_ops.main, [root])
            assert rc == 0, out
            assert "drain backlog 0" in out
            assert hottier.introspect()["at_risk_bytes"] == 0


def test_ops_cli_stranded_drain_exits_nonzero_naming_root():
    root = _mem_root("opsstrand")
    sched = fl.FaultSchedule().permanent(op="write", path="0/s/w")
    with fl.inject(sched):
        with hottier.hot_tier(rank=0, world=2, k=2, drain="manual"):
            Snapshot.take(root, _state(8))
            hottier.drain_now()  # attempts exhaust; object stranded
            assert hottier.introspect()["stranded_objects"] == 1
            rc, out = _run_cli(scope_ops.main, [root])
            assert rc == 1, out
            assert "stranded-drains" in out
            assert root in out  # names the root
    # JSON mode carries the same verdict for machines.
    with hottier.hot_tier(rank=0, world=2, k=2, drain="manual"):
        rc, out = _run_cli(scope_ops.main, [root, "--json"])
        doc = json.loads(out)
        assert rc == 0  # fresh runtime: nothing stranded anymore
        assert doc["critical"] == []


def test_ops_cli_dir_mode_reads_statusfiles(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUSNAPSHOT_PROGRESS_DIR", str(tmp_path))
    root = _mem_root("opsdir")
    with hottier.hot_tier(rank=0, world=2, k=2, drain="manual"):
        Snapshot.take(root, _state(2))
        s = scope_sampler.RuntimeSampler(
            rank=0, statusfile_dir=str(tmp_path)
        )
        assert s.sample_once() is not None
        hottier.drain_now()
    # Tier off: dir mode must read state from the statusfiles alone.
    rc, out = _run_cli(scope_ops.main, [str(tmp_path)])
    assert rc == 0, out
    assert "drain backlog" in out
    # The progress statusfile the take wrote renders too.
    assert "take" in out


def test_ops_cli_bad_path_exits_two(tmp_path):
    rc, _ = _run_cli(
        scope_ops.main, [str(tmp_path / "missing-dir-or-snap")]
    )
    assert rc == 2


def test_slo_live_rules_via_sampler_samples(monkeypatch):
    monkeypatch.setenv(scope_slo.DURABILITY_LAG_ENV_VAR, "30")
    root = _mem_root("live")
    sched = fl.FaultSchedule().permanent(op="write", path="0/s/w")
    with fl.inject(sched):
        with hottier.hot_tier(rank=0, world=2, k=2, drain="manual"):
            Snapshot.take(root, _state(1))
            hottier.drain_now()
            s = scope_sampler.RuntimeSampler(rank=0)
            sample = s.sample_once()
            findings = scope_slo.evaluate_live([sample])
            assert any(
                f.rule == "stranded-drains" and root in f.title
                for f in findings
            )


# ------------------------------------------------ scheduler budget gauges


def test_scheduler_budget_gauges_reset_after_pipeline(tmp_path):
    telemetry.reset()
    root = str(tmp_path / "snap")
    snap = Snapshot.take(root, _state(5, n=4096))
    snap.restore(_state(0, n=4096))
    metrics = telemetry.snapshot()
    for pipeline in ("write", "read"):
        key = f'{_m.SCHED_BUDGET_IN_USE}{{pipeline="{pipeline}"}}'
        assert metrics[key] == 0.0  # reset on pipeline exit
        stalled = f'{_m.SCHED_BUDGET_STALLED}{{pipeline="{pipeline}"}}'
        assert metrics[stalled] == 0.0


# ------------------------------------------------------- bench plumbing


def test_bench_compare_gates_hot_tier_keys():
    import importlib.util
    import os as _os

    spec = importlib.util.spec_from_file_location(
        "bench_compare",
        _os.path.join(
            _os.path.dirname(__file__), "..", "tools", "bench_compare.py"
        ),
    )
    bc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bc)
    assert bc._self_test() == 0

    base = {
        "value": 1.0,
        "hot_tier": {"hot_vs_durable": 7.5, "durability_lag_s": 0.8},
        "every_step": {"hot": {"overhead_pct": 1.9}},
    }
    _, reg = bc.compare(
        base,
        dict(base, hot_tier={"hot_vs_durable": 7.5, "durability_lag_s": 2.0}),
        0.2,
    )
    assert reg and "durability lag" in reg[0]
