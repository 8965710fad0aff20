"""The port's wiretap (snapflight) against the JAX package's: the shared
wire-observability layer of the hot tier's transport — per-op histograms
and outcome taxonomy, deadline margin, window deltas, the blackbox flight
recorder (crc-framed through the port's ``telemetry.ledger.encode_line``),
a real SIGKILLed peer process leaving a survivor's blackbox, and the
doctor's ``deadline-margin-collapsing`` rule. The cases of
``tests/test_snapflight.py`` that need neither the read plane (snapserve)
nor ``telemetry.ops``/``slo``'s live mode, and parity checks: the same
records give the same summaries, windows and findings in both packages,
and each package reads the other's blackbox dumps.
"""

import glob
import os
import signal

import pytest

import torchsnapshot_tpu.wiretap as jwiretap
from torchsnapshot_tpu.telemetry.doctor import diagnose_report as jax_diagnose_report
from torchsnapshot_tpu_torch import tracing, wiretap
from torchsnapshot_tpu_torch.hottier.peer import spawn_peer
from torchsnapshot_tpu_torch.hottier.transport import (
    RemotePeer,
    clear_wire_faults,
    script_wire_fault,
)
from torchsnapshot_tpu_torch.telemetry import memwatch
from torchsnapshot_tpu_torch.telemetry.doctor import (
    diagnose_report,
    wire_pressure_finding,
)

pytestmark = pytest.mark.faultline


@pytest.fixture(autouse=True)
def _fresh_wiretap():
    wiretap.reset()
    jwiretap.reset()
    clear_wire_faults()
    yield
    wiretap.reset()
    jwiretap.reset()
    clear_wire_faults()


# ------------------------------------------------------------ wiretap core


def test_wiretap_module_self_test():
    wiretap._self_test()  # raises on any failed pin


def test_record_aggregates_outcomes_and_margins():
    wiretap.reset()
    wiretap.record("snapwire", "put", seconds=0.010, deadline_s=1.0,
                   bytes_out=4096)
    wiretap.record("snapwire", "put", seconds=0.020, deadline_s=1.0,
                   bytes_out=4096, attempt=1)
    wiretap.record(
        "snapwire", "put", seconds=1.5, deadline_s=1.0,
        outcome="deadline_miss",
    )
    # Unknown outcomes clamp into the bounded taxonomy.
    wiretap.record("snapwire", "put", seconds=0.01, outcome="weird-kind")
    ops = wiretap.summary()
    put = ops["snapwire/put"]
    assert put["count"] == 4
    assert put["deadline_misses"] == 1
    assert put["retries"] == 1
    assert put["bytes_out"] == 8192
    assert put["outcomes"]["ok"] == 2
    assert put["outcomes"]["deadline_miss"] == 1
    assert put["outcomes"]["error"] == 1
    assert "weird-kind" not in put["outcomes"]
    # A miss consumed >= the whole budget: margin clamps at >= 1.0.
    assert put["margin_max"] >= 1.0


def test_window_collect_is_a_delta_not_a_total():
    wiretap.reset()
    wiretap.record("snapserve", "read", seconds=0.01, deadline_s=10.0)
    token = wiretap.window_begin()
    wiretap.record("snapserve", "read", seconds=0.03, deadline_s=10.0)
    wiretap.record("snapserve", "read", seconds=0.05, deadline_s=10.0)
    window = wiretap.window_collect(token)
    assert window["snapserve/read"]["count"] == 2  # not 3
    assert wiretap.summary()["snapserve/read"]["count"] == 3


# --------------------------------------------------------------- blackbox


def test_blackbox_dump_parses_and_skips_torn_tail(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUSNAPSHOT_WIRETAP_DIR", str(tmp_path))
    wiretap.reset()
    for i in range(5):
        wiretap.record(
            "snapwire", "put", seconds=0.01 * (i + 1), deadline_s=2.0,
            trace_id=f"take-{i:012x}",
        )
    path = wiretap.dump_blackbox("fault")
    assert path and os.path.exists(path)
    records, skipped = wiretap.read_blackbox(path)
    assert skipped == 0
    assert records[0]["kind"] == "blackbox_header"
    assert records[0]["reason"] == "fault"
    events = [r for r in records if "op" in r]
    assert len(events) == 5
    assert events[-1]["trace"] == "take-000000000004"
    # Torn tail: chop into the final record — the crc discipline skips
    # exactly the truncated piece and keeps everything before it.
    raw = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(raw[:-9])
    records2, skipped2 = wiretap.read_blackbox(path)
    assert skipped2 == 1
    assert len(records2) == len(records) - 1


def test_note_degrade_dumps_with_mark(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUSNAPSHOT_WIRETAP_DIR", str(tmp_path))
    wiretap.reset()
    wiretap.record("snapwire", "get", seconds=0.02, deadline_s=2.0)
    wiretap.note_degrade("peer_down", peer="127.0.0.1:9")
    files = glob.glob(str(tmp_path / "*.blackbox.jsonl"))
    assert len(files) == 1
    records, skipped = wiretap.read_blackbox(files[0])
    assert skipped == 0
    marks = [r for r in records if "mark" in r]
    assert marks and marks[0]["mark"] == "peer_down"
    assert marks[0]["peer"] == "127.0.0.1:9"


# ------------------------------------------------- faultline: SIGKILL'd peers


def test_sigkilled_peer_leaves_survivor_blackbox_with_trace_join(
    tmp_path, monkeypatch
):
    """SIGKILL a real hot-tier peer subprocess mid-traffic: the
    SURVIVING client process's degrade hook dumps its flight recorder,
    and the dump holds the victim's last RPCs — ops, outcomes, and the
    take's trace id (snapxray-joinable)."""
    monkeypatch.setenv("TPUSNAPSHOT_WIRETAP_DIR", str(tmp_path))
    monkeypatch.setenv("TPUSNAPSHOT_REPLICATION_RETRY_BUDGET_S", "0.5")
    wiretap.reset()
    proc, addr, _none = spawn_peer(host_id=7, register=False)
    peer = RemotePeer(host_id=7, addr=addr)
    try:
        from torchsnapshot_tpu_torch.fingerprint import fingerprint_host

        payload = b"z" * 2048
        tag = fingerprint_host(payload)
        with tracing.trace_scope("take") as trace_id:
            for i in range(3):
                stored, _ = peer.put(f"k{i}", payload, tag=tag,
                                     root="memory://flight/run")
                assert stored
            proc.kill()
            proc.wait(timeout=10.0)
            assert proc.poll() == -signal.SIGKILL
            from torchsnapshot_tpu_torch.hottier.tier import HostLostError

            with pytest.raises(HostLostError):
                peer.put("k-dead", payload, tag=tag,
                         root="memory://flight/run")
    finally:
        peer.close()
        if proc.poll() is None:
            proc.kill()
    files = glob.glob(str(tmp_path / "*.blackbox.jsonl"))
    assert files, "survivor produced no blackbox dump"
    events = []
    marks = []
    for f in files:
        records, _skipped = wiretap.read_blackbox(f)
        events += [r for r in records if "op" in r]
        marks += [r for r in records if "mark" in r]
    assert any(m["mark"] == "peer_down" for m in marks)
    puts = [e for e in events if e["op"] == "put"]
    assert any(e["outcome"] == "ok" and e["trace"] == trace_id
               for e in puts), puts
    # The victim's death is in the record stream too: the failed RPC
    # attempts against the dead socket, under the same trace id.
    assert any(e["outcome"] in ("transport", "deadline_miss")
               and e["trace"] == trace_id for e in puts), puts


# ----------------------------------- doctor / slo: deadline-margin-collapsing


def test_slow_wire_trips_deadline_margin_collapsing(monkeypatch):
    """Acceptance: an injected ``slow_wire`` fault deterministically
    trips the doctor rule — the scripted sleep blows the (tightened)
    per-RPC deadline, the retry lands, and the wiretap window carries
    the miss into the report's ``wire`` block."""
    monkeypatch.setenv("TPUSNAPSHOT_REPLICATION_DEADLINE_S", "0.2")
    monkeypatch.setenv("TPUSNAPSHOT_REPLICATION_RETRY_BUDGET_S", "10")
    wiretap.reset()
    from torchsnapshot_tpu_torch.hottier.peer import start_local_peer

    server, _ = start_local_peer(host_id=11, register=False)
    peer = RemotePeer(host_id=11, addr=server.addr)
    token = wiretap.window_begin()
    try:
        from torchsnapshot_tpu_torch.fingerprint import fingerprint_host

        payload = b"w" * 512
        tag = fingerprint_host(payload)
        script_wire_fault("slow_wire", host=11, seconds=0.6)
        stored, _ = peer.put("k", payload, tag=tag,
                             root="memory://slowwire/run")
        assert stored  # the retry after the miss succeeded
    finally:
        peer.close()
        server.stop()
    window = wiretap.window_collect(token)
    put = window["snapwire/put"]
    assert put["deadline_misses"] >= 1
    assert put["retries"] >= 1
    report = {"kind": "take", "ranks": [{"rank": 0, "wire": window}]}
    findings = [
        f for f in diagnose_report(report)
        if f.rule == "deadline-margin-collapsing"
    ]
    assert findings and findings[0].severity == "critical"
    assert findings[0].evidence["pressured_ops"][0]["op"] == "snapwire/put"
    # Healthy traffic stays silent.
    assert wire_pressure_finding(
        {"snapwire/put": {"count": 10, "deadline_misses": 0,
                          "margin_p99": 0.1}}
    ) is None


def test_margin_only_pressure_warns_not_criticals(monkeypatch):
    monkeypatch.setenv("TPUSNAPSHOT_WIRE_MARGIN_WARN", "0.5")
    f = wire_pressure_finding(
        {"snapserve/read": {"count": 50, "deadline_misses": 0,
                            "margin_p99": 0.62, "p99_s": 6.2,
                            "deadline_s": 10.0}}
    )
    assert f is not None and f.severity == "warn"
    assert "62%" in f.title


# ------------------------------------------------ parity with the JAX package


def _record_mix(tap):
    """One fixed mix of RPC records: ok, retried, missed and failed calls
    of two ops, with bytes and trace ids."""
    tap.record("snapwire", "put", seconds=0.010, deadline_s=1.0, bytes_out=4096,
               trace_id="take-000000000001")
    tap.record("snapwire", "put", seconds=0.020, deadline_s=1.0, bytes_out=4096,
               attempt=1)
    tap.record("snapwire", "put", seconds=1.5, deadline_s=1.0, outcome="deadline_miss")
    tap.record("snapwire", "put", seconds=0.01, outcome="weird-kind")
    tap.record("snapwire", "get", seconds=0.004, deadline_s=2.0, bytes_in=8192)
    tap.record("snapwire", "get", seconds=0.3, deadline_s=2.0, outcome="transport",
               peer="127.0.0.1:9")


def test_summary_and_window_match_jax():
    """The same records give the same per-op summary and window delta in
    both packages: counts, outcomes, bytes, quantiles and margins."""
    wiretap.record("snapwire", "ping", seconds=0.001, deadline_s=1.0)
    jwiretap.record("snapwire", "ping", seconds=0.001, deadline_s=1.0)
    token, jtoken = wiretap.window_begin(), jwiretap.window_begin()
    _record_mix(wiretap)
    _record_mix(jwiretap)
    assert wiretap.window_collect(token) == jwiretap.window_collect(jtoken)
    assert wiretap.summary() == jwiretap.summary()
    assert wiretap.summary()["snapwire/ping"]["count"] == 1


def test_blackbox_dumps_cross_the_packages(tmp_path, monkeypatch):
    """A dump of either package parses through the other's reader, with
    the same events in the same order (the ledger's crc envelope)."""
    monkeypatch.setenv("TPUSNAPSHOT_WIRETAP_DIR", str(tmp_path))
    _record_mix(wiretap)
    _record_mix(jwiretap)
    port_path = wiretap.dump_blackbox("fault", path=str(tmp_path / "port.blackbox.jsonl"))
    jax_path = jwiretap.dump_blackbox("fault", path=str(tmp_path / "jax.blackbox.jsonl"))

    def events(records):
        return [{k: v for k, v in r.items() if k not in ("t", "ts", "wall_t")}
                for r in records if "op" in r]

    port_by_jax, skipped = jwiretap.read_blackbox(port_path)
    assert skipped == 0
    jax_by_port, skipped = wiretap.read_blackbox(jax_path)
    assert skipped == 0
    assert port_by_jax[0]["kind"] == jax_by_port[0]["kind"] == "blackbox_header"
    assert events(port_by_jax) == events(jax_by_port)
    assert len(events(port_by_jax)) == 6


def test_margin_finding_matches_jax():
    """The doctor's deadline-margin verdict over the same wire block is
    the same finding in both packages."""
    token, jtoken = wiretap.window_begin(), jwiretap.window_begin()
    _record_mix(wiretap)
    _record_mix(jwiretap)
    report = {"kind": "take", "ranks": [{"rank": 0, "wire": wiretap.window_collect(token)}]}
    jreport = {"kind": "take", "ranks": [{"rank": 0, "wire": jwiretap.window_collect(jtoken)}]}

    def margin(findings):
        return [(f.rule, f.severity, f.title, f.evidence) for f in findings
                if f.rule == "deadline-margin-collapsing"]

    got, want = margin(diagnose_report(report)), margin(jax_diagnose_report(jreport))
    assert got and got == want


def test_ring_is_a_memwatch_domain():
    """The blackbox ring registers its memwatch domain at import, as the
    JAX package's does, and its occupancy follows the records."""
    _record_mix(wiretap)
    block = memwatch.sample_block()
    assert "wiretap.ring" in block["domains"]
