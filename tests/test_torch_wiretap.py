"""The port's wiretap (snapflight) against the JAX package's: the shared
wire-observability layer of the hot tier's transport — per-op histograms
and outcome taxonomy, deadline margin, window deltas, the blackbox flight
recorder (crc-framed through the port's ``telemetry.ledger.encode_line``),
a real SIGKILLed peer process leaving a survivor's blackbox, and the
doctor's ``deadline-margin-collapsing`` rule; a real SIGKILLed read-plane
server process marking the survivor's blackbox, ``slo``'s live rule over
window deltas, and ``telemetry.ops``' fleet wire mode over a live
snapserve server and a live hot-tier peer. These are the cases of
``tests/test_snapflight.py``, with parity checks: the same records give
the same summaries, windows and findings in both packages, each package
reads the other's blackbox dumps, and each package's ``ops`` view reads
the other's live server.
"""

import glob
import json
import os
import signal
import subprocess
import sys
import time

import pytest

import torchsnapshot_tpu.wiretap as jwiretap
from torchsnapshot_tpu.telemetry.doctor import diagnose_report as jax_diagnose_report
from torchsnapshot_tpu import snapserve as jsnapserve
from torchsnapshot_tpu.telemetry import ops as jax_scope_ops
from torchsnapshot_tpu_torch import snapserve, tracing, wiretap
from torchsnapshot_tpu_torch.hottier.peer import spawn_peer
from torchsnapshot_tpu_torch.hottier.transport import (
    RemotePeer,
    clear_wire_faults,
    script_wire_fault,
)
from torchsnapshot_tpu_torch.telemetry import memwatch
from torchsnapshot_tpu_torch.telemetry import ops as scope_ops
from torchsnapshot_tpu_torch.telemetry import slo as scope_slo
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


# ------------------------------------------- the read plane's wire, ops view

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_sigkilled_snapserve_server_marks_survivor_blackbox(
    tmp_path, monkeypatch
):
    """Kill a real snapserve server subprocess mid-traffic and the
    surviving client dumps a blackbox whose tail holds the ok RPCs before
    the kill and the failure after it."""
    monkeypatch.setenv("TPUSNAPSHOT_WIRETAP_DIR", str(tmp_path))
    wiretap.reset()
    port_file = str(tmp_path / "server.addr")
    proc = subprocess.Popen(
        [sys.executable, "-m", "torchsnapshot_tpu_torch.snapserve.server",
         "--addr", "127.0.0.1:0", "--port-file", port_file],
        env=dict(os.environ, PYTHONPATH=_REPO_ROOT),
        stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL,
    )
    try:
        deadline = time.monotonic() + 60.0
        addr = None
        while time.monotonic() < deadline:
            if os.path.exists(port_file):
                addr = open(port_file).read().strip()
                if addr:
                    break
            if proc.poll() is not None:
                pytest.fail("snapserve server subprocess died at startup")
            time.sleep(0.05)
        assert addr, "server never wrote its port file"
        assert snapserve.ping_server(addr, timeout_s=10.0)["ok"] is True
        proc.kill()
        proc.wait(timeout=10.0)
        with pytest.raises(Exception):
            snapserve.ping_server(addr, timeout_s=2.0)
        wiretap.note_degrade("server_down", peer=addr)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10.0)
    files = glob.glob(str(tmp_path / "*.blackbox.jsonl"))
    assert files
    events = [
        r
        for f in files
        for r in wiretap.read_blackbox(f)[0]
        if "op" in r and r.get("transport") == "snapserve"
    ]
    assert any(e["op"] == "ping" and e["outcome"] == "ok" for e in events)
    assert any(e["op"] == "ping" and e["outcome"] != "ok" for e in events)
    # The JAX package parses the port's dump into the same records.
    for f in files:
        assert jwiretap.read_blackbox(f) == wiretap.read_blackbox(f)


def test_slo_live_rule_scores_window_delta():
    def sample(count, misses):
        return {
            "wire": {
                "ops": {
                    "snapwire/put": {
                        "count": count,
                        "deadline_misses": misses,
                        "retries": 0,
                        "margin_p99": 0.2,
                        "deadline_s": 2.0,
                    }
                }
            }
        }

    stale = scope_slo.evaluate_live([sample(50, 3), sample(60, 3)])
    assert not any(
        f.rule == "deadline-margin-collapsing" for f in stale
    ), stale
    fresh = [
        f
        for f in scope_slo.evaluate_live([sample(50, 3), sample(60, 5)])
        if f.rule == "deadline-margin-collapsing"
    ]
    assert fresh and fresh[0].severity == "critical"
    assert fresh[0].evidence["deadline_misses"] == 2
    from torchsnapshot_tpu.telemetry import slo as jax_slo

    jfresh = [
        f
        for f in jax_slo.evaluate_live([sample(50, 3), sample(60, 5)])
        if f.rule == "deadline-margin-collapsing"
    ]
    assert [f.as_dict() for f in fresh] == [f.as_dict() for f in jfresh]


def test_ops_fleet_wire_aggregates_and_exit_contract(capsys):
    server = snapserve.start_local_server()
    try:
        snapserve.ping_server(server.addr, timeout_s=10.0)
        rc = scope_ops.main(["--wire", server.addr])
        out = capsys.readouterr().out
        assert rc == 0
        assert "fleet wire:" in out
        assert "snapserve/ping" in out
        # One member down (but not all): critical finding, exit 1.
        rc = scope_ops.main(
            ["--wire", f"{server.addr},127.0.0.1:1", "--wire-timeout", "2"]
        )
        out = capsys.readouterr().out
        assert rc == 1
        assert "fleet-member-unreachable" in out
    finally:
        server.stop()
    # Every target unreachable: the view itself is unavailable, exit 2.
    rc = scope_ops.main(["--wire", "127.0.0.1:1", "--wire-timeout", "2"])
    capsys.readouterr()
    assert rc == 2


@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_ops_fleet_wire_reads_either_packages_server(capsys, server_pkg):
    """Each package's ``ops --wire`` reads the other's live server (the
    ``stats`` RPC crosses the packages) with the same exit code."""
    mod = snapserve if server_pkg == "port" else jsnapserve
    server = mod.start_local_server()
    try:
        snapserve.ping_server(server.addr, timeout_s=10.0)
        rcs = []
        for main in (scope_ops.main, jax_scope_ops.main):
            rcs.append(main(["--wire", server.addr, "--json"]))
            doc = json.loads(capsys.readouterr().out)
            assert doc["reachable"] == 1
            assert any(k.startswith("snapserve/") for k in doc["ops"])
        assert rcs == [0, 0]
    finally:
        server.stop()


def test_ops_fleet_wire_json_merges_peer_blocks(capsys):
    from torchsnapshot_tpu_torch.hottier.peer import start_local_peer

    server, _ = start_local_peer(host_id=21, register=False)
    peer = RemotePeer(host_id=21, addr=server.addr)
    try:
        assert peer.probe() is True
        rc = scope_ops.main(
            ["--wire-peers", f"21={server.addr}", "--json"]
        )
        out = capsys.readouterr().out
        assert rc == 0
        doc = json.loads(out)
        assert doc["reachable"] == 1
        assert any(k.startswith("snapwire/") for k in doc["ops"])
    finally:
        peer.close()
        server.stop()
