"""Cross-process tracing of the port's read plane, and the merge of
many processes' traces: the snapserve and merge cases of the JAX
package's ``tests/test_snapxray.py`` on the port.

- snapserve RPCs carry the trace context in their request frames: the
  server's spans adopt the client's trace id, and the client and server
  emit paired flow events (``s``/``t``/``f``) under one flow id.
- A mid-restore server kill keeps the degraded direct reads under the
  same trace id, with the transition visible as a ``snapserve.degraded``
  instant.
- ``telemetry.merge`` takes multi-process inputs (ranks and a server),
  aligns a barrier-less server by paired flows, counts cross-process
  flows and names the gating process; ``summarize`` renders it.
- A server subprocess writes a trace file of its own.

Parity: the same traces merge and summarize to the same output in both
packages, and the port's merge of a live restore through a JAX server
pairs the flows across the packages.
"""

import json
import os
import uuid

import numpy as np
import pytest
import torch

from torchsnapshot_tpu import snapserve as jsnapserve
from torchsnapshot_tpu.telemetry import merge as jax_merge
from torchsnapshot_tpu.telemetry import summarize as jax_summarize
from torchsnapshot_tpu_torch import RemoteSnapshot, Snapshot, StateDict
from torchsnapshot_tpu_torch import faultline as fl
from torchsnapshot_tpu_torch import snapserve, tracing
from torchsnapshot_tpu_torch.telemetry import merge, summarize

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ----------------------------------------------------------------- helpers


@pytest.fixture(autouse=True)
def _clean_tracing_and_servers(monkeypatch):
    monkeypatch.setenv("TPUSNAPSHOT_SNAPSERVE_DOWN_COOLDOWN_S", "0.2")
    tracing.disable()
    yield
    tracing.disable()
    snapserve.kill_local_servers()
    jsnapserve.kill_local_servers()
    # The wire tap is process-wide: a later test's live rules must not read
    # this one's RPCs.
    from torchsnapshot_tpu import wiretap as jwiretap
    from torchsnapshot_tpu_torch import wiretap

    wiretap.reset()
    jwiretap.reset()


def _mem_root(tag):
    return f"memory://snapxray-{tag}-{uuid.uuid4().hex[:10]}/run"


def _state(n_params=3, n=2048, seed=3):
    rng = np.random.default_rng(seed)
    return {
        "m": StateDict(
            **{
                f"p{i}": torch.from_numpy(rng.standard_normal(n).astype(np.float32))
                for i in range(n_params)
            }
        )
    }


def _zero_like(state):
    return {
        "m": StateDict(
            **{k: torch.zeros_like(v) for k, v in state["m"].items()}
        )
    }


def _assert_exact(target, state):
    for k, v in state["m"].items():
        assert torch.equal(target["m"][k], v), k


def _flush_events(path):
    tracing.flush()
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _spans(events, name):
    return [
        e for e in events if e.get("name") == name and e.get("ph") == "b"
    ]


def _trace_ids(events, name):
    return {
        (e.get("args") or {}).get("trace")
        for e in _spans(events, name)
    }


def _restore_report(root):
    import asyncio

    from torchsnapshot_tpu_torch.storage_plugin import url_to_storage_plugin
    from torchsnapshot_tpu_torch.telemetry import report as flight

    storage = url_to_storage_plugin(root)
    try:
        return asyncio.run(
            flight.aread_json(storage, flight.RESTORE_REPORT_FNAME)
        )
    finally:
        storage.close()


# ------------------------------------------------- the read plane's traces


def test_rpc_flow_events_and_server_spans_join_client_trace(tmp_path):
    trace_path = str(tmp_path / "rpc.json")
    root = _mem_root("rpc")
    state = _state()
    Snapshot.take(root, state)
    server = snapserve.start_local_server()
    try:
        tracing.enable(trace_path)
        target = _zero_like(state)
        RemoteSnapshot(root, addr=server.addr).restore(target)
        events = _flush_events(trace_path)
    finally:
        server.stop()
    _assert_exact(target, state)

    restore_traces = _trace_ids(events, "Snapshot.restore")
    (restore_id,) = restore_traces
    # Server spans adopted the client's trace id (in-process server:
    # same trace file, same causal chain).
    req_traces = _trace_ids(events, "snapserve.request")
    assert req_traces == {restore_id}, req_traces
    fetch_traces = _trace_ids(events, "snapserve.backend_fetch")
    assert restore_id in fetch_traces
    # Paired flow events under shared ids: s (client out) + t (server
    # handling) + f (client response in).
    flows = {}
    for e in events:
        if e.get("ph") in ("s", "t", "f"):
            flows.setdefault(e["id"], set()).add(e["ph"])
    full = [fid for fid, phs in flows.items() if {"s", "t", "f"} <= phs]
    assert full, flows
    assert all(restore_id in fid for fid in full)
    # Cache events are visible server-side.
    assert any(
        e.get("name") in ("snapserve.cache_hit", "snapserve.cache_miss")
        for e in events
    )


@pytest.mark.faultline
def test_kill_server_keeps_trace_id_through_degraded_fallback(tmp_path):
    """A mid-restore server kill keeps the fallback direct
    reads under the SAME trace id, with the degraded transition visible
    as an instant."""
    trace_path = str(tmp_path / "kill.json")
    root = _mem_root("kill")
    state = _state(n_params=6)
    Snapshot.take(root, state)
    server = snapserve.start_local_server()
    remote = RemoteSnapshot(root, addr=server.addr)
    sched = fl.FaultSchedule().kill_server(nth=3)
    tracing.enable(trace_path)
    with fl.inject(sched) as ctl:
        target = _zero_like(state)
        remote.restore(target)
    events = _flush_events(trace_path)
    _assert_exact(target, state)
    assert ctl.fault_counts().get("killserver") == 1

    (restore_id,) = _trace_ids(events, "Snapshot.restore")
    # The transition instant, under the restore's trace.
    degraded = [
        e for e in events if e.get("name") == "snapserve.degraded"
    ]
    assert degraded, "no snapserve.degraded instant in the trace"
    assert all(
        (e.get("args") or {}).get("trace") == restore_id for e in degraded
    )
    # Every read span — served AND fallback-direct — is under the same
    # trace id: one causal story across the degradation.
    assert _trace_ids(events, "read") == {restore_id}
    report = _restore_report(root)
    planes = [s.get("read_plane") for s in report["ranks"] if s]
    assert planes and planes[0]["fallback_objects"] > 0


# ------------------------------------------------------- multi-process merge


def _client_doc(epoch=1_700_000_000.0):
    fid = "restore-abc/100.1"
    return {
        "traceEvents": [
            {"name": "read", "cat": "snapshot", "ph": "b", "id": 1,
             "ts": 0.0, "pid": 100, "tid": 1,
             "args": {"trace": "restore-abc"}},
            {"name": "read", "cat": "snapshot", "ph": "e", "id": 1,
             "ts": 400_000.0, "pid": 100, "tid": 1},
            {"name": "snapserve.rpc", "cat": "flow", "ph": "s",
             "id": fid, "ts": 10_000.0, "pid": 100, "tid": 1},
            {"name": "snapserve.rpc", "cat": "flow", "ph": "f",
             "bp": "e", "id": fid, "ts": 210_000.0, "pid": 100,
             "tid": 1},
            {"name": "consume", "cat": "snapshot", "ph": "b", "id": 2,
             "ts": 400_000.0, "pid": 100, "tid": 1},
            {"name": "consume", "cat": "snapshot", "ph": "e", "id": 2,
             "ts": 900_000.0, "pid": 100, "tid": 1},
        ],
        "metadata": {
            "clock_epoch_s": epoch,
            "rank": 0,
            "host": "client-host",
            "pid": 100,
        },
    }


def _server_doc(epoch=1_700_000_000.0, skew_s=0.0):
    fid = "restore-abc/100.1"
    # True wall times sit inside the client's s/f bracket; the recorded
    # epoch carries the injected skew.
    return {
        "traceEvents": [
            {"name": "snapserve.rpc", "cat": "flow", "ph": "t",
             "id": fid, "ts": 110_000.0, "pid": 999, "tid": 1},
            {"name": "snapserve.request", "cat": "snapshot", "ph": "b",
             "id": 1, "ts": 105_000.0, "pid": 999, "tid": 1,
             "args": {"trace": "restore-abc"}},
            {"name": "snapserve.request", "cat": "snapshot", "ph": "e",
             "id": 1, "ts": 200_000.0, "pid": 999, "tid": 1},
            {"name": "snapserve.backend_fetch", "cat": "snapshot",
             "ph": "b", "id": 2, "ts": 120_000.0, "pid": 999, "tid": 1},
            {"name": "snapserve.backend_fetch", "cat": "snapshot",
             "ph": "e", "id": 2, "ts": 190_000.0, "pid": 999, "tid": 1},
        ],
        "metadata": {
            "clock_epoch_s": epoch + skew_s,
            "rank": 0,
            "host": "server-host",
            "pid": 999,
            "role": "server",
        },
    }


def test_merge_multiprocess_client_plus_server(tmp_path, capsys):
    a = tmp_path / "client.json"
    b = tmp_path / "server.json"
    a.write_text(json.dumps(_client_doc()))
    b.write_text(json.dumps(_server_doc()))
    merged_path = str(tmp_path / "m.json")
    assert (
        merge.main([str(a), str(b), "-o", merged_path, "--json"]) == 0
    )
    info = json.loads(capsys.readouterr().out)
    # A server doc with the same rank number is NOT a duplicate-rank
    # error: it is a distinct process.
    assert info["cross_process_flows"] >= 1
    labels = {p["label"] for p in info["processes"]}
    assert "rank 0 (client-host)" in labels
    assert "server pid 999 (server-host)" in labels
    # Critical path: the client's consume ends last (0.9s) — the gating
    # process is the client, and the server's serving spans are in the
    # per-process table.
    cp = info["critical_path"]
    assert cp["gating_process"] == "rank 0 (client-host)"
    assert cp["gating_phase"] == "consume"
    processes = {row["process"] for row in cp["per_rank"]}
    assert "server pid 999 (server-host)" in processes

    merged = json.load(open(merged_path))
    # Flow ids survive un-namespaced (they must match across
    # processes); span ids are namespaced per process.
    flow_ids = {
        e["id"]
        for e in merged["traceEvents"]
        if e.get("ph") in ("s", "t", "f")
    }
    assert flow_ids == {"restore-abc/100.1"}
    span_ids = {
        e["id"]
        for e in merged["traceEvents"]
        if e.get("ph") in ("b", "e")
    }
    assert all(":" in str(i) for i in span_ids)


def test_merge_flow_pairs_align_barrierless_server_clock(tmp_path, capsys):
    a = tmp_path / "client.json"
    b = tmp_path / "server.json"
    a.write_text(json.dumps(_client_doc()))
    b.write_text(json.dumps(_server_doc(skew_s=0.5)))
    assert (
        merge.main(
            [str(a), str(b), "-o", str(tmp_path / "m.json"), "--json"]
        )
        == 0
    )
    info = json.loads(capsys.readouterr().out)
    # The server has no barrier anchors; its skew comes from the
    # paired flow midpoint: t_wall(0.11 + 0.5 skew) vs client bracket
    # midpoint (0.01 + 0.21)/2 = 0.11 → skew ≈ +0.5.
    assert info["skew_s"]["server:999"] == pytest.approx(0.5, abs=0.01)
    assert info["skew_s"]["0"] == pytest.approx(0.0, abs=1e-6)


def test_summarize_merged_trace_names_gating_process(tmp_path, capsys):
    a = tmp_path / "client.json"
    b = tmp_path / "server.json"
    a.write_text(json.dumps(_client_doc()))
    b.write_text(json.dumps(_server_doc(skew_s=0.5)))
    merged_path = str(tmp_path / "m.json")
    assert merge.main([str(a), str(b), "-o", merged_path]) == 0
    capsys.readouterr()
    assert summarize.main([merged_path]) == 0
    out = capsys.readouterr().out
    assert "critical path: rank 0 gated the commit" in out
    # The server's row joins the skew table through its skew_key (the
    # table keys by "<role>:<os-pid>", the row by merged pid) — the
    # flow-pair-corrected skew must actually render.
    server_line = next(
        ln for ln in out.splitlines()
        if "server pid 999 (server-host)" in ln
    )
    assert "clock skew +0.5" in server_line, server_line


def test_server_subprocess_writes_distinct_trace_file(tmp_path):
    """A snapserve server subprocess launched with the SAME
    TPUSNAPSHOT_TRACE as its client writes its own role+pid-suffixed
    file."""
    import subprocess
    import sys

    trace = str(tmp_path / "shared.json")
    env = dict(
        os.environ,
        TPUSNAPSHOT_TRACE=trace,
        TPUSNAPSHOT_TRACE_ROLE="server",
        PYTHONPATH=_REPO_ROOT,
    )
    code = (
        "from torchsnapshot_tpu_torch import tracing\n"
        "print(tracing.flush())\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code],
        env=env,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    written = out.stdout.strip().splitlines()[-1]
    assert written != trace
    assert ".server.pid" in written
    doc = json.load(open(written))
    assert doc["metadata"]["role"] == "server"


# ------------------------------------------------------------------ parity


@pytest.mark.parametrize("skew_s", [0.0, 0.5])
def test_merge_and_summarize_match_jax(tmp_path, capsys, skew_s):
    """The same client and server traces merge to the same document and
    summarize to the same table and JSON in both packages."""
    a = tmp_path / "client.json"
    b = tmp_path / "server.json"
    a.write_text(json.dumps(_client_doc()))
    b.write_text(json.dumps(_server_doc(skew_s=skew_s)))
    outs = []
    for tag, m_main, s_main in (
        ("port", merge.main, summarize.main),
        ("jax", jax_merge.main, jax_summarize.main),
    ):
        merged_path = str(tmp_path / f"m-{tag}.json")
        assert m_main([str(a), str(b), "-o", merged_path, "--json"]) == 0
        info = json.loads(capsys.readouterr().out)
        assert s_main([merged_path]) == 0
        table = capsys.readouterr().out
        assert s_main([merged_path, "--json"]) == 0
        doc = json.loads(capsys.readouterr().out)
        merged = json.load(open(merged_path))
        # The merged document names the package that wrote it.
        assert merged["metadata"].pop("tracer") == {
            "port": "torchsnapshot_tpu_torch", "jax": "torchsnapshot_tpu"
        }[tag]
        outs.append((info, merged, table, doc))
    assert outs[0] == outs[1]
    assert "critical path: rank 0 gated the commit" in outs[0][2]


def test_port_restore_through_jax_server_pairs_flows(tmp_path):
    """A port client restoring through a JAX server (in process: one
    trace file) emits flows the JAX server's spans complete: the frames'
    trace context crosses the packages."""
    trace_path = str(tmp_path / "cross.json")
    root = str(tmp_path / "snap")
    state = _state()
    Snapshot.take(root, state)
    server = jsnapserve.start_local_server()
    try:
        tracing.enable(trace_path)
        target = _zero_like(state)
        RemoteSnapshot(root, addr=server.addr).restore(target)
        events = _flush_events(trace_path)
    finally:
        server.stop()
    _assert_exact(target, state)
    (restore_id,) = _trace_ids(events, "Snapshot.restore")
    flows = {}
    for e in events:
        if e.get("ph") in ("s", "f"):
            flows.setdefault(e["id"], set()).add(e["ph"])
    assert flows and all(phs == {"s", "f"} for phs in flows.values()), flows
    assert all(restore_id in fid for fid in flows)
