"""The port's ``tracing`` module against the JAX package's: the same
sequence of spans, instants, flows and trace scopes gives the same
Chrome-trace events (phase, name, category, argument keys; ids mapped by
first appearance), a spawned process writes its own pid-suffixed file,
and a disabled tracer records nothing."""

import json
import os
import subprocess
import sys
import threading

import pytest

import torchsnapshot_tpu.tracing as jax_tracing
import torchsnapshot_tpu_torch.tracing as port_tracing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _tracers_off():
    for tr in (jax_tracing, port_tracing):
        tr.disable()
    yield
    for tr in (jax_tracing, port_tracing):
        tr.disable()


def _scenario(tr, path):
    """One fixed sequence of tracing calls, as a take and its drain make."""
    tr.enable(path)
    tr.set_identity(rank=3, role="trainer")
    with tr.trace_scope("take"):
        with tr.span("Snapshot.take", path="snap"):
            tr.instant("barrier_exit", gen=1)
            with tr.span("stage", path="0/m/w", bytes=16):
                pass
            with tr.span("write", path="0/m/w", bytes=16):
                pass
            fid = tr.flow_start("replicate", host=1)
            tr.flow_step("replicate", fid, hop=2)
            tr.flow_end("replicate", fid)
        tid = tr.current_trace_id()

    def _drain():
        with tr.adopt_trace(tid), tr.span("write", path="0/m/b", bytes=8):
            tr.instant("metadata_committed", take_id="t", world_size=1)

    t = threading.Thread(target=_drain)
    t.start()
    t.join()
    with tr.span("untraced"):
        pass
    out = tr.flush()
    tr.disable()
    return out


def _normalized(path):
    with open(path) as f:
        doc = json.load(f)
    ids = {}

    def _map(v):
        return ids.setdefault(v, f"id{len(ids)}")

    events = []
    for e in doc["traceEvents"]:
        if e.get("ph") == "M":
            continue
        args = dict(e.get("args") or {})
        norm = {
            "ph": e.get("ph"),
            "name": e.get("name"),
            "cat": e.get("cat"),
            "args": sorted(args),
            "trace": _map(args["trace"]) if "trace" in args else None,
            "id": _map(e["id"]) if "id" in e else None,
        }
        events.append(norm)
    return doc, events


def test_same_calls_give_equal_events(tmp_path):
    jax_path = _scenario(jax_tracing, str(tmp_path / "jax.json"))
    port_path = _scenario(port_tracing, str(tmp_path / "port.json"))
    assert jax_path == str(tmp_path / "jax.json")
    assert port_path == str(tmp_path / "port.json")
    jdoc, jax_events = _normalized(jax_path)
    pdoc, port_events = _normalized(port_path)
    assert port_events == jax_events
    assert len(port_events) >= 12
    # Every span of the scope and the adopted drain carries one trace id;
    # the span after the scope carries none.
    traced = {e["trace"] for e in port_events if e["trace"] is not None}
    assert len(traced) == 1
    assert [e for e in port_events if e["name"] == "untraced"][0]["trace"] is None
    assert sorted(k for k in pdoc if k != "traceEvents") == sorted(
        k for k in jdoc if k != "traceEvents"
    )
    assert pdoc["metadata"]["rank"] == jdoc["metadata"]["rank"] == 3


def test_env_path_gets_the_pid_and_role_in_both(monkeypatch):
    for tr in (jax_tracing, port_tracing):
        assert tr.derive_env_path("/tmp/t.json", None) == f"/tmp/t.pid{os.getpid()}.json"
        assert tr.derive_env_path("/tmp/t.json", "server") == (
            f"/tmp/t.server.pid{os.getpid()}.json"
        )
        assert tr.derive_env_path("/tmp/{role}-{pid}.json", "r") == f"/tmp/r-{os.getpid()}.json"


def test_spawned_process_writes_its_own_pid_file(tmp_path):
    """A rank started with ``TPUSNAPSHOT_TRACE`` set (as a spawned rank
    is) traces into ``<root>.pid<its pid>.json`` and never the parent's."""
    base = str(tmp_path / "trace.json")
    code = (
        "import os\n"
        "from torchsnapshot_tpu_torch import tracing\n"
        "with tracing.span('child', n=1):\n"
        "    pass\n"
        "print(os.getpid())\n"
    )
    env = dict(os.environ, TPUSNAPSHOT_TRACE=base, PYTHONPATH=ROOT)
    pids = []
    for _ in range(2):
        out = subprocess.run(
            [sys.executable, "-c", code], env=env, check=True, capture_output=True,
            text=True, timeout=120,
        )
        pids.append(int(out.stdout.strip()))
    assert not os.path.exists(base)
    for pid in pids:
        with open(str(tmp_path / f"trace.pid{pid}.json")) as f:
            events = json.load(f)["traceEvents"]
        assert [e["name"] for e in events if e.get("ph") == "b"] == ["child"]
        assert all(e["pid"] == pid for e in events if e.get("ph") in ("b", "e"))


def test_disabled_tracer_is_a_no_op(tmp_path):
    for tr in (jax_tracing, port_tracing):
        assert not tr.enabled()
        with tr.span("nothing", path="x"):
            tr.instant("nothing_either")
        assert tr.flush() is None
        # A trace id still propagates with tracing off (context only).
        with tr.trace_scope("take"):
            assert tr.current_trace_id() is not None
        assert tr.current_trace_id() is None
    assert os.listdir(tmp_path) == []
