"""The port's snapwire against the JAX package's: the hot tier's
cross-host transport — ack-at-k over the wire, delta replication, and
the network fault matrix; the tests of ``tests/test_snapwire.py`` on the
port (its snapserve re-export case becomes the frame parity below).

Added here: frames byte-equal to the JAX package's and decoded by it,
the wire's error taxonomy marshalled alike, and replication across the
packages: a port client pushes to a JAX peer server and a JAX client to
a port peer server, each push fingerprint-verified and acked by the
other, deltas carrying only the changed chunk, every replica read back
bit-exact.

In-process peers (``start_local_peer``) carry real TCP sockets without
subprocess spawn cost; the SIGKILL scenarios use real ``spawn_peer``
subprocesses (the port's own peer: ``python -m
torchsnapshot_tpu_torch.hottier.peer``) — killing the process is the
host loss.
"""

import asyncio
import json
import signal
import threading
import time

import numpy as np
import pytest

import torch

from torchsnapshot_tpu_torch import Snapshot, StateDict, hottier
from torchsnapshot_tpu_torch import faultline as fl
from torchsnapshot_tpu import hottier as jhottier
from torchsnapshot_tpu import wire as jwire
from torchsnapshot_tpu.hottier import peer as jpeer
from torchsnapshot_tpu.hottier import tier as jht_tier
from torchsnapshot_tpu.hottier import transport as jtransport
from torchsnapshot_tpu_torch import wire
from torchsnapshot_tpu_torch.hottier import tier as ht_tier
from torchsnapshot_tpu_torch.hottier import transport
from torchsnapshot_tpu_torch.hottier.peer import spawn_peer, start_local_peer
from torchsnapshot_tpu_torch.io_types import IOReq
from torchsnapshot_tpu_torch.storage_plugin import url_to_storage_plugin
from torchsnapshot_tpu_torch.telemetry.doctor import diagnose_report

pytestmark = pytest.mark.faultline


# ----------------------------------------------------------------- helpers


@pytest.fixture(autouse=True)
def _fresh_wire(monkeypatch):
    """Every test starts with an empty tier, no registered peers, no
    scripted wire faults, and tight (fast-failing) wire knobs."""
    monkeypatch.setenv("TPUSNAPSHOT_REPLICATION_DEADLINE_S", "2")
    monkeypatch.setenv("TPUSNAPSHOT_REPLICATION_RETRY_BUDGET_S", "3")
    monkeypatch.setenv("TPUSNAPSHOT_REPLICATION_DOWN_COOLDOWN_S", "0.2")
    monkeypatch.setenv("TPUSNAPSHOT_REPLICATION_CODEC", "none")
    for mod, trans in ((hottier, transport), (jhottier, jtransport)):
        mod.disable_hot_tier(flush=False)
        mod.reset_hot_tier()
        trans.clear_wire_faults()
    servers = []
    yield servers
    for mod, trans in ((hottier, transport), (jhottier, jtransport)):
        mod.disable_hot_tier(flush=False)
        mod.reset_hot_tier()  # closes RemotePeers, kills spawned procs
        trans.clear_wire_faults()
    for server in servers:
        server.stop()
    # The wire tap is process-wide: a later test's live rules must not read
    # this one's RPCs.
    from torchsnapshot_tpu import wiretap as jwiretap
    from torchsnapshot_tpu_torch import wiretap

    wiretap.reset()
    jwiretap.reset()


def _local_peer(servers, host_id, capacity_bytes=1 << 26):
    server, peer = start_local_peer(host_id, capacity_bytes=capacity_bytes)
    servers.append(server)
    return peer


def _state(v, n=2048):
    return {"s": StateDict(w=torch.full((n,), float(v), dtype=torch.float32))}


def _target(n=2048):
    return {"s": StateDict(w=torch.zeros((n,), dtype=torch.float32))}


def _assert_restored(target, v):
    np.testing.assert_array_equal(np.asarray(target["s"]["w"]), float(v))


def _read_report(root):
    plugin = url_to_storage_plugin(root)
    try:
        req = IOReq(path=".report.json")
        asyncio.run(plugin.read(req))
        return json.loads(bytes(req.data).decode("utf-8"))
    finally:
        plugin.close()


# -------------------------------------------------------- framing contract


@pytest.mark.parametrize(
    "header,payload",
    [
        ({"op": "read", "v": 1}, b"payload"),
        ({"v": 1, "op": "put", "key": "memory://r/step_0/0/s/w", "tag": "ab" * 16,
          "basis": {"key": "k", "tag": "t"}, "chunks": [[0, 4096], ["ref", 3]]}, b""),
        ({"v": 1, "ok": False, "error": {"kind": "not_found", "msg": "x é"}},
         bytes(range(256)) * 5),
    ],
)
def test_wire_frames_are_byte_equal_to_jax(header, payload):
    """``encode_frame`` gives the JAX package's frame byte for byte
    (``!I`` header length, ``!Q`` payload length, sorted-keys utf-8
    JSON, the raw payload), and each package decodes the other's."""
    frame = wire.encode_frame(header, payload)
    assert frame == jwire.encode_frame(header, payload)
    body = json.dumps(header, sort_keys=True).encode()
    assert frame[:12] == len(body).to_bytes(4, "big") + len(payload).to_bytes(8, "big")

    async def decode(mod, raw):
        reader = asyncio.StreamReader()
        reader.feed_data(raw)
        reader.feed_eof()
        return await mod.recv_frame(reader)

    assert asyncio.run(decode(wire, jwire.encode_frame(header, payload))) == (header, payload)
    assert asyncio.run(decode(jwire, frame)) == (header, payload)


class InvalidRange(Exception):
    """Shaped as a backend's 416 (classified by the class name)."""


@pytest.mark.parametrize(
    "exc",
    [FileNotFoundError("gone"), InvalidRange("past the end"), RuntimeError("boom")],
)
def test_wire_errors_round_trip_like_jax(exc):
    """``error_to_wire`` classifies a failure as the JAX package does
    (not found, range, backend), and ``wire_to_error`` of either package
    rebuilds the same failure class from the other's dict."""
    assert wire.error_to_wire(exc) == jwire.error_to_wire(exc)
    port_back = wire.wire_to_error(jwire.error_to_wire(exc), "0/s/w")
    jax_back = jwire.wire_to_error(wire.error_to_wire(exc), "0/s/w")
    assert type(port_back).__name__ == type(jax_back).__name__
    assert str(port_back) == str(jax_back)


# --------------------------------------------------------------- ack-at-k


def test_ack_at_k_over_the_wire(_fresh_wire):
    """k=3 across one local + two wire peers: the take acks only after
    every replica crossed a process-visible socket and was fingerprint-
    verified by the receiver; both peers actually hold the bytes."""
    peer1 = _local_peer(_fresh_wire, 1)
    peer2 = _local_peer(_fresh_wire, 2)
    path = "memory://wire-ack/run/step_0"
    before = transport.wire_stats_snapshot()
    with hottier.hot_tier(rank=0, world=3, k=3, drain="manual"):
        snap = Snapshot.take(path, _state(7.0))
        for peer in (peer1, peer2):
            q = peer.query(path + "/0/s/w")
            assert q is not None and q["nbytes"] == 2048 * 4
        after = transport.wire_stats_snapshot()
        assert after["pushes"] - before["pushes"] == 2
        assert (
            after["payload_bytes"] - before["payload_bytes"] == 2 * 8192
        )
        # Kill the local host: the restore is served from a surviving
        # WIRE replica, bit-exact.
        ht_tier.kill_host(0)
        target = _target()
        snap.restore(target)
        _assert_restored(target, 7.0)
        rt = hottier.runtime()
        assert rt.stats_snapshot()["hot_objects"] >= 1
        hottier.drain_now()


def test_corrupt_push_never_acks(_fresh_wire):
    """The receiver's ack gate: a push whose reconstruction does not
    fingerprint back to the pushed tag is NACKed and stores nothing."""
    peer = _local_peer(_fresh_wire, 1)
    data = b"x" * 4096
    resp, _ = peer._call(
        {
            "v": wire.PROTOCOL_VERSION,
            "op": "put",
            "key": "memory://wire-corrupt/run/step_0/0/s/w",
            "root": "memory://wire-corrupt/run/step_0",
            "tag": "bogus-tag",
            "size": len(data),
            "lossy": False,
            "frames": [["raw", 0, len(data), len(data), None]],
        },
        data,
    )
    assert resp["ok"] is False
    assert resp["error"]["kind"] == "corrupt_push"
    assert peer.query("memory://wire-corrupt/run/step_0/0/s/w") is None


def test_capacity_refusal_substitutes_spare_host(_fresh_wire):
    """A wire peer refusing for capacity is not an ack: placement
    continues to the spare host and the object still reaches k replicas
    without a write-through."""
    _local_peer(_fresh_wire, 1, capacity_bytes=64)  # refuses everything
    path = "memory://wire-cap/run/step_0"
    with hottier.hot_tier(rank=0, world=3, k=2, drain="manual"):
        Snapshot.take(path, _state(3.0))
        rt = hottier.runtime()
        stats = rt.stats_snapshot()
        assert stats["write_through"] == 0
        assert stats["replicas"] == 2  # host 0 + spare host 2
        key = path + "/0/s/w"
        assert sorted(ht_tier.replica_hosts_for(key)) == [0, 2]
        hottier.drain_now()


# ----------------------------------------------------------------- deltas


def test_delta_push_costs_changed_chunk_bytes(_fresh_wire, monkeypatch):
    """A partially-dirty retake's push carries exactly the changed
    chunks (chunkstore-style fingerprints are the diff key); unchanged
    chunks travel as ref frames costing zero payload bytes."""
    monkeypatch.setenv("TPUSNAPSHOT_REPLICATION_CHUNK_BYTES", "1024")
    peer = _local_peer(_fresh_wire, 1)
    root0, root1 = (
        "memory://wire-delta/run/step_0",
        "memory://wire-delta/run/step_1",
    )
    base = np.arange(4096, dtype=np.float32)  # 16 KiB = 16 chunks
    data0 = base.tobytes()
    ht_tier.put_replica(
        root0 + "/0/s/w", 1, data0, ht_tier.payload_tag(data0), root0
    )
    dirty = base.copy()
    dirty[:256] += 1.0  # exactly the first 1024-byte chunk
    data1 = dirty.tobytes()
    before = transport.wire_stats_snapshot()
    ht_tier.put_replica(
        root1 + "/0/s/w", 1, data1, ht_tier.payload_tag(data1), root1
    )
    after = transport.wire_stats_snapshot()
    assert after["wire_bytes"] - before["wire_bytes"] == 1024
    assert peer.get(root1 + "/0/s/w").data == data1
    # Fully-unchanged retake: pure-ref push, zero payload bytes.
    root2 = "memory://wire-delta/run/step_2"
    before = transport.wire_stats_snapshot()
    ht_tier.put_replica(
        root2 + "/0/s/w", 1, data1, ht_tier.payload_tag(data1), root2
    )
    after = transport.wire_stats_snapshot()
    assert after["wire_bytes"] - before["wire_bytes"] == 0
    assert peer.get(root2 + "/0/s/w").data == data1


def test_unchanged_retake_delta_ratio_under_10pct(_fresh_wire, monkeypatch):
    """The acceptance number end-to-end: an unchanged retake through
    Snapshot.take replicates < 10% of its payload bytes over the wire,
    and the take report's tier.replication.delta_ratio certifies it."""
    monkeypatch.setenv("TPUSNAPSHOT_REPLICATION_CHUNK_BYTES", "4096")
    _local_peer(_fresh_wire, 1)
    state = _state(11.0, n=8192)
    with hottier.hot_tier(rank=0, world=2, k=2, drain="manual"):
        Snapshot.take("memory://wire-retake/run/step_0", state)
        root1 = "memory://wire-retake/run/step_1"
        Snapshot.take(root1, state)  # unchanged
        hottier.drain_now()
    report = _read_report(root1)
    rep = report["ranks"][0]["tier"]["replication"]
    assert rep["pushes"] >= 1
    assert rep["payload_bytes"] >= 8192 * 4
    assert rep["delta_ratio"] < 0.10


def test_stale_basis_recovers_with_full_push(_fresh_wire):
    """A peer that lost the delta basis (restart/eviction modeled by
    dropping the base replica) answers stale_basis; the client re-pushes
    full and converges — never a wrong replica, never a hang."""
    peer = _local_peer(_fresh_wire, 1)
    root0, root1 = (
        "memory://wire-stale/run/step_0",
        "memory://wire-stale/run/step_1",
    )
    data = np.arange(4096, dtype=np.float32).tobytes()
    ht_tier.put_replica(
        root0 + "/0/s/w", 1, data, ht_tier.payload_tag(data), root0
    )
    # The peer loses the basis replica behind the client's back.
    resp, _ = peer._call(
        {
            "v": wire.PROTOCOL_VERSION,
            "op": "drop",
            "key": root0 + "/0/s/w",
        }
    )
    assert resp["ok"]
    ht_tier.put_replica(
        root1 + "/0/s/w", 1, data, ht_tier.payload_tag(data), root1
    )
    assert peer.get(root1 + "/0/s/w").data == data


def test_int8_optin_lossy_wire_replica(_fresh_wire, monkeypatch):
    """Opt-in int8 moments replication: the wire carries quantized
    frames, the peer stores the DEQUANTIZED moments under their own
    verified tag (bounded error), and the drain persists the EXACT
    bytes from the local replica — the durable tier never sees lossy
    data."""
    from torchsnapshot_tpu_torch import codecs

    monkeypatch.setenv("TPUSNAPSHOT_REPLICATION_INT8_GLOBS", "*opt*")
    monkeypatch.setenv("TPUSNAPSHOT_REPLICATION_CHUNK_BYTES", "4096")
    peer = _local_peer(_fresh_wire, 1)
    root = "memory://wire-int8/run/step_0"
    key = root + "/0/opt/m"
    rng = np.random.default_rng(7)
    moments = rng.standard_normal(4096).astype(np.float32)
    data = moments.tobytes()
    tag = ht_tier.payload_tag(data)
    before = transport.wire_stats_snapshot()
    assert ht_tier.put_replica(key, 1, data, tag, root)
    after = transport.wire_stats_snapshot()
    # Quantized frames cross the wire at ~1/4 the float32 payload.
    assert after["wire_bytes"] - before["wire_bytes"] < len(data) // 2
    obj = peer.get(key)
    assert obj.tag != tag  # lossy replica carries its OWN verified tag
    approx = np.frombuffer(obj.data, dtype=np.float32)
    bound = codecs.quant_error_bound(moments)
    assert float(np.max(np.abs(approx - moments))) <= bound + 1e-6
    # key_tag answers the LOGICAL tag (the drain item's match key), so
    # the lossy replica can never satisfy a drain probe.
    assert ht_tier.key_tag(key) == tag


# ------------------------------------------------------------- wire faults


def test_torn_frame_is_deterministic_and_never_acks(_fresh_wire):
    """faultline's torn_frame at a replicate boundary: the torn attempt
    never acks (the receiver's readexactly observes the tear), the
    retry converges, and the fault record is deterministic."""
    peer = _local_peer(_fresh_wire, 1)
    sched = fl.FaultSchedule().torn_frame(host=1, path="host1:*")
    path = "memory://wire-torn/run/step_0"
    before = transport.wire_stats_snapshot()
    with hottier.hot_tier(rank=0, world=2, k=2, drain="manual"):
        with fl.inject(sched) as ctl:
            snap = Snapshot.take(path, _state(5.0))
        assert ctl.fault_counts() == {"torn_frame": 1}
        after = transport.wire_stats_snapshot()
        assert after["retries"] - before["retries"] >= 1
        assert peer.query(path + "/0/s/w") is not None
        target = _target()
        snap.restore(target)
        _assert_restored(target, 5.0)
        hottier.drain_now()


def test_torn_frames_exhaust_budget_then_degrade(_fresh_wire):
    """Every attempt torn: the push exhausts its retry budget, the
    object is written through to the durable tier BEFORE the ack (the
    obligation is never lost), the peer holds nothing, and the restore
    is bit-exact."""
    peer = _local_peer(_fresh_wire, 1)
    for _ in range(64):  # enough for every retry inside the budget
        transport.script_wire_fault("torn_frame", host=1)
    path = "memory://wire-torn-all/run/step_0"
    with hottier.hot_tier(rank=0, world=2, k=2, drain="manual"):
        t0 = time.monotonic()
        snap = Snapshot.take(path, _state(6.0))
        assert time.monotonic() - t0 < 20.0  # bounded, no hang
        rt = hottier.runtime()
        stats = rt.stats_snapshot()
        assert stats["write_through"] == 1
        assert stats["degraded_puts"] == 1
        transport.clear_wire_faults()
        time.sleep(0.25)  # wait out the down cooldown
        assert peer.probe()  # the peer itself is healthy — only the
        assert peer.query(path + "/0/s/w") is None  # pushes tore; never acked
        target = _target()
        snap.restore(target)
        _assert_restored(target, 6.0)
        hottier.drain_now()
    report = _read_report(path)
    findings = {f.rule: f.severity for f in diagnose_report(report)}
    assert findings.get("replication-degraded") == "critical"


def test_drop_conn_retry_converges(_fresh_wire):
    peer = _local_peer(_fresh_wire, 1)
    sched = fl.FaultSchedule().drop_conn(host=1, path="host1:*")
    path = "memory://wire-drop/run/step_0"
    before = transport.wire_stats_snapshot()
    with hottier.hot_tier(rank=0, world=2, k=2, drain="manual"):
        with fl.inject(sched) as ctl:
            Snapshot.take(path, _state(9.0))
        assert ctl.fault_counts() == {"drop_conn": 1}
        after = transport.wire_stats_snapshot()
        assert after["retries"] - before["retries"] >= 1
        assert after["pushes"] - before["pushes"] == 1
        assert peer.query(path + "/0/s/w") is not None
        hottier.drain_now()


def test_slow_wire_misses_deadline_deterministically(_fresh_wire):
    """slow_wire above the RPC deadline: exactly one counted deadline
    miss, then the retry (unscripted) lands the push; the take report's
    replication window carries the miss and the doctor warns."""
    _local_peer(_fresh_wire, 1)
    sched = fl.FaultSchedule().slow_wire(
        seconds=3.0, host=1, path="host1:*"
    )
    path = "memory://wire-slow/run/step_0"
    before = transport.wire_stats_snapshot()
    with hottier.hot_tier(rank=0, world=2, k=2, drain="manual"):
        with fl.inject(sched) as ctl:
            Snapshot.take(path, _state(2.0))
        assert ctl.fault_counts() == {"slow_wire": 1}
        after = transport.wire_stats_snapshot()
        assert after["deadline_misses"] - before["deadline_misses"] == 1
        hottier.drain_now()
    report = _read_report(path)
    rep = report["ranks"][0]["tier"]["replication"]
    assert rep["deadline_misses"] == 1
    findings = {f.rule: f.severity for f in diagnose_report(report)}
    assert findings.get("replication-degraded") == "warn"


# ------------------------------------------------- real process boundaries


def test_spawn_peer_port_file_and_sigkill(_fresh_wire):
    """The subprocess peer binds via --port-file, answers pings and
    queries over the wire, and dies by real SIGKILL through
    tier.kill_host."""
    proc, addr, peer = spawn_peer(host_id=1, capacity_bytes=1 << 26)
    assert ":" in addr
    assert peer.probe()
    root = "memory://wire-spawn/run/step_0"
    data = b"d" * 4096
    assert ht_tier.put_replica(
        root + "/0/s/w", 1, data, ht_tier.payload_tag(data), root
    )
    assert peer.get(root + "/0/s/w").data == data
    ht_tier.kill_host(1)
    assert proc.poll() == -9  # a REAL SIGKILL, not a flag flip
    with pytest.raises(ht_tier.HostLostError):
        ht_tier.get_replica(root + "/0/s/w", 1)


def test_restore_from_peer_after_real_kill(_fresh_wire):
    """k=3 with two real peer subprocesses; k-1 losses (one real
    SIGKILL + the local host) leave the take restorable bit-exact from
    the surviving peer process."""
    proc1, _, _ = spawn_peer(host_id=1, capacity_bytes=1 << 26)
    proc2, _, _ = spawn_peer(host_id=2, capacity_bytes=1 << 26)
    path = "memory://wire-kill/run/step_0"
    with hottier.hot_tier(rank=0, world=3, k=3, drain="manual"):
        snap = Snapshot.take(path, _state(13.0))
        ht_tier.kill_host(1)  # real SIGKILL
        ht_tier.kill_host(0)  # local host flag — k-1 = 2 losses total
        assert proc1.poll() == -9
        target = _target()
        snap.restore(target)
        _assert_restored(target, 13.0)
        rt = hottier.runtime()
        assert rt.stats_snapshot()["hot_objects"] >= 1
        assert proc2.poll() is None  # the survivor served it
        hottier.drain_now()


def test_lose_host_aborts_blocked_socket_read(_fresh_wire, monkeypatch):
    """The lose_host contract: a socket read blocked on a hung peer
    (SIGSTOP — the process is alive, the socket open, nothing answers)
    observes the loss promptly when kill_host aborts the host's
    in-flight connections, instead of hanging out its full deadline."""
    monkeypatch.setenv("TPUSNAPSHOT_REPLICATION_DEADLINE_S", "30")
    monkeypatch.setenv("TPUSNAPSHOT_REPLICATION_RETRY_BUDGET_S", "60")
    proc, _, peer = spawn_peer(host_id=1, capacity_bytes=1 << 26)
    root = "memory://wire-hang/run/step_0"
    data = b"h" * 4096
    assert ht_tier.put_replica(
        root + "/0/s/w", 1, data, ht_tier.payload_tag(data), root
    )
    proc.send_signal(signal.SIGSTOP)  # the peer hangs, socket stays open
    failures = []
    done = threading.Event()

    def _blocked_get():
        t0 = time.monotonic()
        try:
            ht_tier.get_replica(root + "/0/s/w", 1)
        except ht_tier.HostLostError:
            failures.append(time.monotonic() - t0)
        done.set()

    thread = threading.Thread(target=_blocked_get, daemon=True)
    thread.start()
    time.sleep(0.5)  # let the RPC block on the hung peer
    ht_tier.kill_host(1)  # SIGKILL + in-flight connection abort
    assert done.wait(timeout=10.0), "blocked read never observed the loss"
    thread.join(timeout=5.0)
    assert failures and failures[0] < 10.0  # far below the 30s deadline


def _loss_matrix_point(nth):
    """One host-loss × crash-point matrix cell: a REAL peer subprocess
    is SIGKILLed at the nth hottier.replicate boundary; the take must
    either ack honestly (write-through when k cannot be met) and
    restore bit-exact, with every obligation retired by drain_now."""
    spawn_peer(host_id=1, capacity_bytes=1 << 26)
    path = f"memory://wire-matrix/run/step_{nth}"
    sched = fl.FaultSchedule().lose_host(
        1, op="hottier.replicate", nth=nth
    )
    state = {
        "a": StateDict(x=torch.full((512,), 1.0 + nth, dtype=torch.float32)),
        "b": StateDict(y=torch.full((512,), 2.0 + nth, dtype=torch.float32)),
    }
    with hottier.hot_tier(rank=0, world=2, k=2, drain="manual"):
        t0 = time.monotonic()
        with fl.inject(sched) as ctl:
            snap = Snapshot.take(path, state)
        elapsed = time.monotonic() - t0
        assert elapsed < 30.0, f"take hung {elapsed:.1f}s at nth={nth}"
        assert ctl.fault_counts().get("hostloss") == 1
        rt = hottier.runtime()
        stats = rt.stats_snapshot()
        # Every object acked: either at k replicas or via write-through.
        assert stats["write_through"] + stats["replicas"] >= 2
        target = {
            "a": StateDict(x=torch.zeros((512,), dtype=torch.float32)),
            "b": StateDict(y=torch.zeros((512,), dtype=torch.float32)),
        }
        snap.restore(target)
        np.testing.assert_array_equal(
            np.asarray(target["a"]["x"]), 1.0 + nth
        )
        np.testing.assert_array_equal(
            np.asarray(target["b"]["y"]), 2.0 + nth
        )
        hottier.drain_now()
        assert hottier.wait_drained(timeout_s=30.0)
    # The committed take is durable: restorable with the tier OFF too.
    hottier.reset_hot_tier()
    target2 = {
        "a": StateDict(x=torch.zeros((512,), dtype=torch.float32)),
        "b": StateDict(y=torch.zeros((512,), dtype=torch.float32)),
    }
    Snapshot(path).restore(target2)
    np.testing.assert_array_equal(np.asarray(target2["a"]["x"]), 1.0 + nth)
    np.testing.assert_array_equal(np.asarray(target2["b"]["y"]), 2.0 + nth)


@pytest.mark.parametrize("nth", [1, 2, 3])
def test_real_sigkill_loss_matrix_stride(_fresh_wire, nth):
    """Fast stride subset of the host-loss × crash-point matrix across
    REAL process boundaries (2 payload objects × k=2 = 4 replicate
    boundaries; the full enumeration runs under -m slow)."""
    _loss_matrix_point(nth)


@pytest.mark.slow
@pytest.mark.parametrize("nth", [4])
def test_real_sigkill_loss_matrix_full(_fresh_wire, nth):
    """The remaining matrix cells (every replicate boundary of the
    2-object take)."""
    _loss_matrix_point(nth)


# --------------------------------------------------------------- plumbing


def test_addrs_env_registers_peers(_fresh_wire, monkeypatch):
    """TPUSNAPSHOT_HOT_TIER_ADDRS is the production address book:
    enable_hot_tier registers the named peers and replication crosses
    the wire with no explicit wiring."""
    server, _ = start_local_peer(1, register=False)
    _fresh_wire.append(server)
    monkeypatch.setenv("TPUSNAPSHOT_HOT_TIER_ADDRS", f"1={server.addr}")
    path = "memory://wire-addrs/run/step_0"
    with hottier.hot_tier(rank=0, world=2, k=2, drain="manual"):
        assert hottier.remote_host(1) is not None
        before = transport.wire_stats_snapshot()
        Snapshot.take(path, _state(4.0))
        after = transport.wire_stats_snapshot()
        assert after["pushes"] - before["pushes"] == 1
        hottier.drain_now()


def test_replication_ledger_field_and_metrics(_fresh_wire):
    """The per-take ledger digest carries tier.replication with
    delta_ratio; the five replication counters move."""
    from torchsnapshot_tpu_torch import telemetry
    from torchsnapshot_tpu_torch.telemetry import ledger as runledger
    from torchsnapshot_tpu_torch.telemetry import metrics as m

    _local_peer(_fresh_wire, 1)
    path = "memory://wire-ledger/run/step_0"
    c0 = telemetry.counter(m.HOT_TIER_REPLICATION_PUSHES).value
    b0 = telemetry.counter(m.HOT_TIER_REPLICATION_BYTES).value
    with hottier.hot_tier(rank=0, world=2, k=2, drain="manual"):
        Snapshot.take(path, _state(8.0))
        hottier.drain_now()
    assert telemetry.counter(m.HOT_TIER_REPLICATION_PUSHES).value == c0 + 1
    assert telemetry.counter(m.HOT_TIER_REPLICATION_BYTES).value >= b0 + 8192
    records, _ = runledger.read_records(path)
    takes = [r for r in records if r.get("kind") == "take"]
    assert takes, "take digest missing from ledger"
    rep = (takes[-1].get("tier") or {}).get("replication")
    assert rep is not None
    assert rep["pushes"] == 1
    assert rep["delta_ratio"] is not None


# ------------------------------------------------ across the two packages


@pytest.mark.parametrize("client", ["port", "jax"])
def test_replication_crosses_the_packages(_fresh_wire, monkeypatch, client):
    """A port client pushes to a JAX peer server and a JAX client to a
    port peer server over real sockets: the other package's ack gate
    fingerprint-verifies each push, a retake with one changed chunk
    carries exactly that chunk, an unchanged one no payload byte, and
    every replica reads back bit-exact on both sides."""
    monkeypatch.setenv("TPUSNAPSHOT_REPLICATION_CHUNK_BYTES", "1024")
    if client == "port":
        server_mod, server_tier = jpeer, jht_tier
        c_tier, c_transport = ht_tier, transport
    else:
        server_mod, server_tier = __import__(
            "torchsnapshot_tpu_torch.hottier.peer", fromlist=["peer"]
        ), ht_tier
        c_tier, c_transport = jht_tier, jtransport
    server, _ = server_mod.start_local_peer(5, capacity_bytes=1 << 26, register=False)
    _fresh_wire.append(server)
    peer = c_transport.connect_peer(5, server.addr, capacity_bytes=1 << 26)
    rng = np.random.default_rng(15)
    base = rng.standard_normal(4096).astype(np.float32)  # 16 chunks
    dirty = base.copy()
    dirty[:256] += 1.0  # exactly the first chunk
    roots = [f"memory://wire-cross-{client}/run/step_{i}" for i in range(3)]
    sent = []
    for root, data in zip(roots, (base.tobytes(), dirty.tobytes(), dirty.tobytes())):
        before = c_transport.wire_stats_snapshot()
        assert c_tier.put_replica(root + "/0/s/w", 5, data, c_tier.payload_tag(data), root)
        after = c_transport.wire_stats_snapshot()
        assert after["pushes"] - before["pushes"] == 1
        sent.append(after["wire_bytes"] - before["wire_bytes"])
    assert sent == [4096 * 4, 1024, 0]
    for root, data in zip(roots, (base.tobytes(), dirty.tobytes(), dirty.tobytes())):
        key = root + "/0/s/w"
        assert peer.get(key).data == data  # through the client
        held = server_tier.get_replica(key, 5)  # in the server's own store
        assert held.data == data
        assert held.tag == c_tier.payload_tag(data)


@pytest.mark.parametrize("taker", ["port", "jax"])
def test_take_through_the_other_packages_peer_restores_hot(_fresh_wire, monkeypatch, taker):
    """A take through one package's tier replicates into the other
    package's peer server (named in the address book); with the taker's
    own host lost, the restore is served from that peer, bit-exact."""
    rng = np.random.default_rng(16)
    w = rng.standard_normal(2048).astype(np.float32)
    if taker == "port":
        server, _ = jpeer.start_local_peer(1, register=False)
        mod, state = hottier, {"s": StateDict(w=torch.from_numpy(w.copy()))}
        snap_cls, target = Snapshot, {"s": StateDict(w=torch.zeros(2048))}
    else:
        import jax.numpy as jnp

        from torchsnapshot_tpu import Snapshot as JSnapshot
        from torchsnapshot_tpu import StateDict as JStateDict

        server, _ = start_local_peer(1, register=False)
        mod, state = jhottier, {"s": JStateDict(w=jnp.asarray(w))}
        snap_cls, target = JSnapshot, {"s": JStateDict(w=jnp.zeros(2048, jnp.float32))}
    _fresh_wire.append(server)
    path = f"memory://wire-cross-take-{taker}/run/step_0"
    monkeypatch.setenv("TPUSNAPSHOT_HOT_TIER_ADDRS", f"1={server.addr}")
    with mod.hot_tier(rank=0, world=2, k=2, drain="manual"):
        snap_cls.take(path, state)
        mod.kill_host(0)
        snap_cls(path).restore(target)
        stats = mod.runtime().stats_snapshot()
        assert stats["hot_objects"] >= 1 and stats["fallback_objects"] == 0
    np.testing.assert_array_equal(np.asarray(target["s"]["w"]), w)

