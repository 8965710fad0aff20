"""The port's snapmend against the JAX package's: the hot tier's
self-healing repair plane; the tests of ``tests/test_snapmend.py`` on the
port.

Fast tier (``-m faultline``, runs in tier-1): repair back to k after a
real host loss with a bit-exact restore from a *repaired* (not
original) replica and the under-replicated gauge returning to 0;
subprocess auto-restart one membership generation up with the address
book and port-file hot-reloaded; the hung-not-dead peer (SIGSTOP)
classified lost past the repair deadline with its SIGCONT'd stale
generation refused; deterministic ``flap_host`` lose-then-rejoin
churn; the repair × crash-point stride (full enumeration ``-m
slow``) proving no crash point resurrects a deleted root's objects or
repairs superseded tags; deadline-exceeded escalation to durable
write-through firing ``replication-underreplicated`` critical; the
down-cooldown background re-probe; and the repair telemetry surface
(metrics, the ledger's ``repair`` record, ``introspect``).

Added here: the same loss gives the same repair tick summary, ledger
record and restored bytes in both packages, and the port's repair plane
re-replicates onto a JAX peer server.

In-process peers (``start_local_peer``) carry real TCP sockets without
subprocess spawn cost; loss/restart/SIGSTOP scenarios use real
``spawn_peer`` subprocesses — the signal IS the fault.
"""

import os
import signal
import tempfile
import time

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import torchsnapshot_tpu as jsnap
from torchsnapshot_tpu import hottier as jhottier
from torchsnapshot_tpu.hottier import peer as jpeer
from torchsnapshot_tpu.hottier import tier as jht_tier
from torchsnapshot_tpu.telemetry import ledger as jrunledger
from torchsnapshot_tpu_torch import Snapshot, StateDict, hottier, telemetry
from torchsnapshot_tpu_torch import faultline as fl
from torchsnapshot_tpu_torch.hottier import repair as ht_repair
from torchsnapshot_tpu_torch.hottier import tier as ht_tier
from torchsnapshot_tpu_torch.hottier import transport
from torchsnapshot_tpu_torch.hottier.peer import spawn_peer, start_local_peer
from torchsnapshot_tpu_torch.telemetry import ledger as runledger
from torchsnapshot_tpu_torch.telemetry import metrics as m
from torchsnapshot_tpu_torch.telemetry import ops as ops_cli
from torchsnapshot_tpu_torch.telemetry import slo as slo_mod

pytestmark = pytest.mark.faultline


# ----------------------------------------------------------------- helpers


@pytest.fixture(autouse=True)
def _fresh_mend(monkeypatch):
    """Every test starts with an empty tier, no peers, no scripted
    faults, fast-failing wire knobs, and a tight repair cadence."""
    monkeypatch.setenv("TPUSNAPSHOT_REPLICATION_DEADLINE_S", "2")
    monkeypatch.setenv("TPUSNAPSHOT_REPLICATION_RETRY_BUDGET_S", "3")
    monkeypatch.setenv("TPUSNAPSHOT_REPLICATION_DOWN_COOLDOWN_S", "0.2")
    monkeypatch.setenv("TPUSNAPSHOT_REPLICATION_CODEC", "none")
    monkeypatch.setenv("TPUSNAPSHOT_REPAIR_INTERVAL_S", "0.2")
    monkeypatch.setenv("TPUSNAPSHOT_REPAIR_DEADLINE_S", "30")
    for mod in (hottier, jhottier):
        mod.disable_hot_tier(flush=False)
        mod.reset_hot_tier()
    transport.clear_wire_faults()
    servers = []
    yield servers
    for mod in (hottier, jhottier):
        mod.disable_hot_tier(flush=False)
        mod.reset_hot_tier()  # closes RemotePeers, kills spawned procs
    transport.clear_wire_faults()
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


# --------------------------------------------------------- repair back to k


def test_repair_restores_k_and_restore_from_repaired_replica(_fresh_mend):
    """The headline contract: lose one of the replica hosts →
    repair_tick re-replicates every committed undrained object back to
    k from a surviving replica, the under-replicated gauge returns to
    0, and a restore served ONLY by the repaired replica is
    bit-exact."""
    for h in (1, 2, 3):
        _local_peer(_fresh_mend, h)
    path = "memory://mend-k/run/step_0"
    c_obj = telemetry.counter(m.HOT_TIER_REPAIR_OBJECTS).value
    c_bytes = telemetry.counter(m.HOT_TIER_REPAIR_BYTES).value
    with hottier.hot_tier(
        rank=0, world=4, k=3, drain="manual", repair="manual"
    ):
        snap = Snapshot.take(path, _state(7.0))
        key = path + "/0/s/w"
        assert ht_tier.live_replicas(key) == [0, 1, 2]
        ht_tier.kill_host(1)
        assert ht_tier.live_replicas(key) == [0, 2]
        summary = hottier.repair_tick()
        assert summary["hosts_lost"] == [1]
        assert summary["objects_repaired"] == 1
        assert summary["underreplicated_objects"] == 0
        # Repaired onto the spare host 3 — back at k.
        assert ht_tier.live_replicas(key) == [0, 2, 3]
        assert (
            telemetry.gauge(m.HOT_TIER_UNDERREPLICATED_BYTES).value == 0.0
        )
        assert telemetry.counter(m.HOT_TIER_REPAIR_OBJECTS).value == (
            c_obj + 1
        )
        assert telemetry.counter(m.HOT_TIER_REPAIR_BYTES).value == (
            c_bytes + 8192
        )
        # Kill both ORIGINAL surviving replicas: the restore can only
        # be served by the replica repair placed.
        ht_tier.kill_host(0)
        ht_tier.kill_host(2)
        target = _target()
        snap.restore(target)
        _assert_restored(target, 7.0)
        rt = hottier.runtime()
        assert rt.stats_snapshot()["hot_objects"] >= 1  # not a fallback
        hottier.drain_now()
    # The ledger carries the repair event record for this root.
    records, _ = runledger.read_records(path)
    repairs = [r for r in records if r.get("kind") == "repair"]
    assert repairs and repairs[-1]["objects_repaired"] == 1
    assert repairs[-1]["bytes_repaired"] == 8192
    assert repairs[-1]["underreplicated_bytes"] == 0


def test_sigkill_subprocess_auto_restart_gen_up_and_hot_reload(
    _fresh_mend, monkeypatch
):
    """A real SIGKILLed spawned peer: one tick classifies it lost,
    respawns a FRESH subprocess one membership generation up,
    hot-reloads TPUSNAPSHOT_HOT_TIER_ADDRS and the port-file in place,
    and re-replicates the committed object onto the empty newcomer —
    replica count returns to k with no process restart anywhere."""
    port_file = tempfile.mktemp(prefix="mend-peer-", suffix=".addr")
    proc, addr, _peer = spawn_peer(
        host_id=1, capacity_bytes=1 << 26, port_file=port_file
    )
    monkeypatch.setenv("TPUSNAPSHOT_HOT_TIER_ADDRS", f"1={addr}")
    path = "memory://mend-respawn/run/step_0"
    with hottier.hot_tier(
        rank=0, world=2, k=2, drain="manual", repair="manual"
    ):
        Snapshot.take(path, _state(3.0))
        key = path + "/0/s/w"
        assert ht_tier.live_replicas(key) == [0, 1]
        proc.kill()  # raw SIGKILL behind the tier's back
        proc.wait()
        summary = hottier.repair_tick()
        assert summary["hosts_lost"] == [1]
        assert summary["peer_restarts"] == 1
        new_peer = ht_tier.remote_host(1)
        assert new_peer.generation == 1
        assert ht_tier.host_generation(1) == 1
        assert new_peer.probe()
        # Address book + port-file follow the host across generations.
        assert (
            os.environ["TPUSNAPSHOT_HOT_TIER_ADDRS"]
            == f"1={new_peer.addr_str}"
        )
        with open(port_file) as f:
            assert f.read().strip() == new_peer.addr_str
        # The SAME tick already repaired onto the fresh (empty) peer.
        assert ht_tier.live_replicas(key) == [0, 1]
        q = new_peer.query(key)
        assert q is not None and q["nbytes"] == 2048 * 4
        hottier.drain_now()
    try:
        os.unlink(port_file)
    except OSError:
        pass


def test_background_repair_heals_without_manual_ticks(_fresh_mend):
    """repair="background": the daemon loop alone (no manual ticks)
    detects a host loss and restores k within a few intervals."""
    for h in (1, 2, 3):
        _local_peer(_fresh_mend, h)
    path = "memory://mend-bg/run/step_0"
    with hottier.hot_tier(
        rank=0, world=4, k=3, drain="manual", repair="background"
    ):
        Snapshot.take(path, _state(9.0))
        key = path + "/0/s/w"
        ht_tier.kill_host(2)
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline:
            if len(ht_tier.live_replicas(key)) >= 3:
                break
            time.sleep(0.1)
        assert ht_tier.live_replicas(key) == [0, 1, 3]
        hottier.drain_now()


# ------------------------------------------------- hung, not dead (SIGSTOP)


def test_sigstop_peer_lost_after_deadline_stale_gen_refused(
    _fresh_mend, monkeypatch
):
    """The hung-not-dead peer: SIGSTOP'd, its process never exits but
    its probes fail. Past TPUSNAPSHOT_REPAIR_DEADLINE_S it is
    classified LOST (condemned — never signalled), its objects
    re-replicate elsewhere, and when its replacement has taken the id
    one generation up, the SIGCONT'd predecessor is refused: a probe
    stamped with the CURRENT generation rejects the stale server, the
    shadow occupancy counts the host once, and the restore never sees
    stale bytes."""
    monkeypatch.setenv("TPUSNAPSHOT_REPLICATION_DEADLINE_S", "0.5")
    monkeypatch.setenv("TPUSNAPSHOT_REPAIR_DEADLINE_S", "0.6")
    proc, addr, _peer = spawn_peer(host_id=1, capacity_bytes=1 << 26)
    _local_peer(_fresh_mend, 2)
    path = "memory://mend-stop/run/step_0"
    with hottier.hot_tier(
        rank=0, world=3, k=2, drain="manual", repair="manual"
    ):
        snap = Snapshot.take(path, _state(11.0))
        key = path + "/0/s/w"
        assert ht_tier.live_replicas(key) == [0, 1]
        proc.send_signal(signal.SIGSTOP)  # hung: alive but silent
        t0 = time.monotonic()
        first = hottier.repair_tick()  # probe fails; deadline clock arms
        assert first["hosts_lost"] == []  # not lost yet — only failing
        assert proc.poll() is None
        time.sleep(max(0.0, 0.7 - (time.monotonic() - t0)))
        second = hottier.repair_tick()  # past the deadline: LOST
        assert second["hosts_lost"] == [1]
        assert proc.poll() is None  # never signalled — only condemned
        # Same tick: respawned one generation up AND repaired to k.
        assert ht_tier.host_generation(1) == 1
        assert len(ht_tier.live_replicas(key)) >= 2
        # Wake the stale predecessor: its generation-0 server must be
        # refused by a current-generation probe.
        proc.send_signal(signal.SIGCONT)
        time.sleep(0.1)
        stale_probe = transport.RemotePeer(1, addr, generation=1)
        assert stale_probe.probe() is False  # stale gen refused
        accepts_own = transport.RemotePeer(1, addr, generation=0)
        assert accepts_own.probe() is True  # ...and it IS the gen gate
        stale_probe.close()
        accepts_own.close()
        # No double-count: host 1's occupancy reflects only the
        # current generation's shadow (one object).
        occ = ht_tier.host_occupancy()[1]
        assert occ["objects"] == 1 and occ["alive"]
        target = _target()
        snap.restore(target)
        _assert_restored(target, 11.0)
        hottier.drain_now()
    proc.kill()
    proc.wait()


# --------------------------------------------------------- flap_host churn


def test_flap_host_deterministic_churn_then_repair(_fresh_mend):
    """faultline's flap_host: the wire-backed peer is really SIGKILLed
    at the matched replicate boundary and rejoins two boundaries later
    as a FRESH subprocess one generation up; the repair tick then
    restores k and the restore is bit-exact."""
    proc, _addr, _peer = spawn_peer(host_id=1, capacity_bytes=1 << 26)
    sched = fl.FaultSchedule().flap_host(
        1, revive_after_ops=2, op="hottier.replicate"
    )
    path = "memory://mend-flap/run/step_0"
    with hottier.hot_tier(
        rank=0, world=3, k=2, drain="manual", repair="manual"
    ):
        with fl.inject(sched) as ctl:
            snap = Snapshot.take(path, _state(4.0))
        counts = ctl.fault_counts()
        assert counts.get("flap") == 1
        assert counts.get("revive") == 1
        # The revive record carries the boundary the revival took
        # effect at: exactly revive_after_ops past the loss.
        by_kind = {r.kind: r for r in ctl.records}
        assert (
            by_kind["revive"].op_index == by_kind["flap"].op_index + 2
        )
        assert proc.poll() == -9  # the loss was a REAL SIGKILL
        new_peer = ht_tier.remote_host(1)
        assert new_peer.generation == 1 and new_peer.probe()
        summary = hottier.repair_tick()
        assert summary["underreplicated_objects"] == 0
        key = path + "/0/s/w"
        assert len(ht_tier.live_replicas(key)) >= 2
        ht_tier.kill_host(0)  # force the read onto the churned fleet
        target = _target()
        snap.restore(target)
        _assert_restored(target, 4.0)
        hottier.drain_now()


# --------------------------------------------- repair × crash-point matrix


def _repair_matrix_point(servers, nth):
    """One matrix cell: SimulatedCrash at the nth hottier.repair
    placement boundary; afterwards a clean tick converges back to k,
    the restore is bit-exact, and tier-down retires every obligation."""
    for h in (1, 2, 3):
        _local_peer(servers, h)
    path = f"memory://mend-matrix/run/step_{nth}"
    state = {
        "a": StateDict(x=torch.full((512,), 1.0 + nth, dtype=torch.float32)),
        "b": StateDict(y=torch.full((512,), 2.0 + nth, dtype=torch.float32)),
    }
    with hottier.hot_tier(
        rank=0, world=4, k=3, drain="manual", repair="manual"
    ):
        snap = Snapshot.take(path, state)
        ht_tier.kill_host(1)  # two objects drop to k-1
        sched = fl.FaultSchedule().crash_on(op="hottier.repair", nth=nth)
        with fl.inject(sched) as ctl:
            with pytest.raises(fl.SimulatedCrash):
                hottier.repair_tick()
        assert ctl.fault_counts().get("crash") == 1
        # The next (un-crashed) tick converges from whatever the crash
        # left behind.
        summary = hottier.repair_tick()
        assert summary["underreplicated_objects"] == 0
        for leaf in ("a/x", "b/y"):
            key = f"{path}/0/{leaf}"
            assert len(ht_tier.live_replicas(key)) >= 3, leaf
        target = {
            "a": StateDict(x=torch.zeros((512,), dtype=torch.float32)),
            "b": StateDict(y=torch.zeros((512,), dtype=torch.float32)),
        }
        snap.restore(target)
        np.testing.assert_array_equal(np.asarray(target["a"]["x"]), 1.0 + nth)
        np.testing.assert_array_equal(np.asarray(target["b"]["y"]), 2.0 + nth)
        hottier.drain_now()
        assert hottier.wait_drained(timeout_s=30.0)


@pytest.mark.parametrize("nth", [1])
def test_repair_crash_matrix_stride(_fresh_mend, nth):
    """Fast stride subset of the repair × crash-point matrix (2
    under-replicated objects × 1 placement each = 2 repair boundaries;
    the full enumeration runs under -m slow)."""
    _repair_matrix_point(_fresh_mend, nth)


@pytest.mark.slow
@pytest.mark.parametrize("nth", [2])
def test_repair_crash_matrix_full(_fresh_mend, nth):
    _repair_matrix_point(_fresh_mend, nth)


def test_no_crash_point_resurrects_forgotten_root(_fresh_mend):
    """forget-root latch across a crashed repair: a root deleted after
    a crash mid-repair is never resurrected — later ticks skip it and
    every replica (including any the crashed tick placed) is gone."""
    for h in (1, 2, 3):
        _local_peer(_fresh_mend, h)
    path = "memory://mend-forget/run/step_0"
    with hottier.hot_tier(
        rank=0, world=4, k=3, drain="manual", repair="manual"
    ):
        Snapshot.take(path, _state(6.0))
        key = path + "/0/s/w"
        ht_tier.kill_host(1)
        sched = fl.FaultSchedule().crash_on(op="hottier.repair", nth=1)
        with fl.inject(sched):
            with pytest.raises(fl.SimulatedCrash):
                hottier.repair_tick()
        hottier.forget_root(path)  # the snapshot is deleted mid-story
        summary = hottier.repair_tick()
        assert summary["objects_repaired"] == 0
        assert summary["underreplicated_objects"] == 0
        assert ht_tier.live_replicas(key) == []
        assert path not in hottier.buffered_roots()


def test_superseded_tag_never_repaired(_fresh_mend):
    """tag-strict: the under-replication count and the repair source
    are judged against the path's CURRENT tag only. A surviving stale
    replica neither counts toward k nor ever propagates; when current
    bytes DO survive, repair replicates those — replacing the stale
    replica, never multiplying it."""
    _local_peer(_fresh_mend, 1)
    _local_peer(_fresh_mend, 2)
    path = "memory://mend-stale-tag/run/step_0"
    with hottier.hot_tier(
        rank=0, world=3, k=2, drain="manual", repair="manual"
    ):
        Snapshot.take(path, _state(5.0))
        key = path + "/0/s/w"
        rt = hottier.runtime()
        stale_tag = ht_tier.key_tag(key)
        # Model the re-write race: the path's current bytes move on
        # (the foreground re-put lands on host 0) while host 1 still
        # holds the superseded replica.
        new = np.full((2048,), 50.0, dtype=np.float32).tobytes()
        new_tag = ht_tier.payload_tag(new)
        assert ht_tier.put_replica(key, 0, new, new_tag, path)
        with rt._cond:
            rt._roots[path.rstrip("/")].tags["0/s/w"] = new_tag
        # Phase 1: current bytes survive on host 0 only. Repair must
        # source from THEM — the stale host-1 replica is replaced by
        # current bytes, not kept, and never chosen as a source.
        summary = hottier.repair_tick()
        assert summary["objects_repaired"] == 1
        assert sorted(ht_tier.live_replicas(key, new_tag))[:1] == [0]
        assert len(ht_tier.live_replicas(key, new_tag)) >= 2
        assert ht_tier.live_replicas(key, stale_tag) == []
        # Phase 2: make a stale replica the ONLY survivor. Repair must
        # skip the object entirely (the drain loop owns the loss
        # verdict) — superseded bytes are never re-replicated.
        stale = np.full((2048,), 5.0, dtype=np.float32).tobytes()
        assert ht_tier.put_replica(key, 2, stale, stale_tag, path)
        ht_tier.kill_host(0)
        ht_tier.kill_host(1)
        summary = hottier.repair_tick()
        assert summary["objects_repaired"] == 0
        assert summary["underreplicated_objects"] == 1
        assert ht_tier.live_replicas(key, stale_tag) == [2]  # not grown
        assert ht_tier.live_replicas(key, new_tag) == []
        hottier.reset_pending()


def test_corrupt_source_replica_never_repaired(_fresh_mend):
    """A bit-rotted survivor is not a repair source: the fingerprint
    gate drops it, the repair is counted failed, and no host receives
    the corrupt bytes."""
    fails = telemetry.counter(m.HOT_TIER_REPAIRS_FAILED).value
    path = "memory://mend-corrupt/run/step_0"
    with hottier.hot_tier(
        rank=0, world=3, k=2, drain="manual", repair="manual"
    ):
        Snapshot.take(path, _state(1.0))  # in-process hosts 0 and 1
        key = path + "/0/s/w"
        obj = ht_tier._HOSTS[1].objects[key]
        obj.data = b"\x00" * len(obj.data)  # rot host 1's bytes
        ht_tier.kill_host(0)  # the corrupt replica is the only claim
        summary = hottier.repair_tick()
        assert summary["objects_repaired"] == 0
        assert summary["repairs_failed"] == 1
        assert telemetry.counter(m.HOT_TIER_REPAIRS_FAILED).value == (
            fails + 1
        )
        assert ht_tier.live_replicas(key) == []  # dropped, not spread
        hottier.reset_pending()


def test_corrupt_source_among_survivors_reaches_k_in_one_tick(_fresh_mend):
    """A host whose replica the source scan disproved (corrupt,
    dropped) must not count toward k: the placement loop refills to k
    in THIS tick instead of stopping one replica short and waiting
    another interval."""
    for h in (1, 2, 3):
        _local_peer(_fresh_mend, h)
    path = "memory://mend-corrupt-among/run/step_0"
    with hottier.hot_tier(
        rank=0, world=4, k=3, drain="manual", repair="manual"
    ):
        snap = Snapshot.take(path, _state(6.0))
        key = path + "/0/s/w"
        assert ht_tier.live_replicas(key) == [0, 1, 2]
        obj = ht_tier._HOSTS[0].objects[key]
        obj.data = b"\x00" * len(obj.data)  # rot the LOCAL replica
        ht_tier.kill_host(1)  # drop to k-1 so the repair pass runs
        summary = hottier.repair_tick()
        assert summary["objects_repaired"] == 1
        assert summary["underreplicated_objects"] == 0
        live = ht_tier.live_replicas(key)
        assert len(live) == 3 and 1 not in live
        target = _target()
        snap.restore(target)
        _assert_restored(target, 6.0)
        hottier.drain_now()


# ----------------------------------------- escalation & the critical rule


def test_total_replica_loss_escalates_to_loss_verdict(
    _fresh_mend, monkeypatch
):
    """An object with ZERO surviving replicas is the worst state —
    unrecoverable committed bytes — and must not be the one state the
    repair pass silently skips: pre-deadline it counts a failed repair
    per tick, past the deadline it escalates (so the critical rule can
    fire), and after the cross-tick phantom-loss debounce the drain's
    loss verdict is made official (pending retired, drain_lost
    counted) instead of pinning an under-replicated object forever."""
    monkeypatch.setenv("TPUSNAPSHOT_REPAIR_DEADLINE_S", "0.05")
    _local_peer(_fresh_mend, 1)
    path = "memory://mend-allgone/run/step_0"
    with hottier.hot_tier(
        rank=0, world=2, k=2, drain="manual", repair="manual"
    ):
        Snapshot.take(path, _state(4.0))
        key = path + "/0/s/w"
        assert ht_tier.live_replicas(key) == [0, 1]
        ht_tier.kill_host(0)
        ht_tier.kill_host(1)
        assert ht_tier.live_replicas(key) == []
        first = hottier.repair_tick()  # arms the clock; no source
        assert first["underreplicated_objects"] == 1
        assert first["repairs_failed"] == 1
        time.sleep(0.25)  # past the interval AND the deadline
        deferred = hottier.repair_tick()
        # A deferral is an escalation ATTEMPT, not a write-through:
        # nothing durable ran, so the executed count must stay 0.
        assert deferred["escalation_attempts"] == 1
        assert deferred["escalated_write_throughs"] == 0
        assert deferred["underreplicated_objects"] == 1
        # While the verdict is pending, the live rule goes critical.
        sev = {
            f.rule: f.severity
            for f in slo_mod.evaluate_live(
                [{"hot_tier": hottier.introspect()}]
            )
            if f.rule == "replication-underreplicated"
        }
        assert sev == {"replication-underreplicated": "critical"}
        hottier.repair_tick()  # second consecutive no-source tick
        lost0 = hottier.runtime().stats_snapshot()["drain_lost"]
        final = hottier.repair_tick()  # third: the verdict is official
        assert final["underreplicated_objects"] == 0
        assert (
            hottier.runtime().stats_snapshot()["drain_lost"] == lost0 + 1
        )
        hottier.reset_pending()


class _StubChurnPeer:
    """A duck-typed 'spawned' wire peer for churn bookkeeping tests."""

    def __init__(self) -> None:
        self.generation = 0
        self.alive = True
        self.process = object()  # non-None: restartable/spawned
        self.killed = False

    def condemn(self) -> None:
        self.alive = False

    def kill(self) -> None:
        self.killed = True
        self.alive = False

    def close(self) -> None:
        pass


def test_condemned_peer_handles_bounded_under_churn(_fresh_mend):
    """Continuous hung-peer churn must not accumulate condemned
    subprocess handles (each a hung process pinning its replica RAM)
    for the life of the run: beyond _MAX_CONDEMNED the oldest are
    reaped eagerly, the newest kept unsignalled for close()."""
    cap = ht_repair._MAX_CONDEMNED
    with hottier.hot_tier(
        rank=0, world=2, k=2, drain="manual", repair="manual"
    ):
        plane = hottier.repair_plane()
        stubs = []
        for i in range(30, 30 + cap + 4):
            stub = _StubChurnPeer()
            ht_tier.register_remote_host(i, stub)
            view = ht_repair._HostView(i, stub)
            plane._declare_lost(i, stub, view, reason="test churn")
            stubs.append(stub)
        with plane._lock:
            assert len(plane._condemned) == cap
        assert [s.killed for s in stubs] == [True] * 4 + [False] * cap


def test_respawn_host_idempotent_returns_live_replacement(_fresh_mend):
    """Two racing respawns of one lost host (faultline flap revival vs
    the background plane's _restart) must produce ONE replacement: the
    second caller gets the first's live peer back instead of spawning
    a second subprocess whose handle would leak untracked."""
    _proc, _addr, _peer = spawn_peer(host_id=1, capacity_bytes=1 << 26)
    ht_tier.kill_host(1)
    first = ht_repair.respawn_host(1)
    assert first is not None and first.generation == 1
    again = ht_repair.respawn_host(1)  # the "racing" second caller
    assert again is first  # no second spawn, no generation bump
    assert ht_tier.host_generation(1) == 1
    first.kill()


def test_condemn_only_if_spares_midtick_replacement(_fresh_mend):
    """A replacement registered over a host id after the supervisor
    judged its predecessor must NOT be condemned on the stale verdict:
    the only_if identity pin makes the condemn a no-op for the fresh
    peer."""
    judged = _StubChurnPeer()
    ht_tier.register_remote_host(7, judged)
    replacement = _StubChurnPeer()
    replacement.generation = 1
    ht_tier.register_remote_host(7, replacement)  # took the id over
    ht_tier.condemn_host(7, only_if=judged)  # stale verdict lands late
    assert replacement.alive  # the fresh peer was spared
    ht_tier.condemn_host(7, only_if=replacement)  # a CURRENT verdict...
    assert not replacement.alive  # ...still condemns


def test_condemn_host_spares_replacement_shadow_entries(_fresh_mend):
    """The narrower race: the only_if identity check passes, and the
    replacement registers (and receives a replica) while the judged
    predecessor is being condemned OUTSIDE the tier lock. The final
    shadow clear must re-check the registered identity — wiping the
    host's shadow then would erase the REPLACEMENT's replica credit
    (live_replicas stops counting a replica that really exists)."""
    root = "memory://mend-shadow-race/run/step_0"
    key = root + "/0/s/w"
    data = b"fresh replica bytes" * 8
    tag = ht_tier.payload_tag(data)
    judged = _StubChurnPeer()
    ht_tier.register_remote_host(7, judged)

    def _condemn_then_get_replaced():
        judged.alive = False
        # A respawn takes the id over and receives a fresh replica
        # before the condemner reacquires the tier lock.
        _local_peer(_fresh_mend, 7)
        assert ht_tier.put_replica(key, 7, data, tag, root)

    judged.condemn = _condemn_then_get_replaced
    ht_tier.condemn_host(7, only_if=judged)
    assert ht_tier.live_replicas(key, tag) == [7]


def test_probe_adopts_newer_server_generation(_fresh_mend):
    """A client rebuilt from the generation-less address book /
    port-file (generation 0) must ADOPT a respawned server's higher
    generation on first contact — the stale side is the client's view,
    not the server — while a LOWER server generation (the SIGCONT'd
    stale predecessor) stays refused."""
    server, _ = start_local_peer(5, register=False, generation=2)
    _fresh_mend.append(server)
    rebuilt = transport.RemotePeer(5, server.addr, generation=0)
    ht_tier.register_remote_host(5, rebuilt)
    assert rebuilt.probe() is True
    assert rebuilt.generation == 2  # adopted, not refused
    assert ht_tier.host_generation(5) == 2  # membership view synced
    # The gate still refuses the other direction: a server BELOW the
    # client's generation is a stale predecessor.
    stale_view = transport.RemotePeer(5, server.addr, generation=3)
    assert stale_view.probe() is False
    stale_view.close()


def test_supervise_prunes_unregistered_host_views(_fresh_mend):
    """A host that was UNREGISTERED (not condemned — condemned hosts
    stay registered by design) must leave the membership view: a stale
    _HostView would report a nonexistent host forever and feed
    _restart an unrespawnable candidate every tick."""
    _local_peer(_fresh_mend, 1)
    _local_peer(_fresh_mend, 2)
    with hottier.hot_tier(
        rank=0, world=3, k=2, drain="manual", repair="manual"
    ):
        hottier.repair_tick()
        member_ids = set(hottier.introspect()["repair"]["membership"])
        assert {"1", "2"} <= member_ids
        ht_tier.unregister_remote_host(2)
        hottier.repair_tick()
        member_ids = set(hottier.introspect()["repair"]["membership"])
        assert "2" not in member_ids
        assert "1" in member_ids


def test_condemned_peer_kill_still_reaps_subprocess(_fresh_mend):
    """condemn() latches the peer dead WITHOUT signalling; a later
    kill() — the condemned-cap reap, RepairPlane.close(), or
    reset_hot_tier — must still SIGKILL the subprocess. An early
    return on the shared latch would leave every condemned hung peer
    alive past every reap, pinning its replica RAM for the run."""
    proc, _addr, peer = spawn_peer(host_id=1, capacity_bytes=1 << 26)
    proc.send_signal(signal.SIGSTOP)  # hung, not dead
    ht_tier.condemn_host(1)
    assert proc.poll() is None  # condemn never signals...
    peer.kill()  # ...but the reap still must
    assert proc.wait(timeout=10) == -9


def test_deadline_escalation_write_through_and_critical_rule(
    _fresh_mend, monkeypatch, tmp_path
):
    """Past TPUSNAPSHOT_REPAIR_DEADLINE_S with no spare host, the
    repair deterministically escalates to the synchronous durable
    write-through. While the escalation is stalled (durable backend
    faulted), replication-underreplicated fires CRITICAL and the ops
    CLI exits 1; once the escalation lands, the object is durable, the
    gauge returns to 0, and the finding clears."""
    monkeypatch.setenv("TPUSNAPSHOT_REPAIR_DEADLINE_S", "0.05")
    _local_peer(_fresh_mend, 1)
    path = "memory://mend-esc/run/step_0"
    esc0 = telemetry.counter(m.HOT_TIER_REPAIR_ESCALATIONS).value
    with hottier.hot_tier(
        rank=0, world=2, k=2, drain="manual", repair="manual"
    ):
        Snapshot.take(path, _state(8.0))
        ht_tier.kill_host(1)  # world=2: no spare — k is unreachable
        first = hottier.repair_tick()  # observes under-k: clock arms
        assert first["underreplicated_objects"] == 1
        assert first["escalated_write_throughs"] == 0
        time.sleep(0.3)  # age past the interval AND the deadline
        # Stall the escalation: the durable write faults permanently.
        sched = fl.FaultSchedule().permanent(op="write", path="0/s/w")
        with fl.inject(sched):
            stalled = hottier.repair_tick()
        assert stalled["escalated_write_throughs"] == 1
        assert stalled["underreplicated_objects"] == 1
        assert telemetry.counter(
            m.HOT_TIER_REPAIR_ESCALATIONS
        ).value == esc0 + 1
        # The live rule sees the stall as critical...
        sample = {"hot_tier": hottier.introspect()}
        findings = slo_mod.evaluate_live([sample])
        crit = {
            f.rule: f.severity
            for f in findings
            if f.rule == "replication-underreplicated"
        }
        assert crit == {"replication-underreplicated": "critical"}
        # ...and drives the ops CLI's exit-code contract. (An empty
        # dir is a valid statusfile root; the live in-process runtime
        # is folded in.)
        live_dir = str(tmp_path / "liveops")
        os.makedirs(live_dir, exist_ok=True)
        state = ops_cli.collect(live_dir)
        ops_findings = ops_cli.findings_of(state)
        assert any(
            f.rule == "replication-underreplicated"
            and f.severity == "critical"
            for f in ops_findings
        )
        rendered = ops_cli.render(state, stale_after_s=60.0)
        assert "repair[manual]:" in rendered
        assert "membership:" in rendered and "(LOST)" in rendered
        assert ops_cli.main([live_dir]) == 1
        # Un-stall: the next escalation retires the obligation.
        healed = hottier.repair_tick()
        assert healed["escalated_write_throughs"] == 1
        assert healed["underreplicated_objects"] == 0
        assert (
            telemetry.gauge(m.HOT_TIER_UNDERREPLICATED_BYTES).value == 0.0
        )
        after = slo_mod.evaluate_live([{"hot_tier": hottier.introspect()}])
        assert not any(
            f.rule == "replication-underreplicated" for f in after
        )
        hottier.drain_now()
    # The escalated object is durable: restorable with the tier off.
    hottier.reset_hot_tier()
    target = _target()
    Snapshot(path).restore(target)
    _assert_restored(target, 8.0)


# ------------------------------------------------- down-cooldown re-probe


def test_repair_tick_reprobes_peer_out_of_down_cooldown(
    _fresh_mend, monkeypatch
):
    """satellite: a peer latched down by the cooldown used to rejoin
    only when a foreground push tripped over it; the repair tick's
    background re-probe clears the latch within one tick."""
    monkeypatch.setenv("TPUSNAPSHOT_REPLICATION_RETRY_BUDGET_S", "0.5")
    monkeypatch.setenv("TPUSNAPSHOT_REPLICATION_DOWN_COOLDOWN_S", "60")
    peer = _local_peer(_fresh_mend, 1)
    root = "memory://mend-cooldown/run/step_0"
    data = b"c" * 4096
    with hottier.hot_tier(
        rank=0, world=2, k=2, drain="manual", repair="manual"
    ):
        # Exhaust one push's retry budget with scripted drops: the
        # peer latches into its 60s down cooldown.
        for _ in range(64):
            transport.script_wire_fault("drop_conn", host=1)
        with pytest.raises(ht_tier.HostLostError):
            ht_tier.put_replica(
                root + "/a", 1, data, ht_tier.payload_tag(data), root
            )
        transport.clear_wire_faults()
        assert peer.in_cooldown  # healthy peer, latched out anyway
        with pytest.raises(ht_tier.HostLostError):
            ht_tier.put_replica(
                root + "/a", 1, data, ht_tier.payload_tag(data), root
            )
        summary = hottier.repair_tick()  # background re-probe
        assert not peer.in_cooldown
        assert summary["hosts_lost"] == []
        assert ht_tier.put_replica(
            root + "/a", 1, data, ht_tier.payload_tag(data), root
        )
        plane = hottier.repair_plane()
        assert plane.introspect()["stats"]["reprobes"] >= 1
        ht_tier.forget_key(root + "/a")


# ------------------------------------------------------------- introspect


def test_introspect_membership_and_degraded_read_nudge(_fresh_mend):
    """The sampler-facing repair block: per-host generation + liveness
    membership rows, under-replication accounting, and the
    degraded-read nudge wiring (request_scan reaches the plane)."""
    _local_peer(_fresh_mend, 1)
    path = "memory://mend-intro/run/step_0"
    with hottier.hot_tier(
        rank=0, world=2, k=2, drain="manual", repair="manual"
    ):
        Snapshot.take(path, _state(2.0))
        hottier.repair_tick()
        doc = hottier.introspect()
        repair = doc["repair"]
        assert repair["mode"] == "manual"
        assert repair["underreplicated_objects"] == 0
        row = repair["membership"]["1"]
        assert row["alive"] and row["generation"] == 0
        assert row["current_generation"] == 0
        assert repair["stats"]["hosts_lost"] == 0
        rt = hottier.runtime()
        rt.request_repair_scan()  # no-op wiring must not throw
        hottier.drain_now()
    # With repair off, the block is absent (None), not fabricated.
    with hottier.hot_tier(rank=0, world=1, k=1, drain="manual"):
        assert hottier.introspect()["repair"] is None


# ------------------------------------------------ across the two packages


def _loss_and_repair(pkg_tier, tier_mod, snap_cls, state, target, path, servers, start):
    """k=3 over three wire peers and the local host; host 1 lost; one
    manual repair tick; then both original survivors lost, so the
    restore reads the repaired replica."""
    for h in (1, 2, 3):
        server, _ = start(h, capacity_bytes=1 << 26)
        servers.append(server)
    with pkg_tier.hot_tier(rank=0, world=4, k=3, drain="manual", repair="manual"):
        snap = snap_cls.take(path, state)
        tier_mod.kill_host(1)
        summary = pkg_tier.repair_tick()
        key = path + "/0/s/w"
        placed = tier_mod.live_replicas(key)
        tier_mod.kill_host(0)
        tier_mod.kill_host(2)
        snap.restore(target)
        pkg_tier.drain_now()
    return summary, placed


def test_repair_matches_jax(_fresh_mend, tmp_path):
    """The same loss and repair tick in both packages on the same seeded
    values: the same tick summary, the replica placed on the same spare
    host, the same ledger ``repair`` record fields, and bit-exact
    restores served by the repaired replica."""
    w = np.random.default_rng(31).standard_normal(2048).astype(np.float32)
    port_target = {"s": StateDict(w=torch.zeros(2048))}
    port = _loss_and_repair(
        hottier, ht_tier, Snapshot, {"s": StateDict(w=torch.from_numpy(w.copy()))},
        port_target, str(tmp_path / "port"), _fresh_mend, start_local_peer,
    )
    jax_target = {"s": jsnap.StateDict(w=jnp.zeros(2048, jnp.float32))}
    jax_side = _loss_and_repair(
        jhottier, jht_tier, jsnap.Snapshot, {"s": jsnap.StateDict(w=jnp.asarray(w))},
        jax_target, str(tmp_path / "jax"), _fresh_mend, jpeer.start_local_peer,
    )

    def comparable(summary):
        return {k: v for k, v in summary.items() if not k.endswith("_s")}

    assert comparable(port[0]) == comparable(jax_side[0])
    assert port[1] == jax_side[1] == [0, 2, 3]
    assert np.asarray(port_target["s"]["w"]).tobytes() == w.tobytes()
    assert np.asarray(jax_target["s"]["w"]).tobytes() == w.tobytes()

    def repair_record(read, path):
        records, _ = read(path)
        rec = [r for r in records if r.get("kind") == "repair"][-1]
        return {k: v for k, v in rec.items()
                if k not in ("t", "ts", "wall_t", "path", "time", "unix_time", "seconds")
                and not k.endswith("_s")}

    assert repair_record(runledger.read_records, str(tmp_path / "port")) == repair_record(
        jrunledger.read_records, str(tmp_path / "jax")
    )


def test_port_repair_lands_on_a_jax_peer(_fresh_mend):
    """The port's repair plane re-replicates a lost replica onto a JAX
    peer server (the spare host), which fingerprint-verifies and holds
    the exact bytes; a restore served by it is bit-exact."""
    w = np.random.default_rng(32).standard_normal(2048).astype(np.float32)
    server, _ = start_local_peer(1, capacity_bytes=1 << 26, register=True)
    _fresh_mend.append(server)
    jserver, _ = jpeer.start_local_peer(2, capacity_bytes=1 << 26, register=False)
    _fresh_mend.append(jserver)
    transport.connect_peer(2, jserver.addr, capacity_bytes=1 << 26)
    path = "memory://mend-cross/run/step_0"
    with hottier.hot_tier(rank=0, world=3, k=2, drain="manual", repair="manual"):
        snap = Snapshot.take(path, {"s": StateDict(w=torch.from_numpy(w.copy()))})
        key = path + "/0/s/w"
        assert ht_tier.live_replicas(key) == [0, 1]
        ht_tier.kill_host(1)
        summary = hottier.repair_tick()
        assert summary["objects_repaired"] == 1
        assert ht_tier.live_replicas(key) == [0, 2]
        assert jht_tier.get_replica(key, 2).data == w.tobytes()
        ht_tier.kill_host(0)
        target = {"s": StateDict(w=torch.zeros(2048))}
        snap.restore(target)
        assert hottier.runtime().stats_snapshot()["fallback_objects"] == 0
        hottier.drain_now()
    assert np.asarray(target["s"]["w"]).tobytes() == w.tobytes()
