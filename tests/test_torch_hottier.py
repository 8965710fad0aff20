"""The port's hot tier (snaptier) against the JAX package's:
replication, tier-down, degraded restore, and the host-loss × crash-point
fault matrix; the tests of ``tests/test_hottier.py`` on the port, on
CPU tensors.

Fast tier (``-m faultline``, runs in tier-1): ack-before-drain
semantics, the k-1 host-loss bit-exact e2e acceptance, per-object
durable fallback (dead / corrupt replicas) with the
``hot-tier-degraded`` doctor rule and the ledger ``tier`` field,
capacity/eviction invariants, reconcile's keep-committed-undrained
proof, and a stride-sampled crash matrix over the tiered
save→commit→tier-down pipeline. The full per-op crash enumeration and
the host-loss x crash-point product are also marked ``slow``.

Added here, each on the same seeded numpy values in both packages: a
snapshot taken through either package's tier and drained restores
bit-exact through the other; an async tiered take, its drain and a
restore emit the same storage-op stream in both; the watermark and the
flight report's ``tier`` block agree; and the doctor's
``hot-tier-degraded`` and ``replication-degraded`` findings from a port
report equal those from a JAX report of the same scenario.
"""

import json
import threading
import time
import uuid

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import torchsnapshot_tpu as jsnap
from torchsnapshot_tpu import faultline as jfl
from torchsnapshot_tpu import hottier as jhottier
from torchsnapshot_tpu.hottier import transport as jtransport
from torchsnapshot_tpu.telemetry.doctor import diagnose_report as jax_diagnose_report
from torchsnapshot_tpu_torch import CheckpointManager, Snapshot, StateDict, hottier
from torchsnapshot_tpu_torch import faultline as fl
from torchsnapshot_tpu_torch.hottier import tier as ht_tier
from torchsnapshot_tpu_torch.hottier import transport
from torchsnapshot_tpu_torch.hottier.peer import start_local_peer
from torchsnapshot_tpu_torch.io_types import IOReq
from torchsnapshot_tpu_torch.manager import _step_dir
from torchsnapshot_tpu_torch.storage_plugin import url_to_storage_plugin
from torchsnapshot_tpu_torch.telemetry import ledger as runledger
from torchsnapshot_tpu_torch.telemetry.doctor import diagnose_report

pytestmark = pytest.mark.faultline


# ----------------------------------------------------------------- helpers


@pytest.fixture(autouse=True)
def _fresh_tier():
    """Every test starts and ends with an empty hot tier and no runtime
    in either package (a leaked enable would silently re-route every
    other test's IO)."""
    for mod in (hottier, jhottier):
        mod.disable_hot_tier(flush=False)
        mod.reset_hot_tier()
    yield
    for mod in (hottier, jhottier):
        mod.disable_hot_tier(flush=False)
        mod.reset_hot_tier()
    # The wire tap is process-wide: a later test's live rules must not read
    # this one's RPCs.
    from torchsnapshot_tpu import wiretap as jwiretap
    from torchsnapshot_tpu_torch import wiretap

    wiretap.reset()
    jwiretap.reset()


def _state(v, n=1024):
    return {"s": StateDict(w=torch.full((n,), float(v)))}


def _target(n=1024):
    return {"s": StateDict(w=torch.zeros((n,)))}


def _assert_restored(target, v):
    np.testing.assert_array_equal(np.asarray(target["s"]["w"]), float(v))


def _mem_base(tag):
    return f"memory://hottier-{tag}-{uuid.uuid4().hex[:10]}/run"


def _durable_objects(url):
    storage = url_to_storage_plugin(url)
    try:
        import asyncio

        return sorted(asyncio.run(storage.list_prefix("")) or [])
    finally:
        storage.close()


def _payload_objects(url):
    return [o for o in _durable_objects(url) if hottier.is_payload_path(o)]


def _read_bytes(url, path):
    import asyncio

    from torchsnapshot_tpu_torch.io_types import io_payload

    storage = url_to_storage_plugin(url)
    try:
        io_req = IOReq(path=path)
        asyncio.run(storage.read(io_req))
        return bytes(io_payload(io_req))
    finally:
        storage.close()


def _read_json(url, path):
    return json.loads(_read_bytes(url, path).decode("utf-8"))


# ------------------------------------------------- ack / drain / watermark


def test_ack_before_drain_and_tierdown_watermark(tmp_path):
    """The take commits with payloads k-replicated in peer RAM only;
    tier-down persists them in the background and records the
    ``.tierdown`` watermark; after a full drain the snapshot restores
    from the durable tier alone."""
    root = str(tmp_path / "step-0")
    with hottier.hot_tier(rank=0, world=4, k=2, drain="manual"):
        snap = Snapshot.take(root, _state(7))
        # Committed (metadata durable) but payloads are hot-tier-only.
        objs = _durable_objects(root)
        assert ".snapshot_metadata" in objs
        assert not _payload_objects(root)
        assert ".tierdown" not in objs
        # Restorable RIGHT NOW, from peer RAM.
        target = _target()
        snap.restore({"s": target["s"]})
        _assert_restored(target, 7)
        # Tier-down: payloads land durable, watermark follows.
        hottier.drain_now()
        assert _payload_objects(root)
        watermark = _read_json(root, ".tierdown")
        assert watermark["format_version"] == 1
        assert watermark["drained_objects"] >= 1
    # Tier disabled (RAM gone): the durable tier alone must suffice.
    hottier.reset_hot_tier()
    target = _target()
    Snapshot(root).restore({"s": target["s"]})
    _assert_restored(target, 7)


def test_verify_clean_while_hot_only(tmp_path):
    """Snapshot.verify() sees through the tier: a committed-but-undrained
    snapshot scrubs clean (bytes exist in >= 1 tier, which is the tiered
    integrity contract)."""
    root = str(tmp_path / "step-0")
    with hottier.hot_tier(rank=0, world=2, k=2, drain="manual"):
        snap = Snapshot.take(root, _state(3))
        assert not _payload_objects(root)
        assert snap.verify() == {}


# ------------------------------------------------------ host-loss restores


@pytest.mark.parametrize("lost_host", [0, 1])
def test_k1_host_loss_restores_bit_exact(lost_host):
    """E2E acceptance: with k=2 and payloads living ONLY in peer RAM
    (nothing drained), losing any k-1=1 host still restores bit-exact
    from the surviving replicas."""
    base = _mem_base("k1loss")
    root = f"{base}/step-0"
    rng = np.random.default_rng(42)
    payload = rng.standard_normal(4096).astype(np.float32)
    with hottier.hot_tier(rank=0, world=4, k=2, drain="manual"):
        snap = Snapshot.take(root, {"s": StateDict(w=torch.from_numpy(payload))})
        assert not _payload_objects(root)  # hot-tier-only on purpose
        hottier.kill_host(lost_host)
        target = {"s": StateDict(w=torch.zeros((4096,), dtype=torch.float32))}
        snap.restore(target)
        np.testing.assert_array_equal(
            np.asarray(target["s"]["w"]), payload
        )
        stats = hottier.runtime().stats_snapshot()
        assert stats["fallback_objects"] == 0  # never touched durable


def test_all_replicas_lost_falls_back_and_fires_doctor():
    """Losing ALL replica hosts after tier-down degrades to per-object
    durable reads; the restore stays bit-exact, the flight report's
    ``tier`` block names the dead peers, the ``hot-tier-degraded``
    doctor rule fires critical (100% of bytes fell back), and the
    ledger record carries the ``tier`` field."""
    base = _mem_base("alllost")
    root = f"{base}/step-0"
    with hottier.hot_tier(rank=0, world=2, k=2, drain="manual"):
        snap = Snapshot.take(root, _state(9))
        hottier.drain_now()  # durable copy exists; replicas evictable
        hottier.kill_host(0)
        hottier.kill_host(1)
        target = _target()
        snap.restore({"s": target["s"]})
        _assert_restored(target, 9)
        report = _read_json(root, ".report.restore.json")
        tier_blocks = [
            s.get("tier") for s in report["ranks"] if s and s.get("tier")
        ]
        assert tier_blocks, report["ranks"]
        assert tier_blocks[0]["fallback_objects"] >= 1
        assert tier_blocks[0]["hot_objects"] == 0
        assert sorted(tier_blocks[0]["degraded_peers"]) == [0, 1]
        findings = {f.rule: f for f in diagnose_report(report)}
        assert "hot-tier-degraded" in findings
        finding = findings["hot-tier-degraded"]
        assert finding.severity == "critical"
        assert finding.evidence["degraded_peers"] == "peer hosts 0-1"
        assert finding.evidence["reasons"].get("dead", 0) >= 1
        # Ledger: the restore record carries the tier attribution.
        records, _ = runledger.read_records(root)
        restores = [r for r in records if r["kind"] == "restore"]
        assert restores and restores[-1]["tier"]["fallback_objects"] >= 1
        assert restores[-1]["tier"]["degraded_peers"] == [0, 1]


def test_corrupt_replica_falls_back_per_object():
    """A replica that fails its fingerprint check is dropped and the
    read falls over — to the durable tier here (k=1), bit-exact."""
    base = _mem_base("corrupt")
    root = f"{base}/step-0"
    with hottier.hot_tier(rank=0, world=1, k=1, drain="manual"):
        snap = Snapshot.take(root, _state(5))
        hottier.drain_now()
        # Flip one byte of the single replica in host 0's RAM.
        with ht_tier._TIER_LOCK:
            store = ht_tier._HOSTS[0]
            key = next(iter(store.objects))
            obj = store.objects[key]
            obj.data = obj.data[:-1] + bytes([obj.data[-1] ^ 0xFF])
        target = _target()
        snap.restore({"s": target["s"]})
        _assert_restored(target, 5)
        stats = hottier.runtime().stats_snapshot()
        assert stats["reasons"].get("corrupt", 0) >= 1
        assert stats["fallback_objects"] >= 1
        # The corrupt replica was dropped — nothing can read it again.
        assert ht_tier.total_buffered_bytes() < 4096


def test_lose_host_schedule_is_deterministic():
    """faultline's host-loss schedule kills a peer at a fixed op
    boundary: the take completes, the host is dead afterwards, and the
    injection log records the hostloss."""
    base = _mem_base("sched")
    root = f"{base}/step-0"
    sched = fl.FaultSchedule().lose_host(
        1, op="write", path=".snapshot_metadata"
    )
    with fl.inject(sched) as ctl:
        with hottier.hot_tier(rank=0, world=2, k=2, drain="manual"):
            snap = Snapshot.take(root, _state(4))
            assert 1 not in hottier.live_hosts()
            assert ctl.fault_counts().get("hostloss") == 1
            # Host 0's replica still serves the restore.
            target = _target()
            snap.restore({"s": target["s"]})
            _assert_restored(target, 4)


# --------------------------------------------------- capacity and eviction


def test_undrained_never_evicted_capacity_degrades_to_write_through():
    """An undrained object is the only copy outside its replica set:
    capacity pressure must refuse the put (degrading the write to a
    synchronous durable write-through), never evict undrained bytes."""
    base = _mem_base("cap")
    root = f"{base}/step-0"
    # Room for roughly one 4 KiB payload per host.
    with hottier.hot_tier(
        rank=0, world=1, k=1, capacity_bytes=6000, drain="manual"
    ):
        snap = Snapshot.take(
            root,
            {
                "a": StateDict(w=torch.full((1024,), 1.0)),
                "b": StateDict(w=torch.full((1024,), 2.0)),
            },
        )
        stats = hottier.runtime().stats_snapshot()
        # One payload went hot, the other was refused and wrote through.
        assert stats["write_through"] >= 1
        assert ht_tier.total_buffered_bytes() <= 6000
        # Everything still restores (mixed hot + durable).
        target = {
            "a": StateDict(w=torch.zeros((1024,))),
            "b": StateDict(w=torch.zeros((1024,))),
        }
        snap.restore(target)
        got = {
            float(np.asarray(target["a"]["w"])[0]),
            float(np.asarray(target["b"]["w"])[0]),
        }
        assert got == {1.0, 2.0}
        # After tier-down the buffered object is drained and EVICTABLE:
        # the next put may displace it.
        hottier.drain_now()
        rt = hottier.runtime()
        placed, _tag = rt.hot_put(root, "0/extra/blob", b"x" * 4096)
        assert placed == 1
        assert ht_tier.total_buffered_bytes() <= 6000


def test_k_env_knob(monkeypatch):
    monkeypatch.setenv(hottier.K_ENV_VAR, "3")
    with hottier.hot_tier(rank=0, world=8, drain="manual") as rt:
        assert rt.k == 3
        assert rt.replica_hosts() == [0, 1, 2]
    monkeypatch.setenv(hottier.K_ENV_VAR, "99")
    with hottier.hot_tier(rank=5, world=4, drain="manual") as rt:
        assert rt.k == 4  # clamped to world
        assert rt.replica_hosts() == [5 % 4, 2, 3, 0]


# ------------------------------------------------- delete / reconcile GC


def test_delete_cancels_pending_drain_and_drops_buffers(tmp_path):
    """Deleting a committed-but-undrained snapshot cancels its pending
    tier-down (a background drain must not resurrect deleted objects)
    and drops its replicas; the ``.tierdown`` watermark goes with a
    drained snapshot."""
    root_a = str(tmp_path / "step-0")
    root_b = str(tmp_path / "step-1")
    with hottier.hot_tier(rank=0, world=2, k=2, drain="manual"):
        snap_a = Snapshot.take(root_a, _state(1))
        assert hottier.buffered_roots()
        snap_a.delete()
        assert not hottier.buffered_roots()
        hottier.drain_now()  # nothing to resurrect
        assert not _payload_objects(root_a)
        # Drained snapshot: delete removes payloads AND the watermark.
        snap_b = Snapshot.take(root_b, _state(2))
        hottier.drain_now()
        assert ".tierdown" in _durable_objects(root_b)
        snap_b.delete()
        assert ".tierdown" not in _durable_objects(root_b)
        assert not hottier.buffered_roots()


def test_reconcile_keeps_committed_undrained_drops_aged_orphans(
    monkeypatch,
):
    """The reconcile sweep must never reclaim replicas a committed-but-
    not-yet-drained take still needs (they are the only copy of its
    payload bytes), while an uncommitted crashed take's buffers — which
    nothing can ever resolve — are reclaimed once aged."""
    monkeypatch.setenv("TPUSNAPSHOT_SWEEP_MIN_AGE_S", "0")
    base = _mem_base("reconcile")
    with hottier.hot_tier(rank=0, world=2, k=2, drain="manual"):
        mgr = CheckpointManager(base)
        mgr.save(0, _state(0))  # committed, NOT drained
        committed_root = _step_dir(base, 0)
        # Fake an uncommitted crashed take: hot buffers, no metadata.
        rt = hottier.runtime()
        orphan_root = _step_dir(base, 99)
        rt.hot_put(orphan_root, "0/s/w", b"y" * 512)
        rt.enqueue_drain(orphan_root, "0/s/w")
        assert set(hottier.buffered_roots()) == {
            committed_root,
            orphan_root,
        }
        mgr.reconcile(adopt=True)
        # Orphan reclaimed (age guard disabled), committed kept.
        assert set(hottier.buffered_roots()) == {committed_root}
        # ... and the committed step still restores from the hot tier.
        target = _target()
        assert mgr.restore({"s": target["s"]}, step=0) == 0
        _assert_restored(target, 0)
        # With the age guard ON, even an uncommitted orphan is spared
        # (it may be an in-flight take).
        rt.hot_put(orphan_root, "0/s/w", b"y" * 512)
        monkeypatch.setenv("TPUSNAPSHOT_SWEEP_MIN_AGE_S", "3600")
        mgr.reconcile(adopt=True)
        assert orphan_root in hottier.buffered_roots()


def test_drain_exhaustion_strands_then_redrives(monkeypatch):
    """A durable outage outlasting the drain attempts leaves the object
    STRANDED: wait_drained() must report the flush dirty (the hot copy
    is the only copy — claiming success would let a caller tear the
    tier down over it), and the next drain_now() re-drives it to a
    clean tier-down."""
    monkeypatch.setenv("TPUSNAPSHOT_STORAGE_RETRIES", "0")
    base = _mem_base("strand")
    root = f"{base}/step-0"
    with hottier.hot_tier(rank=0, world=2, k=2, drain="manual"):
        # nth=2: the 1st match is the take's logical write (which the
        # tier absorbs into RAM); every durable drain write after it
        # fails permanently.
        sched = fl.FaultSchedule().permanent(op="write", path="0/s/w", nth=2)
        with fl.inject(sched):
            snap = Snapshot.take(root, _state(8))
            hottier.drain_now()  # attempts exhaust; object stranded
            assert not hottier.wait_drained(timeout_s=1.0)
            assert not _payload_objects(root)
            # The snapshot is still fully restorable from the hot tier.
            target = _target()
            snap.restore({"s": target["s"]})
            _assert_restored(target, 8)
        # Outage over (faults uninstalled): re-drive to a clean flush.
        hottier.drain_now()
        assert hottier.wait_drained(timeout_s=5.0)
        assert _payload_objects(root)
        assert ".tierdown" in _durable_objects(root)


def test_tierdown_write_failure_is_redriven(monkeypatch):
    """A failed ``.tierdown`` watermark write must leave a re-drive
    trigger even though the root is fully drained (no object item will
    ever call back into the watermark path)."""
    monkeypatch.setenv("TPUSNAPSHOT_STORAGE_RETRIES", "0")
    base = _mem_base("tdfail")
    root = f"{base}/step-0"
    with hottier.hot_tier(rank=0, world=2, k=2, drain="manual"):
        sched = fl.FaultSchedule().permanent(op="write", path=".tierdown")
        with fl.inject(sched):
            Snapshot.take(root, _state(2))
            hottier.drain_now()
            assert _payload_objects(root)  # objects drained fine
            assert ".tierdown" not in _durable_objects(root)
            assert not hottier.wait_drained(timeout_s=1.0)
        hottier.drain_now()
        assert hottier.wait_drained(timeout_s=5.0)
        assert ".tierdown" in _durable_objects(root)


# --------------------------------------------------- crash/fault matrices


def _prepare_matrix(monkeypatch, drained_history=True):
    monkeypatch.setenv("TPUSNAPSHOT_SWEEP_MIN_AGE_S", "0")
    hottier.reset_hot_tier()
    hottier.reset_pending()
    base = _mem_base("crashmx")
    mgr = CheckpointManager(base, max_to_keep=1)
    mgr.save(0, _state(0))
    mgr.save(1, _state(1))
    if drained_history:
        hottier.drain_now()
    return base


def _faulted_matrix(base):
    # One full tiered lifecycle: take step 2 (replicate + ack + commit +
    # marker + prune), then tier-down (drain + watermark).
    CheckpointManager(base, max_to_keep=1).save(2, _state(2))
    hottier.drain_now()


def _probe(base):
    def probe(step):
        target = _target()
        got = CheckpointManager(base).restore(target, step=step)
        assert got == step
        _assert_restored(target, step)

    return probe


def _check_matrix(base, outcome):
    # (a)/(b): every marker-visible step restores clean (hot tier or
    # durable); reconcile adopts committed-unmarked work and reclaims
    # crashed debris — including hot-tier buffers.
    res = fl.check_recovery_invariant(base, _probe(base))
    outcome.marked_steps = res.marked_steps
    outcome.adopted_steps = res.adopted_steps
    # Recovery re-drive: a fresh save→drain cycle succeeds, re-drives
    # any interrupted tier-down, and leaves no leaked objects in EITHER
    # tier.
    mgr = CheckpointManager(base, max_to_keep=1, reconcile_on_init="adopt")
    mgr.save(3, _state(3))
    hottier.drain_now()
    mgr.reconcile(adopt=True)
    assert mgr.latest_step() == 3
    _probe(base)(3)
    fl.assert_reclaimed(base, [3])
    # Zero leaked hot-tier buffers: only the live step may stay hot.
    live_root = _step_dir(base, 3)
    assert set(hottier.buffered_roots()) <= {live_root}
    # The live step finished its tier-down: watermark present.
    assert ".tierdown" in _durable_objects(live_root)


def test_tiered_crash_matrix_fast_subset(monkeypatch):
    """Stride-sampled crash points across take→ack→commit→tier-down
    with the hot tier on (tier-1). Proves restore-or-detect plus
    leak-free reconcile at every sampled boundary — including the
    hottier.replicate / hottier.drain / hottier.tierdown boundaries the
    tier adds to the op stream."""
    with hottier.hot_tier(rank=0, world=2, k=2, drain="manual"):
        base = _prepare_matrix(monkeypatch)
        total = fl.count_storage_ops(lambda: _faulted_matrix(base))
        assert total > 0
        stride = max(1, total // 6)
        points = sorted(set(range(1, total + 1, stride)) | {1, total})
        report = fl.enumerate_crash_points(
            prepare=lambda: _prepare_matrix(monkeypatch),
            faulted=_faulted_matrix,
            check=_check_matrix,
            crash_points=points,
            total_ops=total,
        )
        assert set(report.outcomes) == set(points)
        assert any(o.crashed for o in report.outcomes.values())


@pytest.mark.slow
def test_tiered_crash_matrix_full(monkeypatch):
    """Full per-op crash enumeration over the tiered pipeline."""
    with hottier.hot_tier(rank=0, world=2, k=2, drain="manual"):
        report = fl.enumerate_crash_points(
            prepare=lambda: _prepare_matrix(monkeypatch),
            faulted=_faulted_matrix,
            check=_check_matrix,
        )
        assert report.total_ops > 0
        assert any(o.crashed for o in report.outcomes.values())


@pytest.mark.slow
@pytest.mark.parametrize("lost_host", [0, 1])
def test_host_loss_x_crash_point_enumeration(monkeypatch, lost_host):
    """The product matrix: at every sampled crash point, ALSO lose one
    peer host before recovery runs — any k-1 loss composed with any
    crash must still satisfy restore-or-detect with zero leaks."""

    def check(base, outcome):
        hottier.kill_host(lost_host)
        try:
            _check_matrix(base, outcome)
        finally:
            hottier.revive_host(lost_host)

    with hottier.hot_tier(rank=0, world=2, k=2, drain="manual"):
        base = _prepare_matrix(monkeypatch)
        total = fl.count_storage_ops(lambda: _faulted_matrix(base))
        points = sorted(
            set(range(1, total + 1, max(1, total // 12))) | {1, total}
        )
        report = fl.enumerate_crash_points(
            prepare=lambda: _prepare_matrix(monkeypatch),
            faulted=_faulted_matrix,
            check=check,
            crash_points=points,
            total_ops=total,
        )
        assert any(o.crashed for o in report.outcomes.values())


def test_mid_replication_host_loss_during_take(monkeypatch):
    """Partial-tier-down schedule: a peer dies WHILE the take is
    replicating (lose_host bound to a payload write boundary). The take
    must still commit (surviving replicas + write-through degradation)
    and restore bit-exact."""
    base = _mem_base("midloss")
    root = f"{base}/step-0"
    sched = fl.FaultSchedule().lose_host(1, op="hottier.replicate", nth=2)
    with fl.inject(sched):
        with hottier.hot_tier(rank=0, world=2, k=2, drain="manual"):
            snap = Snapshot.take(root, _state(6))
            target = _target()
            snap.restore({"s": target["s"]})
            _assert_restored(target, 6)
            hottier.drain_now()  # tier-down proceeds from survivors
            assert _payload_objects(root)
            assert ".tierdown" in _durable_objects(root)


# ----------------------------- degraded ack / delete-drain / stale-drain


def test_underreplicated_put_uses_spare_host():
    """A dead ring host must not silently halve the replication factor:
    placement continues to spare hosts outside the ring, so the take
    still acks at k RAM replicas without touching the durable tier."""
    base = _mem_base("spare")
    root = f"{base}/step-0"
    with hottier.hot_tier(rank=0, world=4, k=2, drain="manual"):
        hottier.kill_host(1)  # rank 0's ring is hosts {0, 1}
        snap = Snapshot.take(root, _state(11))
        assert not _payload_objects(root)  # ack'd from RAM alone
        stats = hottier.runtime().stats_snapshot()
        assert stats["write_through"] == 0
        assert stats["degraded_puts"] == 0
        # The k-1-loss invariant holds over the SUBSTITUTED replica
        # set: losing host 0 leaves the spare (host 2) serving reads.
        hottier.kill_host(0)
        target = _target()
        snap.restore({"s": target["s"]})
        _assert_restored(target, 11)
        assert hottier.runtime().stats_snapshot()["fallback_objects"] == 0


def test_underreplicated_put_writes_through_before_ack():
    """When k replicas cannot be placed anywhere (world=2, k=2, one
    host dead: no spares exist), the write must degrade to a
    synchronous durable write-through BEFORE the ack — an acked object
    never rests on a lone RAM copy, so losing the one surviving host
    afterwards cannot lose committed bytes."""
    base = _mem_base("degack")
    root = f"{base}/step-0"
    with hottier.hot_tier(rank=0, world=2, k=2, drain="manual"):
        hottier.kill_host(1)
        snap = Snapshot.take(root, _state(13))
        # Durable BEFORE any drain ran: the ack did not rely on RAM.
        assert _payload_objects(root)
        stats = hottier.runtime().stats_snapshot()
        assert stats["degraded_puts"] >= 1
        assert stats["write_through"] >= 1
        # Now lose the single surviving replica host too.
        hottier.kill_host(0)
        target = _target()
        snap.restore({"s": target["s"]})
        _assert_restored(target, 13)


def test_inflight_drain_cannot_resurrect_deleted_snapshot(tmp_path):
    """The delete/drain race, in-flight edition: an item already popped
    off the drain queue (the drainer holding the object bytes) when
    ``delete`` runs must not complete its durable write after the
    sweep — the drain re-checks the forgotten root around the write and
    skips (or undoes) it."""
    root = str(tmp_path / "step-0")
    with hottier.hot_tier(rank=0, world=2, k=2, drain="manual"):
        snap = Snapshot.take(root, _state(4))
        rt = hottier.runtime()
        with rt._cond:  # pop as the background drainer would
            item = rt._queue.popleft()
        snap.delete()  # cancels drains FIRST, then durable deletes
        rt._drain_item(*item)  # the "in-flight" drain now completes
        assert not _payload_objects(root)
        assert ".tierdown" not in _durable_objects(root)
        assert rt.stats_snapshot()["drain_lost"] == 0
        assert not hottier.buffered_roots()


def test_delete_waits_for_inflight_drain(tmp_path):
    """delete must not overtake a drain whose durable write is already
    in flight: forget_root condition-waits on the in-flight item, so
    the durable deletes run strictly after the write lands — and sweep
    it — leaving nothing resurrected."""
    root = str(tmp_path / "step-0")
    # nth=2: the take's logical write is match 1 (absorbed into RAM);
    # the drain's durable write is match 2 and gets the latency.
    sched = fl.FaultSchedule().latency(
        op="write", path="0/s/w", seconds=0.6, nth=2
    )
    with fl.inject(sched):
        with hottier.hot_tier(rank=0, world=2, k=2, drain="manual"):
            snap = Snapshot.take(root, _state(6))
            rt = hottier.runtime()
            drainer = threading.Thread(target=rt.drain_now)
            drainer.start()
            deadline = time.monotonic() + 5.0
            while not rt._inflight_items and time.monotonic() < deadline:
                time.sleep(0.01)
            assert rt._inflight_items  # the slowed write is in flight
            snap.delete()  # must wait the write out, then remove it
            drainer.join(timeout=10.0)
            assert not drainer.is_alive()
            assert not _payload_objects(root)
            assert not hottier.buffered_roots()


def test_rewrite_while_drain_queued_drains_latest_bytes():
    """Re-writing an object whose drain is still QUEUED replaces the
    queued item (same path, new tag): the drain persists the newest
    bytes, and the durable tier never holds stale data after flush."""
    base = _mem_base("requeue")
    root = f"{base}/step-0"
    old, new = b"A" * 256, b"B" * 256
    with hottier.hot_tier(rank=0, world=2, k=2, drain="manual"):
        rt = hottier.runtime()
        rt.hot_put(root, "0/s/w", old)
        rt.enqueue_drain(root, "0/s/w")
        rt.hot_put(root, "0/s/w", new)
        rt.enqueue_drain(root, "0/s/w")
        with rt._cond:
            items = [i for i in rt._queue if i[1] == "0/s/w"]
        assert len(items) == 1  # superseded item replaced, not doubled
        hottier.drain_now()
        assert hottier.wait_drained(timeout_s=5.0)
    hottier.reset_hot_tier()
    assert _read_bytes(root, "0/s/w") == new


def test_rewrite_while_drain_inflight_is_not_resurrected_stale():
    """An IN-FLIGHT drain of superseded bytes must neither clear the
    newer write's pending entry nor mark the newer replicas evictable
    (they are the only copy of the newest bytes); the newer item then
    drains the bytes the durable tier must end up with."""
    base = _mem_base("staledrain")
    root = f"{base}/step-0"
    old, new = b"A" * 256, b"B" * 256
    with hottier.hot_tier(rank=0, world=2, k=2, drain="manual"):
        rt = hottier.runtime()
        rt.hot_put(root, "0/s/w", old)
        rt.enqueue_drain(root, "0/s/w")
        with rt._cond:  # pop as the background drainer would
            item = rt._queue.popleft()
        rt.hot_put(root, "0/s/w", new)
        rt.enqueue_drain(root, "0/s/w")
        rt._drain_item(*item)  # the stale in-flight drain completes
        state = rt.root_state(root)
        assert state.pending == {"0/s/w"}
        key = f"{root}/0/s/w"
        for host in ht_tier.replica_hosts_for(key):
            assert not ht_tier.get_replica(key, host).drained
        hottier.drain_now()
        assert not rt.root_state(root).pending
    hottier.reset_hot_tier()
    assert _read_bytes(root, "0/s/w") == new


def test_degraded_rewrite_cancels_stale_drain_and_keeps_latest():
    """A degraded re-write (write-through) of a path whose drain is
    still queued quiesces the drain pipeline FIRST: the stale item is
    removed before the durable write, so it can never overwrite the
    write-through's bytes, and the flush converges on the latest."""
    import asyncio

    base = _mem_base("degrewrite")
    root = f"{base}/step-0"
    old, new = b"A" * 128, b"B" * 128
    with hottier.hot_tier(rank=0, world=2, k=2, drain="manual"):
        storage = url_to_storage_plugin(root)
        try:
            asyncio.run(storage.write(IOReq(path="0/s/w", data=old)))
            hottier.kill_host(1)  # the re-write cannot reach k replicas
            asyncio.run(storage.write(IOReq(path="0/s/w", data=new)))
        finally:
            storage.close()
        rt = hottier.runtime()
        with rt._cond:
            assert not [i for i in rt._queue if i[1] == "0/s/w"]
        assert rt.stats_snapshot()["degraded_puts"] == 1
        # The surviving replica holds the new bytes and is evictable.
        key = f"{root}/0/s/w"
        obj = ht_tier.get_replica(key, 0)
        assert obj.data == new and obj.drained
        hottier.drain_now()
    hottier.reset_hot_tier()
    assert _read_bytes(root, "0/s/w") == new


def test_rewrite_drops_stale_replicas_outside_new_placement():
    """When the replica set changes between writes (spare substitution,
    then the ring peer comes back), replicas of the superseded bytes on
    hosts the new placement did not revisit are dropped — they would
    otherwise serve stale reads and pin RAM undrained forever."""
    base = _mem_base("stalepin")
    root = f"{base}/step-0"
    with hottier.hot_tier(rank=0, world=3, k=2, drain="manual"):
        rt = hottier.runtime()
        hottier.kill_host(1)
        placed, _tag = rt.hot_put(root, "0/s/w", b"A" * 64)
        key = f"{root}/0/s/w"
        assert placed == 2
        assert sorted(ht_tier.replica_hosts_for(key)) == [0, 2]
        hottier.revive_host(1)
        placed, _tag = rt.hot_put(root, "0/s/w", b"B" * 64)
        assert placed == 2  # back on the ring: hosts 0 and 1
        hosts = sorted(ht_tier.replica_hosts_for(key))
        assert hosts == [0, 1]  # host 2's stale replica dropped
        for host in hosts:
            assert ht_tier.get_replica(key, host).data == b"B" * 64


def test_write_through_after_commit_still_records_watermark():
    """A write-through that retires the root's LAST pending object
    after commit must still get the ``.tierdown`` watermark recorded —
    no drain item will ever visit the watermark path otherwise."""
    import asyncio

    base = _mem_base("wtwm")
    root = f"{base}/step-0"
    with hottier.hot_tier(rank=0, world=2, k=2, drain="manual"):
        storage = url_to_storage_plugin(root)
        try:
            asyncio.run(storage.write(IOReq(path="0/s/w", data=b"A" * 64)))
            # Commit with the object still pending: no watermark item.
            asyncio.run(
                storage.write(IOReq(path=".snapshot_metadata", data=b"{}"))
            )
            hottier.kill_host(1)
            asyncio.run(storage.write(IOReq(path="0/s/w", data=b"B" * 64)))
        finally:
            storage.close()
        hottier.drain_now()
        assert ".tierdown" in _durable_objects(root)
        assert hottier.wait_drained(timeout_s=5.0)
    hottier.reset_hot_tier()
    assert _read_bytes(root, "0/s/w") == b"B" * 64


def test_failed_write_through_rearms_drain(monkeypatch):
    """A degraded write-through whose durable write FAILS must not
    silently retire the durability obligation: the drain is re-armed
    for the placed replicas (which stay unevictable — the only copy)
    and the next drain_now lands the bytes durably."""
    monkeypatch.setenv("TPUSNAPSHOT_STORAGE_RETRIES", "0")
    base = _mem_base("wtfail")
    root = f"{base}/step-0"
    # The first matched write is the take's degraded write-through (it
    # fails → the take fails); the drain's first durable re-drive write
    # fails too, the next succeeds.
    sched = fl.FaultSchedule().transient(op="write", path="0/s/w", times=2)
    with fl.inject(sched):
        with hottier.hot_tier(rank=0, world=2, k=2, drain="manual"):
            hottier.kill_host(1)  # every payload put degrades
            with pytest.raises(Exception):
                Snapshot.take(root, _state(3))
            rt = hottier.runtime()
            # Failed write-through: the obligation survives — newest
            # bytes still pending, the sole replica unevictable.
            assert rt.root_state(root).pending == {"0/s/w"}
            key = f"{root}/0/s/w"
            assert not ht_tier.get_replica(key, 0).drained
            # The re-armed drain re-drives the bytes to durable.
            hottier.drain_now()
            assert hottier.wait_drained(timeout_s=5.0)
            assert _payload_objects(root)
            assert ht_tier.get_replica(key, 0).drained


def test_recreated_root_after_delete_gets_watermark():
    """Deleting a snapshot must not latch its root 'forgotten' forever:
    a snapshot later re-created at the same root — even one whose
    payload writes all degrade to write-through (so enqueue_drain never
    runs) — still gets its ``.tierdown`` watermark and keeps it."""
    base = _mem_base("recreate")
    root = f"{base}/step-0"
    with hottier.hot_tier(rank=0, world=2, k=2, drain="manual"):
        snap = Snapshot.take(root, _state(1))
        snap.delete()
        hottier.kill_host(1)  # the re-take degrades to write-through
        Snapshot.take(root, _state(2))
        hottier.drain_now()
        assert ".tierdown" in _durable_objects(root)
        target = _target()
        Snapshot(root).restore({"s": target["s"]})
        _assert_restored(target, 2)


def test_drain_executors_serialize_per_path():
    """Two drain executors (background loop + a drain_now re-drive)
    must never drain the same path concurrently: a queued item whose
    path has an in-flight drain is deferred until it finishes — the
    tag ordering between their durable writes would otherwise be lost,
    leaving superseded bytes durable."""
    base = _mem_base("serial")
    root = f"{base}/step-0"
    with hottier.hot_tier(rank=0, world=2, k=2, drain="manual"):
        rt = hottier.runtime()
        rt.hot_put(root, "0/s/w", b"A" * 64)
        rt.enqueue_drain(root, "0/s/w")
        with rt._cond:  # executor 1 takes the item mid-write
            item = rt._pop_runnable_locked()
            assert item is not None
            rt._inflight_begin_locked(item[0], item[1])
        rt.hot_put(root, "0/s/w", b"B" * 64)
        rt.enqueue_drain(root, "0/s/w")
        with rt._cond:
            # Executor 2 must NOT get the newer item for the same path.
            assert rt._pop_runnable_locked() is None
            rt._inflight_end_locked(item[0], item[1])
            assert rt._pop_runnable_locked() is not None


def test_replica_replacement_mid_drain_is_not_counted_lost():
    """hot_put replacing a path's replicas between a drain item's pop
    and its probe (the foreground re-write window, before enqueue_drain
    updates the bookkeeping) must not be misread as 'every replica
    lost': the item is re-driven instead, and the root converges to a
    clean ``.tierdown`` once the re-write's bookkeeping lands."""
    base = _mem_base("midswap")
    root = f"{base}/step-0"
    with hottier.hot_tier(rank=0, world=2, k=2, drain="manual"):
        rt = hottier.runtime()
        rt.hot_put(root, "0/s/w", b"A" * 64)
        rt.enqueue_drain(root, "0/s/w")
        with rt._cond:  # the background drainer holds the A item...
            item = rt._pop_runnable_locked()
        rt.hot_put(root, "0/s/w", b"B" * 64)  # ...as the re-write lands
        rt._drain_item(*item)  # probe finds no tag-A replica
        assert rt.stats_snapshot()["drain_lost"] == 0
        rt.enqueue_drain(root, "0/s/w")  # re-write's bookkeeping lands
        rt.on_commit(root)
        hottier.drain_now()
        assert hottier.wait_drained(timeout_s=5.0)
        assert ".tierdown" in _durable_objects(root)
    hottier.reset_hot_tier()
    assert _read_bytes(root, "0/s/w") == b"B" * 64


def test_genuine_replica_loss_still_detected():
    """All replicas actually dying pre-drain is still detected once the
    re-drive budget is spent: the loss is counted and the root can
    never tier down clean (truthful accounting)."""
    base = _mem_base("loss")
    root = f"{base}/step-0"
    with hottier.hot_tier(rank=0, world=2, k=2, drain="manual"):
        rt = hottier.runtime()
        rt.hot_put(root, "0/s/w", b"A" * 64)
        rt.enqueue_drain(root, "0/s/w")
        hottier.kill_host(0)
        hottier.kill_host(1)
        hottier.drain_now()
        assert rt.stats_snapshot()["drain_lost"] == 1
        rt.on_commit(root)
        hottier.drain_now()
        assert ".tierdown" not in _durable_objects(root)


def test_zero_capacity_forces_pure_write_through():
    """``capacity_bytes=0`` (TPUSNAPSHOT_HOT_TIER_BYTES=0) must refuse
    EVERY put — including the first per host — so nothing is ever
    buffered in RAM the operator sized to zero."""
    base = _mem_base("cap0")
    root = f"{base}/step-0"
    with hottier.hot_tier(
        rank=0, world=2, k=2, capacity_bytes=0, drain="manual"
    ):
        Snapshot.take(root, _state(5))
        assert ht_tier.total_buffered_bytes() == 0
        assert _payload_objects(root)  # everything wrote through
        assert hottier.runtime().stats_snapshot()["write_through"] >= 1


def test_disable_hot_tier_uninstalls_even_if_flush_crashes():
    """A SimulatedCrash striking the flush inside disable_hot_tier must
    not leak the wrap hook / runtime global: the tier must come down
    (and be re-enableable) regardless."""
    base = _mem_base("disablecrash")
    root = f"{base}/step-0"
    sched = fl.FaultSchedule().crash_on(op="hottier.drain")
    with fl.inject(sched):  # inject OUTER: enable/disable stay LIFO
        hottier.enable_hot_tier(rank=0, world=2, k=2, drain="manual")
        Snapshot.take(root, _state(1))
        with pytest.raises(fl.SimulatedCrash):
            hottier.disable_hot_tier(flush=True)
        assert hottier.runtime() is None  # uninstalled despite the crash
    with hottier.hot_tier(rank=0, world=2, k=2, drain="manual"):
        pass  # re-enable works


def test_same_tag_degraded_rewrite_requeues_drain():
    """Re-writing the SAME bytes while degraded must not let the
    enqueue dedupe drop the drain obligation after begin_write_through
    canceled the queued item: an obligation with no queued/in-flight
    owner would never tier down while wait_drained reports clean."""
    base = _mem_base("sametag")
    root = f"{base}/step-0"
    with hottier.hot_tier(rank=0, world=2, k=2, drain="manual"):
        rt = hottier.runtime()
        placed, tag = rt.hot_put(root, "0/s/w", b"A" * 64)
        rt.enqueue_drain(root, "0/s/w", tag)
        # Degraded re-write of identical bytes: the quiesce cancels the
        # queued item...
        rt.begin_write_through(root, "0/s/w")
        with rt._cond:
            assert not rt._queue
        # ...the durable write fails, and abort must RE-ARM the drain
        # (the same-tag dedupe must not swallow it).
        rt.abort_write_through(root, "0/s/w", tag, placed)
        with rt._cond:
            assert [i for i in rt._queue if i[1] == "0/s/w"]
        hottier.drain_now()
        assert hottier.wait_drained(timeout_s=5.0)
        assert _payload_objects(root)


def test_drain_now_waits_for_other_executors_inflight():
    """drain_now (the force-flush) must not return while another
    executor still holds the last item in flight — the caller would
    tear the tier down believing the bytes are durable."""
    base = _mem_base("flushwait")
    root = f"{base}/step-0"
    with hottier.hot_tier(rank=0, world=2, k=2, drain="manual"):
        rt = hottier.runtime()
        rt.hot_put(root, "0/s/w", b"A" * 64)
        rt.enqueue_drain(root, "0/s/w")
        with rt._cond:  # another executor holds the only item
            item = rt._pop_runnable_locked()
            rt._inflight_begin_locked(item[0], item[1])
        done = []
        flusher = threading.Thread(
            target=lambda: (rt.drain_now(), done.append(True))
        )
        flusher.start()
        time.sleep(0.3)
        assert not done  # still waiting on the in-flight item
        rt._drain_item(*item)
        with rt._cond:
            rt._inflight_end_locked(item[0], item[1])
        flusher.join(timeout=5.0)
        assert done


def test_wait_drained_sees_inflight_write_through():
    """wait_drained must not report a clean flush while a degraded
    write-through is mid-flight on the foreground: it owns no queue
    item (begin_write_through canceled it), but the pending entry it
    deliberately leaves alive keeps the flush dirty until
    note/abort_write_through resolves it."""
    base = _mem_base("wtwait")
    root = f"{base}/step-0"
    with hottier.hot_tier(rank=0, world=2, k=2, drain="manual"):
        rt = hottier.runtime()
        placed, tag = rt.hot_put(root, "0/s/w", b"A" * 64)
        rt.enqueue_drain(root, "0/s/w", tag)
        rt.begin_write_through(root, "0/s/w")  # write-through "in flight"
        assert not hottier.wait_drained(timeout_s=0.3)
        rt.note_write_through(root, "0/s/w", tag, placed)
        assert hottier.wait_drained(timeout_s=5.0)


def test_tierdown_watermark_counts_are_per_root(tmp_path):
    """Each root's ``.tierdown`` records THAT root's drained-object
    count (and its process scope), not the process-cumulative stats
    counter."""
    root_a = str(tmp_path / "step-0")
    root_b = str(tmp_path / "step-1")
    with hottier.hot_tier(rank=0, world=2, k=2, drain="manual"):
        Snapshot.take(root_a, _state(1))
        Snapshot.take(root_b, _state(2))
        hottier.drain_now()
        for root in (root_a, root_b):
            watermark = _read_json(root, ".tierdown")
            assert watermark["drained_objects"] == 1
            assert watermark["scope"] == "process"


# ------------------------------------------------ across the two packages

_PORT = {"snap": Snapshot, "sd": StateDict, "tier": hottier, "fl": fl,
         "diagnose": diagnose_report, "transport": transport,
         "peer": start_local_peer, "array": lambda a: torch.from_numpy(a.copy())}
_JAX = {"snap": jsnap.Snapshot, "sd": jsnap.StateDict, "tier": jhottier, "fl": jfl,
        "diagnose": jax_diagnose_report, "transport": jtransport,
        "peer": None, "array": jnp.asarray}


def _values(seed=21):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((64, 48)).astype(np.float32),
        "b": rng.standard_normal(48).astype(np.float32),
        "i": rng.integers(-1000, 1000, size=300).astype(np.int32),
    }


def _pkg_state(pkg, values):
    return {"s": pkg["sd"](**{k: pkg["array"](v) for k, v in values.items()})}


def _pkg_target(pkg, values):
    return {"s": pkg["sd"](**{k: pkg["array"](np.zeros_like(v)) for k, v in values.items()})}


def _assert_values(target, values):
    for k, v in values.items():
        got = np.asarray(target["s"][k])
        assert got.dtype == v.dtype and got.tobytes() == v.tobytes(), k


@pytest.mark.parametrize("taker", ["port", "jax"])
def test_tiered_snapshot_restores_through_the_other_package(tmp_path, taker):
    """A snapshot taken asynchronously through one package's tier (acked
    from RAM, then drained) restores bit-exact through the other package
    with its tier off, and through the taker's tier with every host lost
    (per-object durable fallback); both packages write the same
    watermark fields."""
    values = _values()
    pkg, other = (_PORT, _JAX) if taker == "port" else (_JAX, _PORT)
    root = str(tmp_path / "step-0")
    with pkg["tier"].hot_tier(rank=0, world=2, k=2, drain="manual"):
        pkg["snap"].async_take(root, _pkg_state(pkg, values)).wait()
        assert not _payload_objects(root)  # acked from RAM only
        pkg["tier"].drain_now()
        assert pkg["tier"].wait_drained(timeout_s=10.0)
        watermark = _read_json(root, ".tierdown")
        pkg["tier"].kill_host(0)
        pkg["tier"].kill_host(1)
        target = _pkg_target(pkg, values)
        pkg["snap"](root).restore(target)
        _assert_values(target, values)
        stats = pkg["tier"].runtime().stats_snapshot()
        assert stats["fallback_objects"] == len(values) and stats["hot_objects"] == 0
    target = _pkg_target(other, values)
    other["snap"](root).restore(target)
    _assert_values(target, values)
    assert watermark["format_version"] == 1
    assert watermark["drained_objects"] == len(values)
    # The other package's watermark of the same take has the same fields.
    root2 = str(tmp_path / "step-1")
    with other["tier"].hot_tier(rank=0, world=2, k=2, drain="manual"):
        other["snap"].take(root2, _pkg_state(other, values))
        other["tier"].drain_now()
    assert sorted(_read_json(root2, ".tierdown")) == sorted(watermark)


def _masked(ops):
    """The op multiset with the take's random nonces masked."""
    import collections
    import re

    out = collections.Counter()
    for op, path in ops:
        path = re.sub(r"\.completed/[0-9a-f]{32}/", ".completed/<nonce>/", path)
        path = re.sub(r"\.progress/[0-9a-f]{32}", ".progress/<nonce>", path)
        out[(op, path)] += 1
    return out


def _op_stream(pkg, root, values):
    """Every storage-op boundary (with the hot tier's own ``hottier.*``
    boundaries) of an async tiered take, its drain and a restore."""
    sched = pkg["fl"].FaultSchedule().latency(op="*", path="*", seconds=0.0)
    with pkg["tier"].hot_tier(rank=0, world=2, k=2, drain="manual"):
        with pkg["fl"].inject(sched) as ctl:
            pkg["snap"].async_take(root, _pkg_state(pkg, values)).wait()
            pkg["tier"].drain_now()
            target = _pkg_target(pkg, values)
            pkg["snap"](root).restore(target)
    _assert_values(target, values)
    assert len(ctl.records) == ctl.op_index
    return _masked((r.op, r.path) for r in ctl.records)


def test_tiered_op_stream_matches_jax(tmp_path):
    """An async take through the tier, its drain and a restore emit the
    same multiset of storage ops in both packages: the replication
    boundaries a host, the drain's writes and watermark, the reports and
    ledger appends, the fs sub-steps."""
    values = _values(22)
    got = _op_stream(_PORT, str(tmp_path / "port" / "step-0"), values)
    want = _op_stream(_JAX, str(tmp_path / "jax" / "step-0"), values)
    # The port's async take settles the fs plugin's deferred directory
    # fsyncs (``ensure_durable``, one boundary) before its commit
    # markers, with or without the tier; the JAX package's async route
    # has no such call. Not a hot-tier op: set aside.
    assert got.pop(("durable", "")) == 1
    assert sum(c for (op, _), c in got.items() if op == "hottier.replicate") == 2 * len(values)
    assert got == want, (
        f"only in the port: {sorted((got - want).elements())}\n"
        f"only in JAX: {sorted((want - got).elements())}"
    )


def _degraded_restore_report(pkg, base, values):
    root = f"{base}/step-0"
    with pkg["tier"].hot_tier(rank=0, world=2, k=2, drain="manual"):
        pkg["snap"].take(root, _pkg_state(pkg, values))
        pkg["tier"].drain_now()
        pkg["tier"].kill_host(0)
        pkg["tier"].kill_host(1)
        target = _pkg_target(pkg, values)
        pkg["snap"](root).restore(target)
    _assert_values(target, values)
    return _read_json(root, ".report.restore.json")


def _findings(pkg, report, rule):
    return [(f.rule, f.severity, f.title, f.evidence)
            for f in pkg["diagnose"](report) if f.rule == rule]


def test_hot_tier_degraded_finding_matches_jax(tmp_path):
    """Every replica lost after tier-down: the port's restore report has
    the JAX report's ``tier`` block, and the doctor's critical
    ``hot-tier-degraded`` finding names the same dead hosts."""
    values = _values(23)
    port = _degraded_restore_report(_PORT, str(tmp_path / "port"), values)
    jax_rep = _degraded_restore_report(_JAX, str(tmp_path / "jax"), values)
    assert port["ranks"][0]["tier"] == jax_rep["ranks"][0]["tier"]
    got = _findings(_PORT, port, "hot-tier-degraded")
    assert got and got == _findings(_JAX, jax_rep, "hot-tier-degraded")
    assert got[0][1] == "critical" and got[0][3]["degraded_peers"] == "peer hosts 0-1"


def _torn_take_report(pkg, base, values, monkeypatch):
    monkeypatch.setenv("TPUSNAPSHOT_REPLICATION_DEADLINE_S", "2")
    monkeypatch.setenv("TPUSNAPSHOT_REPLICATION_RETRY_BUDGET_S", "1")
    monkeypatch.setenv("TPUSNAPSHOT_REPLICATION_DOWN_COOLDOWN_S", "0.2")
    monkeypatch.setenv("TPUSNAPSHOT_REPLICATION_CODEC", "none")
    start = pkg["peer"] or __import__(
        "torchsnapshot_tpu.hottier.peer", fromlist=["peer"]
    ).start_local_peer
    server, _ = start(1, capacity_bytes=1 << 26)
    root = f"{base}/step-0"
    try:
        for _ in range(64):  # every attempt inside the budget tears
            pkg["transport"].script_wire_fault("torn_frame", host=1)
        with pkg["tier"].hot_tier(rank=0, world=2, k=2, drain="manual"):
            pkg["snap"].take(root, _pkg_state(pkg, values))
            pkg["transport"].clear_wire_faults()
            pkg["tier"].drain_now()
    finally:
        pkg["transport"].clear_wire_faults()
        pkg["tier"].reset_hot_tier()
        server.stop()
    return _read_json(root, ".report.json")


def test_replication_degraded_finding_matches_jax(tmp_path, monkeypatch):
    """Every push torn: each object writes through before its ack, and
    the take report's ``tier.replication`` block and the doctor's
    critical ``replication-degraded`` finding are the same in both
    packages."""
    values = {"w": _values(24)["w"]}
    port = _torn_take_report(_PORT, str(tmp_path / "port"), values, monkeypatch)
    jax_rep = _torn_take_report(_JAX, str(tmp_path / "jax"), values, monkeypatch)

    def block(rep):
        b = dict(rep["ranks"][0]["tier"]["replication"])
        b.pop("retries")  # how many attempts fit the budget is timing
        b.pop("push_failures")
        return b

    assert block(port) == block(jax_rep)

    def finding(pkg, rep):
        return [(r, sev, ev["write_through_fraction"] if "write_through_fraction" in ev else None)
                for r, sev, _t, ev in _findings(pkg, rep, "replication-degraded")]

    got = finding(_PORT, port)
    assert got and got == finding(_JAX, jax_rep)
    assert got[0][1] == "critical"
