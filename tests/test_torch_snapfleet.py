"""snapfleet: the consistent-hashed snapserve fleet — ring routing,
membership generations, supervision, chunk pushdown, multi-tenant
admission, client failover, and the fleet fault matrix: the cases of
the JAX package's ``tests/test_snapfleet.py`` on the port. Its
differently-meshed restore runs here as a spawned gloo world of 2 ranks
restoring row halves of a chunk-stored array through a fleet.

Invariants pinned here:

- Ring spread: with >= 128 vnodes per member no member owns more than
  2x its ideal key share, and losing a member remaps ONLY that
  member's keys (survivors keep their owners — and their warm caches).
- Generations: a stale re-register raises; the supervisor refuses a
  stale probe answer, counts it, and re-registers a respawn one
  generation up. Hung != dead: a probe timeout is a strike, only
  consecutive strikes mark a member down; a refused connection is
  death now.
- Chunk pushdown: the ``plan`` RPC answer equals the client's local
  pushdown cut AND a brute-force ground truth; malformed plan docs are
  server errors, not hangs.
- Tenant admission: an over-quota tenant's requests DEFER (never
  error) behind its own quota while another tenant's requests grant
  immediately; oversize responses are admitted alone when the tenant
  is idle.
- Failover ladder: owner death mid-fan-out surfaces as ring-replica
  failover (counted, bit-exact, zero client-visible errors, zero
  direct fallbacks while replicas live); exhausting the whole fleet
  degrades to direct reads with reason ``fleet-exhausted`` and fires
  the ``fleet-degraded`` doctor rule.
- Conn pools: entries keyed to a CLOSED event loop are swept (the
  id-recycle liveness bug), and pooled conns whose writer is closing
  are never handed out.
"""

import asyncio
import json
import threading
import uuid

import numpy as np
import pytest
import torch

from torchsnapshot_tpu_torch import RemoteSnapshot, Snapshot, StateDict, snapserve
from torchsnapshot_tpu_torch import faultline as fl
from torchsnapshot_tpu_torch.io_types import IOReq
from torchsnapshot_tpu_torch.snapserve import fleet as sv_fleet
from torchsnapshot_tpu_torch.snapserve import pushdown
from torchsnapshot_tpu_torch.snapserve.server import TenantAdmission
from torchsnapshot_tpu_torch.storage_plugin import url_to_storage_plugin
from torchsnapshot_tpu_torch.telemetry import report as flight
from torchsnapshot_tpu_torch.telemetry.doctor import diagnose_report
from torchsnapshot_tpu_torch.wire import RemoteServerError


@pytest.fixture(autouse=True)
def _fleet_hygiene(monkeypatch):
    """Short down-cooldowns (one test's latch must not slow the next)
    and no leaked in-process servers or member registrations."""
    monkeypatch.setenv("TPUSNAPSHOT_SNAPSERVE_DOWN_COOLDOWN_S", "0.2")
    yield
    for name in sv_fleet.local_member_names():
        sv_fleet.unregister_local_member(name)
    snapserve.kill_local_servers()


def _mem_root(tag):
    return f"memory://snapfleet-{tag}-{uuid.uuid4().hex[:10]}/run"


def _state(n_params=4, n=2048, seed=11):
    rng = np.random.default_rng(seed)
    return {
        "m": StateDict(
            **{
                f"p{i}": rng.standard_normal(n).astype(np.float32)
                for i in range(n_params)
            }
        )
    }


def _zero_like(state):
    return {
        "m": StateDict(
            **{k: np.zeros_like(v) for k, v in state["m"].items()}
        )
    }


def _assert_exact(target, state):
    for k, v in state["m"].items():
        assert np.array_equal(target["m"][k], v), k


def _restore_report(root):
    storage = url_to_storage_plugin(root)
    try:
        return asyncio.run(
            flight.aread_json(storage, flight.RESTORE_REPORT_FNAME)
        )
    finally:
        storage.close()


# ------------------------------------------------------------------- ring


def test_ring_spread_within_2x_ideal_at_128_vnodes():
    members = [f"10.0.0.{i}:7000" for i in range(5)]
    ring = sv_fleet.HashRing(members, vnodes=128)
    counts = {m: 0 for m in members}
    n_keys = 10_000
    for i in range(n_keys):
        counts[ring.owner(f"key-{i}")] += 1
    ideal = n_keys / len(members)
    assert sum(counts.values()) == n_keys
    for m, c in counts.items():
        assert c <= 2 * ideal, f"{m} owns {c} keys (ideal {ideal})"
        assert c > 0, f"{m} owns nothing"


def test_ring_member_loss_remaps_only_lost_members_keys():
    members = [f"h{i}:1" for i in range(4)]
    ring = sv_fleet.HashRing(members, vnodes=128)
    smaller = sv_fleet.HashRing(members[:-1], vnodes=128)
    keys = [f"obj-{i}" for i in range(4000)]
    moved = 0
    for k in keys:
        before = ring.owner(k)
        after = smaller.owner(k)
        if before == members[-1]:
            assert after != members[-1]
        else:
            # A surviving member's keys NEVER move: its cache stays
            # warm through someone else's death.
            assert after == before
            continue
        moved += 1
    # The lost member owned ~1/4 of the keyspace; only that share moved.
    assert moved <= 2 * len(keys) / len(members)


def test_ring_preference_is_distinct_and_starts_at_owner():
    members = [f"h{i}:1" for i in range(4)]
    ring = sv_fleet.HashRing(members, vnodes=64)
    for i in range(64):
        pref = ring.preference(f"k{i}")
        assert len(pref) == len(members)
        assert len(set(pref)) == len(members)
        assert pref[0] == ring.owner(f"k{i}")


def test_routing_key_content_addressed_vs_location():
    from torchsnapshot_tpu_torch.chunkstore import chunk_object_path

    key = "xs128:" + "ab" * 16 + "-4096-raw"
    path = chunk_object_path(key)
    # Chunk objects route by content key: the same chunk referenced
    # from two different backends keeps ONE ring owner.
    assert sv_fleet.routing_key("memory://a/x", path) == sv_fleet.routing_key(
        "memory://b/y", path
    )
    # Ordinary objects route by backend-qualified location.
    assert sv_fleet.routing_key(
        "memory://a/x", "0/m.0"
    ) != sv_fleet.routing_key("memory://b/y", "0/m.0")


# ------------------------------------------------- membership + supervision


def test_membership_doc_round_trip_and_stale_register_refused():
    ms = sv_fleet.FleetMembership()
    ms.register("m0", "127.0.0.1:7001", generation=3)
    ms.register("m1", "127.0.0.1:7002", generation=1)
    # Same generation re-register is a no-op refresh; higher wins.
    ms.register("m0", "127.0.0.1:7001", generation=4)
    with pytest.raises(sv_fleet.StaleGenerationError):
        ms.register("m0", "127.0.0.1:7001", generation=2)
    doc = ms.to_doc()
    back = sv_fleet.FleetMembership.from_doc(doc)
    assert back.get("m0").generation == 4
    assert back.get("m1").addr == "127.0.0.1:7002"


def test_supervisor_hung_is_strikes_dead_is_now_stale_is_refused():
    ms = sv_fleet.FleetMembership()
    ms.register("m0", "a0", generation=2)
    ms.register("m1", "a1", generation=2)
    verdicts = {"a0": "ok", "a1": "ok"}

    def probe(addr, timeout_s):
        v = verdicts[addr]
        if v == "hang":
            raise asyncio.TimeoutError("probe deadline")
        if v == "dead":
            raise ConnectionRefusedError("refused")
        if v == "stale":
            return {"member": "m0", "generation": 1}
        if v == "respawn":
            return {"member": "m0", "generation": 3}
        return {"member": addr, "generation": 2}

    sup = sv_fleet.FleetSupervisor(ms, probe=probe, hung_strikes=2)
    # Hung != dead: one missed deadline is a strike, not a death.
    verdicts["a0"] = "hang"
    sup.tick()
    assert ms.get("m0").status == "up"
    assert ms.get("m0").strikes == 1
    sup.tick()
    assert ms.get("m0").status == "down"
    # Recovery is observed by the background re-probe of down members.
    verdicts["a0"] = "ok"
    sup.tick()
    assert ms.get("m0").status == "up"
    assert ms.get("m0").strikes == 0
    # A refused connection is death NOW, no strikes.
    verdicts["a1"] = "dead"
    sup.tick()
    assert ms.get("m1").status == "down"
    verdicts["a1"] = "ok"
    # A stale zombie answering is refused and counted; state unchanged.
    verdicts["a0"] = "stale"
    before = sup.refused_generations
    sup.tick()
    assert sup.refused_generations == before + 1
    assert ms.get("m0").generation == 2
    # A respawn answers one generation UP and re-registers.
    verdicts["a0"] = "respawn"
    sup.tick()
    assert ms.get("m0").generation == 3
    assert ms.get("m0").status == "up"


def test_supervisor_probes_real_fleet_and_respawn_reregisters():
    lf = sv_fleet.start_local_fleet(n=2)
    try:
        sup = sv_fleet.FleetSupervisor(lf.membership, probe_timeout_s=5.0)
        sup.tick()
        assert len(lf.membership.up_members()) == 2
        # Kill m0; the next tick sees a refused connection = down.
        dead_addr = lf.membership.get("m0").addr
        sv_fleet.kill_local_member("m0")
        sup.tick()
        assert lf.membership.get("m0").status == "down"
        assert lf.membership.get("m1").status == "up"
        # Respawn m0 one generation up on the SAME logical name (fresh
        # port — the doc's addr follows the re-register).
        server = snapserve.start_local_server(
            member_name="m0", generation=2
        )
        sv_fleet.register_local_member("m0", server)
        lf.membership.register("m0", server.addr, generation=2)
        sup.tick()
        assert lf.membership.get("m0").status == "up"
        assert lf.membership.get("m0").generation == 2
        assert lf.membership.get("m0").addr != dead_addr
    finally:
        lf.stop()


# --------------------------------------------------------- chunk pushdown


def test_pushdown_hull_and_select_against_brute_force():
    shape = (16, 24)
    itemsize = 4
    rng = np.random.default_rng(3)
    flat = np.arange(shape[0] * shape[1] * itemsize, dtype=np.uint8)
    for _ in range(50):
        r0 = int(rng.integers(0, shape[0]))
        r1 = int(rng.integers(r0 + 1, shape[0] + 1))
        c0 = int(rng.integers(0, shape[1]))
        c1 = int(rng.integers(c0 + 1, shape[1] + 1))
        box = ((r0, r1), (c0, c1))
        hull = pushdown.slice_byte_hull(shape, box, itemsize)
        # Brute force: the strided element footprint of the box.
        footprint = set()
        for r in range(r0, r1):
            for c in range(c0, c1):
                base = (r * shape[1] + c) * itemsize
                footprint.update(range(base, base + itemsize))
        lo, hi = hull
        # The hull is a conservative SUPERSET of the footprint and
        # tight at both ends (first and last footprint byte).
        assert lo == min(footprint) and hi == max(footprint) + 1
        # Record selection covers every footprint byte.
        sizes = [96, 160, 64] * ((len(flat) // 320) + 1)
        total, record_sizes = 0, []
        for n in sizes:
            if total >= len(flat):
                break
            record_sizes.append(min(n, len(flat) - total))
            total += record_sizes[-1]
        plan = pushdown.select_records(
            record_sizes,
            pushdown.needed_intervals(shape, [box], itemsize),
        )
        offsets = np.cumsum([0] + record_sizes)
        covered = set()
        for i in plan.indices:
            covered.update(range(offsets[i], offsets[i + 1]))
        assert footprint <= covered


def test_pushdown_plan_rpc_equals_local_cut():
    server = snapserve.start_local_server()
    try:
        doc = {
            "shape": [64, 64],
            "itemsize": 4,
            "record_sizes": [4096] * 4,
            "boxes": [[[0, 16], [0, 64]], [[48, 64], [0, 64]]],
        }
        remote = snapserve.plan_remote(server.addr, doc)
        local = pushdown.plan_from_doc(doc)
        assert remote == local
        assert remote["indices"] == [0, 3]
        assert remote["selected_bytes"] == 8192
        # Malformed docs are server errors, never hangs.
        with pytest.raises((RemoteServerError, ValueError)):
            snapserve.plan_remote(server.addr, {"shape": "nope"})
    finally:
        server.stop()


def test_content_chunks_read_state_selected_cut():
    from torchsnapshot_tpu_torch.chunkstore import chunk_object_path
    from torchsnapshot_tpu_torch.io_preparer import _ContentChunksReadState

    records = [
        {"k": f"xs128:{format(i, '032x')}-100-raw", "n": 100}
        for i in range(5)
    ]
    state = _ContentChunksReadState(500, inner=None, dtype_name="float32")
    reqs = state.build_reads(records, store_base=None, selected=[1, 3])
    # Only the selected records are fetched, at their ORIGINAL
    # cumulative offsets; the full-size assembly buffer is retained.
    assert state.nbytes == 500
    assert [r.path for r in reqs] == [
        chunk_object_path(records[1]["k"]),
        chunk_object_path(records[3]["k"]),
    ]
    assert [c.buffer_consumer._start for c in reqs] == [100, 300]
    assert [c.buffer_consumer._first for c in reqs] == [True, False]
    assert state._remaining == 2


def test_differently_meshed_chunked_restore_through_fleet_bit_exact(
    monkeypatch, tmp_path
):
    """A chunk-stored array taken by one process restores as row halves
    in a spawned gloo world of 2 through a 3-member fleet: every rank's
    box is bit-exact, the reads were served remotely by more than one
    member with no direct fallback, and each rank fetched (pushdown) only
    the content chunks of its half."""
    from tests import torch_rank_workers as workers
    from torchsnapshot_tpu_torch.utils.test_utils import run_multiprocess

    # 64 KiB chunks over a 1 MiB array → 16 content chunks whose ring
    # owners spread over the fleet.
    monkeypatch.setenv("TPUSNAPSHOT_CHUNK_BYTES", str(64 << 10))
    arr = np.arange(512 * 512, dtype=np.float32).reshape(512, 512)
    path = str(tmp_path / "step-1")
    Snapshot.take(
        path, {"m": StateDict(w=torch.from_numpy(arr))}, chunks=True, replicated=["**"]
    )
    lf = sv_fleet.start_local_fleet(n=3)
    try:
        out = tmp_path / "ranks"
        out.mkdir()
        run_multiprocess(
            workers.restore_rows_through_snapserve, 2,
            (f"snapserve://{lf.addr_spec}/{path}", arr, str(out)), timeout_s=120,
        )
    finally:
        lf.stop()
    for rank in range(2):
        rec = json.loads((out / f"rank{rank}.json").read_text())
        assert rec["fallback_objects"] == 0, rec
        assert rec["remote_objects"] > 0, rec
        # Fleet routing spread the reads over more than one member.
        assert len(rec["servers"]) > 1, rec
        # Half of the 16 chunks, each 64 KiB.
        assert rec["chunk_bytes"] == arr.nbytes // 2, rec


# ------------------------------------------------------- tenant admission


def test_tenant_quota_defers_over_quota_and_isolates_small_tenant():
    async def _run():
        adm = TenantAdmission(100)
        order = []

        async def big(tag, n):
            await adm.acquire("big", n)
            order.append(f"grant:{tag}")

        # 60 + 60 > 100: the second BIG request parks.
        await big("b1", 60)
        task_b2 = asyncio.ensure_future(big("b2", 60))
        await asyncio.sleep(0.01)
        assert not task_b2.done()
        st = adm.stats()
        assert st["big"]["deferrals"] == 1
        assert st["big"]["inflight_bytes"] == 60
        # The SMALL tenant is untouched by big's backlog.
        await asyncio.wait_for(adm.acquire("small", 50), timeout=1)
        assert adm.stats()["small"]["deferrals"] == 0
        # Oversize admitted alone when its tenant is idle.
        await asyncio.wait_for(adm.acquire("huge", 10_000), timeout=1)
        adm.release("huge", 10_000)
        # Releasing big's first grant pumps the parked request.
        adm.release("big", 60)
        await asyncio.wait_for(task_b2, timeout=1)
        assert order == ["grant:b1", "grant:b2"]
        adm.release("big", 60)
        adm.release("small", 50)
        st = adm.stats()
        assert st["big"]["inflight_bytes"] == 0
        assert st["big"]["grant_wait_p95_s"] >= 0.0

    asyncio.run(_run())


def test_tenant_quota_isolation_under_concurrency():
    """Against a REAL quota-limited server: a saturating tenant's
    oversize responses serialize behind their own quota (deferrals
    counted) while a small tenant's sequential reads all grant with
    zero wait — and every byte stays correct for both."""
    root = _mem_root("tenants")
    # The saturating responses must exceed BOTH the quota (so they are
    # oversize-admitted alone and concurrent peers defer) and the
    # loopback socket buffers (so the send genuinely yields while the
    # quota is held): 4 MiB responses against a 1 MiB quota.
    payload = (np.arange(4 << 20, dtype=np.uint8) % 251).tobytes()
    backend = url_to_storage_plugin(root)
    try:
        asyncio.run(backend.write(IOReq(path="blob", data=payload)))
        asyncio.run(
            backend.write(IOReq(path="tiny", data=payload[:4096]))
        )
    finally:
        backend.close()
    server = snapserve.start_local_server(tenant_quota_bytes=1 << 20)
    try:
        errors = []
        # The saturating readers send their first requests together, so
        # that they meet at the server (under a loaded test host, threads
        # started one after another may otherwise never overlap).
        together = threading.Barrier(4)

        def _reads(tenant, path, want, n, barrier=None):
            plugin = snapserve.SnapServePlugin(f"{server.addr}/{root}")
            plugin.tenant_override = tenant
            try:
                if barrier is not None:
                    barrier.wait(timeout=60)

                async def _go():
                    for _ in range(n):
                        req = IOReq(path=path)
                        await plugin.read(req)
                        assert bytes(req.data) == want

                asyncio.run(_go())
            except Exception as e:
                errors.append(repr(e))
            finally:
                plugin.close()

        sat = [
            threading.Thread(
                target=_reads,
                args=("sat", "blob", payload, 3, together),
                daemon=True,
            )
            for _ in range(4)
        ]
        small = threading.Thread(
            target=_reads,
            args=("small", "tiny", payload[:4096], 8),
            daemon=True,
        )
        for t in sat:
            t.start()
        small.start()
        for t in sat + [small]:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in sat + [small])
        assert not errors, errors
        tenants = snapserve.fetch_server_stats(server.addr)["tenants"]
        # 4 MiB responses against a 1 MiB quota: every concurrent
        # saturating request beyond the first defers (admitted alone
        # when the tenant drains) — never errors.
        assert tenants["sat"]["deferrals"] > 0
        assert tenants["small"]["deferrals"] == 0
        assert tenants["small"]["grant_wait_p95_s"] == 0.0
        assert tenants["sat"]["requests"] == 12
        assert tenants["small"]["requests"] == 8
    finally:
        server.stop()


# -------------------------------------------------------- failover ladder


def test_owner_death_fails_over_to_replica_never_direct():
    root = _mem_root("ladder")
    # Enough distinct object paths that the lone survivor cannot own
    # ALL of them (two of three members dead → some owner is dead).
    state = _state(n_params=12, n=1024)
    Snapshot.take(root, state)
    lf = sv_fleet.start_local_fleet(n=3)
    try:
        before = snapserve.stats_snapshot()
        sv_fleet.kill_local_member("m0")
        sv_fleet.kill_local_member("m1")
        target = _zero_like(state)
        RemoteSnapshot(root, addr=lf.addr_spec).restore(target)
        _assert_exact(target, state)
        after = snapserve.stats_snapshot()
        # The survivor absorbed the dead members' shares: zero direct
        # fallbacks, and every object owned by a dead member counted as
        # failover (first touch) or owner_miss (after the down latch).
        assert after["fallback_objects"] == before["fallback_objects"]
        assert (
            after["failover_objects"] + after["owner_misses"]
            > before["failover_objects"] + before["owner_misses"]
        )
        # Degraded-but-absorbed routing is doctor-visible as a WARN
        # (critical is reserved for fleet-exhausted direct fallbacks).
        findings = diagnose_report(_restore_report(root))
        fleet_findings = [
            f for f in findings if f.rule == "fleet-degraded"
        ]
        assert fleet_findings and fleet_findings[0].severity == "warn"
    finally:
        lf.stop()


def test_fleet_exhausted_degrades_direct_and_fires_fleet_degraded():
    root = _mem_root("exhaust")
    state = _state(n_params=2, n=512)
    Snapshot.take(root, state)
    lf = sv_fleet.start_local_fleet(n=3)
    try:
        for name in list(sv_fleet.local_member_names()):
            sv_fleet.kill_local_member(name)
        before = snapserve.stats_snapshot()
        target = _zero_like(state)
        RemoteSnapshot(root, addr=lf.addr_spec).restore(target)
        _assert_exact(target, state)
        after = snapserve.stats_snapshot()
        assert after["fallback_objects"] > before["fallback_objects"]
        assert (
            after["reasons"].get("fleet-exhausted", 0)
            > before["reasons"].get("fleet-exhausted", 0)
        )
        report = _restore_report(root)
        findings = diagnose_report(report)
        fleet_findings = [
            f for f in findings if f.rule == "fleet-degraded"
        ]
        assert fleet_findings and fleet_findings[0].severity == "critical"
        assert any(
            f.rule == "read-plane-degraded" for f in findings
        )
    finally:
        lf.stop()


@pytest.mark.faultline
@pytest.mark.parametrize("victim", ["m0", "m1", "m2"])
def test_fleet_crash_matrix_member_killed_mid_fanout(victim):
    """Each of the 3 members killed deterministically mid-32-client
    fan-out: every client stays bit-exact with ZERO visible errors,
    the failover counter moves, and NO client leaves the fleet for the
    direct backend (replicas were alive the whole time)."""
    root = _mem_root(f"matrix-{victim}")
    # 24 params + manifest = 25 distinct ring keys: the probability the
    # victim owns NONE of them (which would leave the failover counter
    # still) is (2/3)^25 — negligible.
    state = _state(n_params=24, n=1024)
    Snapshot.take(root, state)
    lf = sv_fleet.start_local_fleet(n=3)
    try:
        before = snapserve.stats_snapshot()
        sched = fl.FaultSchedule().kill_fleet_member(victim, nth=20)
        errors = []
        barrier = threading.Barrier(32)

        def _one():
            try:
                barrier.wait(timeout=60)
                target = _zero_like(state)
                RemoteSnapshot(root, addr=lf.addr_spec).restore(target)
                _assert_exact(target, state)
            except Exception as e:
                errors.append(repr(e))

        with fl.inject(sched) as ctl:
            threads = [
                threading.Thread(target=_one, daemon=True)
                for _ in range(32)
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
        assert not errors, errors[:5]
        assert ctl.fault_counts().get("killmember") == 1
        assert victim not in sv_fleet.local_member_names()
        after = snapserve.stats_snapshot()
        assert (
            after["failover_objects"] + after["owner_misses"]
            > before["failover_objects"] + before["owner_misses"]
        )
        assert after["fallback_objects"] == before["fallback_objects"]
    finally:
        lf.stop()


@pytest.mark.faultline
def test_slow_fleet_member_keeps_serving_correct_bytes():
    root = _mem_root("slowmember")
    state = _state(n_params=2, n=512)
    Snapshot.take(root, state)
    lf = sv_fleet.start_local_fleet(n=2)
    try:
        sched = fl.FaultSchedule().slow_fleet_member(
            "m0", seconds=0.02, nth=1
        )
        with fl.inject(sched) as ctl:
            target = _zero_like(state)
            RemoteSnapshot(root, addr=lf.addr_spec).restore(target)
        _assert_exact(target, state)
        assert ctl.fault_counts().get("slowmember") == 1
        # Slow-but-alive: no fallbacks, no member death.
        assert set(sv_fleet.local_member_names()) == {"m0", "m1"}
    finally:
        lf.stop()


# ------------------------------------------------------------- conn pools


class _FakeTransport:
    def __init__(self, log):
        self._log = log

    def abort(self):
        self._log.append("abort")


class _FakeWriter:
    def __init__(self, log, closing=False):
        self.transport = _FakeTransport(log)
        self._closing = closing

    def is_closing(self):
        return self._closing

    def close(self):
        self.transport.abort()


def test_conn_pool_sweeps_closed_loop_entries():
    """The id-recycle liveness bug: an entry whose loop has been
    CLOSED must be swept on the next lookup (its sockets can never be
    awaited again), even when the dict key never collides — and a
    recycled id with a dead loop object must not hand out its conns."""
    server = snapserve.start_local_server()
    try:
        plugin = snapserve.SnapServePlugin(
            f"{server.addr}/memory://pool-test/x"
        )
        try:
            dead_loop = asyncio.new_event_loop()
            dead_loop.close()
            log = []
            stale_conn = (object(), _FakeWriter(log))
            addr = server.addr

            async def _use():
                # Plant two stale entries: one under an arbitrary key
                # (leak scenario), one under THIS loop's id (recycle
                # scenario — same id, different loop object).
                loop = asyncio.get_running_loop()
                plugin._pools[(987654321, addr)] = (
                    dead_loop,
                    [stale_conn],
                )
                plugin._pools[(id(loop), addr)] = (
                    dead_loop,
                    [(object(), _FakeWriter(log))],
                )
                conn = await plugin._checkout(addr)
                # The dial produced a REAL conn, not a planted one.
                assert conn is not stale_conn
                plugin._checkin(addr, conn)
                assert (987654321, addr) not in plugin._pools

            asyncio.run(_use())
            # Both planted conns were aborted, not leaked.
            assert log.count("abort") == 2
        finally:
            plugin.close()
    finally:
        server.stop()


def test_conn_pool_two_sequential_loops_at_same_id_stay_live():
    """Regression for the loop-id-recycle scenario end-to-end: two
    sequential asyncio.run() loops (CPython may allocate the second
    loop at the first's address) must each get live sockets."""
    server = snapserve.start_local_server()
    root = _mem_root("pool2")
    payload = b"y" * 2048
    backend = url_to_storage_plugin(root)
    try:
        asyncio.run(backend.write(IOReq(path="obj", data=payload)))
    finally:
        backend.close()
    try:
        plugin = snapserve.SnapServePlugin(f"{server.addr}/{root}")
        try:
            for _ in range(3):

                async def _read():
                    req = IOReq(path="obj")
                    await plugin.read(req)
                    return bytes(req.data)

                assert asyncio.run(_read()) == payload
            before = snapserve.stats_snapshot()["fallback_objects"]
            assert (
                snapserve.stats_snapshot()["fallback_objects"] == before
            )
        finally:
            plugin.close()
    finally:
        server.stop()


def test_conn_pool_skips_closing_conns_on_checkout():
    server = snapserve.start_local_server()
    try:
        plugin = snapserve.SnapServePlugin(
            f"{server.addr}/memory://pool-test/y"
        )
        try:
            log = []
            closing = (object(), _FakeWriter(log, closing=True))
            addr = server.addr

            async def _use():
                pool = plugin._pool(addr)
                pool.append(closing)
                conn = await plugin._checkout(addr)
                assert conn is not closing
                plugin._checkin(addr, conn)

            asyncio.run(_use())
            assert "abort" in log
        finally:
            plugin.close()
    finally:
        server.stop()


# ----------------------------------------------------------- fleet plugin


def test_env_fleet_addrs_merge_additively(monkeypatch):
    lf = sv_fleet.start_local_fleet(n=2)
    try:
        a0, a1 = lf.addrs
        monkeypatch.setenv(
            sv_fleet.FLEET_ADDRS_ENV_VAR, f"{a1},{a0}"
        )
        plugin = snapserve.SnapServePlugin(f"{a0}/memory://env-merge/x")
        try:
            # URL seed first, env members appended without duplicates.
            assert plugin._addrs == [a0, a1]
            assert plugin._fleet is not None
        finally:
            plugin.close()
    finally:
        lf.stop()


def test_single_server_url_keeps_legacy_single_path():
    server = snapserve.start_local_server()
    try:
        plugin = snapserve.SnapServePlugin(
            f"{server.addr}/memory://legacy/x"
        )
        try:
            assert plugin._fleet is None
        finally:
            plugin.close()
    finally:
        server.stop()
