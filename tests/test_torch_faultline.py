"""The port's faultline against the JAX package's: the fault-injection
plugin, scriptable schedules, the three storage seams (the plugin wrap
hook under the retry layer, the storage-op hooks, the fs sub-steps),
torn writes, latency, stale-tmp cleanup, and rank faults for the
coordinator's collectives: the 19 tests of ``tests/test_faultline.py``,
and ``test_snapmem.py::test_mem_pressure_fault_trips_overcommit``.

Added here: the same manager cycle gives the same storage-op stream in
both packages, telemetry objects included; ``FAULTS_INJECTED`` moves by
exactly ``fault_counts()`` in both; the six hot-tier rules (a slow
drain, a lost or flapped host, a dropped connection, a torn frame, a slow
wire) fire against the port's tier and wire with the JAX package's
counts and outcomes; and the four read-plane rules (a killed server, a
killed or slow fleet member, a slow server) build the JAX package's rules
and fire at a restore's ``snapserve.request`` boundaries in both
packages, with the same counts and outcomes."""

import asyncio
import collections
import os
import re
import subprocess
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jsnap
from torchsnapshot_tpu import faultline as jfl
from torchsnapshot_tpu_torch import CheckpointManager, Snapshot, StateDict
from torchsnapshot_tpu_torch import faultline as fl
from torchsnapshot_tpu_torch import storage_plugin as sp
from torchsnapshot_tpu_torch.coord import DictStore, StoreCoordinator, format_rank_list
from torchsnapshot_tpu_torch.io_types import (
    IOReq,
    RetryingStoragePlugin,
    add_storage_op_hook,
    is_not_found_error,
    is_range_not_satisfiable_error,
    remove_storage_op_hook,
)
from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin
from torchsnapshot_tpu_torch.storage_plugins.memory import MemoryStoragePlugin

pytestmark = pytest.mark.faultline

_BACKOFF = "torchsnapshot_tpu_torch.io_types._RETRY_BACKOFF_INITIAL_S"


def _state(v):
    return {"s": StateDict(w=torch.full((4,), float(v)))}


def _target():
    return {"s": StateDict(w=torch.zeros(4))}


# ------------------------------------------------------------- plugin unit


def test_transient_faults_absorbed_by_retry_layer(monkeypatch):
    """Injected 503s sit UNDER the retry layer: a write under two
    transient failures succeeds, and the controller logged both."""
    monkeypatch.setenv("TPUSNAPSHOT_STORAGE_RETRIES", "3")
    monkeypatch.setattr(_BACKOFF, 0.001)
    sched = fl.FaultSchedule().transient(op="write", times=2)
    with fl.inject(sched) as ctl:
        store = MemoryStoragePlugin()
        plugin = RetryingStoragePlugin(fl.FaultPlugin(store, ctl))
        asyncio.run(plugin.write(IOReq(path="obj", data=b"payload")))
    assert store.store["obj"] == b"payload"
    assert ctl.fault_counts() == {"transient": 2}


def test_permanent_fault_exhausts_retries(monkeypatch):
    monkeypatch.setenv("TPUSNAPSHOT_STORAGE_RETRIES", "2")
    monkeypatch.setattr(_BACKOFF, 0.001)
    sched = fl.FaultSchedule().permanent(op="write", path="obj")
    with fl.inject(sched) as ctl:
        plugin = RetryingStoragePlugin(fl.FaultPlugin(MemoryStoragePlugin(), ctl))
        with pytest.raises(fl.InjectedPermanentError):
            asyncio.run(plugin.write(IOReq(path="obj", data=b"x")))
    assert ctl.fault_counts()["permanent"] == 3  # initial + 2 retries


def test_torn_write_retry_rewrites_whole_object(monkeypatch):
    """A torn write leaves a truncated object visible; the retry layer's
    rewrite must replace it whole (whole-object puts are idempotent)."""
    monkeypatch.setattr(_BACKOFF, 0.001)
    sched = fl.FaultSchedule().torn_write(path="obj", keep_bytes=3)
    with fl.inject(sched) as ctl:
        store = MemoryStoragePlugin()
        plugin = RetryingStoragePlugin(fl.FaultPlugin(store, ctl))
        asyncio.run(plugin.write(IOReq(path="obj", data=b"0123456789")))
    assert store.store["obj"] == b"0123456789"
    assert ctl.fault_counts()["torn"] == 1


def test_torn_write_permanent_leaves_detectable_truncation(monkeypatch):
    monkeypatch.setenv("TPUSNAPSHOT_STORAGE_RETRIES", "0")
    sched = fl.FaultSchedule().torn_write(
        path="obj", keep_bytes=3, then="permanent", times=None
    )
    with fl.inject(sched) as ctl:
        store = MemoryStoragePlugin()
        plugin = RetryingStoragePlugin(fl.FaultPlugin(store, ctl))
        with pytest.raises(fl.InjectedPermanentError):
            asyncio.run(plugin.write(IOReq(path="obj", data=b"0123456789")))
    assert store.store["obj"] == b"012"  # torn, and verifiably short


def test_latency_injection_delays_op():
    sched = fl.FaultSchedule().latency(op="write", seconds=0.05, times=1)
    with fl.inject(sched) as ctl:
        plugin = fl.FaultPlugin(MemoryStoragePlugin(), ctl)
        begin = time.monotonic()
        asyncio.run(plugin.write(IOReq(path="obj", data=b"x")))
        assert time.monotonic() - begin >= 0.05
    assert ctl.fault_counts() == {"latency": 1}


def test_crash_is_base_exception_and_latches():
    """SimulatedCrash must not be absorbable by `except Exception`
    recovery paths, and every op after the crash point dies too."""
    assert not issubclass(fl.SimulatedCrash, Exception)
    sched = fl.FaultSchedule().crash_at(2)
    with fl.inject(sched) as ctl:
        plugin = fl.FaultPlugin(MemoryStoragePlugin(), ctl)
        asyncio.run(plugin.write(IOReq(path="a", data=b"1")))  # op 1: fine
        with pytest.raises(fl.SimulatedCrash):
            asyncio.run(plugin.write(IOReq(path="b", data=b"2")))
        with pytest.raises(fl.SimulatedCrash):
            asyncio.run(plugin.read(IOReq(path="a")))
        plugin.close()  # post-crash close is a silent no-op
    assert ctl.crashed


def test_nth_and_path_glob_targeting():
    sched = fl.FaultSchedule().transient(op="delete", path=".steps/*", nth=2)
    with fl.inject(sched) as ctl:
        plugin = fl.FaultPlugin(MemoryStoragePlugin(), ctl)
        for p in (".steps/1", "payload/x", ".steps/2", ".steps/3"):
            asyncio.run(plugin.write(IOReq(path=p, data=b"1")))
        asyncio.run(plugin.delete(".steps/1"))  # 1st match: passes
        asyncio.run(plugin.delete("payload/x"))  # not a match
        with pytest.raises(fl.InjectedTransientError):
            asyncio.run(plugin.delete(".steps/2"))  # 2nd match: fires
        asyncio.run(plugin.delete(".steps/3"))  # times=1 spent: passes


def test_injected_transient_error_is_cloud_shaped():
    """The injected 429/503 must classify as retryable, NOT as the
    deterministic not-found/range errors the retry layer propagates."""
    for status in (429, 503):
        e = fl.InjectedTransientError(status, "write", "x")
        assert not is_not_found_error(e)
        assert not is_range_not_satisfiable_error(e)


# ----------------------------------------------------------- the seams


def test_wrap_hook_sits_under_retry_layer(tmp_path, monkeypatch):
    """Through ``url_to_storage_plugin``, as a take resolves it: a
    transient fault is absorbed by the real retry policy, and a
    ``SimulatedCrash`` passes straight through it (one attempt)."""
    monkeypatch.setenv("TPUSNAPSHOT_STORAGE_RETRIES", "3")
    monkeypatch.setattr(_BACKOFF, 0.001)
    url = str(tmp_path / "snap")
    with fl.inject(fl.FaultSchedule().transient(op="write", times=2)) as ctl:
        plugin = sp.url_to_storage_plugin(url)
        assert isinstance(plugin, RetryingStoragePlugin)
        assert isinstance(plugin._inner, fl.FaultPlugin)
        asyncio.run(plugin.write(IOReq(path="obj", data=b"payload")))
        plugin.close()
    assert ctl.fault_counts() == {"transient": 2}
    with open(tmp_path / "snap" / "obj", "rb") as f:
        assert f.read() == b"payload"
    with fl.inject(fl.FaultSchedule().crash_on(op="write")) as ctl:
        plugin = sp.url_to_storage_plugin(url)
        with pytest.raises(fl.SimulatedCrash):
            asyncio.run(plugin.write(IOReq(path="obj2", data=b"x")))
        plugin.close()
    assert ctl.fault_counts() == {"crash": 1}  # no retry of a crash
    assert sp.set_plugin_wrap_hook(None) is None  # inject() restored it
    assert not isinstance(sp.url_to_storage_plugin(url)._inner, fl.FaultPlugin)


# --------------------------------------------------------- op-granular hooks


def test_fs_write_emits_substep_boundaries(tmp_path):
    seen = []

    def hook(op, path):
        if op.startswith("fs."):
            seen.append((op, path))

    add_storage_op_hook(hook)
    try:
        plugin = FSStoragePlugin(str(tmp_path))
        asyncio.run(plugin.write(IOReq(path="dir/obj", data=b"x")))
        plugin.close()
    finally:
        remove_storage_op_hook(hook)
    assert [op for op, _ in seen] == [
        "fs.write.tmp",
        "fs.write.fsync",
        "fs.write.rename",
        "fs.write.dirsync",
    ]
    assert all(p == "dir/obj" for _, p in seen)


def test_crash_between_fsync_and_rename_leaves_uncommitted(tmp_path):
    """Crash after the tmp payload is durable but before the rename: the
    final name never appears — a torn PROTOCOL, not a torn object."""
    path = str(tmp_path / "snap")
    sched = fl.FaultSchedule().crash_on(op="fs.write.rename", path="0/s/w")
    with fl.inject(sched):
        with pytest.raises(fl.SimulatedCrash):
            Snapshot.take(path, {"s": StateDict(w=torch.arange(4.0))})
    assert not os.path.exists(os.path.join(path, "0", "s", "w"))
    assert not os.path.exists(os.path.join(path, ".snapshot_metadata"))
    with pytest.raises(FileNotFoundError):
        Snapshot(path).restore({"s": StateDict(w=torch.zeros(4))})


def test_crash_after_marker_rename_still_restorable(tmp_path, monkeypatch):
    """Crash after the step marker's rename sub-step: the marker is
    visible, so invariant arm (a) applies — the step it names restores."""
    monkeypatch.setenv("TPUSNAPSHOT_SWEEP_MIN_AGE_S", "0")
    base = str(tmp_path / "run")
    sched = fl.FaultSchedule().crash_on(op="fs.write.dirsync", path=".steps/0")
    with fl.inject(sched):
        with pytest.raises(fl.SimulatedCrash):
            CheckpointManager(base, max_to_keep=2).save(0, _state(0))
    mgr = CheckpointManager(base)
    assert mgr.all_steps() == [0]
    target = _target()
    assert mgr.restore(target) == 0
    assert torch.equal(target["s"]["w"], torch.zeros(4))


# ------------------------------------------------------- rank-fault injection


def test_barrier_names_rank_that_never_published():
    """A rank whose barrier arrival never becomes visible (process death
    after the local call) must be NAMED by every healthy rank's shared-
    deadline TimeoutError — not hang them, not blame a healthy peer."""
    world = 3
    store = fl.MuteRankStore(DictStore(), rank=1)
    messages = [None] * world

    def run(rank):
        coord = StoreCoordinator(store, rank, world, timeout_s=0.5)
        with pytest.raises(TimeoutError) as exc_info:
            coord.barrier()
        messages[rank] = str(exc_info.value)

    threads = [threading.Thread(target=run, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30.0)
    assert not any(t.is_alive() for t in threads)
    for rank, msg in enumerate(messages):
        assert msg is not None, f"rank {rank} did not time out"
        assert "rank 1" in msg and "never arrived" in msg
        assert "rank 0" not in msg.split("observed by")[0]
    assert store.dropped  # the fault actually fired


def test_all_gather_names_all_stalled_ranks():
    """With TWO muted ranks the error must name both."""
    world = 4
    store = fl.MuteRankStore(
        DictStore(),
        rank=-1,
        patterns=fl.mute_patterns_for_rank(1) + fl.mute_patterns_for_rank(3),
    )
    messages = {}
    lock = threading.Lock()

    def run(rank):
        coord = StoreCoordinator(store, rank, world, timeout_s=0.5)
        with pytest.raises(TimeoutError) as exc_info:
            coord.all_gather_object(rank)
        with lock:
            messages[rank] = str(exc_info.value)

    threads = [threading.Thread(target=run, args=(r,)) for r in (0, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30.0)
    assert not any(t.is_alive() for t in threads)
    for rank in (0, 2):
        msg = messages[rank]
        assert "ranks 1, 3" in msg and "never finished publishing" in msg


def test_partial_chunked_publish_reads_as_never_finished():
    """A rank that dies partway into a chunked publish (head visible,
    parts missing) must read as "never finished publishing", never as
    garbage handed to pickle."""
    world = 2
    big = b"x" * (3 << 20)  # > the coordinator's chunk: the chunked path
    store = fl.MuteRankStore(DictStore(), rank=1, mute_after=1)
    messages = {}

    def run0():
        coord = StoreCoordinator(store, 0, world, timeout_s=0.8)
        with pytest.raises(TimeoutError) as exc_info:
            coord.all_gather_object(b"small")
        messages[0] = str(exc_info.value)

    def run1():
        coord = StoreCoordinator(store, 1, world, timeout_s=0.8)
        with pytest.raises(TimeoutError):
            coord.all_gather_object(big)

    threads = [threading.Thread(target=run0), threading.Thread(target=run1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30.0)
    assert not any(t.is_alive() for t in threads)
    assert "rank 1" in messages[0]
    assert "never finished publishing" in messages[0]


def test_mute_patterns_match_the_coordinators_keys():
    """The muted globs are the keys the port's StoreCoordinator publishes
    through; a ``TorchStore`` namespaces them below the wrapper."""
    seen = []

    class _Recording(DictStore):
        def set(self, key, value):
            seen.append(key)
            super().set(key, value)

    store = _Recording()
    coords = [StoreCoordinator(store, r, 2, timeout_s=5.0) for r in range(2)]

    def run(rank):
        c = coords[rank]
        c.barrier()
        c.all_gather_object(b"x" * ((3 << 20) if rank == 1 else 1))
        c.broadcast_object("v" if rank == 0 else None, src=0)

    threads = [threading.Thread(target=run, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30.0)
    mute = fl.MuteRankStore(DictStore(), rank=1)
    rank1 = [k for k in seen if mute._muted(k)]
    assert {k.split("/")[0] for k in rank1} == {"b", "ag", "bcack"}
    assert any("/part" in k for k in rank1)
    assert not [k for k in seen if k.endswith("/0") and mute._muted(k)]


# ------------------------------------------------------------- op counting


def test_count_storage_ops_is_fault_free():
    store_url = f"memory://countbkt-torch-{os.getpid()}"

    def scenario():
        Snapshot.take(store_url, {"s": StateDict(w=torch.arange(4.0))})

    n = fl.count_storage_ops(scenario)
    assert n > 0
    target = _target()
    Snapshot(store_url).restore(target)
    assert torch.equal(target["s"]["w"], torch.arange(4.0))


def test_fmt_ranks_compresses_contiguous_spans():
    """Pod-scale stalls must read as spans ("ranks 17, 40-63")."""
    assert format_rank_list([17]) == "rank 17"
    assert format_rank_list([1, 3]) == "ranks 1, 3"
    assert format_rank_list([1, 2, 3, 7]) == "ranks 1-3, 7"
    assert format_rank_list([17] + list(range(40, 64))) == "ranks 17, 40-63"


def test_stale_tmp_cleanup_spares_live_writer(tmp_path):
    """Publish-point stale-tmp cleanup removes a DEAD writer's torn tmp
    but never a live concurrent writer's in-flight tmp."""
    proc = subprocess.Popen(["true"])
    proc.wait()
    dead = proc.pid

    plugin = FSStoragePlugin(str(tmp_path))
    os.makedirs(str(tmp_path / ".steps"), exist_ok=True)
    # pid 1 always exists: a live concurrent writer of the same marker.
    live_tmp = str(tmp_path / ".steps" / "5.tmp1")
    dead_tmp = str(tmp_path / ".steps" / f"5.tmp{dead}")
    for p in (live_tmp, dead_tmp):
        with open(p, "wb") as f:
            f.write(b"torn")
    asyncio.run(plugin.write(IOReq(path=".steps/5", data=b"marker")))
    plugin.close()
    assert os.path.exists(live_tmp)
    assert not os.path.exists(dead_tmp)
    with open(str(tmp_path / ".steps" / "5"), "rb") as f:
        assert f.read() == b"marker"


def test_crash_on_close_boundary_skips_deferred_durability():
    """close IS an op boundary: a crash scheduled there dies before the
    inner plugin settles deferred work, and stays dead."""
    sched = fl.FaultSchedule().crash_on(op="close")
    with fl.inject(sched) as ctl:
        plugin = fl.FaultPlugin(MemoryStoragePlugin(), ctl)
        asyncio.run(plugin.write(IOReq(path="a", data=b"1")))
        with pytest.raises(fl.SimulatedCrash):
            plugin.close()
        plugin.close()  # post-crash: silent no-op
    assert ctl.crashed


def test_crashed_fs_plugin_close_settles_no_deferred_fsync(tmp_path, monkeypatch):
    """On the fs backend: after a crash, closing the plugin must not run
    the inner plugin's deferred dirent fsyncs (a dead process never
    settles them)."""
    calls = []
    monkeypatch.setattr(
        "torchsnapshot_tpu_torch.storage_plugins.fs._fsync_dir", calls.append
    )
    sched = fl.FaultSchedule().crash_at(6)  # the 2nd write's first boundary
    with fl.inject(sched) as ctl:
        plugin = sp.url_to_storage_plugin(str(tmp_path))
        asyncio.run(plugin.write(IOReq(path="d/a", data=b"1")))
        with pytest.raises(fl.SimulatedCrash):
            asyncio.run(plugin.write(IOReq(path="d/b", data=b"2")))
        calls.clear()
        plugin.close()
    assert ctl.crashed and calls == []
    assert plugin._inner._inner._dirty_dirs  # left unsettled


# ------------------------------------------------ the read plane's rules


_READ_PLANE_RULES = {
    "kill_server": ((), {"nth": 2}),
    "kill_fleet_member": (("m1",), {"nth": 2}),
    "slow_fleet_member": (("m1",), {"seconds": 0.01}),
    "slow_server": ((), {"seconds": 0.01, "times": 2}),
}


@pytest.mark.parametrize("method", sorted(_READ_PLANE_RULES))
def test_unported_rule_raises_naming_its_item(method):
    """Each read-plane method of the JAX package's ``FaultSchedule`` adds,
    in the port, the rule the JAX package's adds: same kind, boundary,
    count, member and latency."""
    args, kwargs = _READ_PLANE_RULES[method]
    (rule,) = getattr(fl.FaultSchedule(), method)(*args, **kwargs).rules
    (jrule,) = getattr(jfl.FaultSchedule(), method)(*args, **kwargs).rules
    fields = ("kind", "op", "path", "nth", "times", "seconds", "member")
    assert {f: getattr(rule, f) for f in fields} == {f: getattr(jrule, f) for f in fields}
    assert rule.op == "snapserve.request"


def _read_plane_fault_run(pkg, kind, path, arrays):
    """Restore ``path`` through a 2-member in-process fleet of ``pkg``'s
    package under one rule of ``kind``: (fault counts, client stats
    delta, restored leaves)."""
    if pkg == "port":
        from torchsnapshot_tpu_torch import RemoteSnapshot, snapserve
        from torchsnapshot_tpu_torch import wiretap as wiretap_mod
        from torchsnapshot_tpu_torch.snapserve import fleet

        mod_fl, template = fl, {"m": StateDict(**{k: torch.zeros(v.shape) for k, v in arrays.items()})}
    else:
        from torchsnapshot_tpu import snapserve
        from torchsnapshot_tpu import wiretap as wiretap_mod
        from torchsnapshot_tpu.snapserve import RemoteSnapshot, fleet

        mod_fl, template = jfl, {"m": jsnap.StateDict(**{k: np.zeros_like(v) for k, v in arrays.items()})}
    sched = mod_fl.FaultSchedule()
    if kind == "killserver":
        sched.kill_server(nth=2)
    elif kind == "killmember":
        sched.kill_fleet_member("m1", nth=1)
    else:
        sched.slow_fleet_member("m1", seconds=0.01, nth=1)
    lf = fleet.start_local_fleet(n=2)
    try:
        before = snapserve.stats_snapshot()
        with mod_fl.inject(sched) as ctl:
            RemoteSnapshot(path, addr=lf.addr_spec).restore(template)
        after = snapserve.stats_snapshot()
    finally:
        lf.stop()
        for name in fleet.local_member_names():
            fleet.unregister_local_member(name)
        snapserve.kill_local_servers()
        wiretap_mod.reset()
    delta = {k: after[k] - before[k] for k in ("remote_objects", "fallback_objects")}
    return ctl.fault_counts(), delta, {k: np.asarray(template["m"][k]) for k in arrays}


@pytest.mark.parametrize("kind", ["killserver", "killmember", "slowmember"])
def test_unported_rule_kind_cannot_be_constructed(kind, tmp_path, monkeypatch):
    """A rule of each read-plane kind fires at a restore's
    ``snapserve.request`` boundary in both packages: counted once, the
    restore bit-exact; a killed server degrades to direct reads, a
    killed member fails over to its ring replica (no direct read), a
    slow member only slows."""
    monkeypatch.setenv("TPUSNAPSHOT_SNAPSERVE_DOWN_COOLDOWN_S", "0.2")
    rng = np.random.default_rng(9)
    arrays = {f"p{i}": rng.standard_normal(1024).astype(np.float32) for i in range(6)}
    path = str(tmp_path / "snap")
    Snapshot.take(path, {"m": StateDict(**{k: torch.from_numpy(v) for k, v in arrays.items()})})
    runs = {pkg: _read_plane_fault_run(pkg, kind, path, arrays) for pkg in ("port", "jax")}
    for pkg, (counts, delta, got) in runs.items():
        assert counts == {kind: 1}, (pkg, counts)
        for k, v in arrays.items():
            assert got[k].tobytes() == v.tobytes(), (pkg, k)
        if kind == "killserver":
            assert delta["fallback_objects"] > 0, (pkg, delta)
        else:
            assert delta["fallback_objects"] == 0, (pkg, delta)


# ------------------------------------- the hot tier's rules, both packages


@pytest.fixture
def _fresh_tiers(monkeypatch):
    """Both packages' hot tiers empty, no wire fault armed, fast-failing
    wire knobs; in-process peer servers stopped afterwards."""
    from torchsnapshot_tpu import hottier as jhottier
    from torchsnapshot_tpu.hottier import transport as jtransport
    from torchsnapshot_tpu_torch import hottier
    from torchsnapshot_tpu_torch.hottier import transport

    monkeypatch.setenv("TPUSNAPSHOT_REPLICATION_DEADLINE_S", "0.5")
    monkeypatch.setenv("TPUSNAPSHOT_REPLICATION_RETRY_BUDGET_S", "3")
    monkeypatch.setenv("TPUSNAPSHOT_REPLICATION_DOWN_COOLDOWN_S", "0.2")
    monkeypatch.setenv("TPUSNAPSHOT_REPLICATION_CODEC", "none")
    servers = []
    for tier, trans in ((hottier, transport), (jhottier, jtransport)):
        tier.disable_hot_tier(flush=False)
        tier.reset_hot_tier()
        trans.clear_wire_faults()
    yield servers
    for tier, trans in ((hottier, transport), (jhottier, jtransport)):
        tier.disable_hot_tier(flush=False)
        tier.reset_hot_tier()
        trans.clear_wire_faults()
    for server in servers:
        server.stop()
    # The wire tap is process-wide: a later test's live rules must not read
    # this one's RPCs.
    from torchsnapshot_tpu import wiretap as jwiretap
    from torchsnapshot_tpu_torch import wiretap

    wiretap.reset()
    jwiretap.reset()


def _tier_pkg(pkg):
    """The modules of one package a hot-tier fault scenario drives."""
    if pkg == "port":
        from torchsnapshot_tpu_torch import hottier
        from torchsnapshot_tpu_torch.hottier import peer, tier, transport

        return {"fl": fl, "tier": hottier, "ht": tier, "transport": transport, "peer": peer,
                "snap": Snapshot, "state": lambda v: _state(v), "target": _target}
    from torchsnapshot_tpu import hottier
    from torchsnapshot_tpu.hottier import peer, tier, transport

    return {"fl": jfl, "tier": hottier, "ht": tier, "transport": transport, "peer": peer,
            "snap": jsnap.Snapshot,
            "state": lambda v: {"s": jsnap.StateDict(w=jnp.full((4,), float(v)))},
            "target": lambda: {"s": jsnap.StateDict(w=jnp.zeros(4))}}


def _rule_scenario(builder, pkg, servers, root):
    """Take a 4-value state through a k = 2 tier (host 1 a wire peer
    for the wire rules) under one schedule of ``builder``; returns what
    the rule must have done, as comparable values."""
    p = _tier_pkg(pkg)
    build = {
        "slow_drain": lambda s: s.slow_drain(seconds=0.05),
        "lose_host": lambda s: s.lose_host(1, op="write", path=".snapshot_metadata"),
        "flap_host": lambda s: s.flap_host(1, revive_after_ops=2, op="write",
                                           path=".snapshot_metadata"),
        "drop_conn": lambda s: s.drop_conn(host=1, path="host1:*"),
        "torn_frame": lambda s: s.torn_frame(host=1, path="host1:*"),
        "slow_wire": lambda s: s.slow_wire(seconds=1.0, host=1, path="host1:*"),
    }[builder]
    wire_rule = builder in ("drop_conn", "torn_frame", "slow_wire")
    if wire_rule:
        server, _ = p["peer"].start_local_peer(1, capacity_bytes=1 << 24)
        servers.append(server)
    before = p["transport"].wire_stats_snapshot()
    with p["tier"].hot_tier(rank=0, world=2, k=2, drain="manual"):
        with p["fl"].inject(build(p["fl"].FaultSchedule())) as ctl:
            snap = p["snap"].take(root, p["state"](3))
            live_after_take = p["tier"].live_hosts()
            p["tier"].drain_now()
        after = p["transport"].wire_stats_snapshot()
        target = p["target"]()
        snap.restore(target)
        stats = p["tier"].runtime().stats_snapshot()
    np.testing.assert_array_equal(np.asarray(target["s"]["w"]), 3.0)
    wire = {k: after[k] - before[k] for k in ("pushes", "deadline_misses")}
    return {
        "counts": ctl.fault_counts(),
        "live_after_take": sorted(live_after_take),
        "wire": wire if wire_rule else None,
        "retried": (after["retries"] > before["retries"]) if wire_rule else None,
        "write_through": stats["write_through"],
        "fallback_objects": stats["fallback_objects"],
    }


_HOT_TIER_RULES = {
    "slow_drain": {"counts": {"latency": 1}, "live_after_take": [0, 1], "wire": None,
                   "retried": None, "write_through": 0, "fallback_objects": 0},
    "lose_host": {"counts": {"hostloss": 1}, "live_after_take": [0], "wire": None,
                  "retried": None, "write_through": 0, "fallback_objects": 0},
    "flap_host": {"counts": {"flap": 1, "revive": 1}, "live_after_take": [0, 1], "wire": None,
                  "retried": None, "write_through": 0, "fallback_objects": 0},
    "drop_conn": {"counts": {"drop_conn": 1}, "live_after_take": [0, 1],
                  "wire": {"pushes": 1, "deadline_misses": 0}, "retried": True,
                  "write_through": 0, "fallback_objects": 0},
    "torn_frame": {"counts": {"torn_frame": 1}, "live_after_take": [0, 1],
                   "wire": {"pushes": 1, "deadline_misses": 0}, "retried": True,
                   "write_through": 0, "fallback_objects": 0},
    "slow_wire": {"counts": {"slow_wire": 1}, "live_after_take": [0, 1],
                  "wire": {"pushes": 1, "deadline_misses": 1}, "retried": True,
                  "write_through": 0, "fallback_objects": 0},
}


@pytest.mark.parametrize("builder", sorted(_HOT_TIER_RULES))
def test_hot_tier_rule_fires_as_in_jax(builder, tmp_path, _fresh_tiers):
    """Each of the six hot-tier rules fires against the port's tier or
    wire: a slow drain pays its latency at the ``hottier.drain``
    boundary, a lost host is dead after the take (its replica gone, the
    restore served by host 0), a flapped host is lost and back two
    boundaries later, and the three wire faults each strike one push of
    the wire peer (a retry lands it; the slow one misses its deadline
    once). The same schedule gives the same counts and outcomes in the
    JAX package, and every restore is exact."""
    port = _rule_scenario(builder, "port", _fresh_tiers, str(tmp_path / "port" / "step-0"))
    jax_side = _rule_scenario(builder, "jax", _fresh_tiers, str(tmp_path / "jax" / "step-0"))
    assert port == jax_side == _HOT_TIER_RULES[builder]


@pytest.mark.parametrize("kind", ["hostloss", "flap", "drop_conn", "torn_frame", "slow_wire"])
def test_hot_tier_rule_kind_acts_at_its_boundary(kind, _fresh_tiers):
    """A rule of each hot-tier kind, built directly, acts at its
    boundary: a host loss kills in-process host 1, a flap kills it and
    revives it at the boundary its ``revive_after_ops`` names, and a wire
    kind arms exactly one scripted fault for host 1 (which ``inject``'s
    exit clears)."""
    from torchsnapshot_tpu_torch.hottier import tier, transport

    rule = fl.FaultRule(kind=kind, op="x", host=1, revive_after_ops=2, seconds=0.1)
    sched = fl.FaultSchedule()
    sched.rules.append(rule)
    with fl.inject(sched) as ctl:
        ctl.on_op("x", "p")
        if kind in ("hostloss", "flap"):
            assert 1 not in tier.live_hosts()
        else:
            assert transport._SCRIPT == [{"kind": kind, "host": 1, "seconds": 0.1}]
        ctl.on_op("y", "p")
        ctl.on_op("y", "p")
        if kind == "flap":
            assert 1 in tier.live_hosts()
            assert ctl.fault_counts() == {"flap": 1, "revive": 1}
        else:
            assert ctl.fault_counts() == {kind: 1}
    assert transport._SCRIPT == []
    if kind == "hostloss":
        assert 1 not in tier.live_hosts()


def test_public_api_matches_the_jax_package():
    from torchsnapshot_tpu.telemetry.ledger import LEDGER_DIR

    assert sorted(fl.__all__) == sorted(jfl.__all__)
    assert fl.crashpoints.LEDGER_DIR == LEDGER_DIR


# ------------------------------------------------------ op-stream parity


def _op_stream(faultline, scenario):
    """Every storage-op boundary of ``scenario`` as ``(op, path)``: a
    zero-second latency rule on every op records each one."""
    sched = faultline.FaultSchedule().latency(op="*", path="*", seconds=0.0)
    with faultline.inject(sched) as ctl:
        scenario()
    assert len(ctl.records) == ctl.op_index
    return [(r.op, r.path) for r in ctl.records]


def _comparable(ops):
    """The op multiset, telemetry included (the flight reports and the
    ledger's reads and appends). A take's completion markers carry its
    random nonce, which is masked."""
    out = collections.Counter()
    for op, path in ops:
        out[(op, re.sub(r"^\.completed/[0-9a-f]{32}/", ".completed/<nonce>/", path))] += 1
    return out


def test_manager_cycle_op_stream_matches_jax(tmp_path, monkeypatch):
    """The same cycle (three saves with ``max_to_keep=1``, each pruning
    the step before) over the same shapes gives the same multiset of
    storage ops, sub-steps and telemetry objects included, in both
    packages (``_comparable``)."""
    monkeypatch.setenv("TPUSNAPSHOT_SWEEP_MIN_AGE_S", "0")
    w = np.arange(16, dtype=np.float32).reshape(4, 4)

    def cycle(mgr_cls, make):
        def run(base):
            for step in (0, 1, 2):
                mgr_cls(base, max_to_keep=1).save(step, make(step))
        return run

    port = _op_stream(fl, lambda: cycle(CheckpointManager, lambda s: {
        "s": StateDict(w=torch.from_numpy(w + s), b=torch.zeros(3))
    })(str(tmp_path / "port")))
    jax_ops = _op_stream(jfl, lambda: cycle(jsnap.CheckpointManager, lambda s: {
        "s": jsnap.StateDict(w=jnp.asarray(w + s), b=jnp.zeros(3))
    })(str(tmp_path / "jax")))
    got, want = _comparable(port), _comparable(jax_ops)
    assert got == want, (
        f"only in the port: {sorted((got - want).elements())}\n"
        f"only in JAX: {sorted((want - got).elements())}"
    )


# ------------------------------------- a crash surfaces, never absorbed


@pytest.mark.parametrize("nth", [1, 6, 16])
def test_crash_at_nth_read_of_a_restore_leaves_the_template_untouched(
    tmp_path, monkeypatch, nth
):
    """A crash at the nth read of a restore (a 1 MiB leaf in four 256 KiB
    chunks, each in four ranged reads, placed through the H2D pipeline,
    which the host path rides too; the first, a middle and the last) surfaces from ``restore`` as the
    ``SimulatedCrash`` itself, and the template keeps every byte: the
    leaf-atomic publish, through faultline."""
    from torchsnapshot_tpu_torch import io_preparer

    monkeypatch.setattr(io_preparer, "MAX_CHUNK_SIZE_BYTES", 256 << 10)
    monkeypatch.setenv("TPUSNAPSHOT_PARALLEL_READ_THRESHOLD", str(64 << 10))
    path = str(tmp_path / "snap")
    w = torch.arange(1 << 18, dtype=torch.float32)
    Snapshot.take(path, {"s": StateDict(w=w, b=torch.ones(3))})
    target = StateDict(w=torch.full((1 << 18,), -1.0), b=torch.zeros(3))
    before = target["w"].clone()
    with fl.inject(fl.FaultSchedule().crash_on(op="read", path="chunked/0/s/w*", nth=nth)) as ctl:
        with pytest.raises(fl.SimulatedCrash):
            Snapshot(path).restore({"s": target})
    assert ctl.fault_counts() == {"crash": 1}
    assert torch.equal(target["w"], before)


def test_crash_in_an_async_take_surfaces_from_wait(tmp_path):
    """The drain thread stores the crash; ``wait()`` raises it, and the
    snapshot never commits."""
    path = str(tmp_path / "snap")
    with fl.inject(fl.FaultSchedule().crash_on(op="fs.write.rename", path="0/s/w")):
        pending = Snapshot.async_take(path, {"s": StateDict(w=torch.arange(8.0))})
        with pytest.raises(fl.SimulatedCrash):
            pending.wait()
    assert not os.path.exists(os.path.join(path, ".snapshot_metadata"))


# ------------------------------------------------ fault telemetry


def test_injected_faults_emit_trace_instants(tmp_path, monkeypatch):
    """Every injected fault lands in the trace beside the retry layer's
    storage_retry instants (the JAX package's case of the same name)."""
    from torchsnapshot_tpu_torch import tracing
    from torchsnapshot_tpu_torch.storage_plugin import RetryingStoragePlugin

    monkeypatch.setenv("TPUSNAPSHOT_STORAGE_RETRIES", "3")
    monkeypatch.setattr("torchsnapshot_tpu_torch.io_types._RETRY_BACKOFF_INITIAL_S", 0.001)
    trace_path = str(tmp_path / "trace.json")
    tracing.enable(trace_path)
    try:
        sched = fl.FaultSchedule().transient(op="write", path="obj", times=2)
        with fl.inject(sched) as ctl:
            plugin = RetryingStoragePlugin(fl.FaultPlugin(MemoryStoragePlugin(), ctl))
            asyncio.run(plugin.write(IOReq(path="obj", data=b"x")))
    finally:
        tracing.flush()
        tracing.disable()
    import json

    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    faults = [e for e in events if e["name"] == "fault_injected"]
    retries = [e for e in events if e["name"] == "storage_retry"]
    assert len(faults) == 2
    assert {f["args"]["kind"] for f in faults} == {"transient"}
    assert {f["args"]["op"] for f in faults} == {"write"}
    assert all("op_index" in f["args"] for f in faults)
    assert len(retries) == 2
    assert all(r["args"]["error"] == "InjectedTransientError" for r in retries)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_faults_injected_counter_equals_fault_counts(tmp_path, monkeypatch, pkg):
    """``FAULTS_INJECTED{kind}`` moves by exactly ``fault_counts()`` over a
    save with transients, latency and a torn write, in both packages,
    and a take's flight report carries the same counts."""
    monkeypatch.setenv("TPUSNAPSHOT_STORAGE_RETRIES", "4")
    if pkg == "port":
        from torchsnapshot_tpu_torch import telemetry
        from torchsnapshot_tpu_torch.telemetry import metrics as mn

        monkeypatch.setattr("torchsnapshot_tpu_torch.io_types._RETRY_BACKOFF_INITIAL_S", 0.001)
        faultline, snap, state = fl, Snapshot, {"s": StateDict(w=torch.arange(64.0))}
    else:
        from torchsnapshot_tpu import telemetry
        from torchsnapshot_tpu.telemetry import metrics as mn

        monkeypatch.setattr("torchsnapshot_tpu.io_types._RETRY_BACKOFF_INITIAL_S", 0.001)
        faultline, snap = jfl, jsnap.Snapshot
        state = {"s": jsnap.StateDict(w=jnp.arange(64.0))}
    sched = (
        faultline.FaultSchedule()
        .transient(op="write", path="0/s/w", times=2)
        .latency(op="fs.write.tmp", path="*", seconds=0.0, times=3)
    )
    before = telemetry.snapshot()
    with faultline.inject(sched) as ctl:
        snap.take(str(tmp_path / "snap"), state)
    delta = mn.diff_snapshots(before, telemetry.snapshot())
    counted = mn.samples_by_label(delta, mn.FAULTS_INJECTED, "kind")
    assert ctl.fault_counts() == {"transient": 2, "latency": 3}
    assert {k: int(v) for k, v in counted.items()} == ctl.fault_counts()


def test_mem_pressure_fault_trips_overcommit():
    """The JAX package's ``test_snapmem.py`` case of the same name: the
    rule shrinks a domain's reported cap at its op, and the doctor's
    ``host-memory-overcommit`` rule names the domain."""
    from torchsnapshot_tpu_torch.faultline.schedule import FaultController, FaultSchedule
    from torchsnapshot_tpu_torch.telemetry import doctor, memwatch

    memwatch.reset()
    d = memwatch.register("staging_pool", cap_bytes=1 << 20)
    try:
        d.set_used(4096, pinned_bytes=4096)
        ctl = FaultController(FaultSchedule().mem_pressure("staging_pool", 100))
        assert doctor.memory_pressure_finding(memwatch.sample_block()) is None
        ctl.on_op("write", "some/object")
        assert memwatch.snapshot()["domains"]["staging_pool"]["cap_bytes"] == 100
        finding = doctor.memory_pressure_finding(memwatch.sample_block(), source="test")
        assert finding is not None
        assert (finding.rule, finding.severity) == ("host-memory-overcommit", "critical")
        assert finding.evidence["over_cap_domains"][0]["domain"] == "staging_pool"
        token = memwatch.window_begin()
        assert memwatch.reconcile(memwatch.window_collect(token)) == []
        assert ctl.fault_counts() == {"mem_pressure": 1}
    finally:
        d.close()
        memwatch.reset()
