"""The port's restore fast lane, held to the JAX package's.

The staging-buffer pool (exact-size reuse, the once-only budget
re-credit, holds that keep a buffer out of the pool while a copy reads
it), the H2D pipeline (transfers off the consume wall, errors surfaced
before anything is published, no deadlock at depth 1), split and
streamed reads with their budget releases, the scheduler's deferred
costs, device budget and bounded force-admit, and the leaf-atomic
publish: a restore that fails on a corrupt chunk or a failed transfer
leaves the template untouched in both packages, and the retry is
bit-exact. Cross-package restores run with both packages at 256 KiB
chunks and a 64 KiB read threshold, so streaming and split reads are
engaged on both sides.
"""

import asyncio
import threading
import time
from concurrent.futures import Future

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torch_rank_workers as workers
import torchsnapshot_tpu as jsnap
from torchsnapshot_tpu import io_preparer as jiop
from torchsnapshot_tpu import staging_pool as jpool
from torchsnapshot_tpu.ops.transfer import H2DPipeline as JaxH2DPipeline
from torchsnapshot_tpu_torch import Snapshot, StateDict
from torchsnapshot_tpu_torch import io_preparer as iop
from torchsnapshot_tpu_torch import scheduler as sched
from torchsnapshot_tpu_torch import snapshot as psnap
from torchsnapshot_tpu_torch import staging_pool
from torchsnapshot_tpu_torch.io_types import BufferConsumer, IOReq, ReadReq
from torchsnapshot_tpu_torch.manifest import ArrayEntry
from torchsnapshot_tpu_torch.ops import transfer
from torchsnapshot_tpu_torch.ops.transfer import H2DPipeline
from torchsnapshot_tpu_torch.serialization import compute_checksum
from torchsnapshot_tpu_torch.storage_plugins import fs as fs_plugin
from torchsnapshot_tpu_torch.storage_plugins.memory import MemoryStoragePlugin
from torchsnapshot_tpu_torch.telemetry import consume_profile as _cprof
from torchsnapshot_tpu_torch.utils.test_utils import run_multiprocess

CHUNK = 256 << 10
THRESHOLD = 64 << 10


class _JaxHolder:
    def __init__(self, sd):
        self.sd = sd

    def state_dict(self):
        return self.sd

    def load_state_dict(self, sd):
        self.sd = sd


@pytest.fixture(autouse=True)
def _fresh_pools():
    staging_pool.reset_staging_pool()
    jpool.reset_staging_pool()
    yield
    staging_pool.reset_staging_pool()
    jpool.reset_staging_pool()


@pytest.fixture
def small_scale(monkeypatch):
    """256 KiB chunks and 64 KiB sub-reads in both packages: a MiB-sized
    array walks the machinery a GiB-sized one hits at the defaults."""
    monkeypatch.setattr(iop, "MAX_CHUNK_SIZE_BYTES", CHUNK)
    monkeypatch.setattr(jiop, "MAX_CHUNK_SIZE_BYTES", CHUNK)
    monkeypatch.setenv("TPUSNAPSHOT_PARALLEL_READ_THRESHOLD", str(THRESHOLD))


def _arr(shape, seed=0, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _port_take(path, arrays):
    Snapshot.take(path, {"m": StateDict(**{k: torch.from_numpy(v.copy()) for k, v in arrays.items()})})


def _port_zeros(arrays):
    return StateDict(**{k: torch.zeros(v.shape, dtype=torch.from_numpy(v[:0]).dtype) for k, v in arrays.items()})


def _jax_take(path, arrays, **kwargs):
    jsnap.Snapshot.take(
        path, {"m": _JaxHolder({k: jnp.asarray(v) for k, v in arrays.items()})}, **kwargs
    )


def _reports(monkeypatch):
    """Every restore's collected consume-profile block, in order."""
    blocks = []
    collect = _cprof.collect

    def keep(token, consume_s=None):
        block = collect(token, consume_s)
        blocks.append(block)
        return block

    monkeypatch.setattr(_cprof, "collect", keep)
    return blocks


def _in_consume_seconds(block):
    return sum(
        e["seconds"] for n, e in block["substeps"].items()
        if n not in _cprof.OVERLAP_SUBSTEPS
    )


# ------------------------------------------------------------ staging pool


def test_pool_reuses_exact_size_buffers():
    pool = staging_pool.StagingPool(capacity_bytes=1 << 20)
    a = pool.acquire(4096)
    backing = a.buffer.data_ptr()
    a.release()
    b = pool.acquire(4096)
    assert b.buffer.data_ptr() == backing  # exact-size reuse, no allocation
    assert pool.stats()["in_use_bytes"] == 4096
    c = pool.acquire(8192)  # another size: a miss
    b.release()
    c.release()
    stats = pool.stats()
    assert (stats["hits"], stats["misses"], stats["in_use_bytes"]) == (1, 2, 0)
    assert stats["free_bytes"] == 4096 + 8192


def test_pool_budget_recredit_fires_exactly_once():
    pool = staging_pool.StagingPool(capacity_bytes=1 << 20)
    credits = []
    lease = pool.acquire(8192)
    lease.set_budget_release(credits.append, 8192)
    lease.release()
    lease.release()  # idempotent
    assert credits == [8192]
    # A releaser attached after the return fires at once, still once.
    lease2 = pool.acquire(8192)
    lease2.release()
    late = []
    lease2.set_budget_release(late.append, 8192)
    assert late == [8192]


def test_lease_returns_only_after_every_hold_drops():
    """A reader (an in-flight copy) holds the lease: release() marks it,
    the buffer and its budget re-credit return with the last drop."""
    pool = staging_pool.StagingPool(capacity_bytes=1 << 20)
    credits = []
    lease = pool.acquire(4096)
    lease.set_budget_release(credits.append, 4096)
    lease.hold()
    lease.hold()
    lease.release()
    assert credits == [] and pool.stats()["in_use_bytes"] == 4096
    other = pool.acquire(4096)
    assert other.buffer.data_ptr() != lease.buffer.data_ptr()
    lease.drop()
    assert credits == []
    lease.drop()
    assert credits == [4096] and pool.stats()["in_use_bytes"] == 4096
    with pytest.raises(RuntimeError, match="after it returned"):
        lease.hold()
    other.release()


def test_pipeline_holds_the_lease_until_the_copy_lands():
    pool = staging_pool.StagingPool(capacity_bytes=1 << 20)
    lease = pool.acquire(4096)
    lease.buffer.fill_(7)
    dst = torch.zeros(4096, dtype=torch.uint8)
    gate = threading.Event()
    engine = H2DPipeline(depth=1)
    fut = engine.submit(lease.buffer, dst, then=gate.wait, lease=lease)
    lease.release()
    time.sleep(0.05)
    assert pool.stats()["in_use_bytes"] == 4096  # still held by the copy
    gate.set()
    fut.result(timeout=10)
    assert pool.stats()["in_use_bytes"] == 0
    assert torch.equal(dst, torch.full((4096,), 7, dtype=torch.uint8))


def test_pool_disabled_by_env(monkeypatch):
    monkeypatch.setenv("TPUSNAPSHOT_RESTORE_STAGING_POOL_BYTES", "0")
    staging_pool.reset_staging_pool()
    assert staging_pool.get_staging_pool() is None
    lease = staging_pool.acquire(64)
    assert lease.buffer.numel() == 64
    lease.release()


def test_pool_capacity_wait_notes_pool_wait_and_never_deadlocks():
    pool = staging_pool.StagingPool(capacity_bytes=4096, max_wait_s=0.2)
    profile = _cprof.ConsumeProfile()
    first = pool.acquire(4096)
    t = threading.Timer(0.05, first.release)
    t.start()
    with _cprof.consume_section():
        second = pool.acquire(4096, profile)
    t.join()
    assert second.buffer.data_ptr() == first.buffer.data_ptr()
    waited = profile.summary().get("pool_wait")
    assert waited and waited["seconds"] > 0
    # At capacity with no release coming: the bounded wait expires and
    # the pool allocates past the cap rather than deadlock.
    third = pool.acquire(4096, profile)
    assert third.buffer.data_ptr() != second.buffer.data_ptr()
    assert pool.stats()["waits"] == 2
    second.release()
    third.release()


def test_pool_retains_free_bytes_only_up_to_capacity():
    pool = staging_pool.StagingPool(capacity_bytes=8192, max_wait_s=0.05)
    leases = [pool.acquire(4096) for _ in range(3)]  # the third overflows
    for lease in leases:
        lease.release()
    assert pool.stats()["free_bytes"] <= 8192


# --------------------------------------------------- split and streamed reads


class _LeaseSink(BufferConsumer):
    """An inner consumer of a split read: keeps the assembled bytes."""

    def __init__(self, sink):
        self.sink = sink

    async def consume_buffer(self, buf, executor=None):
        raise AssertionError("a split state hands its inner consumer the lease")

    async def consume_lease(self, lease, executor=None):
        self.sink["payload"] = lease.buffer.numpy().tobytes()

    def get_consuming_cost_bytes(self):
        return 10


@pytest.mark.parametrize("pool_bytes", [1 << 20, 0], ids=["pooled", "unpooled"])
def test_split_state_releases_assembly_cost_once(monkeypatch, pool_bytes):
    """N sub-reads share one assembly buffer: the first carries its cost
    as deferred, and the releaser fires once, when the buffer goes back
    (to the pool, or freed), not per sub-read."""
    monkeypatch.setenv("TPUSNAPSHOT_RESTORE_STAGING_POOL_BYTES", str(pool_bytes))
    staging_pool.reset_staging_pool()
    sink = {}
    state = iop._SplitObjectReadState(10, _LeaseSink(sink))
    reqs = state.add_sub_reads("p", 4)
    assert [r.byte_range for r in reqs] == [(0, 4), (4, 8), (8, 10)]
    consumers = [r.buffer_consumer for r in reqs]
    assert [c.get_deferred_cost_bytes() for c in consumers] == [10, 0, 0]
    assert [c.get_consuming_cost_bytes() for c in consumers] == [14, 4, 2]
    assert {c.sort_key_bytes for c in consumers} == {10}
    credits = []
    consumers[0].set_cost_releaser(credits.append)

    async def _run():
        await consumers[0].consume_buffer(b"aaaa")
        await consumers[1].consume_buffer(b"bbbb")
        assert credits == []  # buffer still leased: reservation held
        await consumers[2].consume_buffer(b"cc")

    asyncio.run(_run())
    assert credits == [10]
    assert sink["payload"] == b"aaaabbbbcc"
    if pool_bytes:
        assert staging_pool.get_staging_pool().stats()["free_bytes"] >= 10


def test_pooled_state_stores_lease_before_anything_else(monkeypatch):
    """``_ensure_buf`` makes the lease reachable from the state before
    anything can raise, so the release path still returns it and fires
    the re-credit the lease never got, exactly once."""

    class _Lease:
        def __init__(self):
            self.released = False
            self._cb = None
            self._n = 0

        def release(self):
            self.released = True
            cb, self._cb = self._cb, None
            if cb is not None:
                cb(self._n)

        def set_budget_release(self, cb, nbytes):
            if self.released:
                cb(nbytes)
            else:
                self._cb, self._n = cb, nbytes

    lease = _Lease()

    def acquire(nbytes, profile=None, pinned=False):
        return lease

    monkeypatch.setattr(staging_pool, "acquire", acquire)
    state = iop._SplitObjectReadState(64, _LeaseSink({}))
    credits = []
    state.set_cost_releaser(credits.append)

    async def _boom():
        await state.absorb(0, 64, b"x" * 64)  # the fake lease has no buffer

    with pytest.raises(AttributeError):
        asyncio.run(_boom())
    assert state._lease is lease
    state._release_assembly_buffer()
    assert lease.released and credits == [64]
    state._release_assembly_buffer()
    assert credits == [64]


def _plan_for(arr, template):
    entry = ArrayEntry(
        location="p", serializer="buffer_protocol", dtype="float32",
        shape=list(arr.shape), replicated=False, checksum=compute_checksum(arr.tobytes()),
    )
    return iop.ArrayRestorePlan(entry, template, lambda v: None)


def test_streaming_split_defers_per_part_and_releases_on_drain():
    """A streamed part's reservation is released once both of its holds
    drop (the crc stash and the transfer), out of order too; the parts
    land at their offsets and the plan completes once."""
    data = np.arange(4, dtype=np.float32)
    template = torch.zeros(4)
    plan = _plan_for(data, template)
    plan._outstanding = 1
    done = []
    plan.finalize = lambda: done.append(1)
    raw = data.tobytes()
    state = iop._StreamingSplitState(plan, 16, 0, compute_checksum(raw))
    c0, c1 = (r.buffer_consumer for r in state.add_sub_reads("p", 8))
    assert c0.get_consuming_cost_bytes() == 8  # no assembly buffer
    assert c0.get_deferred_cost_bytes() == c1.get_deferred_cost_bytes() == 8
    released = []
    c0.set_cost_releaser(released.append)

    async def _run():
        await c1.consume_buffer(raw[8:16])  # out of order: stashed
        await c0.consume_buffer(raw[0:8])

    asyncio.run(_run())
    deadline = time.monotonic() + 30
    while not done and time.monotonic() < deadline:
        time.sleep(0.005)
    assert done == [1]
    assert sum(released) == 16
    assert torch.equal(plan.region.buffer, torch.from_numpy(data))
    assert not torch.equal(template, torch.from_numpy(data))  # nothing published


# ---------------------------------------------------------------- scheduler


def test_deferred_cost_held_until_release():
    """A consumer's deferred reservation stays charged after its consume
    completes: a same-cost read behind it is admitted only once the
    releaser fires."""
    events = []

    class _Deferred(BufferConsumer):
        def __init__(self, gate):
            self.gate = gate
            self._release = None

        async def consume_buffer(self, buf, executor=None):
            events.append("A consumed")

            async def _later():
                await self.gate.wait()
                events.append("released")
                self._release(150)

            asyncio.ensure_future(_later())

        def get_consuming_cost_bytes(self):
            return 150

        def get_deferred_cost_bytes(self):
            return 150

        def set_cost_releaser(self, release):
            self._release = release

    class _Gated(BufferConsumer):
        def __init__(self, gate):
            self.gate = gate

        async def consume_buffer(self, buf, executor=None):
            self.gate.set()
            await asyncio.sleep(0.02)
            events.append("C consumed")

        def get_consuming_cost_bytes(self):
            return 150

        def get_deferred_cost_bytes(self):
            return 150

    class _Recording(BufferConsumer):
        async def consume_buffer(self, buf, executor=None):
            events.append("B consumed")

        def get_consuming_cost_bytes(self):
            return 150

    async def _run():
        storage = MemoryStoragePlugin()
        for p in ("a", "b", "c"):
            await storage.write(IOReq(path=p, data=b"x"))
        gate = asyncio.Event()
        reqs = [
            ReadReq(path="a", buffer_consumer=_Deferred(gate)),
            ReadReq(path="c", buffer_consumer=_Gated(gate)),
            ReadReq(path="b", buffer_consumer=_Recording()),
        ]
        await sched.execute_read_reqs(reqs, storage, memory_budget_bytes=350, rank=0)

    asyncio.run(_run())
    assert events.index("released") < events.index("B consumed")


class _DevConsumer(BufferConsumer):
    def __init__(self, events, name, dcost, hold_s=0.0, release_after=None):
        self.events = events
        self.name = name
        self.dcost = dcost
        self.hold_s = hold_s
        self.release_after = release_after
        self._release = None

    async def consume_buffer(self, buf, executor=None):
        self.events.append(f"start {self.name}")
        if self.hold_s:
            await asyncio.sleep(self.hold_s)
        if self.release_after is not None:
            self._release(self.release_after)
            self.events.append(f"release {self.name}")
        self.events.append(f"end {self.name}")

    def get_consuming_cost_bytes(self):
        return 1

    def get_device_cost_bytes(self):
        return self.dcost

    def set_device_cost_releaser(self, release):
        self._release = release


class _OrderedStorage(MemoryStoragePlugin):
    """Reads complete in the order of their delays."""

    def __init__(self, delays):
        super().__init__()
        self._delays = delays

    async def read(self, io_req):
        await asyncio.sleep(self._delays.get(io_req.path, 0.0))
        await super().read(io_req)


def test_scheduler_device_budget_gates_consume_dispatch():
    """A consume with device cost waits while the device budget is spent
    and another consume is in flight; one without device cost skips past
    it; the releaser re-admits it."""
    events = []

    async def _run():
        storage = _OrderedStorage({"a": 0.0, "c": 0.01, "b": 0.02})
        for p in ("a", "b", "c"):
            await storage.write(IOReq(path=p, data=b"x"))
        reqs = [
            ReadReq("a", _DevConsumer(events, "A", 80, hold_s=0.05, release_after=80)),
            ReadReq("b", _DevConsumer(events, "B", 50)),
            ReadReq("c", _DevConsumer(events, "C", 0)),
        ]
        stats = {}
        await sched.execute_read_reqs(
            reqs, storage, memory_budget_bytes=1 << 20, rank=0,
            device_budget_bytes=100, stats=stats,
        )
        return stats

    stats = asyncio.run(_run())
    assert events.index("release A") < events.index("start B")
    assert events.index("start C") < events.index("start B")
    assert stats["device_budget_bytes"] == 100
    assert stats["device_high_water_bytes"] == 80


def test_force_admit_is_bounded_by_one_consume(monkeypatch):
    """Consumes larger than the whole device budget still run, one at a
    time: with nothing in flight the head is force-admitted (after the
    straggler grace), so the overrun never exceeds one consume's bytes."""
    monkeypatch.setattr(sched, "_FORCE_ADMIT_GRACE_S", 0.02)
    events = []

    async def _run():
        storage = MemoryStoragePlugin()
        for p in ("a", "b", "c"):
            await storage.write(IOReq(path=p, data=b"x"))
        reqs = [ReadReq(p, _DevConsumer(events, p, 150, release_after=150)) for p in "abc"]
        stats = {}
        await sched.execute_read_reqs(
            reqs, storage, memory_budget_bytes=1 << 20, rank=0,
            device_budget_bytes=100, stats=stats,
        )
        return stats

    stats = asyncio.run(_run())
    assert stats["device_high_water_bytes"] == 150  # budget + one consume's overrun
    for p in "abc":
        assert events.index(f"start {p}") + 2 == events.index(f"end {p}")


def test_largest_object_first_keeps_split_groups_together():
    order = []

    class _Sized(BufferConsumer):
        def __init__(self, name, cost, key=None):
            self.name, self.cost = name, cost
            if key is not None:
                self.sort_key_bytes = key

        async def consume_buffer(self, buf, executor=None):
            order.append(self.name)

        def get_consuming_cost_bytes(self):
            return self.cost

    class _OneAtATime(MemoryStoragePlugin):
        max_read_concurrency = 1

    async def _run():
        storage = _OneAtATime()
        await storage.write(IOReq(path="x", data=b"x"))
        reqs = [
            ReadReq("x", _Sized("small", 5)),
            # A split object of 30 bytes: its first part carries a 30-byte
            # surcharge, which must not float it ahead of its siblings.
            ReadReq("x", _Sized("split0", 40, key=30)),
            ReadReq("x", _Sized("split1", 10, key=30)),
            ReadReq("x", _Sized("whole", 20)),
        ]
        await sched.execute_read_reqs(reqs, storage, memory_budget_bytes=1 << 20, rank=0)

    asyncio.run(_run())
    assert order == ["split0", "split1", "whole", "small"]


def test_device_budget_env_and_probe(monkeypatch):
    """An explicit value wins, 0 is unbounded, a malformed value falls
    through to the probe: 0.9 × (free + the caching allocator's unused
    blocks), at least 256 MiB. A CPU target has no device budget."""
    cuda = torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda d=None: (10 << 30, 80 << 30))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda d=None: 3 << 30)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda d=None: 1 << 30)
    assert iop.get_device_restore_budget_bytes(torch.device("cpu")) is None
    assert iop.get_device_restore_budget_bytes(None) is None
    assert iop.get_device_restore_budget_bytes(cuda) == int(0.9 * (12 << 30))
    monkeypatch.setenv("TPUSNAPSHOT_DEVICE_BUDGET_BYTES", "12345")
    assert iop.get_device_restore_budget_bytes(cuda) == 12345
    monkeypatch.setenv("TPUSNAPSHOT_DEVICE_BUDGET_BYTES", "0")
    assert iop.get_device_restore_budget_bytes(cuda) is None
    monkeypatch.setenv("TPUSNAPSHOT_DEVICE_BUDGET_BYTES", "lots")
    assert iop.get_device_restore_budget_bytes(cuda) == int(0.9 * (12 << 30))
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda d=None: (1 << 20, 80 << 30))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda d=None: 0)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda d=None: 0)
    assert iop.get_device_restore_budget_bytes(cuda) == 256 << 20


# ----------------------------------------------------- restores, one package


def test_streaming_report_moves_h2d_off_the_consume_wall(tmp_path, small_scale, monkeypatch):
    """Every byte reaches the target through the pipeline: h2d_overlap
    carries the payload, and the in-consume sub-steps reconcile with the
    consume wall."""
    blocks = _reports(monkeypatch)
    arrays = {"w": _arr(1 << 18, seed=7), "b": _arr(100, seed=8)}
    path = str(tmp_path / "snap")
    _port_take(path, arrays)
    target = _port_zeros(arrays)
    Snapshot(path).restore({"m": target})
    for k, v in arrays.items():
        assert np.array_equal(target[k].numpy(), v)
    block = blocks[-1]
    assert block is psnap._last_restore_report
    substeps = block["substeps"]
    total = sum(v.nbytes for v in arrays.values())
    assert substeps["h2d_overlap"]["bytes"] == total
    assert _in_consume_seconds(block) == pytest.approx(block["consume_s"], abs=1e-6)
    assert block["h2d_overlap_gbps"] > 0
    report = block["scheduler"]
    assert report["streamed_bytes"] == arrays["w"].nbytes
    assert report["region_bytes"] == total
    assert report["private_bytes"] == arrays["w"].nbytes  # "b" lands in place


def test_chunked_dense_restore_streams_across_objects(tmp_path, monkeypatch):
    """Every chunk object of a chunked dense array streams into the
    leaf's private buffer at its offset, bit-exact."""
    monkeypatch.setattr(iop, "MAX_CHUNK_SIZE_BYTES", 1 << 20)
    monkeypatch.setenv("TPUSNAPSHOT_PARALLEL_READ_THRESHOLD", str(256 << 10))
    puts = []
    submit = H2DPipeline.submit

    def spy(self, src, dst, *args, **kwargs):
        puts.append(dst.numel() * dst.element_size())
        return submit(self, src, dst, *args, **kwargs)

    monkeypatch.setattr(H2DPipeline, "submit", spy)
    arrays = {"w": _arr(1 << 20, seed=1)}  # 4 chunks x 4 sub-reads
    path = str(tmp_path / "snap")
    _port_take(path, arrays)
    target = _port_zeros(arrays)
    Snapshot(path).restore({"m": target})
    assert np.array_equal(target["w"].numpy(), arrays["w"])
    assert sum(puts) == arrays["w"].nbytes and len(puts) == 16


def test_unrun_chunks_assemble_on_host_and_scatter(tmp_path, small_scale):
    """Chunks split along dim 1 are not runs of the target: each is read
    whole (verified, split into pooled sub-reads), never streamed, and
    cut into the box."""
    arrays = {"w": _arr((256, 1024), seed=2)}
    path = str(tmp_path / "snap")
    _port_take(path, arrays)
    target = _port_zeros(arrays)
    Snapshot(path).restore({"m": target})
    assert np.array_equal(target["w"].numpy(), arrays["w"])
    report = psnap._last_restore_report["scheduler"]
    assert report["streamed_bytes"] == 0
    assert staging_pool.get_staging_pool().stats()["in_use_bytes"] == 0


def test_streaming_skipped_for_resharded_templates(tmp_path, small_scale):
    """World 2 restores a JAX snapshot of row blocks into column halves:
    every stored object is cut, so none streams, and each rank's box is
    bit-exact."""
    arr = _arr((512, 512), seed=4)
    path = str(tmp_path / "snap")
    _jax_take(path, {"w": arr}, replicated=["**"])
    run_multiprocess(workers.restore_columns_unstreamed, 2, (path, arr), timeout_s=60)


def test_failed_read_never_publishes_torn_leaf(tmp_path, small_scale, monkeypatch):
    """A storage failure on the 10th of 16 streamed sub-reads fails the
    restore with the template untouched; the retry is bit-exact."""
    arrays = {"w": _arr(1 << 18, seed=5)}
    path = str(tmp_path / "snap")
    _port_take(path, arrays)
    read = fs_plugin.FSStoragePlugin._read_sync
    calls = [0]

    def failing(self, io_req):
        if io_req.path.endswith("m/w__chunk_2"):
            calls[0] += 1
            if calls[0] == 2:
                raise OSError("injected read failure")
        read(self, io_req)

    monkeypatch.setattr(fs_plugin.FSStoragePlugin, "_read_sync", failing)
    monkeypatch.setenv("TPUSNAPSHOT_STORAGE_RETRIES", "0")
    target = _port_zeros(arrays)
    with pytest.raises(OSError, match="injected read failure"):
        Snapshot(path).restore({"m": target})
    assert int(torch.count_nonzero(target["w"])) == 0
    monkeypatch.setattr(fs_plugin.FSStoragePlugin, "_read_sync", read)
    Snapshot(path).restore({"m": target})
    assert np.array_equal(target["w"].numpy(), arrays["w"])


def test_concurrent_restores_share_pool_without_cross_attribution(tmp_path, small_scale, monkeypatch):
    """Two restores at once draw from the one pool; each profile still
    reconciles with its own consume wall, and every lease comes back."""
    monkeypatch.setenv("TPUSNAPSHOT_RESTORE_STAGING_POOL_BYTES", str(8 << 20))
    staging_pool.reset_staging_pool()
    blocks = _reports(monkeypatch)
    roots, states = [], []
    for i in range(2):
        root = str(tmp_path / f"snap{i}")
        arrays = {"w": _arr((96, 2048), seed=20 + i), "v": _arr(3 << 16, seed=30 + i)}
        _port_take(root, arrays)
        roots.append(root)
        states.append(arrays)
    errors = []

    def _restore(root, arrays):
        try:
            target = _port_zeros(arrays)
            Snapshot(root).restore({"m": target})
            for k, v in arrays.items():
                assert np.array_equal(target[k].numpy(), v)
        except Exception as e:  # reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=_restore, args=rs) for rs in zip(roots, states)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(blocks) == 2
    for block in blocks:
        assert _in_consume_seconds(block) == pytest.approx(block["consume_s"], abs=1e-6)
    assert staging_pool.get_staging_pool().stats()["in_use_bytes"] == 0


def test_depth_one_engine_never_deadlocks_finalize(tmp_path, small_scale, monkeypatch):
    """At TPUSNAPSHOT_H2D_DEPTH=1 a finalize triggered on the pipeline's
    only worker hops to the finalize pool instead of blocking it."""
    monkeypatch.setenv("TPUSNAPSHOT_H2D_DEPTH", "1")
    transfer._reset_h2d_pipeline_for_tests()
    try:
        arrays = {"a": _arr(1 << 17, seed=31), "b": _arr(1 << 17, seed=32)}
        path = str(tmp_path / "snap")
        _port_take(path, arrays)
        target = _port_zeros(arrays)
        done = []

        def _run():
            Snapshot(path).restore({"m": target})
            done.append(1)

        t = threading.Thread(target=_run)
        t.start()
        t.join(timeout=120)
        assert done == [1], "restore deadlocked at H2D depth 1"
        for k, v in arrays.items():
            assert np.array_equal(target[k].numpy(), v)
    finally:
        transfer._reset_h2d_pipeline_for_tests()


def test_read_object_of_a_streamed_leaf(tmp_path, small_scale):
    arrays = {"w": _arr(1 << 18, seed=9)}
    path = str(tmp_path / "snap")
    _port_take(path, arrays)
    got = Snapshot(path).read_object("m/w")
    assert np.array_equal(got.numpy(), arrays["w"])
    got = Snapshot(path).read_object("m/w", template=np.zeros_like(arrays["w"]))
    assert isinstance(got, np.ndarray) and np.array_equal(got, arrays["w"])
    assert psnap._last_restore_report["scheduler"]["streamed_bytes"] == arrays["w"].nbytes


# --------------------------------------------------------- across packages


_CROSS = {
    "streamed": _arr(1 << 18, seed=11),  # 4 chunks, each 4 streamed sub-reads
    "columns": _arr((256, 1024), seed=12),  # chunks cut along dim 1
    "small": _arr((3, 5), seed=13),  # one whole read, in place
    "ints": np.arange(70000, dtype=np.int32),  # one read above the threshold
    "bf16": _arr((300, 700), seed=14, dtype=ml_dtypes.bfloat16),
}


def _to_torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _port_bytes(t):
    return t.contiguous().view(torch.uint8).numpy().tobytes()


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_cross_package_restores_are_bit_exact(tmp_path, small_scale, direction):
    path = str(tmp_path / "snap")
    if direction == "jax_to_port":
        _jax_take(path, _CROSS)
        target = StateDict(**{k: torch.zeros_like(_to_torch(v)) for k, v in _CROSS.items()})
        Snapshot(path).restore({"m": target})
        for k, v in _CROSS.items():
            assert _port_bytes(target[k]) == v.tobytes(), k
        assert psnap._last_restore_report["scheduler"]["streamed_bytes"] > 0
    else:
        Snapshot.take(path, {"m": StateDict(**{k: _to_torch(v) for k, v in _CROSS.items()})})
        holder = _JaxHolder({k: jnp.zeros_like(jnp.asarray(v)) for k, v in _CROSS.items()})
        jsnap.Snapshot(path).restore({"m": holder})
        for k, v in _CROSS.items():
            assert np.asarray(holder.sd[k]).tobytes() == v.tobytes(), k


@pytest.mark.parametrize("threshold", [None, THRESHOLD], ids=["whole_chunks", "streamed_chunks"])
@pytest.mark.parametrize("shape", [(1 << 18,), (256, 1024)], ids=["runs", "columns"])
def test_torn_leaf_in_both_packages(tmp_path, monkeypatch, shape, threshold):
    """The reproduction: a 1 MiB f32 array stored as four 256 KiB chunk
    objects, one byte flipped in chunk 3, restored into zeros. Both
    packages raise the same error and change no element of the template;
    the retry after a repair is bit-exact."""
    monkeypatch.setattr(iop, "MAX_CHUNK_SIZE_BYTES", CHUNK)
    monkeypatch.setattr(jiop, "MAX_CHUNK_SIZE_BYTES", CHUNK)
    if threshold is not None:
        monkeypatch.setenv("TPUSNAPSHOT_PARALLEL_READ_THRESHOLD", str(threshold))
    arr = _arr(shape, seed=17)
    for package in ("jax", "port"):
        path = tmp_path / package
        if package == "jax":
            _jax_take(str(path), {"w": arr})
        else:
            _port_take(str(path), {"w": arr})
        victim = path / "chunked" / "0" / "m" / "w__chunk_3"
        good = victim.read_bytes()
        raw = bytearray(good)
        raw[1000] ^= 0x55
        victim.write_bytes(bytes(raw))
        errors = []
        for restorer in ("jax", "port"):
            if restorer == "jax":
                holder = _JaxHolder({"w": jnp.zeros(shape, jnp.float32)})
                with pytest.raises(RuntimeError, match="Checksum mismatch") as info:
                    jsnap.Snapshot(str(path)).restore({"m": holder})
                changed = int(np.count_nonzero(np.asarray(holder.sd["w"])))
            else:
                target = StateDict(w=torch.zeros(shape))
                with pytest.raises(RuntimeError, match="Checksum mismatch") as info:
                    Snapshot(str(path)).restore({"m": target})
                changed = int(torch.count_nonzero(target["w"]))
            errors.append(info.type)
            assert changed == 0, (package, restorer, changed)
        assert errors[0] is errors[1]
        victim.write_bytes(good)
        target = StateDict(w=torch.zeros(shape))
        Snapshot(str(path)).restore({"m": target})
        assert np.array_equal(target["w"].numpy(), arr)


@pytest.mark.parametrize("kind", ["content_chunks", "compressed"])
def test_torn_dedup_leaf_in_both_packages(tmp_path, monkeypatch, kind):
    """The torn-leaf reproduction on the deduplication paths: a 1 MiB f32
    leaf stored as 4 KiB content chunks of the run's chunk store, or as
    four zlib-compressed 256 KiB chunk objects, with one stored byte
    flipped, restored into zeros by both packages. Both raise, and neither
    changes an element of the template."""
    monkeypatch.setenv("TPUSNAPSHOT_CHUNK_BYTES", "4096")
    if kind == "compressed":
        monkeypatch.setattr(iop, "MAX_CHUNK_SIZE_BYTES", CHUNK)
        monkeypatch.setattr(jiop, "MAX_CHUNK_SIZE_BYTES", CHUNK)
    arr = _arr((1 << 18,), seed=23)
    kwargs = {"chunks": True} if kind == "content_chunks" else {"compression": "zlib"}
    for package in ("jax", "port"):
        path = tmp_path / package / "step-1"
        if package == "jax":
            _jax_take(str(path), {"w": arr}, **kwargs)
        else:
            Snapshot.take(str(path), {"m": StateDict(w=torch.from_numpy(arr.copy()))}, **kwargs)
        if kind == "content_chunks":
            victim = sorted((tmp_path / package / ".chunkstore" / "objects").glob("*/*"))[7]
        else:
            victim = path / "chunked" / "0" / "m" / "w__chunk_3"
        good = victim.read_bytes()
        raw = bytearray(good)
        raw[len(raw) // 2] ^= 0x55
        victim.write_bytes(bytes(raw))
        for restorer in ("jax", "port"):
            if restorer == "jax":
                holder = _JaxHolder({"w": jnp.zeros(arr.shape, jnp.float32)})
                with pytest.raises(Exception, match="corrupt|Checksum"):
                    jsnap.Snapshot(str(path)).restore({"m": holder})
                changed = int(np.count_nonzero(np.asarray(holder.sd["w"])))
            else:
                target = StateDict(w=torch.zeros(arr.shape))
                with pytest.raises(RuntimeError, match="corrupt|Checksum"):
                    Snapshot(str(path)).restore({"m": target})
                changed = int(torch.count_nonzero(target["w"]))
            assert changed == 0, (kind, package, restorer, changed)
        victim.write_bytes(good)
        target = StateDict(w=torch.zeros(arr.shape))
        Snapshot(str(path)).restore({"m": target})
        assert np.array_equal(target["w"].numpy(), arr)


def test_injected_transfer_failure_in_both_packages(tmp_path, small_scale, monkeypatch):
    """The third H2D submit fails: each package surfaces the error from
    the plan before it publishes, the template is untouched, and the
    retry without the fault is bit-exact."""
    arr = _arr(1 << 17, seed=19)  # 512 KiB: eight streamed sub-reads
    path = str(tmp_path / "snap")
    _port_take(path, {"w": arr})

    def failing(orig):
        calls = [0]

        def submit(self, *args, **kwargs):
            calls[0] += 1
            if calls[0] == 3:
                fut = Future()
                fut.set_exception(RuntimeError("injected transfer failure"))
                return fut
            return orig(self, *args, **kwargs)

        return submit

    monkeypatch.setattr(H2DPipeline, "submit", failing(H2DPipeline.submit))
    monkeypatch.setattr(JaxH2DPipeline, "submit", failing(JaxH2DPipeline.submit))
    target = StateDict(w=torch.zeros(arr.shape))
    with pytest.raises(RuntimeError, match="injected transfer failure"):
        Snapshot(path).restore({"m": target})
    assert int(torch.count_nonzero(target["w"])) == 0
    holder = _JaxHolder({"w": jnp.zeros(arr.shape, jnp.float32)})
    with pytest.raises(RuntimeError, match="injected transfer failure"):
        jsnap.Snapshot(path).restore({"m": holder})
    assert int(np.count_nonzero(np.asarray(holder.sd["w"]))) == 0
    monkeypatch.undo()
    monkeypatch.setattr(iop, "MAX_CHUNK_SIZE_BYTES", CHUNK)
    monkeypatch.setenv("TPUSNAPSHOT_PARALLEL_READ_THRESHOLD", str(THRESHOLD))
    Snapshot(path).restore({"m": target})
    assert np.array_equal(target["w"].numpy(), arr)


@pytest.mark.parametrize("spec", [("tp", None), (None, "tp")], ids=["rows", "columns"])
def test_elastic_world2_to_world1_across_packages(tmp_path, small_scale, spec):
    """A world-2 sharded snapshot, taken by the JAX package on a
    2-device mesh and by the port's two spawned ranks, restores at world
    1 through the other package (and the port), bit-exact, with streamed
    and split reads engaged."""
    arr = _arr((1024, 256), seed=23)
    jpath, ppath = str(tmp_path / "jax"), str(tmp_path / "port")
    mesh2 = Mesh(np.array(jax.devices()[:2]), ("tp",))
    jsnap.Snapshot.take(
        jpath,
        {"m": _JaxHolder({"w": jax.device_put(jnp.asarray(arr), NamedSharding(mesh2, P(*spec)))})},
    )
    run_multiprocess(workers.take_chunked, 2, (ppath, arr, spec, CHUNK), timeout_s=60)
    for path in (jpath, ppath):
        target = StateDict(w=torch.zeros(arr.shape))
        Snapshot(path).restore({"m": target})
        assert np.array_equal(target["w"].numpy(), arr), path
        report = psnap._last_restore_report["scheduler"]
        if spec == ("tp", None):
            assert report["streamed_bytes"] == arr.nbytes
        holder = _JaxHolder({"w": jnp.zeros(arr.shape, jnp.float32)})
        jsnap.Snapshot(path).restore({"m": holder})
        assert np.asarray(holder.sd["w"]).tobytes() == arr.tobytes(), path
