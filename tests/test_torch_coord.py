"""The port's StoreCoordinator over its three stores (DictStore, FileStore
and TorchStore, a c10d TCPStore): collectives, chunked values, key
garbage collection and the timeouts that name the missing ranks — a
subset of tests/test_coord.py — and the same store keys as the JAX
package's coordinator for the same collectives."""

import threading
import time

import pytest
import torch.distributed as dist

from torchsnapshot_tpu import coord as jcoord
from torchsnapshot_tpu_torch.coord import (
    _BC_WINDOW,
    Coordinator,
    DictStore,
    FileStore,
    NoOpCoordinator,
    StoreCoordinator,
    TorchStore,
    barrier_compat,
    format_rank_list,
    get_coordinator,
)

KINDS = ["dict", "file", "torch"]


class _Stores:
    """One store per rank: a DictStore or FileStore is shared by the
    threads; a TCPStore client is not (a blocking wait holds its socket),
    so each rank gets its own client of one server."""

    def __init__(self, kind, tmp_path):
        self.kind = kind
        if kind == "dict":
            self._shared = DictStore()
        elif kind == "file":
            self._shared = FileStore(str(tmp_path / "kv"))
        else:
            self._server = dist.TCPStore("127.0.0.1", 0, is_master=True, wait_for_workers=False)
            self._shared = TorchStore(self._server, prefix="t/")

    def for_rank(self):
        if self.kind != "torch":
            return self._shared
        client = dist.TCPStore("127.0.0.1", self._server.port, is_master=False)
        return TorchStore(client, prefix="t/")

    def key_count(self):
        # The server also holds the c10d clients' own bookkeeping keys.
        return self._shared.key_count()


@pytest.fixture(params=KINDS)
def stores(request, tmp_path):
    return _Stores(request.param, tmp_path)


def _run(stores, world, fn, timeout_s=60):
    per_rank = [stores.for_rank() for _ in range(world)]
    results = [None] * world
    errors = []

    def worker(rank):
        try:
            c = StoreCoordinator(per_rank[rank], rank, world, timeout_s=timeout_s)
            results[rank] = fn(c, rank)
        except BaseException as e:  # raised below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(r,), daemon=True) for r in range(world)]
    deadline = time.monotonic() + timeout_s
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=max(0.0, deadline - time.monotonic()))
    if errors:
        raise errors[0]
    assert not any(t.is_alive() for t in threads)
    return results


def test_collectives(stores):
    def fn(c, r):
        gathered = c.all_gather_object({"rank": r})
        c.barrier()
        return gathered, c.broadcast_object(f"from{r}", src=1), c.all_gather_object(r * 10)

    for gathered, bcast, again in _run(stores, 4, fn):
        assert gathered == [{"rank": i} for i in range(4)]
        assert bcast == "from1"
        assert again == [0, 10, 20, 30]


def test_large_objects_are_chunked(stores):
    big = b"z" * (1300 * 1024)  # three 512 KiB parts

    def fn(c, r):
        return c.all_gather_object(big + bytes([r])), c.broadcast_object(big if r == 2 else None, src=2)

    for gathered, bcast in _run(stores, 3, fn):
        assert gathered == [big + bytes([q]) for q in range(3)]
        assert bcast == big


def test_collective_keys_are_garbage_collected(stores):
    world = 3
    base = stores.key_count()

    def fn(c, r):
        for i in range(30):
            c.barrier()
            c.all_gather_object({"rank": r, "i": i})
            c.broadcast_object(b"x" * (700 * 1024) if r == 0 else None, src=0)
        c.barrier()
        c.barrier()

    _run(stores, world, fn)
    # Pending: the last barrier's keys only; without GC 30 rounds leave
    # hundreds of keys.
    assert stores.key_count() - base <= 2 * world


def test_broadcast_only_keys_are_garbage_collected(stores):
    world = 3
    base = stores.key_count()

    def fn(c, r):
        out = [c.broadcast_object(("v", i) if r == 0 else None) for i in range(60)]
        return out, len(c._own_keys)

    for out, n_own in _run(stores, world, fn):
        assert out == [("v", i) for i in range(60)]
        assert n_own <= 2 * _BC_WINDOW
    assert stores.key_count() - base <= _BC_WINDOW * world


def test_timeouts_name_the_missing_ranks(stores):
    c0 = StoreCoordinator(stores.for_rank(), 0, 3, timeout_s=0.3)
    # Rank 2 arrives at the first barrier; rank 1 never does.
    stores.for_rank().set("b/1/2", b"1")
    begin = time.monotonic()
    with pytest.raises(TimeoutError, match=r"rank 1 never arrived"):
        c0.barrier(timeout_s=0.3)
    with pytest.raises(TimeoutError, match=r"ranks 1-2 never finished publishing"):
        c0.all_gather_object("mine")
    c1 = StoreCoordinator(stores.for_rank(), 1, 2, timeout_s=0.3)
    with pytest.raises(TimeoutError, match=r"source rank 0 never finished publishing"):
        c1.broadcast_object("ignored", src=0)
    # One shared deadline per operation, not one per missing rank.
    assert time.monotonic() - begin < 3


def test_try_get_does_not_block(stores):
    store = stores.for_rank()
    assert store.try_get("k") is None
    store.set("k", b"\x00v")
    assert store.try_get("k") == b"\x00v"
    store.delete("k")
    assert store.try_get("k") is None
    with pytest.raises(TimeoutError):
        store.get("k", timeout_s=0.05)


def test_same_store_keys_as_the_jax_coordinator():
    """Both packages' coordinators leave the same keys with the same
    values after the same collectives (no GC proof yet at the end)."""
    world = 2
    results = []
    for make_store, make_coord in (
        (jcoord.DictStore, jcoord.StoreCoordinator),
        (DictStore, StoreCoordinator),
    ):
        store = make_store()

        def fn(r, make_coord=make_coord, store=store):
            c = make_coord(store, r, world, timeout_s=30)
            c.broadcast_object("hello" if r == 0 else None)
            c.all_gather_object(b"p" * (600 * 1024) if r else r)

        threads = [threading.Thread(target=fn, args=(r,)) for r in range(world)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        results.append(dict(store._data))
    assert results[0] == results[1]
    assert "ag/2/1/part1" in results[1]


@pytest.mark.parametrize(
    "ranks,expected",
    [([], "no ranks"), ([17], "rank 17"), ([1, 2, 3, 7], "ranks 1-3, 7"), ([0, 2, 4], "ranks 0, 2, 4")],
)
def test_format_rank_list_matches_jax(ranks, expected):
    assert format_rank_list(ranks) == jcoord.format_rank_list(ranks) == expected
    assert format_rank_list(ranks, "peer host") == jcoord.format_rank_list(ranks, "peer host")


def test_barrier_compat_and_noop():
    calls = []

    class Legacy(NoOpCoordinator):
        def barrier(self):  # a coordinator written without a timeout
            calls.append("legacy")

    class Modern(NoOpCoordinator):
        def barrier(self, timeout_s=None):
            calls.append(timeout_s)

    barrier_compat(Legacy(), 5.0)
    barrier_compat(Modern(), 5.0)
    assert calls == ["legacy", 5.0]
    assert isinstance(Legacy(), Coordinator)
    assert isinstance(get_coordinator(), NoOpCoordinator)
    c = StoreCoordinator(DictStore(), 0, 1, timeout_s=60)
    assert c._remaining(time.monotonic() - 100) >= 0.05


def test_memory_budget_divides_by_processes_on_the_host(monkeypatch):
    from torchsnapshot_tpu_torch import scheduler
    from torchsnapshot_tpu_torch.utils.test_utils import run_thread_ranks

    monkeypatch.delenv("TPUSNAPSHOT_PER_RANK_MEMORY_BUDGET_BYTES", raising=False)
    monkeypatch.setattr(scheduler, "available_memory_bytes", lambda: 10 << 30)
    share = int((10 << 30) * 0.8)
    assert run_thread_ranks(4, lambda c, r: scheduler.get_memory_budget_bytes(c)) == [share // 4] * 4
    # Without a coordinator (read_object) this process counts alone.
    assert scheduler.get_memory_budget_bytes() == share
