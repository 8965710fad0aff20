"""Coordination shim: small object collectives over a KV store.

The snapshot protocol needs only *tiny* object collectives — key lists,
glob matches, manifests (kilobytes) — plus barriers; bulk tensor data
goes process→storage, never process→process. So the collectives run over
a blocking key-value store, not over tensor collectives: NCCL refuses two
ranks on one GPU, and a library must not issue object collectives on a
job's NCCL group.

- ``NoOpCoordinator`` — single process; every collective is the identity.
- ``StoreCoordinator`` — generic collectives over a :class:`Store`:

  - ``DictStore`` — an in-process dict (threads simulating ranks);
  - ``FileStore`` — a directory on a shared filesystem;
  - ``TorchStore`` — a ``torch.distributed`` c10d store (the default
    process group's ``TCPStore``), the production path.

``get_coordinator()`` resolves a ``StoreCoordinator`` over the default
process group's store when ``torch.distributed`` is initialised, else a
``NoOpCoordinator``. Values above 512 KiB are chunked through the store.
"""

import abc
import datetime
import inspect
import os
import pickle
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from . import telemetry, tracing

_DEFAULT_TIMEOUT_S = 300.0
_CHUNK = 512 * 1024  # chunk size for large values through the KV store
# Max broadcast generations a source lets go unacked before it blocks on
# the oldest one's acks. A free-running source outpaces its receivers
# indefinitely (it never blocks), so purely lazy ack collection would
# never fire in a broadcast-only loop; the window bounds live keys at
# O(window x world) and doubles as backpressure.
_BC_WINDOW = 8


class Store(abc.ABC):
    """A blocking KV store: set once, get blocks until the key exists."""

    @abc.abstractmethod
    def set(self, key: str, value: bytes) -> None:
        ...

    @abc.abstractmethod
    def get(self, key: str, timeout_s: float = _DEFAULT_TIMEOUT_S) -> bytes:
        ...

    def delete(self, key: str) -> None:
        """Best-effort removal of a key (collective-key GC); deleting an
        absent key is a no-op."""

    def try_get(self, key: str) -> Optional[bytes]:
        """Non-blocking read: the value if the key exists *now*, else
        None. A false None only defers key GC, never affects
        correctness."""
        try:
            return self.get(key, timeout_s=0.05)
        except TimeoutError:
            return None


class DictStore(Store):
    """In-process store shared between threads simulating ranks."""

    def __init__(self) -> None:
        self._data: Dict[str, bytes] = {}
        self._cond = threading.Condition()

    def set(self, key: str, value: bytes) -> None:
        with self._cond:
            self._data[key] = value
            self._cond.notify_all()

    def get(self, key: str, timeout_s: float = _DEFAULT_TIMEOUT_S) -> bytes:
        deadline = time.monotonic() + timeout_s
        with self._cond:
            while key not in self._data:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(f"Timed out waiting for key: {key}")
                self._cond.wait(timeout=remaining)
            return self._data[key]

    def delete(self, key: str) -> None:
        with self._cond:
            self._data.pop(key, None)

    def try_get(self, key: str) -> Optional[bytes]:
        with self._cond:
            return self._data.get(key)

    def key_count(self) -> int:
        with self._cond:
            return len(self._data)


class FileStore(Store):
    """Directory-backed store for multi-process coordination on one node
    (or any shared filesystem). Writes are atomic via rename."""

    def __init__(self, path: str) -> None:
        self.path = path
        os.makedirs(path, exist_ok=True)

    def _file(self, key: str) -> str:
        return os.path.join(self.path, key.replace("/", "__"))

    def set(self, key: str, value: bytes) -> None:
        fd, tmp = tempfile.mkstemp(dir=self.path)
        with os.fdopen(fd, "wb") as f:
            f.write(value)
        # No fsync: coordination keys are ephemeral per-collective values;
        # close() precedes the rename, so readers always see full data.
        # snapcheck: disable=durability-order -- ephemeral coordination keys
        os.replace(tmp, self._file(key))

    def get(self, key: str, timeout_s: float = _DEFAULT_TIMEOUT_S) -> bytes:
        target = self._file(key)
        deadline = time.monotonic() + timeout_s
        delay = 0.001
        while True:
            try:
                with open(target, "rb") as f:
                    return f.read()
            except FileNotFoundError:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"Timed out waiting for key: {key}")
                time.sleep(delay)
                delay = min(delay * 2, 0.05)

    def delete(self, key: str) -> None:
        try:
            os.unlink(self._file(key))
        except OSError:
            # Best-effort: a hiccup on a shared filesystem must never fail
            # the snapshot whose collective triggered the GC.
            pass

    def try_get(self, key: str) -> Optional[bytes]:
        try:
            with open(self._file(key), "rb") as f:
                return f.read()
        except OSError:
            return None

    def key_count(self) -> int:
        return len(os.listdir(self.path))


# Never a stored value: collective values start with 0x00/0x01 (chunk
# header) or are b"1" (barrier and ack keys).
_ABSENT = b"\xff<absent>"


class TorchStore(Store):
    """A ``torch.distributed`` c10d store (``TCPStore``, c10d
    ``FileStore``, ``HashStore``) under a ``PrefixStore`` namespace, so
    the coordinator's keys never meet the process group's own."""

    def __init__(self, store: Any, prefix: str = "tpusnapshot/") -> None:
        import torch.distributed as dist

        self._store = dist.PrefixStore(prefix, store)
        self._timeout_error = getattr(dist, "DistStoreError", RuntimeError)

    def set(self, key: str, value: bytes) -> None:
        self._store.set(key, value)

    def get(self, key: str, timeout_s: float = _DEFAULT_TIMEOUT_S) -> bytes:
        try:
            self._store.wait([key], datetime.timedelta(seconds=timeout_s))
        except self._timeout_error as e:
            # c10d reports expiry as DistStoreError("wait timeout ...");
            # other failures (a lost connection) keep their own type, so
            # the collectives never blame a healthy peer rank for them.
            if "timeout" not in str(e).lower():
                raise
            raise TimeoutError(f"Timed out waiting for key: {key}") from e
        return self._store.get(key)

    def delete(self, key: str) -> None:
        self._store.delete_key(key)

    def try_get(self, key: str) -> Optional[bytes]:
        # compare_set on an absent key hands back the expected value and
        # creates nothing; on a present one (whose value is never
        # _ABSENT) it returns the value: an atomic non-blocking read, where
        # check-then-get could block on a key deleted in between.
        value = self._store.compare_set(key, _ABSENT, _ABSENT)
        return None if value == _ABSENT else value

    def key_count(self) -> int:
        return self._store.num_keys()


def format_rank_list(ranks: List[int], noun: str = "rank") -> str:
    """``[17]`` → "rank 17"; ``[1,2,3,7]`` → "ranks 1-3, 7". Runs compress
    to ranges, so a stall of many ranks reads as a handful of spans.
    Input must be sorted ascending; empty input reads as "no <noun>s"."""
    if not ranks:
        return f"no {noun}s"
    if len(ranks) == 1:
        return f"{noun} {ranks[0]}"
    spans = []
    start = prev = ranks[0]
    for r in ranks[1:]:
        if r == prev + 1:
            prev = r
            continue
        spans.append(f"{start}-{prev}" if prev > start else str(start))
        start = prev = r
    spans.append(f"{start}-{prev}" if prev > start else str(start))
    return f"{noun}s " + ", ".join(spans)


class Coordinator(abc.ABC):
    """Collective interface used by Snapshot."""

    @abc.abstractmethod
    def get_rank(self) -> int:
        ...

    @abc.abstractmethod
    def get_world_size(self) -> int:
        ...

    @abc.abstractmethod
    def barrier(self, timeout_s: Optional[float] = None) -> None:
        """Block until every rank arrives. ``timeout_s`` overrides the
        default wait for this one barrier: callers that barrier behind a
        long rank-0 operation (a metadata commit) pass its own timeout."""

    @abc.abstractmethod
    def all_gather_object(self, obj: Any) -> List[Any]:
        ...

    @abc.abstractmethod
    def broadcast_object(self, obj: Any, src: int = 0) -> Any:
        ...


class NoOpCoordinator(Coordinator):
    def get_rank(self) -> int:
        return 0

    def get_world_size(self) -> int:
        return 1

    def barrier(self, timeout_s: Optional[float] = None) -> None:
        pass

    def all_gather_object(self, obj: Any) -> List[Any]:
        return [obj]

    def broadcast_object(self, obj: Any, src: int = 0) -> Any:
        return obj


class StoreCoordinator(Coordinator):
    """Object collectives over a :class:`Store`, as the JAX package runs
    them (the same keys, chunking and garbage collection).

    Every collective consumes one *generation*, so keys never collide
    across successive operations; all processes must issue the same
    sequence of collectives.

    **Key garbage collection.** In a barrier or all-gather at generation
    ``g`` every rank sets its own ``…/g/<rank>`` key only after finishing
    every operation of generations ``< g`` (reads included). So once this
    rank has observed all keys of generation ``g``, every key it wrote
    at generations ``< g`` has been read by everyone who ever will, and
    it deletes them. Receivers ack each broadcast with a tiny key; the
    source collects acks lazily (non-blocking) at its next broadcast and
    deletes its payload keys and the acks, so a broadcast-only loop does
    not grow the store either. Steady state: O(world) live keys.
    """

    def __init__(
        self,
        store: Store,
        rank: int,
        world_size: int,
        timeout_s: float = _DEFAULT_TIMEOUT_S,
    ) -> None:
        self._store = store
        self._rank = rank
        self._world = world_size
        # Stamp the trace identity once the rank is known, so every trace
        # this process flushes names its rank.
        tracing.set_identity(rank=rank)
        self._gen = 0
        self._timeout_s = timeout_s
        # (generation, key) for every key this rank wrote and has not yet
        # proven globally consumed.
        self._own_keys: List[Tuple[int, str]] = []
        # Generations at which this rank was a broadcast source and has
        # not yet observed every receiver's ack (oldest first).
        self._pending_bc: List[int] = []

    def _gc_through(self, proven_gen: int) -> None:
        """Delete own keys of generations < ``proven_gen``."""
        keep = []
        for gen, key in self._own_keys:
            if gen < proven_gen:
                self._store.delete(key)
            else:
                keep.append((gen, key))
        self._own_keys = keep
        self._pending_bc = [g for g in self._pending_bc if g >= proven_gen]

    def get_rank(self) -> int:
        return self._rank

    def get_world_size(self) -> int:
        return self._world

    def _next_gen(self) -> int:
        self._gen += 1
        return self._gen

    def _set_chunked(self, key: str, payload: bytes, gen: int) -> None:
        if len(payload) <= _CHUNK:
            self._store.set(key, b"\x00" + payload)
            self._own_keys.append((gen, key))
        else:
            n = -(-len(payload) // _CHUNK)
            for i in range(n):
                part = f"{key}/part{i}"
                self._store.set(part, payload[i * _CHUNK:(i + 1) * _CHUNK])
                self._own_keys.append((gen, part))
            self._store.set(key, b"\x01" + str(n).encode())
            self._own_keys.append((gen, key))

    def _remaining(self, deadline: Optional[float]) -> float:
        if deadline is None:
            return self._timeout_s
        # A floor, not zero: a zero budget could time out on a key that is
        # already published and blame a healthy rank.
        return max(0.05, deadline - time.monotonic())

    def _get_chunked(self, key: str, deadline: Optional[float] = None) -> bytes:
        head = self._store.get(key, self._remaining(deadline))
        if head[:1] == b"\x00":
            return head[1:]
        n = int(head[1:].decode())
        return b"".join(
            self._store.get(f"{key}/part{i}", self._remaining(deadline))
            for i in range(n)
        )

    def _absent_ranks(self, key_fmt: str, first: int) -> List[int]:
        """``first`` plus every later rank whose key is absent *now*, so a
        timeout names every straggler."""
        missing = [first]
        for r in range(first + 1, self._world):
            if self._store.try_get(key_fmt.format(rank=r)) is None:
                missing.append(r)
        return missing

    def barrier(self, timeout_s: Optional[float] = None) -> None:
        wait = self._timeout_s if timeout_s is None else timeout_s
        gen = self._next_gen()
        key = f"b/{gen}/{self._rank}"
        self._store.set(key, b"1")
        self._own_keys.append((gen, key))
        # One shared deadline for the whole barrier: the timeout bounds
        # the operation, not each rank's key.
        deadline = time.monotonic() + wait
        wait_t0 = time.monotonic()
        try:
            for r in range(self._world):
                try:
                    self._store.get(f"b/{gen}/{r}", self._remaining(deadline))
                except TimeoutError:
                    missing = self._absent_ranks(f"b/{gen}/{{rank}}", r)
                    raise TimeoutError(
                        f"barrier (generation {gen}) timed out after {wait:g}s: "
                        f"{format_rank_list(missing)} never arrived (observed by "
                        f"rank {self._rank} of {self._world}); likely crashed or "
                        f"stuck in storage IO."
                    ) from None
        finally:
            # A barrier that times out is observed too.
            telemetry.record_coord_wait("barrier", time.monotonic() - wait_t0)
        # Every rank passes here only after the last one arrived, so the
        # same generation's instants mark about one moment on every rank.
        tracing.instant("barrier_exit", gen=gen)
        self._gc_through(gen)

    def all_gather_object(self, obj: Any) -> List[Any]:
        gen = self._next_gen()
        self._set_chunked(f"ag/{gen}/{self._rank}", pickle.dumps(obj, protocol=4), gen)
        deadline = time.monotonic() + self._timeout_s
        out = []
        wait_t0 = time.monotonic()
        try:
            for r in range(self._world):
                try:
                    out.append(pickle.loads(self._get_chunked(f"ag/{gen}/{r}", deadline)))
                except TimeoutError:
                    missing = self._absent_ranks(f"ag/{gen}/{{rank}}", r)
                    raise TimeoutError(
                        f"all_gather (generation {gen}) timed out after "
                        f"{self._timeout_s:g}s total: {format_rank_list(missing)} "
                        f"never finished publishing (observed by rank "
                        f"{self._rank} of {self._world})."
                    ) from None
        finally:
            telemetry.record_coord_wait("all_gather", time.monotonic() - wait_t0)
        self._gc_through(gen)
        return out

    def broadcast_object(self, obj: Any, src: int = 0) -> Any:
        gen = self._next_gen()
        if self._rank == src:
            self._collect_broadcast_acks()
            self._set_chunked(f"bc/{gen}", pickle.dumps(obj, protocol=4), gen)
            self._pending_bc.append(gen)
            # Bounded in-flight window: receivers are sequential and every
            # pending payload exists, so each reaches (and acks) the oldest.
            while len(self._pending_bc) > _BC_WINDOW:
                self._collect_broadcast_acks(block_oldest=True)
            return obj
        self._prune_consumed_acks()
        deadline = time.monotonic() + self._timeout_s
        wait_t0 = time.monotonic()
        try:
            out = pickle.loads(self._get_chunked(f"bc/{gen}", deadline))
        except TimeoutError:
            raise TimeoutError(
                f"broadcast (generation {gen}) timed out after "
                f"{self._timeout_s:g}s total: source rank {src} never "
                f"finished publishing (receiving rank {self._rank} of "
                f"{self._world})."
            ) from None
        finally:
            telemetry.record_coord_wait("broadcast", time.monotonic() - wait_t0)
        # Ack after the read: the source may delete the payload keys the
        # moment all acks exist. The ack is tracked in _own_keys too, so
        # barrier/gather progress collects it if the source never
        # broadcasts again.
        ack = f"bcack/{gen}/{self._rank}"
        self._store.set(ack, b"1")
        self._own_keys.append((gen, ack))
        return out

    def _prune_consumed_acks(self) -> None:
        """Drop own ack entries whose keys the source already deleted,
        oldest first, stopping at the first still present (the source
        consumes acks in generation order)."""
        while True:
            idx = next(
                (i for i, (_, k) in enumerate(self._own_keys) if k.startswith("bcack/")),
                None,
            )
            if idx is None or self._store.try_get(self._own_keys[idx][1]) is not None:
                return
            self._own_keys.pop(idx)

    def _collect_broadcast_acks(self, block_oldest: bool = False) -> None:
        """Source-side GC of broadcast payload keys, oldest pending
        generation first, stopping at the first not fully acked. With
        ``block_oldest`` the first generation is waited on."""
        first = True
        while self._pending_bc:
            gen = self._pending_bc[0]
            acks = [f"bcack/{gen}/{r}" for r in range(self._world) if r != self._rank]
            if block_oldest and first:
                deadline = time.monotonic() + self._timeout_s
                for a in acks:
                    try:
                        self._store.get(a, self._remaining(deadline))
                    except TimeoutError:
                        raise TimeoutError(
                            f"broadcast ack (generation {gen}) timed out after "
                            f"{self._timeout_s:g}s total: rank "
                            f"{a.rsplit('/', 1)[1]} never acknowledged (source "
                            f"rank {self._rank} of {self._world})."
                        ) from None
                first = False
            elif any(self._store.try_get(a) is None for a in acks):
                return
            for a in acks:
                self._store.delete(a)
            keep = []
            for g, key in self._own_keys:
                if g == gen:
                    self._store.delete(key)
                else:
                    keep.append((g, key))
            self._own_keys = keep
            self._pending_bc.pop(0)


def barrier_compat(coordinator: Coordinator, timeout_s: float) -> None:
    """``coordinator.barrier(timeout_s=...)``, tolerating coordinators
    written against an ABC whose ``barrier(self)`` takes no timeout:
    they wait their own default instead of raising ``TypeError`` at a
    commit barrier after the storage work already succeeded."""
    try:
        params = inspect.signature(coordinator.barrier).parameters
        accepts = "timeout_s" in params or any(
            p.kind is p.VAR_KEYWORD for p in params.values()
        )
    except (ValueError, TypeError):
        accepts = False
    if accepts:
        coordinator.barrier(timeout_s=timeout_s)
    else:
        coordinator.barrier()


# Process-wide singleton per default process group: collective key
# generations must advance monotonically across *all* snapshot operations
# of a process — a fresh StoreCoordinator per take() would restart at
# generation 1 and meet keys already in the store. A new default group
# (after destroy_process_group and a new init) gets a new coordinator in
# a new key namespace, numbered by the groups in which this process
# resolved one. Only collective calls resolve it (take, async_take,
# restore, the manager's save and restore), so every rank of a group
# counts it; a one-rank call takes its rank from get_rank().
_default_coordinator: Optional[Tuple[Any, Coordinator]] = None
_default_groups_seen = 0
_default_coordinator_lock = threading.Lock()


def get_coordinator(coord: Optional[Coordinator] = None) -> Coordinator:
    """Resolve the coordinator: explicit > ``torch.distributed`` > single
    process.

    With ``torch.distributed`` initialised, the coordinator is a
    process-wide ``StoreCoordinator`` over the default process group's
    c10d store, at ``dist.get_rank()`` of ``dist.get_world_size()``. It
    never degrades to a single-process coordinator there: that would let
    every rank commit a "complete" snapshot of only its own state.

    Call it on every rank of a group or on none: its store namespace
    counts the groups in which this process called it. Where one rank
    needs only its rank, use :func:`get_rank`.
    """
    global _default_coordinator, _default_groups_seen
    if coord is not None:
        return coord
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return NoOpCoordinator()
    from torch.distributed import distributed_c10d as c10d

    with _default_coordinator_lock:
        group = c10d._get_default_group()
        if _default_coordinator is None or _default_coordinator[0] is not group:
            _default_groups_seen += 1
            store = TorchStore(
                c10d._get_default_store(), prefix=f"tpusnapshot/{_default_groups_seen}/"
            )
            _default_coordinator = (
                group,
                StoreCoordinator(store, dist.get_rank(), dist.get_world_size()),
            )
        return _default_coordinator[1]


def get_rank(coord: Optional[Coordinator] = None) -> int:
    """This process's rank: ``coord``'s, else ``torch.distributed``'s,
    else 0. Unlike :func:`get_coordinator` it may be called on one rank
    alone."""
    if coord is not None:
        return coord.get_rank()
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0
