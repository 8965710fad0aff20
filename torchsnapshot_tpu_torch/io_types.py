"""IO interfaces shared by the scheduler, preparers, and storage plugins.

- ``BufferStager`` — produces the payload for one storage write; staging is
  where the device→host copy and serialization happen, inside a thread
  executor.
- ``BufferConsumer`` — absorbs the payload of one storage read; consuming
  is where deserialization and the host→device copy happen.
- ``WriteReq``/``ReadReq`` pair a storage path with a stager/consumer.
- ``IOReq`` is the unit handed to a ``StoragePlugin``.
- ``StoragePlugin`` — async write/read/delete/list + sync close;
  concrete backends live in ``torchsnapshot_tpu_torch.storage_plugins``.
- ``RetryingStoragePlugin`` — capped, jittered retries around every op.
"""

import abc
import asyncio
import io
import logging
import random
import time
from concurrent.futures import Executor
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple, Union

from .utils.env import env_float, env_int

BufferType = Union[bytes, bytearray, memoryview]

logger = logging.getLogger(__name__)


def is_not_found_error(exc: BaseException) -> bool:
    """Whether a storage failure means "object does not exist" — the
    dialect both ported backends (fs, memory) speak. Not-found is
    deterministic: the retry layer never retries it. (The JAX package
    also classifies cloud clients' 404s; those backends are not ported.)
    """
    return isinstance(exc, FileNotFoundError)


# Storage-op retry policy: decorrelated-jitter backoff (each delay drawn
# uniformly from [initial, prev*3], capped), under an elapsed budget.
_STORAGE_RETRIES_ENV_VAR = "TPUSNAPSHOT_STORAGE_RETRIES"
_DEFAULT_STORAGE_ATTEMPTS = 3
_RETRY_BACKOFF_INITIAL_S = 0.25
_RETRY_DELAY_CAP_ENV_VAR = "TPUSNAPSHOT_STORAGE_RETRY_CAP_S"
_DEFAULT_RETRY_DELAY_CAP_S = 20.0
_RETRY_BUDGET_ENV_VAR = "TPUSNAPSHOT_STORAGE_RETRY_BUDGET_S"
_DEFAULT_RETRY_BUDGET_S = 600.0

# Deliberately unseeded: concurrent processes must draw DIFFERENT delays.
_retry_rng = random.Random()


async def retry_storage_op(make_coro, desc: str):
    """Run ``await make_coro()`` with capped, decorrelated-jitter backoff
    on transient failures. ``make_coro`` is a zero-arg callable returning
    a fresh coroutine (a coroutine object cannot be awaited twice)."""
    attempts = 1 + max(
        0, env_int(_STORAGE_RETRIES_ENV_VAR, _DEFAULT_STORAGE_ATTEMPTS - 1)
    )
    cap = env_float(_RETRY_DELAY_CAP_ENV_VAR, _DEFAULT_RETRY_DELAY_CAP_S)
    if cap <= 0:
        cap = _DEFAULT_RETRY_DELAY_CAP_S
    floor = min(_RETRY_BACKOFF_INITIAL_S, cap)
    budget_s = env_float(_RETRY_BUDGET_ENV_VAR, _DEFAULT_RETRY_BUDGET_S)
    start = time.monotonic()
    prev_delay = floor
    for attempt in range(1, attempts + 1):
        try:
            return await make_coro()
        except asyncio.CancelledError:
            raise
        except Exception as e:
            if is_not_found_error(e) or attempt == attempts:
                raise
            delay = min(
                cap, _retry_rng.uniform(floor, max(floor, prev_delay * 3.0))
            )
            prev_delay = delay
            elapsed = time.monotonic() - start
            if elapsed + delay > budget_s:
                logger.warning(
                    f"Storage op {desc} failed (attempt {attempt}/"
                    f"{attempts}): {e!r}; retry budget exhausted "
                    f"({elapsed:.1f}s elapsed of {budget_s:g}s) — giving up"
                )
                raise
            logger.warning(
                f"Storage op {desc} failed (attempt {attempt}/{attempts}): "
                f"{e!r}; retrying in {delay:.2f}s"
            )
            await asyncio.sleep(delay)


class BufferStager(abc.ABC):
    @abc.abstractmethod
    async def stage_buffer(self, executor: Optional[Executor] = None) -> BufferType:
        """Produce the payload bytes (device→host copy + serialize)."""

    @abc.abstractmethod
    def get_staging_cost_bytes(self) -> int:
        """Peak host memory charged against the budget while staging."""


class BufferConsumer(abc.ABC):
    # Dispatch order key for the read scheduler (largest first): the
    # size of the logical object this read belongs to. None means "use
    # the consuming cost". All sub-reads of one split object share the
    # object's size, so the stable sort keeps them together and in order.
    sort_key_bytes: Optional[int] = None

    @abc.abstractmethod
    async def consume_buffer(
        self, buf: BufferType, executor: Optional[Executor] = None
    ) -> None:
        """Absorb the payload bytes (deserialize + host→device copy)."""

    @abc.abstractmethod
    def get_consuming_cost_bytes(self) -> int:
        """Peak host memory charged against the budget while consuming."""

    def get_deferred_cost_bytes(self) -> int:
        """The part of :meth:`get_consuming_cost_bytes` whose allocation
        outlives ``consume_buffer`` (a split read's shared assembly
        buffer; a payload the H2D pipeline still reads). The scheduler
        re-credits it through the releaser of :meth:`set_cost_releaser`
        instead of when the consume returns. 0 for ordinary consumers."""
        return 0

    def set_cost_releaser(self, release: Callable[[int], None]) -> None:
        """Receive the scheduler's host-budget release callback. Called
        only when :meth:`get_deferred_cost_bytes` is non-zero; the
        consumer calls ``release(n)`` once, when the deferred allocation
        is actually freed."""

    def get_device_cost_bytes(self) -> int:
        """Device bytes this consume allocates that outlive the consume
        call (a leaf's private landing buffer, a region landed whole for
        an on-card scatter). The scheduler gates consume dispatch on a
        device budget with it. 0 for consumers that stay on the host."""
        return 0

    def set_device_cost_releaser(self, release: Callable[[int], None]) -> None:
        """Receive the device-budget release callback. Called only when
        :meth:`get_device_cost_bytes` is non-zero; the consumer calls
        ``release(n)`` once the device bytes are freed."""


@dataclass
class WriteReq:
    path: str
    buffer_stager: BufferStager


@dataclass
class ReadReq:
    path: str
    buffer_consumer: BufferConsumer
    # [start, end) byte offsets: read only this part of the object.
    byte_range: Optional[Tuple[int, int]] = None


@dataclass
class IOReq:
    path: str
    buf: io.BytesIO = field(default_factory=io.BytesIO)
    # Zero-copy payload. Writes: when set, plugins write `data` directly
    # instead of draining `buf`. Reads: plugins return the payload here.
    data: Optional[BufferType] = None
    # Reads: [start, end) byte offsets of the object to return.
    byte_range: Optional[Tuple[int, int]] = None


def io_payload(io_req: IOReq) -> BufferType:
    """The payload of a completed IOReq, whichever field carries it."""
    if io_req.data is not None:
        return io_req.data
    return io_req.buf.getbuffer()


class StoragePlugin(abc.ABC):
    # How many concurrent IO ops this backend profits from (the
    # scheduler's per-pipeline concurrency caps).
    max_write_concurrency: int = 16
    max_read_concurrency: int = 16

    @abc.abstractmethod
    async def write(self, io_req: IOReq) -> None:
        ...

    @abc.abstractmethod
    async def read(self, io_req: IOReq) -> None:
        ...

    @abc.abstractmethod
    async def delete(self, path: str) -> None:
        """Remove one object; a missing one raises the not-found error
        (:func:`is_not_found_error`), which the caller decides about."""

    async def list_prefix(self, prefix: str) -> Optional[List[str]]:
        """Stored object paths that start with ``prefix``, relative to the
        plugin's root (the namespace of write/read/delete), or None when
        the backend cannot enumerate objects."""
        return None

    async def object_age_s(self, path: str) -> Optional[float]:
        """Seconds since ``path`` was last written, or None when the
        backend cannot tell. Sweeps spare objects younger than their age
        guard: they may belong to a take still in flight."""
        return None

    def ensure_durable(self) -> None:
        """Make everything written through this plugin so far
        crash-durable. Called before the metadata commit, so a backend may
        defer per-object durability work (directory fsyncs) to here.
        Default no-op: object stores are durable on write-ack."""

    @abc.abstractmethod
    def close(self) -> None:
        ...


class RetryingStoragePlugin(StoragePlugin):
    """Adds transparent retries to every op of a plugin. A failed read
    attempt may have partially filled the request buffer, so reads reset
    it per attempt. Not-found propagates immediately."""

    def __init__(self, inner: StoragePlugin) -> None:
        self._inner = inner
        self.max_write_concurrency = inner.max_write_concurrency
        self.max_read_concurrency = inner.max_read_concurrency

    async def write(self, io_req: IOReq) -> None:
        await retry_storage_op(
            lambda: self._inner.write(io_req), f"write({io_req.path})"
        )

    async def read(self, io_req: IOReq) -> None:
        async def _attempt() -> None:
            io_req.buf.seek(0)
            io_req.buf.truncate()
            io_req.data = None
            await self._inner.read(io_req)

        await retry_storage_op(_attempt, f"read({io_req.path})")

    async def delete(self, path: str) -> None:
        await retry_storage_op(lambda: self._inner.delete(path), f"delete({path})")

    async def list_prefix(self, prefix: str) -> Optional[List[str]]:
        return await retry_storage_op(
            lambda: self._inner.list_prefix(prefix), f"list({prefix})"
        )

    async def object_age_s(self, path: str) -> Optional[float]:
        # A final failure propagates, so a sweep's age guard fails closed
        # (spares the object) instead of reading it as "age unknown".
        return await retry_storage_op(
            lambda: self._inner.object_age_s(path), f"age({path})"
        )

    def ensure_durable(self) -> None:
        self._inner.ensure_durable()

    def close(self) -> None:
        self._inner.close()
