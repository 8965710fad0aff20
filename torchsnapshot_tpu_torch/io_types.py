"""IO interfaces shared by the scheduler, preparers, and storage plugins.

- ``BufferStager`` — produces the payload for one storage write; staging is
  where the device→host copy and serialization happen, inside a thread
  executor.
- ``BufferConsumer`` — absorbs the payload of one storage read; consuming
  is where deserialization and the host→device copy happen.
- ``WriteReq``/``ReadReq`` pair a storage path with a stager/consumer.
- ``IOReq`` is the unit handed to a ``StoragePlugin``.
- ``StoragePlugin`` — async write/read/delete/list/age/size + sync close;
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

from . import telemetry, tracing
from .telemetry import metrics as _metric_names
from .utils.env import env_float, env_int

BufferType = Union[bytes, bytearray, memoryview]

logger = logging.getLogger(__name__)


# --------------------------------------------------------- storage-op hooks
#
# Observation seam for every storage-op boundary. Registered hooks receive
# ``(op, path)`` right before the op executes: plugin-level ops are emitted
# by wrappers (faultline's FaultPlugin emits "write"/"read"/"delete"/...),
# and backends with multi-step durability protocols emit their SUB-step
# boundaries too (fs.py emits "fs.write.tmp" → "fs.write.fsync" →
# "fs.write.rename" → "fs.write.dirsync"), so a fault-injection harness can
# place a crash BETWEEN the steps of a single logical write. A hook may
# raise — the exception propagates into the op exactly where a real failure
# (or process death) would strike. Zero cost when no hook is registered
# (one truthiness check per boundary).

_STORAGE_OP_HOOKS: List[Callable[[str, str], None]] = []


def add_storage_op_hook(hook: Callable[[str, str], None]) -> None:
    """Register ``hook(op, path)`` to observe every storage-op boundary."""
    _STORAGE_OP_HOOKS.append(hook)


def remove_storage_op_hook(hook: Callable[[str, str], None]) -> None:
    """Unregister a hook added by :func:`add_storage_op_hook`."""
    _STORAGE_OP_HOOKS.remove(hook)


def emit_storage_op(op: str, path: str) -> None:
    """Announce a storage-op boundary to registered hooks (may raise)."""
    if _STORAGE_OP_HOOKS:
        for hook in list(_STORAGE_OP_HOOKS):
            hook(op, path)


def _code_attr_http_status(exc: BaseException) -> Optional[int]:
    """The exception's ``.code`` as an int, but only when the exception
    looks like an HTTP client's: ``code`` is also a gRPC status or a
    library's own error number, and reading those as HTTP statuses would
    make a retryable failure look deterministic. The test: an ``errors``
    or ``response`` attribute (google.api_core carries both), or a
    defining module of an HTTP client."""
    code = getattr(exc, "code", None)
    if code is None:
        return None
    if not (
        hasattr(exc, "errors")
        or getattr(exc, "response", None) is not None
        or any(
            tok in type(exc).__module__
            for tok in ("google", "http", "urllib", "requests", "aiohttp")
        )
    ):
        return None
    try:
        return int(code)
    except (TypeError, ValueError):
        return None


def is_not_found_error(exc: BaseException) -> bool:
    """Whether a storage failure means "object does not exist".

    fs and memory raise ``FileNotFoundError``; the cloud clients' errors
    carry NotFound / NoSuchKey in their type's name or a structured 404.
    Classified by structure, never by message text (a proxy's error page
    may contain "404"). Not-found is deterministic: the retry layer never
    retries it, and pollers read it as "not yet"."""
    if isinstance(exc, FileNotFoundError):
        return True
    for klass in type(exc).__mro__:
        if klass.__name__ in ("NotFound", "NoSuchKey", "NoSuchBucket"):
            return True
    if _code_attr_http_status(exc) == 404:
        return True
    response = getattr(exc, "response", None)
    if isinstance(response, dict):
        error_code = response.get("Error", {}).get("Code")
        if error_code in ("404", "NoSuchKey", "NotFound", "NoSuchBucket"):
            return True
        if response.get("ResponseMetadata", {}).get("HTTPStatusCode") == 404:
            return True
    return False


def is_range_not_satisfiable_error(exc: BaseException) -> bool:
    """Whether a storage failure means "the requested byte range starts
    at or past the end of the object" (GCS 416, S3 InvalidRange). On
    those backends a healthy object answers ``verify()``'s probe one byte
    past its end this way, so the probe reads it as a clean end of file.
    Deterministic, like not-found: never retried. Classified by structure,
    never by message text."""
    for klass in type(exc).__mro__:
        if klass.__name__ in (
            "RequestRangeNotSatisfiable",
            "RequestedRangeNotSatisfiable",
            "InvalidRange",
        ):
            return True
    response = getattr(exc, "response", None)
    if isinstance(response, dict):
        if response.get("Error", {}).get("Code") in ("416", "InvalidRange"):
            return True
        if response.get("ResponseMetadata", {}).get("HTTPStatusCode") == 416:
            return True
    return _code_attr_http_status(exc) == 416


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
        attempt_start = time.monotonic()
        try:
            return await make_coro()
        except asyncio.CancelledError:
            raise
        except Exception as e:
            if (
                is_not_found_error(e)
                or is_range_not_satisfiable_error(e)
                or attempt == attempts
            ):
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
            # The counters beside the instant, so the instants equal the
            # count whenever a trace is recorded. The op type labels the
            # counter (the full desc carries a path).
            op_type = desc.split("(", 1)[0]
            telemetry.counter(_metric_names.STORAGE_RETRIES, op=op_type).inc()
            telemetry.counter(_metric_names.STORAGE_RETRY_BACKOFF, op=op_type).inc(delay)
            tracing.instant(
                "storage_retry",
                op=desc,
                attempt=attempt,
                attempt_s=round(time.monotonic() - attempt_start, 4),
                delay_s=round(delay, 4),
                error=type(e).__name__,
            )
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

    def get_progress_bytes(self) -> int:
        """The payload bytes this read credits to live progress: its
        consuming cost less the deferred part, unless the consumer
        defers its own payload (a read the H2D pipeline still holds)."""
        return self.get_consuming_cost_bytes() - self.get_deferred_cost_bytes()

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

    async def object_size_bytes(self, path: str) -> Optional[int]:
        """Stored size of ``path`` (a stat or HEAD, not a read), or None
        when the backend cannot tell. ``copy_to`` admits object entries,
        whose size the manifest does not record, against its byte budget
        with it; an unknown size is admitted at the whole budget."""
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

    async def object_size_bytes(self, path: str) -> Optional[int]:
        return await retry_storage_op(
            lambda: self._inner.object_size_bytes(path), f"size({path})"
        )

    def ensure_durable(self) -> None:
        self._inner.ensure_durable()

    def close(self) -> None:
        self._inner.close()
