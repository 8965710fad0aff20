"""Memory-budgeted, pipelined execution of write/read requests.

Two two-stage asyncio pipelines overlap staging with storage IO under a
per-process host-memory budget:

- write: ``stage_buffer`` (device→host copy + checksum, thread executor)
  → ``storage.write``;
- read: ``storage.read`` → ``consume_buffer`` (checksum, staging and the
  submit of host→device copies to the H2D pipeline, thread executor).

Budget accounting: a write charges its staging cost at dispatch,
re-credits ``cost − len(buf)`` when staging ends and ``len(buf)`` when the
write lands. A read charges its consuming cost at dispatch and re-credits
it after the consume, except the consumer's *deferred* part (a split
read's shared assembly buffer; a payload the H2D pipeline still reads),
which the consumer re-credits through a releaser when the allocation is
actually freed. Pooled staging buffers bind that releaser to their lease,
which fires it exactly once. Releases may arrive from pipeline threads,
so the read budget is a locked :class:`_BudgetCell`.

A second budget bounds the DEVICE bytes that in-flight consumes hold
(a leaf's private landing buffer until it is published, a region landed
whole for an on-card scatter): consume dispatch waits while it is spent.

At least one request is always in flight regardless of budget, so a
single over-budget buffer cannot deadlock the pipeline.
"""

import asyncio
import logging
import os
import socket
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

from . import telemetry, tracing
from .io_types import IOReq, ReadReq, StoragePlugin, WriteReq, io_payload
from .telemetry import consume_profile as _cprof
from .telemetry import memwatch
from .telemetry import metrics as _metric_names

logger = logging.getLogger(__name__)

_MAX_PER_RANK_MEMORY_BUDGET_BYTES: int = 32 * 1024 * 1024 * 1024
_AVAILABLE_MEMORY_MULTIPLIER: float = 0.8
_MAX_STAGING_THREADS: int = 16

_MEMORY_BUDGET_ENV_VAR = "TPUSNAPSHOT_PER_RANK_MEMORY_BUDGET_BYTES"


def available_memory_bytes(meminfo: str = "/proc/meminfo") -> int:
    """``MemAvailable`` from ``/proc/meminfo``: the kernel's estimate of
    memory a new workload can use without swapping."""
    with open(meminfo) as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError(f"{meminfo} reports no MemAvailable")


def get_local_world_size(coord: Any) -> int:
    """Number of snapshot processes on this host (a hostname all-gather:
    a collective, so every rank must call it)."""
    hostnames = coord.all_gather_object(socket.gethostname())
    return max(1, hostnames.count(socket.gethostname()))


def get_memory_budget_bytes(coord: Any = None) -> int:
    """min(0.8 × available RAM ÷ snapshot processes on this host, 32 GB),
    overridden by ``TPUSNAPSHOT_PER_RANK_MEMORY_BUDGET_BYTES``.

    With a coordinator the processes on the host are counted through it
    (a collective: only from paths every rank runs); without one
    (``read_object``, single-process reads) this process counts alone.
    """
    env_val = os.environ.get(_MEMORY_BUDGET_ENV_VAR)
    if env_val is not None:
        return int(env_val)
    local_world_size = 1 if coord is None else get_local_world_size(coord)
    return min(
        int(available_memory_bytes() * _AVAILABLE_MEMORY_MULTIPLIER) // local_world_size,
        _MAX_PER_RANK_MEMORY_BUDGET_BYTES,
    )


def _observe_op(
    ops: Dict[str, Dict[str, Any]],
    op: str,
    seconds: float,
    nbytes: int,
    progress: Optional[Any] = None,
    progress_bytes: int = 0,
) -> None:
    """Record one pipelined op in the process metrics and in the call's
    own aggregate (the flight recorder's exact numbers), from the event
    loop's thread only. ``progress`` (a ProgressPublisher) gets the same
    pulse, so its heartbeat beats as often as the pipeline completes
    work. ``progress_bytes`` is the op's credit against the announced
    ``bytes_total``, in cost units (not stored bytes, which differ under
    compression); ops that describe payloads another op credited pass 0."""
    telemetry.record_scheduler_op(op, seconds, nbytes)
    agg = ops.setdefault(op, {"count": 0, "seconds": 0.0, "bytes": 0})
    agg["count"] += 1
    agg["seconds"] += seconds
    agg["bytes"] += nbytes
    if progress is not None:
        progress.pipeline_update(op, progress_bytes)


def _merge_stats(
    stats: Optional[Dict[str, Any]],
    pipeline: str,
    nbytes: int,
    stall_s: float,
    high_water: int,
    ops: Dict[str, Dict[str, Any]],
) -> None:
    """Fold one pipeline run into the process metrics and, when the
    caller asked for them, the ``stats`` dict."""
    telemetry.counter(_metric_names.SCHED_STALL_SECONDS, pipeline=pipeline).inc(stall_s)
    telemetry.gauge(_metric_names.SCHED_BUDGET_HWM, pipeline=pipeline).set_max(high_water)
    if stats is None:
        return
    stats["bytes"] = stats.get("bytes", 0) + nbytes
    stats["stall_s"] = stats.get("stall_s", 0.0) + stall_s
    stats["budget_high_water_bytes"] = max(stats.get("budget_high_water_bytes", 0), high_water)
    out = stats.setdefault("ops", {})
    for op, agg in ops.items():
        acc = out.setdefault(op, {"count": 0, "seconds": 0.0, "bytes": 0})
        for k in acc:
            acc[k] += agg[k]


async def execute_write_reqs(
    write_reqs: List[WriteReq],
    storage: StoragePlugin,
    memory_budget_bytes: int,
    rank: int,
    stats: Optional[Dict[str, Any]] = None,
    progress: Optional[Any] = None,
) -> int:
    """Run the staged-write pipeline; returns total bytes written.

    ``stats`` (optional) accumulates this run's numbers for the flight
    recorder: bytes, per-op count/seconds/bytes (``stage``, ``encode``,
    ``write``), the seconds dispatch waited on the budget, and the
    budget's high-water mark. ``progress`` (a ProgressPublisher) is
    pulsed at every op and published from this loop on its cadence."""
    begin = time.monotonic()
    if progress is not None:
        # Pre-staged buffers charge no budget but name their real size.
        progress.add_bytes_total(
            sum(
                getattr(wr.buffer_stager, "payload_nbytes", None)
                or wr.buffer_stager.get_staging_cost_bytes()
                for wr in write_reqs
            )
        )
        await progress.async_tick(force=True)
    pending = deque(write_reqs)
    staged: deque = deque()  # (WriteReq, buf)
    staging: Dict[asyncio.Task, Tuple[WriteReq, int]] = {}
    io_tasks: Dict[asyncio.Task, int] = {}
    budget = memory_budget_bytes
    min_budget = memory_budget_bytes
    stall_s = 0.0
    ops: Dict[str, Dict[str, Any]] = {}
    bytes_written = 0
    executor = ThreadPoolExecutor(max_workers=_MAX_STAGING_THREADS)
    in_use_gauge = telemetry.gauge(_metric_names.SCHED_BUDGET_IN_USE, pipeline="write")
    stalled_gauge = telemetry.gauge(_metric_names.SCHED_BUDGET_STALLED, pipeline="write")
    # Staged buffers live only between stage and write: any residual
    # after the pipeline exits is a leak. The burst is at most the
    # smaller of the total staging cost and the budget.
    mem_domain = memwatch.register(
        "scheduler.write",
        cap_bytes=memory_budget_bytes,
        transient=True,
        watch_residual="used",
    )
    memwatch.forecast(
        min(
            sum(wr.buffer_stager.get_staging_cost_bytes() for wr in write_reqs),
            memory_budget_bytes,
        ),
        kind="take",
    )

    async def _stage(wr: WriteReq, cost: int) -> Any:
        t0 = time.monotonic()
        with tracing.span("stage", path=wr.path, bytes=cost):
            buf = await wr.buffer_stager.stage_buffer(executor)
        _observe_op(ops, "stage", time.monotonic() - t0, len(buf), progress)
        # A chunk's codec ran inside the stage: report it as its own op
        # (no progress credit; the stage took it).
        enc = getattr(wr.buffer_stager, "encode_stats", None)
        if enc is not None:
            _observe_op(ops, "encode", enc[0], enc[1])
            telemetry.counter(_metric_names.CODEC_SECONDS, op="encode").inc(enc[0])
        return buf

    async def _write(wr: WriteReq, buf: Any) -> None:
        # Credit in the units bytes_total summed (before compression).
        share = (
            getattr(wr.buffer_stager, "payload_nbytes", None)
            or wr.buffer_stager.get_staging_cost_bytes()
        )
        t0 = time.monotonic()
        with tracing.span("write", path=wr.path, bytes=len(buf)):
            await storage.write(IOReq(path=wr.path, data=buf))
        _observe_op(
            ops, "write", time.monotonic() - t0, len(buf), progress, progress_bytes=share
        )

    try:
        while pending or staged or staging or io_tasks:
            blocked = False
            while pending:
                cost = pending[0].buffer_stager.get_staging_cost_bytes()
                nothing_in_flight = not (staging or staged or io_tasks)
                if budget < cost and not nothing_in_flight:
                    blocked = True
                    break
                wr = pending.popleft()
                budget -= cost
                min_budget = min(min_budget, budget)
                staging[asyncio.ensure_future(_stage(wr, cost))] = (wr, cost)
            while staged and len(io_tasks) < storage.max_write_concurrency:
                wr, buf = staged.popleft()
                io_tasks[asyncio.ensure_future(_write(wr, buf))] = len(buf)
            in_use = max(0, memory_budget_bytes - budget)
            in_use_gauge.set(in_use)
            mem_domain.set_used(in_use, pinned_bytes=in_use)
            stalled_gauge.set(1.0 if blocked else 0.0)
            in_flight = set(staging) | set(io_tasks)
            if not in_flight:
                continue
            wait_t0 = time.monotonic()
            done, _ = await asyncio.wait(
                in_flight, return_when=asyncio.FIRST_COMPLETED
            )
            if blocked:
                # Work was ready but the budget said no: the time until
                # the next completion is budget stall.
                stall_s += time.monotonic() - wait_t0
            for task in done:
                if task in staging:
                    wr, cost = staging.pop(task)
                    buf = task.result()
                    budget += cost - len(buf)
                    staged.append((wr, buf))
                else:
                    buf_len = io_tasks.pop(task)
                    task.result()  # propagate storage errors
                    budget += buf_len
                    bytes_written += buf_len
            if progress is not None:
                await progress.async_tick()
    finally:
        executor.shutdown(wait=False)
        in_use_gauge.set(0)
        stalled_gauge.set(0)
        mem_domain.set_used(max(0, memory_budget_bytes - budget))
        mem_domain.close()
    _merge_stats(stats, "write", bytes_written, stall_s, memory_budget_bytes - min_budget, ops)
    logger.info(
        "Rank %d saved %d bytes in %.3f s",
        rank,
        bytes_written,
        time.monotonic() - begin,
    )
    return bytes_written


class _BudgetCell:
    """A budget shared with consumers that hold deferred reservations:
    ``release`` re-credits when the backing allocation is freed, from any
    thread. Counts its charges and releases for the force-admit grace."""

    __slots__ = ("value", "low", "_lock", "_charges", "_releases")

    def __init__(self, value: int) -> None:
        self.value = value
        self.low = value
        self._lock = threading.Lock()
        self._charges = 0
        self._releases = 0

    def charge(self, nbytes: int) -> None:
        with self._lock:
            self.value -= nbytes
            self.low = min(self.low, self.value)
            self._charges += 1

    def release(self, nbytes: int) -> None:
        with self._lock:
            self.value += nbytes
            self._releases += 1

    def charge_count(self) -> int:
        with self._lock:
            return self._charges

    def release_count(self) -> int:
        with self._lock:
            return self._releases


# Force-admission grace: when nothing is in flight on the event loop but
# the head still does not fit the budget, a completed consume's deferred
# release may still be riding a pipeline thread the OS has not scheduled
# yet. Wait this long for such a straggler before force-admitting.
_FORCE_ADMIT_GRACE_S = 0.5
_FORCE_ADMIT_POLL_S = 0.005


async def _straggler_release_landed(cell: _BudgetCell) -> bool:
    """Wait up to the grace window for ANY release on ``cell``; True means
    one landed and the caller should rescan under the refreshed budget."""
    if cell.charge_count() == 0:
        # Nothing was ever charged, so no release can be in flight.
        return False
    baseline = cell.release_count()
    deadline = time.monotonic() + _FORCE_ADMIT_GRACE_S
    while time.monotonic() < deadline:
        await asyncio.sleep(_FORCE_ADMIT_POLL_S)
        if cell.release_count() != baseline:
            return True
    return cell.release_count() != baseline


async def execute_read_reqs(
    read_reqs: List[ReadReq],
    storage: StoragePlugin,
    memory_budget_bytes: int,
    rank: int,
    device_budget_bytes: Optional[int] = None,
    stats: Optional[Dict[str, Any]] = None,
    progress: Optional[Any] = None,
) -> int:
    """Run the read→consume pipeline; returns total bytes read.

    The largest LOGICAL objects go first (``sort_key_bytes``, else the
    consuming cost), so one big object does not gate the tail alone; a
    split object's sub-reads share one key and stay together in order.

    ``device_budget_bytes`` bounds the device bytes held by in-flight
    consumes (:meth:`BufferConsumer.get_device_cost_bytes`); None is
    unbounded. A consume that does not fit waits, while consumes behind
    it that fit go ahead; with nothing in flight the head is admitted
    anyway, so the overrun is bounded by one consume's device bytes.

    ``stats`` (optional) accumulates this run's numbers: bytes, per-op
    count/seconds/bytes (``read``, ``consume``), the seconds dispatch
    waited on a budget, and both budgets' high-water marks. ``progress``
    (a ProgressPublisher) is pulsed at every op, as in
    :func:`execute_write_reqs`.
    """
    begin = time.monotonic()
    if progress is not None:
        progress.add_bytes_total(sum(r.buffer_consumer.get_progress_bytes() for r in read_reqs))
        await progress.async_tick(force=True)

    def _sort_bytes(r: ReadReq) -> int:
        key = r.buffer_consumer.sort_key_bytes
        return key if key is not None else r.buffer_consumer.get_consuming_cost_bytes()

    pending = deque(sorted(read_reqs, key=lambda r: -_sort_bytes(r)))
    reading: Dict[asyncio.Task, Tuple[ReadReq, int]] = {}
    # Completed reads waiting for their consume: (req, buf, refund, ready_t).
    consumable: deque = deque()
    consuming: Dict[asyncio.Task, int] = {}
    profile = _cprof.current()
    budget = _BudgetCell(memory_budget_bytes)
    device_budget = _BudgetCell(
        device_budget_bytes if device_budget_bytes is not None else 1 << 62
    )
    ops: Dict[str, Dict[str, Any]] = {}
    stall_s = 0.0
    bytes_read = 0
    executor = ThreadPoolExecutor(max_workers=_MAX_STAGING_THREADS)
    in_use_gauge = telemetry.gauge(_metric_names.SCHED_BUDGET_IN_USE, pipeline="read")
    stalled_gauge = telemetry.gauge(_metric_names.SCHED_BUDGET_STALLED, pipeline="read")
    # The host cell's bytes are transient host memory; the device cell's
    # are card memory, registered external (shown, but not counted
    # against the host's headroom).
    mem_domain = memwatch.register(
        "scheduler.read.host",
        cap_bytes=memory_budget_bytes,
        transient=True,
        watch_residual="used",
    )
    mem_device_domain = memwatch.register(
        "scheduler.read.device",
        cap_bytes=device_budget_bytes,
        transient=True,
        external=True,
    )
    memwatch.forecast(
        min(
            sum(r.buffer_consumer.get_consuming_cost_bytes() for r in read_reqs),
            memory_budget_bytes,
        ),
        kind="restore",
    )

    async def _read(rr: ReadReq, share: int) -> IOReq:
        io_req = IOReq(path=rr.path, byte_range=rr.byte_range)
        t0 = time.monotonic()
        with tracing.span("read", path=rr.path) as end:
            await storage.read(io_req)
            if end is not None:
                # A view of an object the backend holds (memory://'s
                # ranged reads), not a payload made for this read.
                end["view"] = isinstance(io_req.data, memoryview)
        _observe_op(
            ops, "read", time.monotonic() - t0, len(io_payload(io_req)), progress,
            progress_bytes=share,
        )
        return io_req

    async def _consume(rr: ReadReq, buf: Any) -> None:
        t0 = time.monotonic()
        with tracing.span("consume", path=rr.path, bytes=len(buf)):
            await rr.buffer_consumer.consume_buffer(buf, executor)
        _observe_op(ops, "consume", time.monotonic() - t0, len(buf), progress)

    try:
        while pending or reading or consumable or consuming:
            blocked = False
            while pending and len(reading) < storage.max_read_concurrency:
                consumer = pending[0].buffer_consumer
                cost = consumer.get_consuming_cost_bytes()
                nothing_in_flight = not (reading or consumable or consuming)
                if budget.value < cost and nothing_in_flight:
                    # A deferred release may still be on its way from a
                    # pipeline thread: give it the grace before forcing.
                    while budget.value < cost and await _straggler_release_landed(budget):
                        pass
                if budget.value < cost and not nothing_in_flight:
                    blocked = True
                    break
                rr = pending.popleft()
                # Re-credited when the consume completes, except the
                # deferred part, which the consumer's releaser returns.
                # Invariant the flow analysis cannot see: the release
                # lands in a LATER loop iteration, and the cell is
                # per-pipeline-run — a failed run cancels its tasks and
                # drops the cell with the stack frame, so no charge
                # outlives the budget it was charged against.
                # snapcheck: disable=resource-lifecycle -- cross-iteration discharge: released at task completion (below) or via the consumer's deferred releaser; cell dies with the run
                budget.charge(cost)
                deferred = consumer.get_deferred_cost_bytes()
                if deferred:
                    consumer.set_cost_releaser(budget.release)
                share = consumer.get_progress_bytes()
                reading[asyncio.ensure_future(_read(rr, share))] = (rr, cost - deferred)

            # Consume dispatch under the device budget. The scan skips
            # past blocked entries: a consume waiting for device bytes
            # must not hold back consumes that need none, whose progress
            # is what frees budget.
            while consumable:
                pick = None
                for i, (rr, _buf, _refund, _ready_t) in enumerate(consumable):
                    dcost = rr.buffer_consumer.get_device_cost_bytes()
                    if not dcost or device_budget.value >= dcost:
                        pick = i
                        break
                if pick is None:
                    if reading or consuming:
                        blocked = True
                        break
                    if await _straggler_release_landed(device_budget):
                        continue
                    pick = 0
                rr, buf, refund, ready_t = consumable[pick]
                del consumable[pick]
                if profile is not None:
                    profile.note("read_wait", time.monotonic() - ready_t, len(buf))
                dcost = rr.buffer_consumer.get_device_cost_bytes()
                if dcost:
                    device_budget.charge(dcost)
                    rr.buffer_consumer.set_device_cost_releaser(device_budget.release)
                consuming[asyncio.ensure_future(_consume(rr, buf))] = refund

            host_in_use = max(0, memory_budget_bytes - budget.value)
            in_use_gauge.set(host_in_use)
            mem_domain.set_used(host_in_use, pinned_bytes=host_in_use)
            if device_budget_bytes is not None:
                dev_in_use = max(0, device_budget_bytes - device_budget.value)
                mem_device_domain.set_used(dev_in_use, pinned_bytes=dev_in_use)
            stalled_gauge.set(1.0 if blocked else 0.0)
            in_flight = set(reading) | set(consuming)
            if not in_flight:
                continue
            wait_t0 = time.monotonic()
            done, _ = await asyncio.wait(in_flight, return_when=asyncio.FIRST_COMPLETED)
            if blocked:
                # Work was ready but a budget said no: the time until the
                # next completion is budget stall.
                stall_s += time.monotonic() - wait_t0
            for task in done:
                if task in reading:
                    rr, refund = reading.pop(task)
                    buf = io_payload(task.result())
                    bytes_read += len(buf)
                    consumable.append((rr, buf, refund, time.monotonic()))
                else:
                    refund = consuming.pop(task)
                    task.result()  # propagate consume errors
                    budget.release(refund)
            if progress is not None:
                await progress.async_tick()
    finally:
        for task in list(reading) + list(consuming):
            task.cancel()
        # After a failure, let the consumes already running finish (they
        # may still submit transfers the caller must wait out) and drop
        # the queued ones.
        executor.shutdown(wait=True, cancel_futures=True)
        in_use_gauge.set(0)
        stalled_gauge.set(0)
        mem_domain.set_used(max(0, memory_budget_bytes - budget.value))
        mem_domain.close()
        mem_device_domain.close()
    elapsed = time.monotonic() - begin
    _merge_stats(stats, "read", bytes_read, stall_s, memory_budget_bytes - budget.low, ops)
    if stats is not None:
        stats["seconds"] = stats.get("seconds", 0.0) + elapsed
        if device_budget_bytes is not None:
            stats["device_budget_bytes"] = device_budget_bytes
            stats["device_high_water_bytes"] = max(
                stats.get("device_high_water_bytes", 0),
                device_budget_bytes - device_budget.low,
            )
    logger.info("Rank %d loaded %d bytes in %.3f s", rank, bytes_read, elapsed)
    return bytes_read
