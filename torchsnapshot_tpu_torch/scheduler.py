"""Memory-budgeted, pipelined execution of write/read requests.

Two two-stage asyncio pipelines overlap staging with storage IO under a
per-process host-memory budget:

- write: ``stage_buffer`` (device→host copy + checksum, thread executor)
  → ``storage.write``;
- read: ``storage.read`` → ``consume_buffer`` (checksum + host→device
  copy, thread executor).

Budget accounting: a write charges its staging cost at dispatch,
re-credits ``cost − len(buf)`` when staging ends and ``len(buf)`` when the
write lands; a read charges its consuming cost at dispatch and re-credits
it after the consume. At least one request is always in flight regardless
of budget, so a single over-budget buffer cannot deadlock the pipeline.
"""

import asyncio
import logging
import os
import socket
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

from .io_types import IOReq, ReadReq, StoragePlugin, WriteReq, io_payload

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


async def execute_write_reqs(
    write_reqs: List[WriteReq],
    storage: StoragePlugin,
    memory_budget_bytes: int,
    rank: int,
) -> int:
    """Run the staged-write pipeline; returns total bytes written."""
    begin = time.monotonic()
    pending = deque(write_reqs)
    staged: deque = deque()  # (WriteReq, buf)
    staging: Dict[asyncio.Task, Tuple[WriteReq, int]] = {}
    io_tasks: Dict[asyncio.Task, int] = {}
    budget = memory_budget_bytes
    bytes_written = 0
    executor = ThreadPoolExecutor(max_workers=_MAX_STAGING_THREADS)
    try:
        while pending or staged or staging or io_tasks:
            while pending:
                cost = pending[0].buffer_stager.get_staging_cost_bytes()
                nothing_in_flight = not (staging or staged or io_tasks)
                if budget < cost and not nothing_in_flight:
                    break
                wr = pending.popleft()
                budget -= cost
                task = asyncio.ensure_future(wr.buffer_stager.stage_buffer(executor))
                staging[task] = (wr, cost)
            while staged and len(io_tasks) < storage.max_write_concurrency:
                wr, buf = staged.popleft()
                task = asyncio.ensure_future(
                    storage.write(IOReq(path=wr.path, data=buf))
                )
                io_tasks[task] = len(buf)
            in_flight = set(staging) | set(io_tasks)
            if not in_flight:
                continue
            done, _ = await asyncio.wait(
                in_flight, return_when=asyncio.FIRST_COMPLETED
            )
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
    finally:
        executor.shutdown(wait=False)
    logger.info(
        "Rank %d saved %d bytes in %.3f s",
        rank,
        bytes_written,
        time.monotonic() - begin,
    )
    return bytes_written


async def execute_read_reqs(
    read_reqs: List[ReadReq],
    storage: StoragePlugin,
    memory_budget_bytes: int,
    rank: int,
) -> int:
    """Run the read→consume pipeline; returns total bytes read. The
    largest objects go first, so one big object does not gate the tail
    alone."""
    begin = time.monotonic()
    pending = deque(
        sorted(
            read_reqs, key=lambda r: -r.buffer_consumer.get_consuming_cost_bytes()
        )
    )
    reading: Dict[asyncio.Task, Tuple[ReadReq, int]] = {}
    consuming: Dict[asyncio.Task, int] = {}
    budget = memory_budget_bytes
    bytes_read = 0
    executor = ThreadPoolExecutor(max_workers=_MAX_STAGING_THREADS)

    async def _read(rr: ReadReq) -> IOReq:
        io_req = IOReq(path=rr.path, byte_range=rr.byte_range)
        await storage.read(io_req)
        return io_req

    try:
        while pending or reading or consuming:
            while pending and len(reading) < storage.max_read_concurrency:
                cost = pending[0].buffer_consumer.get_consuming_cost_bytes()
                nothing_in_flight = not (reading or consuming)
                if budget < cost and not nothing_in_flight:
                    break
                rr = pending.popleft()
                budget -= cost
                reading[asyncio.ensure_future(_read(rr))] = (rr, cost)
            done, _ = await asyncio.wait(
                set(reading) | set(consuming),
                return_when=asyncio.FIRST_COMPLETED,
            )
            for task in done:
                if task in reading:
                    rr, cost = reading.pop(task)
                    buf = io_payload(task.result())
                    bytes_read += len(buf)
                    consume = rr.buffer_consumer.consume_buffer(buf, executor)
                    consuming[asyncio.ensure_future(consume)] = cost
                else:
                    cost = consuming.pop(task)
                    task.result()  # propagate consume errors
                    budget += cost
    finally:
        executor.shutdown(wait=False)
    logger.info(
        "Rank %d loaded %d bytes in %.3f s",
        rank,
        bytes_read,
        time.monotonic() - begin,
    )
    return bytes_read
