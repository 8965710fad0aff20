"""Live in-flight progress records (snapwatch's publishing half).

Everything the flight recorder (:mod:`.report`) ships is post-hoc: the
``.report.json`` exists only once a take commits, so a 30-minute
multi-rank take that hangs, straggles, or crawls is a black box until it
finishes or times out. This module closes that gap: the take/restore
paths publish small rank-local **progress records** on a cadence —

- to a **local statusfile** (``TPUSNAPSHOT_PROGRESS_DIR``, one
  atomically-replaced JSON per rank), readable by anything on the host;
- on the **async/storage commit route** (where the take_id nonce exists
  before the writes drain), to ``.progress/<take_id>/<rank>`` objects in
  the snapshot prefix itself — so ``python -m
  torchsnapshot_tpu_torch.telemetry.watch <path>`` can render per-rank
  phase/throughput/ETA for an in-flight operation from any machine that
  can read the snapshot's storage, and flag ranks whose heartbeat went
  stale (straggler / hang detection).

Progress is observability, not protocol: every publish is best-effort,
rate-limited (``TPUSNAPSHOT_PROGRESS_INTERVAL_S``, default 2s), and may
never fail or slow the operation it describes. Storage progress objects
are cleaned at commit: each rank publishes a terminal ``done`` record
BEFORE its completion marker (never deleting its own), and rank 0 —
the only deleter — sweeps every rank's object after the metadata
lands, so the sweep cannot race a republish.
``CheckpointManager.reconcile`` reclaims debris left by crashed takes —
a progress object must never survive a commit or a detected crash.

Record schema (``format_version`` 1)::

    {
      "format_version": 1,
      "kind": "take" | "async_take" | "restore",
      "path": "<snapshot url>",
      "take_id": "<nonce or null>",
      "rank": r, "world_size": N,
      "phase": "capture" | "prestage" | "write" | "commit" | ... | "done",
      "bytes_done": B, "bytes_total": T | null,
      "ops": {"stage": n, "write": n, ...},      # pipelined op counts
      "retries": n,                              # storage retry delta
      "seq": monotonically increasing per publish,
      "host": hostname, "pid": pid,
      "started_at": wall epoch s, "heartbeat_at": wall epoch s
    }

``heartbeat_at`` is the load-bearing field: the publisher refreshes it
at every pipeline completion and phase change, so a rank whose record
stops aging forward is stuck inside one storage op, one collective, or
one device transfer — exactly the straggler signature ``watch`` flags.
"""

import json
import logging
import os
import socket
import threading
import time
from typing import Any, Dict, Optional

from .. import tracing
from . import metrics as _m
from .metrics import REGISTRY, diff_snapshots, sum_samples

logger = logging.getLogger(__name__)

PROGRESS_FORMAT_VERSION = 1
# Listing prefix covering every progress object a snapshot can hold.
PROGRESS_PREFIX = ".progress"
# Per-rank in-flight records on the storage route.
RANK_PROGRESS_PREFIX = ".progress/"

_INTERVAL_ENV_VAR = "TPUSNAPSHOT_PROGRESS_INTERVAL_S"
_DEFAULT_INTERVAL_S = 2.0
_DIR_ENV_VAR = "TPUSNAPSHOT_PROGRESS_DIR"

# Phase a finished operation publishes; watch renders it as complete and
# never flags its heartbeat as stale.
DONE_PHASE = "done"


def progress_path(take_id: str, rank: int) -> str:
    return f"{RANK_PROGRESS_PREFIX}{take_id}/{rank}"


def statusfile_name(rank: int) -> str:
    return f"rank{rank}.progress.json"


def _interval_s() -> float:
    raw = os.environ.get(_INTERVAL_ENV_VAR)
    if raw is None:
        return _DEFAULT_INTERVAL_S
    try:
        return max(0.0, float(raw))
    except ValueError:
        logger.warning(
            "Malformed %s=%r; using %gs",
            _INTERVAL_ENV_VAR,
            raw,
            _DEFAULT_INTERVAL_S,
        )
        return _DEFAULT_INTERVAL_S


class ProgressPublisher:
    """One rank's live progress record for one snapshot operation.

    Thread-safe: an async take updates from the background drain thread
    while the foreground may still be mutating phase state, and the
    statusfile write may race a reader (atomic tmp+rename, same
    crash-safe discipline as ``tracing.flush``).

    The storage sink is attached only once a take_id exists (async
    takes broadcast the nonce before the drain starts; sync takes draw
    it at commit time, when writes are already done — so sync takes and
    restores publish statusfiles only). Storage publication happens via
    :meth:`async_tick` from inside the pipeline's event loop, so it
    needs no extra thread and stops exactly when the pipeline stops —
    which is the point: a stuck pipeline's record goes stale.
    """

    def __init__(
        self,
        kind: str,
        path: str,
        rank: int,
        world_size: int = 1,
        take_id: Optional[str] = None,
        statusfile_dir: Optional[str] = None,
        interval_s: Optional[float] = None,
    ) -> None:
        self.kind = kind
        self.path = path
        self.rank = rank
        self.world_size = world_size
        self.take_id = take_id
        self._dir = (
            statusfile_dir
            if statusfile_dir is not None
            else os.environ.get(_DIR_ENV_VAR)
        )
        self._interval_s = (
            interval_s if interval_s is not None else _interval_s()
        )
        self._storage: Optional[Any] = None
        self._lock = threading.Lock()
        self._seq = 0
        self._phase = "starting"
        self._bytes_done = 0
        self._bytes_total: Optional[int] = None
        self._ops: Dict[str, int] = {}
        self._heartbeat_at = time.time()
        self._started_at = self._heartbeat_at
        self._baseline = REGISTRY.snapshot()
        self._last_file_emit = 0.0
        self._last_storage_emit = 0.0
        self._finished = False

    # ------------------------------------------------------------- mutation

    def attach_storage(self, storage: Any, take_id: str) -> None:
        """Enable the ``.progress/<take_id>/<rank>`` storage sink (the
        async/storage route, where the nonce exists before writes)."""
        with self._lock:
            self._storage = storage
            self.take_id = take_id

    def set_phase(self, phase: str) -> None:
        with self._lock:
            self._phase = phase
            self._heartbeat_at = time.time()
        self._emit_file(force=True)

    def add_bytes_total(self, total: int) -> None:
        """Accumulate expected bytes: an operation may run several
        pipeline legs (restore runs one per stateful), each announcing
        its own total as it starts."""
        with self._lock:
            self._bytes_total = (self._bytes_total or 0) + int(total)

    def pipeline_update(self, op: str, done_bytes: int = 0) -> None:
        """One pipelined op (stage/write/read/consume) completed. Called
        from the scheduler's event-loop thread per completion — the
        heartbeat's pulse. ``done_bytes`` is the op's share of
        ``bytes_total`` IN THE SAME UNITS the totals were announced in
        (the scheduler credits pre-compression costs, so done/total stay
        commensurable when compression shrinks the stored payloads);
        ops that re-describe already-counted payloads pass 0."""
        with self._lock:
            self._ops[op] = self._ops.get(op, 0) + 1
            self._bytes_done += int(done_bytes)
            self._heartbeat_at = time.time()
        self._emit_file()

    def heartbeat(self) -> None:
        """Refresh liveness without other state changes (long phases
        with no pipeline completions, e.g. marker polling)."""
        with self._lock:
            self._heartbeat_at = time.time()
        self._emit_file()

    def finish(self) -> None:
        """Publish the terminal record (phase ``done``) to the
        statusfile; storage objects are deleted at commit instead."""
        with self._lock:
            if self._finished:
                return
            self._finished = True
            self._phase = DONE_PHASE
            self._heartbeat_at = time.time()
        self._emit_file(force=True)

    # ------------------------------------------------------------ rendering

    def record(self) -> Dict[str, Any]:
        retries = sum_samples(
            diff_snapshots(self._baseline, REGISTRY.snapshot()),
            _m.STORAGE_RETRIES,
        )
        with self._lock:
            self._seq += 1
            return {
                "format_version": PROGRESS_FORMAT_VERSION,
                "kind": self.kind,
                "path": self.path,
                "take_id": self.take_id,
                "rank": self.rank,
                "world_size": self.world_size,
                "phase": self._phase,
                "bytes_done": self._bytes_done,
                "bytes_total": self._bytes_total,
                "ops": dict(self._ops),
                "retries": int(retries),
                "seq": self._seq,
                "host": socket.gethostname(),
                "pid": os.getpid(),
                "started_at": round(self._started_at, 3),
                "heartbeat_at": round(self._heartbeat_at, 3),
            }

    # -------------------------------------------------------------- sinks

    def _emit_file(self, force: bool = False) -> None:
        if self._dir is None:
            return
        now = time.monotonic()
        with self._lock:
            # Cadence check-and-set under the lock: the foreground and
            # the drain thread emit concurrently by contract.
            if not force and now - self._last_file_emit < self._interval_s:
                return
            self._last_file_emit = now
        try:
            os.makedirs(self._dir, exist_ok=True)
            target = os.path.join(self._dir, statusfile_name(self.rank))
            # Thread id in the tmp name: two threads sharing one tmp
            # could rename a half-written sibling into place; distinct
            # tmps make each replace atomic and complete (last wins).
            tmp = (
                f"{target}.tmp{os.getpid()}."
                f"{threading.get_ident() & 0xFFFFFFFF}"
            )
            with open(tmp, "w") as f:
                json.dump(self.record(), f)
            os.replace(tmp, target)
        except Exception as e:
            # Best-effort by contract; one debug line, never a failure.
            logger.debug("progress statusfile write failed: %r", e)

    async def async_tick(self, force: bool = False) -> None:
        """Publish to the attached storage sink if the cadence elapsed.
        Awaited from the pipeline's event loop (and the drain's phase
        boundaries); best-effort, and rate-limited so a fast pipeline
        does not turn progress into measurable IO load."""
        self._emit_file(force=force)
        storage, take_id = self._storage, self.take_id
        if storage is None or take_id is None:
            return
        now = time.monotonic()
        if not force and now - self._last_storage_emit < self._interval_s:
            return
        self._last_storage_emit = now
        try:
            from ..io_types import IOReq

            io_req = IOReq(
                path=progress_path(take_id, self.rank),
                data=json.dumps(self.record(), sort_keys=True).encode(
                    "utf-8"
                ),
            )
            with tracing.span("progress"):
                await storage.write(io_req)
        except Exception as e:
            logger.debug("progress object write failed: %r", e)


async def acleanup_progress_objects(
    storage: Any, take_id: str, world_size: int
) -> None:
    """Best-effort sweep of every rank's ``.progress/<take_id>/*`` object
    — called by rank 0 after the metadata commit, so a committed
    snapshot never retains in-flight progress debris. Deletes fan out
    under the backend's write cap: at pod scale, world_size sequential
    round-trips would measurably stretch the commit tail."""
    import asyncio

    sem = asyncio.Semaphore(
        max(1, getattr(storage, "max_write_concurrency", 1))
    )

    async def _one(r: int) -> None:
        async with sem:
            try:
                await storage.delete(progress_path(take_id, r))
            except Exception:
                # Absent (the rank never published) or transiently
                # unreadable — both fine; reconcile() sweeps survivors.
                logger.debug(
                    "progress cleanup of %s skipped",
                    progress_path(take_id, r),
                    exc_info=True,
                )

    await asyncio.gather(*(_one(r) for r in range(world_size)))


# ---------------------------------------------------------------- collection


def parse_record(data: bytes) -> Optional[Dict[str, Any]]:
    """A progress record from raw bytes; None when torn/garbage (a
    concurrent writer on a non-atomic backend is expected, not an
    error)."""
    try:
        doc = json.loads(data.decode("utf-8"))
    # Torn/garbage record IS the expected answer on a non-atomic
    # backend racing the writer; "no record" keeps the watcher going.
    except Exception:  # snapcheck: disable=swallowed-exception -- torn-record probe
        return None
    if not isinstance(doc, dict) or "rank" not in doc:
        return None
    return doc


def collect_statusfiles(directory: str) -> Dict[int, Dict[str, Any]]:
    """Read every ``rank<N>.progress.json`` under ``directory``."""
    out: Dict[int, Dict[str, Any]] = {}
    try:
        names = os.listdir(directory)
    except OSError:
        return out
    for name in names:
        if not (name.startswith("rank") and name.endswith(".progress.json")):
            continue
        try:
            with open(os.path.join(directory, name), "rb") as f:
                doc = parse_record(f.read())
        except OSError:
            continue
        if doc is not None:
            out[int(doc["rank"])] = doc
    return out


async def acollect_storage_records(
    storage: Any,
) -> Dict[str, Dict[int, Dict[str, Any]]]:
    """All in-flight progress records in a snapshot prefix, grouped by
    take_id: ``{take_id: {rank: record}}``."""
    out: Dict[str, Dict[int, Dict[str, Any]]] = {}
    from ..io_types import IOReq, io_payload

    paths = await storage.list_prefix(RANK_PROGRESS_PREFIX)
    for path in paths or []:
        tail = path[len(RANK_PROGRESS_PREFIX):]
        take_id, _, rank_s = tail.partition("/")
        if not take_id or not rank_s.isdigit():
            continue
        try:
            io_req = IOReq(path=path)
            await storage.read(io_req)
        # A record deleted between listing and read is the commit's
        # cleanup racing the watcher — expected, not an error.
        except Exception:  # snapcheck: disable=swallowed-exception -- commit races watch
            continue
        doc = parse_record(bytes(io_payload(io_req)))
        if doc is not None:
            out.setdefault(take_id, {})[int(rank_s)] = doc
    return out
