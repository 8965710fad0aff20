"""snapscope's publishing half: the live runtime sampler.

Everything else in the telemetry subsystem is either post-hoc (flight
reports, the ledger) or event-driven (progress records pulse when the
pipeline completes work). Neither can answer the questions that matter
while a background tier-down is the only thing between an acked
checkpoint and data loss: *how deep is the drain queue right now? how
old is its oldest item? how many committed bytes exist in RAM only? is
the scheduler stalled on its memory budget?* The sampler answers them
by periodically snapshotting runtime state — no hooks in the operation
paths, so it can never slow or fail them:

- **hot-tier drain pipeline** (``hottier.runtime.introspect()``): queue
  depth, oldest pending-object age, at-risk (committed-but-undrained)
  bytes per root, stranded-drain count, per-host replica occupancy vs
  capacity, drain heartbeat age ("event-loop lag");
- **scheduler budget**: live occupancy and stalled-right-now state (the
  gauges the pipelines maintain), plus the stall-seconds counters and
  high-water marks;
- **goodput**: the accountant's current attribution, when it has data.

Samples land in three sinks, all best-effort:

- a bounded in-memory **ring buffer** (``samples()``), what in-process
  consumers (the ops view, the SLO engine's live rules, tests) read;
- a local **JSONL statusfile** ``<dir>/rank<N>.scope.jsonl``
  (``TPUSNAPSHOT_PROGRESS_DIR`` — the same live-ops directory the
  progress statusfiles use), size-rotated so it stays bounded;
- optionally a **storage object** ``.scope/rank<N>`` in a snapshot
  prefix (latest sample only, atomically replaced), so
  ``python -m torchsnapshot_tpu_torch.telemetry.ops <url>`` can render the
  drain state from any machine that can read the snapshot's storage.
  Scope objects are operational debris like progress records:
  ``Snapshot.delete`` removes them and ``reconcile()`` sweeps aged
  orphans (they must never survive a deleted snapshot or a detected
  crash).

Crash isolation is the load-bearing contract: the sampler thread is a
daemon, every sampling pass is wrapped, an exception is counted
(``tpusnapshot_sampler_errors_total``) and logged once per distinct
error — it never propagates, and nothing on the take/restore path ever
waits on the sampler.
"""

import json
import logging
import os
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

from . import metrics as _m
from .metrics import REGISTRY

logger = logging.getLogger(__name__)

SAMPLE_FORMAT_VERSION = 1

# Storage-object prefix for published scope records (one per rank),
# mirroring the .progress/ lifecycle: swept by Snapshot.delete and by
# reconcile's age-guarded debris pass.
SCOPE_PREFIX = ".scope"


def scope_path(rank: int) -> str:
    return f"{SCOPE_PREFIX}/rank{rank}"


def statusfile_name(rank: int) -> str:
    return f"rank{rank}.scope.jsonl"


_INTERVAL_ENV_VAR = "TPUSNAPSHOT_SAMPLER_INTERVAL_S"
_DEFAULT_INTERVAL_S = 2.0
_DIR_ENV_VAR = "TPUSNAPSHOT_PROGRESS_DIR"  # shared live-ops directory
_RING_ENV_VAR = "TPUSNAPSHOT_SAMPLER_RING"
_DEFAULT_RING = 512
# Statusfile rotation cap: past this, the JSONL is rewritten from the
# ring (bounded by construction) instead of appended forever.
_STATUSFILE_CAP_BYTES = 1 << 20


def _scalar(name: str, **labels: str) -> float:
    return REGISTRY.gauge(name, **labels).value


class RuntimeSampler:
    """One process's background runtime sampler (see module docstring).

    ``storage_url`` (optional) enables the ``.scope/rank<N>`` storage
    sink; the plugin is resolved lazily on the sampler thread so even a
    hanging backend cannot block the caller that started the sampler.
    """

    def __init__(
        self,
        rank: int = 0,
        interval_s: Optional[float] = None,
        ring: Optional[int] = None,
        statusfile_dir: Optional[str] = None,
        storage_url: Optional[str] = None,
    ) -> None:
        self.rank = rank
        if interval_s is None:
            try:
                interval_s = float(
                    os.environ.get(_INTERVAL_ENV_VAR, _DEFAULT_INTERVAL_S)
                )
            except ValueError:
                interval_s = _DEFAULT_INTERVAL_S
        self.interval_s = max(0.05, interval_s)
        if ring is None:
            try:
                ring = int(os.environ.get(_RING_ENV_VAR, _DEFAULT_RING))
            except ValueError:
                ring = _DEFAULT_RING
        self._ring: Deque[Dict[str, Any]] = deque(maxlen=max(1, ring))
        self._dir = (
            statusfile_dir
            if statusfile_dir is not None
            else os.environ.get(_DIR_ENV_VAR)
        )
        self.storage_url = storage_url
        self._storage: Any = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._seq = 0
        self._last_error: Optional[str] = None
        self.error_count = 0

    # ------------------------------------------------------------ sampling

    def build_sample(self) -> Dict[str, Any]:
        """One sample of the live runtime state (may raise — callers go
        through :meth:`sample_once`, which is the crash-isolated path)."""
        from .. import hottier
        from . import goodput as _goodput

        with self._lock:
            self._seq += 1
            seq = self._seq
        sample: Dict[str, Any] = {
            "format_version": SAMPLE_FORMAT_VERSION,
            "ts_epoch_s": round(time.time(), 3),
            "seq": seq,
            "rank": self.rank,
            "pid": os.getpid(),
            "hot_tier": hottier.introspect(),
            "scheduler": {
                pipeline: {
                    "budget_in_use_bytes": int(
                        _scalar(_m.SCHED_BUDGET_IN_USE, pipeline=pipeline)
                    ),
                    "stalled": bool(
                        _scalar(_m.SCHED_BUDGET_STALLED, pipeline=pipeline)
                    ),
                    "stall_s_total": round(
                        REGISTRY.counter(
                            _m.SCHED_STALL_SECONDS, pipeline=pipeline
                        ).value,
                        6,
                    ),
                    "high_water_bytes": int(
                        _scalar(_m.SCHED_BUDGET_HWM, pipeline=pipeline)
                    ),
                }
                for pipeline in ("write", "read")
            },
            "goodput": (
                _goodput.snapshot() if _goodput.has_data() else None
            ),
        }
        # Wire observability (wiretap/snapflight): cumulative per-op
        # view — the slo live rule diffs consecutive samples for
        # fresh deadline misses; absent when nothing crossed a wire.
        from .. import wiretap

        wire = wiretap.sample_block()
        if wire.get("ops"):
            sample["wire"] = wire
        # Host memory plane (memwatch/snapmem): the cross-domain
        # occupancy table + headroom headline — the slo live rule
        # tracks residual drift and overcommit across samples; absent
        # when no domain is registered. Includes the staging pool's
        # retained/leased/high-water split via its domain entry.
        from . import memwatch

        mem = memwatch.sample_block()
        if mem.get("domains"):
            sample["memory"] = mem
        return sample

    def sample_once(self) -> Optional[Dict[str, Any]]:
        """Take one sample and publish it to every sink; returns the
        sample, or None when the pass failed (counted, never raised) —
        the crash-isolation boundary the tests pin."""
        try:
            sample = self.build_sample()
        except Exception as e:
            self._note_error(e, where="build")
            return None
        self._ring.append(sample)
        REGISTRY.counter(_m.SAMPLER_SAMPLES).inc()
        try:
            self._emit_file(sample)
        except Exception as e:
            self._note_error(e, where="statusfile")
        try:
            self._emit_storage(sample)
        except Exception as e:
            self._note_error(e, where="storage")
        return sample

    def _note_error(self, e: BaseException, where: str) -> None:
        self.error_count += 1
        REGISTRY.counter(_m.SAMPLER_ERRORS).inc()
        msg = f"{where}: {e!r}"
        if msg != self._last_error:
            # Log each distinct failure once, not once per tick — a
            # persistently broken sink must not flood the log at 0.5 Hz.
            self._last_error = msg
            logger.warning("runtime sampler %s failed: %r", where, e)

    # -------------------------------------------------------------- sinks

    def _emit_file(self, sample: Dict[str, Any]) -> None:
        if self._dir is None:
            return
        os.makedirs(self._dir, exist_ok=True)
        target = os.path.join(self._dir, statusfile_name(self.rank))
        line = json.dumps(sample, sort_keys=True) + "\n"
        try:
            size = os.path.getsize(target)
        except OSError:
            size = 0
        if size + len(line) > _STATUSFILE_CAP_BYTES:
            # Rotate by rewriting from the ring: bounded on disk, and
            # the tail a reader wants (recent samples) survives.
            tmp = f"{target}.tmp{os.getpid()}"
            with open(tmp, "w") as f:
                for s in list(self._ring):
                    f.write(json.dumps(s, sort_keys=True) + "\n")
            # snapcheck: disable=durability-order -- ephemeral live state; a sample lost to a crash is re-sampled next tick
            os.replace(tmp, target)
        else:
            with open(target, "a") as f:
                # snapcheck: disable=durability-order -- ephemeral live state; a sample lost to a crash is re-sampled next tick
                f.write(line)

    def _emit_storage(self, sample: Dict[str, Any]) -> None:
        if self.storage_url is None:
            return
        if self._storage is None:
            from ..storage_plugin import url_to_storage_plugin

            self._storage = url_to_storage_plugin(self.storage_url)
        import asyncio

        from ..io_types import IOReq

        asyncio.run(
            self._storage.write(
                IOReq(
                    path=scope_path(self.rank),
                    data=json.dumps(sample, sort_keys=True).encode("utf-8"),
                )
            )
        )

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "RuntimeSampler":
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop,
                name="tpusnapshot-scope-sampler",
                daemon=True,
            )
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.is_set():
            self.sample_once()
            self._stop.wait(self.interval_s)

    def stop(self, final_sample: bool = True) -> None:
        self._stop.set()
        thread = self._thread
        if thread is not None and thread.is_alive():
            thread.join(timeout=5.0)
        if final_sample:
            self.sample_once()
        storage, self._storage = self._storage, None
        if storage is not None:
            try:
                storage.close()
            except Exception as e:
                logger.debug("sampler storage close failed: %r", e)

    def samples(self) -> List[Dict[str, Any]]:
        return list(self._ring)

    def latest(self) -> Optional[Dict[str, Any]]:
        return self._ring[-1] if self._ring else None


# ------------------------------------------------------- module-level API

_SAMPLER: Optional[RuntimeSampler] = None
_SAMPLER_LOCK = threading.Lock()


def start(
    storage_url: Optional[str] = None, **kwargs: Any
) -> RuntimeSampler:
    """Start (or return) the process-wide sampler. ``storage_url``
    additionally publishes ``.scope/rank<N>`` into that snapshot
    prefix."""
    global _SAMPLER
    with _SAMPLER_LOCK:
        if _SAMPLER is None:
            _SAMPLER = RuntimeSampler(storage_url=storage_url, **kwargs)
            _SAMPLER.start()
        return _SAMPLER


def stop(final_sample: bool = True) -> None:
    global _SAMPLER
    with _SAMPLER_LOCK:
        sampler, _SAMPLER = _SAMPLER, None
    if sampler is not None:
        sampler.stop(final_sample=final_sample)


def current() -> Optional[RuntimeSampler]:
    return _SAMPLER


# ---------------------------------------------------------------- reading


def parse_statusfile(path: str) -> List[Dict[str, Any]]:
    """All parseable samples from one ``rank<N>.scope.jsonl`` (torn tail
    lines are skipped — a concurrent writer is expected)."""
    out: List[Dict[str, Any]] = []
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError:
        return out
    for line in raw.splitlines():
        if not line.strip():
            continue
        try:
            doc = json.loads(line.decode("utf-8"))
        # Torn/garbage line IS the expected answer mid-append.
        except Exception:  # snapcheck: disable=swallowed-exception -- torn-line probe
            continue
        if isinstance(doc, dict) and "format_version" in doc:
            out.append(doc)
    return out


def collect_statusfiles(directory: str) -> Dict[int, List[Dict[str, Any]]]:
    """``{rank: samples}`` from every scope statusfile under
    ``directory``."""
    out: Dict[int, List[Dict[str, Any]]] = {}
    try:
        names = os.listdir(directory)
    except OSError:
        return out
    for name in names:
        if not (name.startswith("rank") and name.endswith(".scope.jsonl")):
            continue
        samples = parse_statusfile(os.path.join(directory, name))
        if samples:
            out[int(samples[-1].get("rank", 0))] = samples
    return out


async def acollect_storage_records(
    storage: Any,
) -> Dict[int, List[Dict[str, Any]]]:
    """Latest published sample per rank from ``.scope/rank<N>`` objects
    (each holds one sample; returned as a one-element list so dir and
    storage modes share a shape)."""
    import re

    from ..io_types import IOReq, io_payload

    out: Dict[int, List[Dict[str, Any]]] = {}
    pat = re.compile(r"^\.scope/rank(\d+)$")
    for path in await storage.list_prefix(SCOPE_PREFIX + "/") or []:
        m = pat.match(path)
        if not m:
            continue
        try:
            io_req = IOReq(path=path)
            await storage.read(io_req)
            doc = json.loads(bytes(io_payload(io_req)).decode("utf-8"))
        # Deleted/torn between list and read: the writer (or a delete)
        # raced the reader — expected for live state.
        except Exception:  # snapcheck: disable=swallowed-exception -- live-state read races
            continue
        if isinstance(doc, dict):
            out[int(m.group(1))] = [doc]
    return out
