"""snapflight — shared wire observability for every transport.

The snapwire hot-tier transport/peer pair and the repair/membership
probes (and, once it is ported, the snapserve read plane) report RPCs
here instead of growing per-stack copies. Per ``(transport, op)`` the
layer records:

- log2-bucketed latency histograms and bytes in/out,
- a bounded result taxonomy (``ok`` / error kind / ``deadline_miss`` /
  per-attempt retries),
- **deadline margin**: the fraction of the per-RPC budget the call
  consumed (1.0 == the whole deadline). Margin is the signal that says
  which hand-tuned ``TPUSNAPSHOT_*_DEADLINE_S`` /
  ``TPUSNAPSHOT_*_TIMEOUT_S`` knobs are mis-sized *before* an op blows
  its budget — doctor's ``deadline-margin-collapsing`` rule and the
  ops CLI's deadline-pressure table read it.

Everything mirrors into the process metrics registry (the
``tpusnapshot_wire_*`` catalog entries) AND into module-local
aggregates that support cheap windowed deltas (``window_begin`` /
``window_collect``) for flight reports and bench blocks, mirroring the
hot tier's ``replication_stats_begin`` pattern.

**Flight recorder.** Always on: a bounded ring of the last N RPC
events (trace id, op, peer, latency, outcome, attempt). On fault /
degrade / process-exit hooks the ring dumps to a
``*.blackbox.jsonl`` statusfile so a crash leaves evidence in the
*survivors* — the SIGKILL'd process never gets to write anything, its
peers' blackboxes carry its last known RPCs. Dump lines use the
ledger's crc envelope (``telemetry.ledger.encode_line``), so a torn
tail from a dump interrupted mid-write is skipped by the same
discipline ``parse_ledger_bytes`` applies to the ledger itself, and
events are joinable to a merged snapxray trace by trace id.

Hot-path cost is one lock acquire + dict bumps per RPC; the blackbox
only touches disk on the hooks. Recording must never take a transport
down: callers wrap ``record`` in best-effort guards or call it after
the RPC outcome is already decided.
"""

import atexit
import json
import logging
import os
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

from . import tracing
from .telemetry import memwatch
from .telemetry.metrics import (
    REGISTRY,
    WIRE_BLACKBOX_DUMPS,
    WIRE_DEADLINE_MARGIN,
    WIRE_DEADLINE_MISSES,
    WIRE_OP_BYTES,
    WIRE_OP_RESULTS,
    WIRE_OP_SECONDS,
    WIRE_RETRIES,
    bucket_le,
)
from .utils.env import env_float, env_int

logger = logging.getLogger(__name__)

# Ring capacity (events kept in memory for the blackbox dump).
_RING_ENV_VAR = "TPUSNAPSHOT_WIRETAP_RING"
_DEFAULT_RING = 512
# Blackbox directory; falls back to the live-ops statusfile directory.
_DIR_ENV_VAR = "TPUSNAPSHOT_WIRETAP_DIR"
_PROGRESS_DIR_ENV_VAR = "TPUSNAPSHOT_PROGRESS_DIR"
# Degrade storms (a dying peer fails every ladder rung) must not turn
# into a dump-per-failure disk storm: dumps are rate-limited per path.
_DUMP_INTERVAL_ENV_VAR = "TPUSNAPSHOT_WIRETAP_DUMP_INTERVAL_S"
_DEFAULT_DUMP_INTERVAL_S = 1.0

_TRACE_ROLE_ENV_VAR = "TPUSNAPSHOT_TRACE_ROLE"

# Bounded result taxonomy. Wire error kinds map 1:1; anything novel is
# clamped to "error" so the label set stays enumerable.
OUTCOMES = frozenset(
    {
        "ok",
        "deadline_miss",
        "transport",
        "not_found",
        "range",
        "bad_request",
        "backend",
        "bad_frame",
        "stale_basis",
        "corrupt_push",
        "error",
    }
)

# Server-reported error kinds that pass through as outcome labels:
# the wire taxonomy (error_to_wire) plus the snapwire push verdicts.
_WIRE_ERROR_KINDS = frozenset(
    {
        "not_found",
        "range",
        "bad_request",
        "backend",
        "bad_frame",
        "stale_basis",
        "corrupt_push",
    }
)


def classify_error(exc: BaseException) -> str:
    """Map a client-side RPC failure into the bounded outcome taxonomy
    using the same structural taxonomy :mod:`.wire` marshals."""
    import asyncio

    from . import wire

    if isinstance(exc, FileNotFoundError):
        return "not_found"
    if isinstance(exc, wire.InvalidRange):
        return "range"
    if isinstance(exc, wire.RemoteServerError):
        return "backend"
    if isinstance(exc, wire.ProtocolError):
        return "bad_frame"
    # Before the OSError umbrella: an expired per-RPC wait IS a
    # deadline miss (builtins.TimeoutError subclasses OSError).
    if isinstance(exc, (asyncio.TimeoutError, TimeoutError)):
        return "deadline_miss"
    if isinstance(
        exc,
        (
            ConnectionError,
            OSError,
            EOFError,
            asyncio.IncompleteReadError,
        ),
    ):
        return "transport"
    return "error"


def outcome_from_wire_error(error: Optional[Dict[str, Any]]) -> str:
    """The outcome label for a server-reported wire error dict."""
    kind = (error or {}).get("kind")
    return kind if kind in _WIRE_ERROR_KINDS else "error"


def _new_agg() -> Dict[str, Any]:
    return {
        "count": 0,
        "seconds": 0.0,
        "bytes_in": 0,
        "bytes_out": 0,
        "lat_buckets": {},
        "outcomes": {},
        "retries": 0,
        "deadline_misses": 0,
        "margin_buckets": {},
        "margin_sum": 0.0,
        "margin_max": 0.0,
        "margin_count": 0,
        "deadline_s": None,
    }


_LOCK = threading.Lock()
_AGG: Dict[Tuple[str, str], Dict[str, Any]] = {}
_RING: Deque[Dict[str, Any]] = deque(maxlen=env_int(_RING_ENV_VAR, _DEFAULT_RING))
_ATEXIT_REGISTERED = False
_LAST_DUMP: Dict[str, float] = {}

# snapmem: the flight-recorder ring is a real (if small) RAM consumer —
# a few hundred event dicts. Report it as a polled domain with a fixed
# per-event estimate; the point is the registry's completeness (every
# byte-capped structure visible in one table), not byte-exact dict
# sizing. Evictable: the ring drops its tail by design.
_RING_EVENT_EST_BYTES = 512


def _mem_provider() -> Tuple[int, int, Optional[int]]:
    with _LOCK:
        used = len(_RING) * _RING_EVENT_EST_BYTES
        cap = (_RING.maxlen or 0) * _RING_EVENT_EST_BYTES
    return used, 0, cap


memwatch.register_provider("wiretap.ring", _mem_provider)


def reset() -> None:
    """Drop all aggregates and ring contents; re-read the ring size
    (tests flip the env knobs between cases)."""
    global _RING
    with _LOCK:
        _AGG.clear()
        _LAST_DUMP.clear()
        _RING = deque(maxlen=env_int(_RING_ENV_VAR, _DEFAULT_RING))
    memwatch.register_provider("wiretap.ring", _mem_provider)


def _register_atexit() -> None:
    global _ATEXIT_REGISTERED
    if _ATEXIT_REGISTERED:
        return
    _ATEXIT_REGISTERED = True
    atexit.register(_dump_at_exit)


def _dump_at_exit() -> None:
    try:
        dump_blackbox("exit")
    except Exception as e:  # pragma: no cover - exit path must never raise
        logger.debug(f"exit blackbox dump failed: {e!r}")


def record(
    transport: str,
    op: str,
    *,
    seconds: float,
    outcome: str = "ok",
    bytes_in: int = 0,
    bytes_out: int = 0,
    attempt: int = 0,
    deadline_s: Optional[float] = None,
    peer: Optional[str] = None,
    trace_id: Optional[str] = None,
) -> None:
    """Record one wire RPC (one attempt, client- or server-side).

    ``attempt`` is 0 for a first try, N for the Nth retry — retried
    attempts are individually attributable instead of folding into one
    span. ``deadline_s`` is the per-RPC budget this attempt ran under;
    when present the deadline margin ``seconds / deadline_s`` is
    recorded too. ``trace_id`` defaults to the ambient snapxray trace.
    """
    if outcome not in OUTCOMES:
        outcome = "error"
    if trace_id is None:
        trace_id = tracing.current_trace_id()
    seconds = max(0.0, float(seconds))
    margin: Optional[float] = None
    if deadline_s is not None and deadline_s > 0:
        margin = seconds / deadline_s
        if outcome == "deadline_miss" and margin < 1.0:
            margin = 1.0

    key = (transport, op)
    event = {
        "t": round(time.time(), 3),
        "transport": transport,
        "op": op,
        "peer": peer,
        "seconds": round(seconds, 6),
        "outcome": outcome,
        "attempt": attempt,
        "trace": trace_id,
        "bytes_in": int(bytes_in),
        "bytes_out": int(bytes_out),
        "margin": None if margin is None else round(margin, 4),
    }

    with _LOCK:
        agg = _AGG.get(key)
        if agg is None:
            agg = _AGG[key] = _new_agg()
        agg["count"] += 1
        agg["seconds"] += seconds
        agg["bytes_in"] += int(bytes_in)
        agg["bytes_out"] += int(bytes_out)
        le = bucket_le(seconds)
        agg["lat_buckets"][le] = agg["lat_buckets"].get(le, 0) + 1
        agg["outcomes"][outcome] = agg["outcomes"].get(outcome, 0) + 1
        if attempt > 0:
            agg["retries"] += 1
        if outcome == "deadline_miss":
            agg["deadline_misses"] += 1
        if margin is not None:
            mle = bucket_le(margin)
            agg["margin_buckets"][mle] = agg["margin_buckets"].get(mle, 0) + 1
            agg["margin_sum"] += margin
            agg["margin_count"] += 1
            if margin > agg["margin_max"]:
                agg["margin_max"] = margin
        if deadline_s is not None:
            agg["deadline_s"] = float(deadline_s)
        _RING.append(event)

    REGISTRY.histogram(WIRE_OP_SECONDS, transport=transport, op=op).observe(
        seconds
    )
    if bytes_in:
        REGISTRY.counter(
            WIRE_OP_BYTES, transport=transport, op=op, dir="in"
        ).inc(int(bytes_in))
    if bytes_out:
        REGISTRY.counter(
            WIRE_OP_BYTES, transport=transport, op=op, dir="out"
        ).inc(int(bytes_out))
    REGISTRY.counter(
        WIRE_OP_RESULTS, transport=transport, op=op, result=outcome
    ).inc()
    if attempt > 0:
        REGISTRY.counter(WIRE_RETRIES, transport=transport, op=op).inc()
    if outcome == "deadline_miss":
        REGISTRY.counter(
            WIRE_DEADLINE_MISSES, transport=transport, op=op
        ).inc()
    if margin is not None:
        REGISTRY.histogram(
            WIRE_DEADLINE_MARGIN, transport=transport, op=op
        ).observe(margin)

    _register_atexit()


def note_degrade(reason: str, peer: Optional[str] = None) -> None:
    """A transport latched a peer/member down (or the repair plane
    declared a host lost): stamp a mark into the ring and flush the
    blackbox — this is exactly the moment postmortem evidence is worth
    a statusfile write."""
    mark = {
        "t": round(time.time(), 3),
        "mark": reason,
        "peer": peer,
        "trace": tracing.current_trace_id(),
    }
    with _LOCK:
        _RING.append(mark)
    dump_blackbox(reason)


# --------------------------------------------------------------- windows


def _copy_agg() -> Dict[Tuple[str, str], Dict[str, Any]]:
    with _LOCK:
        return {
            key: {
                **agg,
                "lat_buckets": dict(agg["lat_buckets"]),
                "outcomes": dict(agg["outcomes"]),
                "margin_buckets": dict(agg["margin_buckets"]),
            }
            for key, agg in _AGG.items()
        }


def window_begin() -> Dict[Tuple[str, str], Dict[str, Any]]:
    """Opaque token for :func:`window_collect` — flight reports open
    one per take/restore, bench blocks one per block."""
    return _copy_agg()


def _quantile_from_buckets(
    buckets: Dict[float, int], count: int, q: float
) -> Optional[float]:
    """Conservative quantile: the log2 bucket upper bound at rank
    ``ceil(q * count)``."""
    if count <= 0:
        return None
    rank = max(1, int(q * count + 0.9999999))
    seen = 0
    for le in sorted(buckets):
        seen += buckets[le]
        if seen >= rank:
            return le
    return max(buckets) if buckets else None


def _diff_buckets(
    now: Dict[float, int], then: Dict[float, int]
) -> Dict[float, int]:
    out = {}
    for le, n in now.items():
        d = n - then.get(le, 0)
        if d > 0:
            out[le] = d
    return out


def _diff_counts(now: Dict[str, int], then: Dict[str, int]) -> Dict[str, int]:
    out = {}
    for k, n in now.items():
        d = n - then.get(k, 0)
        if d > 0:
            out[k] = d
    return out


def _op_summary(
    agg: Dict[str, Any], base: Optional[Dict[str, Any]]
) -> Optional[Dict[str, Any]]:
    if base is None:
        base = _new_agg()
    count = agg["count"] - base["count"]
    if count <= 0:
        return None
    lat = _diff_buckets(agg["lat_buckets"], base["lat_buckets"])
    out: Dict[str, Any] = {
        "count": count,
        "seconds": round(agg["seconds"] - base["seconds"], 6),
        "bytes_in": agg["bytes_in"] - base["bytes_in"],
        "bytes_out": agg["bytes_out"] - base["bytes_out"],
        "p50_s": _quantile_from_buckets(lat, count, 0.50),
        "p99_s": _quantile_from_buckets(lat, count, 0.99),
        "outcomes": _diff_counts(agg["outcomes"], base["outcomes"]),
        "retries": agg["retries"] - base["retries"],
        "deadline_misses": agg["deadline_misses"] - base["deadline_misses"],
    }
    if agg["deadline_s"] is not None:
        out["deadline_s"] = agg["deadline_s"]
    mcount = agg["margin_count"] - base["margin_count"]
    if mcount > 0:
        mbuckets = _diff_buckets(agg["margin_buckets"], base["margin_buckets"])
        out["margin_p99"] = _quantile_from_buckets(mbuckets, mcount, 0.99)
        # max over the window is unknowable from cumulative state once
        # the baseline saw a larger value; the cumulative max is still
        # the honest upper bound.
        out["margin_max"] = round(agg["margin_max"], 4)
    return out


def window_collect(
    token: Dict[Tuple[str, str], Dict[str, Any]],
) -> Dict[str, Any]:
    """Per-op deltas since ``window_begin``, keyed by telemetry key
    (``transport/op``). Empty dict when nothing crossed the wire."""
    now = _copy_agg()
    ops: Dict[str, Any] = {}
    for key, agg in sorted(now.items()):
        block = _op_summary(agg, token.get(key))
        if block:
            ops["/".join(key)] = block
    return ops


def summary() -> Dict[str, Any]:
    """Cumulative per-op summaries since process start (or reset)."""
    now = _copy_agg()
    ops: Dict[str, Any] = {}
    for key, agg in sorted(now.items()):
        block = _op_summary(agg, None)
        if block:
            ops["/".join(key)] = block
    return ops


def sample_block() -> Dict[str, Any]:
    """Compact block for the runtime sampler and the stats RPCs: the
    per-op summaries plus the headline pressure numbers the slo/ops
    consumers sort by."""
    ops = summary()
    misses = sum(b.get("deadline_misses", 0) for b in ops.values())
    retries = sum(b.get("retries", 0) for b in ops.values())
    worst_op = None
    worst_margin = 0.0
    for key, block in ops.items():
        m = block.get("margin_p99")
        if m is not None and m > worst_margin:
            worst_margin = m
            worst_op = key
    out: Dict[str, Any] = {
        "ops": ops,
        "deadline_misses": misses,
        "retries": retries,
    }
    if worst_op is not None:
        out["worst_margin_p99"] = worst_margin
        out["worst_op"] = worst_op
    return out


# -------------------------------------------------------------- blackbox


def blackbox_dir() -> Optional[str]:
    return os.environ.get(_DIR_ENV_VAR) or os.environ.get(
        _PROGRESS_DIR_ENV_VAR
    )


def blackbox_path() -> Optional[str]:
    """This process's blackbox statusfile path (None → recording stays
    in-memory only). Role-prefixed like snapxray's per-process trace
    shards so fleet members and peers land distinct files."""
    base = blackbox_dir()
    if not base:
        return None
    role = os.environ.get(_TRACE_ROLE_ENV_VAR)
    prefix = f"{role}." if role else ""
    return os.path.join(base, f"{prefix}pid{os.getpid()}.blackbox.jsonl")


def dump_blackbox(reason: str, path: Optional[str] = None) -> Optional[str]:
    """Flush the flight recorder to its statusfile. Overwrites — the
    file is always the *latest* ring, one dump per fault/degrade/exit
    hook (rate-limited per path). Returns the path written, or None
    when no directory is configured or the ring is empty."""
    if path is None:
        path = blackbox_path()
    if path is None:
        return None
    with _LOCK:
        events = list(_RING)
        if not events:
            return None
        now = time.monotonic()
        last = _LAST_DUMP.get(path)
        min_interval = env_float(
            _DUMP_INTERVAL_ENV_VAR, _DEFAULT_DUMP_INTERVAL_S
        )
        if last is not None and reason != "exit" and (
            now - last
        ) < min_interval:
            return None
        _LAST_DUMP[path] = now
    from .telemetry import ledger

    header = {
        "kind": "blackbox_header",
        "reason": reason,
        "ts": round(time.time(), 3),
        "pid": os.getpid(),
        "role": os.environ.get(_TRACE_ROLE_ENV_VAR),
        "events": len(events),
    }
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(ledger.encode_line(header) + "\n")
            for event in events:
                f.write(ledger.encode_line(event) + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except OSError as e:
        logger.debug(f"blackbox dump to {path} failed: {e!r}")
        return None
    REGISTRY.counter(WIRE_BLACKBOX_DUMPS, reason=reason).inc()
    return path


def read_blackbox(path: str) -> Tuple[List[Dict[str, Any]], int]:
    """Parse a blackbox dump with the ledger's crc discipline: returns
    ``(records, skipped)`` where a torn final record (a dump cut off
    mid-write) is counted in ``skipped``, never surfaced as data."""
    from .telemetry import ledger

    with open(path, "rb") as f:
        raw = f.read()
    records, _valid_len, skipped = ledger.parse_ledger_bytes(raw)
    return records, skipped


def ring_events() -> List[Dict[str, Any]]:
    """Snapshot of the in-memory ring (tests and the ops CLI)."""
    with _LOCK:
        return list(_RING)


def _self_test() -> None:
    """Exercise the aggregate/window/blackbox machinery hermetically."""
    import tempfile

    reset()
    record("snapwire", "put", seconds=0.01, bytes_out=1024, deadline_s=1.0)
    record(
        "snapwire",
        "put",
        seconds=1.2,
        outcome="deadline_miss",
        attempt=1,
        deadline_s=1.0,
    )
    record("snapserve", "read", seconds=0.002, bytes_in=4096, deadline_s=60.0)
    s = summary()
    assert set(s) == {"snapwire/put", "snapserve/read"}, s
    put = s["snapwire/put"]
    assert put["count"] == 2 and put["deadline_misses"] == 1, put
    assert put["retries"] == 1 and put["margin_max"] >= 1.0, put
    token = window_begin()
    record("snapserve", "read", seconds=0.004, deadline_s=60.0)
    w = window_collect(token)
    assert set(w) == {"snapserve/read"} and w["snapserve/read"]["count"] == 1, w
    block = sample_block()
    assert block["deadline_misses"] == 1 and block["worst_op"] == "snapwire/put"
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "t.blackbox.jsonl")
        assert dump_blackbox("test", path=path) == path
        records, skipped = read_blackbox(path)
        assert skipped == 0 and records[0]["kind"] == "blackbox_header"
        assert len(records) == 1 + records[0]["events"]
        # Torn tail: truncate mid-record → skipped, prefix intact.
        with open(path, "rb") as f:
            raw = f.read()
        with open(path, "wb") as f:
            f.write(raw[:-7])
        records2, skipped2 = read_blackbox(path)
        assert skipped2 == 1 and len(records2) == len(records) - 1
    reset()
    print(json.dumps({"wiretap_self_test": "ok"}))


if __name__ == "__main__":
    _self_test()
