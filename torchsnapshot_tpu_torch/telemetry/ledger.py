"""Durable cross-take telemetry ledger.

snapstats answers "what happened inside THIS take" (one ``.report.json``
per snapshot); snapwatch answers "what is happening right now". Neither
answers the longitudinal questions that decide whether checkpointing is
paying for itself: *is checkpoint overhead creeping up across this
run? did throughput regress after step 40k? how incremental are
consecutive takes really?* The ledger is the durable record those
questions fold over: every committed take and every completed restore
appends one compact, schema-versioned digest to

    <ledger-root>/.telemetry/ledger.jsonl

where the ledger root is the CheckpointManager base for step-indexed
snapshots (``<base>/step-<N>`` appends to ``<base>/.telemetry/``, so
consecutive steps share one ledger) and the snapshot prefix itself for
bare takes.

Durability contract (the ledger is *metadata*, not ephemeral export):

- **rank-0-only append** — the digests are built from the merged flight
  report at commit time, which only rank 0 holds; no cross-rank writes.
- **crash-tolerant** — appends go through the storage plugin's atomic
  whole-object replace (fs: tmp + fsync + rename), so a crash mid-append
  can never corrupt previously committed records; at worst the new
  record is absent.
- **per-record checksum + torn-tail-skipping parser** — each line is
  ``{"crc": <crc32 of the canonical record json>, "record": {...}}``.
  A torn write (a non-atomic backend, or faultline's torn-write
  injection) truncates the tail; the parser verifies every line and
  skips unparseable/mismatched ones, and the next append rewrites from
  the last *valid* prefix — the torn tail is dropped, prior records are
  preserved byte-for-byte.
- **never orphaned** — the manager-base ledger sits OUTSIDE every
  ``step-<N>`` prefix, so per-step deletes and retention prunes
  structurally cannot reach it: records outlive the pruned steps they
  describe, which is the whole point of a longitudinal record.
  ``reconcile()`` treats it as durable metadata (its debris sweeps
  clear only torn ``*.tmp<pid>`` leftovers under ``.telemetry/``,
  age-guarded, never the ledger object). A BARE snapshot's ledger
  lives in its own prefix and is removed by ``Snapshot.delete`` along
  with everything else — no orphaned ``.telemetry/`` stubs.

Like every telemetry write, appends are best-effort at the call sites:
a ledger failure warns and never fails the commit it describes — but
within ``append`` the storage write lands BEFORE any success signal
(log line / ``ledger_appended`` trace instant), the same
durability-before-publish ordering snapcheck's SNAP002 enforces.

Record schema (``format_version`` 1); nullable fields are null when the
source operation did not produce them::

    {
      "format_version": 1,
      "kind": "take" | "async_take" | "restore",
      "ts_epoch_s": <wall-clock epoch at append>,
      "path": "<snapshot url>",
      "step": <int | null>,              # parsed from .../step-<N>
      "take_id": "<nonce | null>",
      "world_size": N,
      "wall_s": ...,                     # slowest rank's wall
      "bytes": ...,                      # payload bytes moved
      "gbps": ...,
      "stall_s": ...,                    # summed budget stall
      "stall_pct": ...,                  # stall / (world * wall)
      "retries": ..., "faults": ...,
      "phases": {"<phase>_s": max-across-ranks, ...},
      "goodput": {...} | null,           # goodput.snapshot() at commit
      "churn": {"added_bytes",           # LOGICAL bytes persisted anew
                "unchanged_bytes",       # leaf- + chunk-dedup'd bytes
                "removed_bytes",
                "efficiency", "basis": "incremental" | "full",
                "physical_bytes",        # bytes that HIT storage
                                         # (post-dedup, post-codec)
                "codec_ratio"            # stored/logical through the
                                         # codec stage; null = no codec
                } | null,
      "tier": {"hot_objects", "hot_bytes", "fallback_objects",
               "fallback_bytes", "degraded_peers": [host, ...],
               "replication": {           # takes whose replication rode
                 "pushes", "payload_bytes",  # the snapwire transport
                 "wire_bytes",
                 "delta_ratio",           # wire/payload through chunk
                                          # delta + codec (unchanged
                                          # retake certifies < 0.10)
                 "retries", "deadline_misses",
                 "write_through_bytes"} | absent} | null,
                                         # hot-tier attribution (restores
                                         # with the hot tier enabled)
      "read_plane": {"remote_objects", "remote_bytes",
                     "fallback_objects", "fallback_bytes",
                     "fallback_reasons": {reason: n},
                     "owner_misses"?, "failover_objects"?,
                     "servers"?: {addr: {objects, bytes}}} | null,
                                         # snapserve attribution
                                         # (restores routed through the
                                         # read service; fallbacks =
                                         # direct degraded reads)
      "consume": {"substeps": {"<substep>": {"seconds", "bytes"}},
                  "consume_s", "consume_gbps",
                  "h2d_probe_gbps", "h2d_fraction"} | null,
                                         # snapxray consume sub-phase
                                         # breakdown (restores only):
                                         # substeps + `other` sum to
                                         # consume_s; h2d_fraction =
                                         # consume GB/s over the
                                         # measured H2D probe
      "wire": {"rpcs", "deadline_misses", "retries",
               "worst_margin_p99"?, "worst_margin_op"?,
               "slowest_p99_s"?, "slowest_op"?} | null,
                                         # wiretap (snapflight) headline:
                                         # total RPCs this operation put
                                         # on any transport + the worst
                                         # deadline-pressure op
      "memory": {"domains": {"<name>": {"high_water_bytes",
                                        "residual_bytes"?,
                                        "cap_bytes"?}},
                 "high_water_bytes", "headroom_bytes"?,
                 "forecasts"?} | null,
                                         # memwatch (snapmem) headline:
                                         # worst per-domain window
                                         # high-waters across ranks,
                                         # worst-rank aggregate, minimum
                                         # observed headroom, and total
                                         # overcommit forecasts — the
                                         # leak sentinel reads
                                         # residual_bytes across records
      "durability_lag_s": null,          # ALWAYS null on take records —
                                         # the digest is written at commit,
                                         # while the ack→.tierdown window
                                         # is still open; the hot tier's
                                         # drain closes it by APPENDING a
                                         # separate drain event record
                                         # (below), never by rewriting
                                         # committed history
      "doctor": ["<rule id>", ...]       # rules that fired on the report
    }

Drain event record (kind ``tierdown``, appended by the hot tier's drain
when a committed root's ``.tierdown`` watermark lands — the chosen
alternative to back-filling the take record, keeping the ledger strictly
append-only)::

    {
      "format_version": 1,
      "kind": "tierdown",
      "ts_epoch_s": ..., "path": "<snapshot url>", "step": <int | null>,
      "take_id": null,
      "durability_lag_s": ...,           # commit ack -> .tierdown
      "drained_objects": ..., "write_through_objects": ...
    }

Repair event record (kind ``repair``, appended by the snapmend repair
plane — hottier/repair.py — after any tick that re-replicated or
escalated objects of a root; the ledger's durable trace of the
self-healing loop)::

    {
      "format_version": 1,
      "kind": "repair",
      "ts_epoch_s": ..., "path": "<snapshot url>", "step": <int | null>,
      "take_id": null,
      "objects_repaired": ...,           # re-replicated back toward k
      "bytes_repaired": ...,             # replica bytes placed
      "repairs_failed": ...,             # no usable source survived
      "escalated_write_throughs": ...,   # drain items actually run past
                                         #   TPUSNAPSHOT_REPAIR_DEADLINE_S
      "underreplicated_bytes": ...       # THIS root's bytes still below
                                         #   k after the tick
    }
"""

import asyncio
import json
import logging
import re
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

from ..io_types import IOReq, io_payload, is_not_found_error
from . import metrics as _m
from .metrics import REGISTRY

logger = logging.getLogger(__name__)

LEDGER_FORMAT_VERSION = 1
LEDGER_DIR = ".telemetry"
LEDGER_OBJECT = ".telemetry/ledger.jsonl"
# Appends are read-validate-rewrite of the whole active object (the
# storage plugins expose atomic whole-object replace, which is also
# what keeps faultline's crash/torn injection meaningful here). To keep
# cumulative append IO linear rather than quadratic over a long run,
# the active object rotates into an immutable archive segment
# (.telemetry/ledger-archive-<n>.jsonl) once it crosses this cap;
# read_records folds archives + active back into one history.
LEDGER_ROTATE_ENV_VAR = "TPUSNAPSHOT_LEDGER_ROTATE_BYTES"
_DEFAULT_LEDGER_ROTATE_BYTES = 4 << 20
ARCHIVE_PREFIX = ".telemetry/ledger-archive-"

_STEP_LEAF_RE = re.compile(r"^step-(\d+)$")
_ARCHIVE_RE = re.compile(r"^\.telemetry/ledger-archive-(\d+)\.jsonl$")


def ledger_root_for(snapshot_path: str) -> Tuple[str, Optional[int]]:
    """``(ledger_root_url, step)`` for a snapshot path.

    ``<base>/step-<N>`` ledgers at ``<base>`` with ``step=N`` so every
    CheckpointManager save lands in ONE ledger; anything else ledgers
    in its own prefix with ``step=None``."""
    trimmed = snapshot_path.rstrip("/")
    head, _, leaf = trimmed.rpartition("/")
    m = _STEP_LEAF_RE.match(leaf)
    if m and head and not head.endswith(":/"):
        return head, int(m.group(1))
    return trimmed, None


# ------------------------------------------------------------- line codec


def _canonical(record: Dict[str, Any]) -> str:
    return json.dumps(record, sort_keys=True, separators=(",", ":"))


def encode_line(record: Dict[str, Any]) -> str:
    """One ledger line: the record wrapped with its crc32 checksum."""
    payload = _canonical(record)
    crc = f"{zlib.crc32(payload.encode('utf-8')) & 0xFFFFFFFF:08x}"
    return json.dumps(
        {"crc": crc, "record": record},
        sort_keys=True,
        separators=(",", ":"),
    )


def decode_line(line: str) -> Optional[Dict[str, Any]]:
    """The record, or None for a torn/corrupt line."""
    try:
        doc = json.loads(line)
        record = doc["record"]
        crc = f"{zlib.crc32(_canonical(record).encode('utf-8')) & 0xFFFFFFFF:08x}"
        if crc != doc["crc"]:
            return None
        return record
    except (ValueError, KeyError, TypeError):
        return None


def parse_ledger_bytes(
    raw: bytes,
) -> Tuple[List[Dict[str, Any]], int, int]:
    """``(records, valid_prefix_len, n_skipped)``.

    ``valid_prefix_len`` is the byte offset covering the leading run of
    valid, newline-terminated lines — the next append rewrites from
    exactly there, dropping any torn tail. Lines after the first bad
    one are still *parsed* (a mid-file tear on an exotic backend must
    not hide later records from readers) but are not part of the valid
    prefix."""
    records: List[Dict[str, Any]] = []
    skipped = 0
    valid_prefix_len = 0
    prefix_intact = True
    pos = 0
    n = len(raw)
    while pos < n:
        nl = raw.find(b"\n", pos)
        if nl < 0:
            # Unterminated final piece: a torn append's tail by
            # construction (every complete append is newline-terminated).
            piece, end, terminated = raw[pos:], n, False
        else:
            piece, end, terminated = raw[pos:nl], nl + 1, True
        if piece.strip():
            record = (
                decode_line(piece.decode("utf-8", errors="replace"))
                if terminated
                else None
            )
            if record is not None:
                records.append(record)
                if prefix_intact:
                    valid_prefix_len = end
            else:
                skipped += 1
                prefix_intact = False
        elif prefix_intact and terminated:
            valid_prefix_len = end  # blank line: harmless, keep it
        pos = end
    return records, valid_prefix_len, skipped


# ------------------------------------------------------------ storage IO


async def _aread_raw(storage: Any) -> bytes:
    try:
        io_req = IOReq(path=LEDGER_OBJECT)
        await storage.read(io_req)
        return bytes(io_payload(io_req))
    except Exception as e:
        if not is_not_found_error(e):
            logger.warning("ledger read failed (treating as empty): %r", e)
        return b""


# Serializes the read-validate-rewrite across THREADS in this process:
# an async drain committing a take races the foreground (a restore, a
# sync take, another drain) to the same ledger object, and without
# mutual exclusion the second replace would silently erase the first
# record. Held across the awaits deliberately — each appender runs its
# own event loop, appends are short, and cross-thread blocking is the
# point. (Cross-PROCESS appenders don't exist by construction: rank 0
# of one run is the only writer; two unrelated jobs sharing a ledger
# root would be misconfiguration.)
_APPEND_LOCK = threading.Lock()


async def aappend(storage: Any, record: Dict[str, Any]) -> None:
    """Append ``record`` to the ledger behind ``storage`` (a plugin
    rooted at the ledger root). Read-validate-rewrite under the
    process-wide append lock: the current object's valid prefix plus
    the new line is written back through the plugin's atomic replace.
    The write lands before the success instant — durability before
    publish."""
    from .. import tracing

    with _APPEND_LOCK:
        await _aappend_locked(storage, record, tracing)


async def _aappend_locked(
    storage: Any, record: Dict[str, Any], tracing: Any
) -> None:
    from ..utils.env import env_int

    raw = await _aread_raw(storage)
    prior, valid_len, skipped = parse_ledger_bytes(raw)
    if skipped:
        logger.warning(
            "ledger at %s: dropping %d torn/corrupt line(s) past byte %d",
            LEDGER_OBJECT,
            skipped,
            valid_len,
        )
    record = _with_goodput_window(record, prior)
    prefix = raw[:valid_len]
    rotate_bytes = env_int(
        LEDGER_ROTATE_ENV_VAR, _DEFAULT_LEDGER_ROTATE_BYTES
    )
    if rotate_bytes > 0 and len(prefix) >= rotate_bytes:
        # Archive-then-truncate, in that order: a crash between the two
        # writes duplicates history (archive + still-full active, and
        # readers dedup nothing — duplicates are benign trend points)
        # rather than losing it.
        seq = await _next_archive_seq(storage)
        archive = IOReq(
            path=f"{ARCHIVE_PREFIX}{seq:06d}.jsonl", data=prefix
        )
        await storage.write(archive)
        prefix = b""
    line = encode_line(record) + "\n"
    io_req = IOReq(path=LEDGER_OBJECT, data=prefix + line.encode("utf-8"))
    await storage.write(io_req)
    REGISTRY.counter(
        _m.LEDGER_RECORDS_TOTAL, kind=str(record.get("kind", "?"))
    ).inc()
    tracing.instant(
        "ledger_appended",
        kind=str(record.get("kind", "?")),
        step=record.get("step") if record.get("step") is not None else -1,
    )


def _with_goodput_window(
    record: Dict[str, Any], prior: List[Dict[str, Any]]
) -> Dict[str, Any]:
    """Stamp the goodput delta since the previous goodput-bearing
    record: ``window_fraction`` / ``window_overhead_pct``. The
    accountant's totals are lifetime-cumulative, and a cumulative
    fraction flattens as the run grows — overhead creeping up after
    step 40k would hide inside it, which is exactly the question the
    ledger exists to answer. First record (or right after a process
    restart, when cumulative counters moved backwards, or after a
    segment rotation) falls back to the cumulative fraction."""
    gp = record.get("goodput")
    if not isinstance(gp, dict):
        return record
    train = gp.get("train_s")
    ckpt = gp.get("checkpoint_s")
    if not isinstance(train, (int, float)) or not isinstance(
        ckpt, (int, float)
    ):
        return record
    prev = next(
        (
            r.get("goodput")
            for r in reversed(prior)
            if isinstance(r.get("goodput"), dict)
        ),
        None,
    )
    window_fraction = gp.get("goodput_fraction")
    window_overhead = gp.get("checkpoint_overhead_pct")
    if prev is not None:
        d_train = train - (prev.get("train_s") or 0.0)
        d_ckpt = ckpt - (prev.get("checkpoint_s") or 0.0)
        if d_train >= 0 and d_ckpt >= 0 and d_train + d_ckpt > 0:
            window_fraction = round(d_train / (d_train + d_ckpt), 6)
            window_overhead = round(
                100.0 * d_ckpt / (d_train + d_ckpt), 3
            )
    gp = dict(
        gp,
        window_fraction=window_fraction,
        window_overhead_pct=window_overhead,
    )
    return dict(record, goodput=gp)


async def _next_archive_seq(storage: Any) -> int:
    seqs = [0]
    for p in await storage.list_prefix(ARCHIVE_PREFIX) or []:
        m = _ARCHIVE_RE.match(p)
        if m:
            seqs.append(int(m.group(1)) + 1)
    return max(seqs)


def append_for_snapshot(snapshot_path: str, record: Dict[str, Any]) -> None:
    """Resolve the ledger root for ``snapshot_path``, stamp the step
    (unless the caller already set one), and append synchronously.
    Raises on failure — call sites wrap with their own best-effort
    handling (and the append-failures counter)."""
    from ..storage_plugin import url_to_storage_plugin

    root, step = ledger_root_for(snapshot_path)
    if record.get("step") is None:
        record = dict(record, step=step)
    storage = url_to_storage_plugin(root)
    try:
        asyncio.run(aappend(storage, record))
    finally:
        storage.close()


async def aappend_for_snapshot(
    snapshot_path: str, record: Dict[str, Any]
) -> None:
    """Async-context variant of :func:`append_for_snapshot` (the async
    drain's commit path already runs inside an event loop)."""
    from ..storage_plugin import url_to_storage_plugin

    root, step = ledger_root_for(snapshot_path)
    if record.get("step") is None:
        record = dict(record, step=step)
    storage = url_to_storage_plugin(root)
    try:
        await aappend(storage, record)
    finally:
        storage.close()


def read_records(
    path: str,
) -> Tuple[List[Dict[str, Any]], int]:
    """``(records, n_skipped)`` from a ledger root URL (folds rotated
    ``ledger-archive-*.jsonl`` segments plus the active
    ``<path>/.telemetry/ledger.jsonl``), a direct ``.jsonl`` file path,
    or a snapshot path (resolved through :func:`ledger_root_for`).
    Exact-duplicate records are dropped: a crash between the rotation's
    archive write and the active truncate duplicates history rather
    than losing it, and readers fold that back out."""
    import os

    from ..storage_plugin import url_to_storage_plugin

    if "://" not in path and os.path.isfile(path):
        with open(path, "rb") as f:
            raw = f.read()
        records, _, skipped = parse_ledger_bytes(raw)
        return _dedup(records), skipped
    root, _ = ledger_root_for(path)
    storage = url_to_storage_plugin(root)
    try:

        async def _read_all() -> Tuple[List[bytes], bytes]:
            archives = sorted(
                p
                for p in await storage.list_prefix(ARCHIVE_PREFIX) or []
                if _ARCHIVE_RE.match(p)
            )
            chunks = []
            for p in archives:
                io_req = IOReq(path=p)
                await storage.read(io_req)
                chunks.append(bytes(io_payload(io_req)))
            return chunks, await _aread_raw(storage)

        chunks, active = asyncio.run(_read_all())
    finally:
        storage.close()
    records: List[Dict[str, Any]] = []
    skipped = 0
    for raw in chunks + [active]:
        part, _, part_skipped = parse_ledger_bytes(raw)
        records.extend(part)
        skipped += part_skipped
    return _dedup(records), skipped


def _dedup(records: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    seen: set = set()
    out: List[Dict[str, Any]] = []
    for r in records:
        key = _canonical(r)
        if key not in seen:
            seen.add(key)
            out.append(r)
    return out


# --------------------------------------------------------- digest builders


def _phase_max(
    summaries: List[Optional[Dict[str, Any]]],
) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for s in summaries:
        for name, v in ((s or {}).get("phases") or {}).items():
            out[name] = max(out.get(name, 0.0), float(v))
    return {k: round(v, 6) for k, v in sorted(out.items())}


def _churn_totals(
    summaries: List[Optional[Dict[str, Any]]], added_bytes: int
) -> Optional[Dict[str, Any]]:
    """Aggregate per-rank churn notes (see incremental.py) into the
    digest's churn block. None when no rank recorded churn (a take with
    neither base nor fingerprints)."""
    noted = [s.get("churn") for s in summaries if s and s.get("churn")]
    if not noted:
        return None

    def _sum(key: str) -> int:
        return sum(int(c.get(key) or 0) for c in noted)

    # Chunk-store accounting (chunkstore.py fold_into_churn): hit bytes
    # count as unchanged; the LOGICAL added bytes replace the stored
    # (post-codec) chunk bytes inside the pipeline's byte total, so
    # `efficiency` keeps measuring byte-movement dedup while
    # `physical_bytes` records what actually hit storage.
    chunk_hit = _sum("chunk_hit_bytes")
    chunk_stored = _sum("chunk_stored_bytes")
    chunk_written_logical = _sum("chunk_written_logical_bytes")
    codec_in = _sum("codec_in_bytes")
    codec_out = _sum("codec_out_bytes")
    unchanged = _sum("unchanged_bytes") + chunk_hit
    removed = _sum("removed_bytes")
    added_logical = added_bytes - chunk_stored + chunk_written_logical
    basis = (
        "incremental"
        if chunk_hit > 0
        or any(c.get("basis") == "incremental" for c in noted)
        else "full"
    )
    denom = added_logical + unchanged
    return {
        "added_bytes": int(added_logical),
        "unchanged_bytes": unchanged,
        "removed_bytes": removed,
        "efficiency": round(unchanged / denom, 6) if denom > 0 else None,
        "basis": basis,
        # Bytes that hit storage this take (post-dedup post-codec) and
        # the codec's logical→stored ratio (None = no codec ran).
        "physical_bytes": int(added_bytes),
        "codec_ratio": (
            round(codec_out / codec_in, 6) if codec_in > 0 else None
        ),
    }


def _tier_totals(
    summaries: List[Optional[Dict[str, Any]]]
) -> Optional[Dict[str, Any]]:
    """Aggregate per-rank hot-tier blocks (hottier/) into the digest's
    ``tier`` field. None when no rank recorded tier traffic: restores
    attribute tier reads; takes whose replication crossed the snapwire
    transport attribute a ``replication`` sub-block (with the per-take
    ``delta_ratio`` — wire bytes over logical payload bytes)."""
    noted = [s.get("tier") for s in summaries if s and s.get("tier")]
    if not noted:
        return None
    out: Dict[str, Any] = {
        "hot_objects": sum(int(t.get("hot_objects") or 0) for t in noted),
        "hot_bytes": sum(int(t.get("hot_bytes") or 0) for t in noted),
        "fallback_objects": sum(
            int(t.get("fallback_objects") or 0) for t in noted
        ),
        "fallback_bytes": sum(
            int(t.get("fallback_bytes") or 0) for t in noted
        ),
        "degraded_peers": sorted(
            {int(p) for t in noted for p in (t.get("degraded_peers") or [])}
        ),
    }
    reps = [
        t["replication"] for t in noted if isinstance(t, dict)
        and t.get("replication")
    ]
    if reps:
        payload = sum(int(r.get("payload_bytes") or 0) for r in reps)
        wire = sum(int(r.get("wire_bytes") or 0) for r in reps)
        out["replication"] = {
            "pushes": sum(int(r.get("pushes") or 0) for r in reps),
            "payload_bytes": payload,
            "wire_bytes": wire,
            "delta_ratio": (
                round(wire / payload, 4) if payload > 0 else None
            ),
            "retries": sum(int(r.get("retries") or 0) for r in reps),
            "deadline_misses": sum(
                int(r.get("deadline_misses") or 0) for r in reps
            ),
            "write_through_bytes": sum(
                int(r.get("write_through_bytes") or 0) for r in reps
            ),
        }
    return out


def _read_plane_totals(
    summaries: List[Optional[Dict[str, Any]]]
) -> Optional[Dict[str, Any]]:
    """Aggregate per-rank snapserve ``read_plane`` blocks into the
    digest's ``read_plane`` field. None when no rank saw read-plane
    traffic (direct snapshots, or a take — only restores read)."""
    noted = [
        s.get("read_plane") for s in summaries if s and s.get("read_plane")
    ]
    if not noted:
        return None
    reasons: Dict[str, int] = {}
    for p in noted:
        for r, c in (p.get("fallback_reasons") or {}).items():
            reasons[r] = reasons.get(r, 0) + int(c)
    out = {
        "remote_objects": sum(
            int(p.get("remote_objects") or 0) for p in noted
        ),
        "remote_bytes": sum(int(p.get("remote_bytes") or 0) for p in noted),
        "fallback_objects": sum(
            int(p.get("fallback_objects") or 0) for p in noted
        ),
        "fallback_bytes": sum(
            int(p.get("fallback_bytes") or 0) for p in noted
        ),
    }
    if reasons:
        out["fallback_reasons"] = reasons
    # Snapfleet attribution: failover/owner-miss counts and the
    # per-server byte balance (which member served how much — a skewed
    # balance under a uniform key set is a ring or membership problem).
    owner_misses = sum(int(p.get("owner_misses") or 0) for p in noted)
    failover = sum(int(p.get("failover_objects") or 0) for p in noted)
    if owner_misses:
        out["owner_misses"] = owner_misses
    if failover:
        out["failover_objects"] = failover
    servers: Dict[str, Dict[str, int]] = {}
    for p in noted:
        for addr, entry in (p.get("servers") or {}).items():
            agg = servers.setdefault(addr, {"objects": 0, "bytes": 0})
            agg["objects"] += int(entry.get("objects") or 0)
            agg["bytes"] += int(entry.get("bytes") or 0)
    if len(servers) > 1 or owner_misses or failover:
        out["servers"] = servers
    return out


def _consume_totals(
    summaries: List[Optional[Dict[str, Any]]]
) -> Optional[Dict[str, Any]]:
    """Aggregate per-rank consume micro-profiles (snapxray,
    telemetry/consume_profile.py) into the digest's ``consume`` field:
    seconds + bytes per sub-step summed across ranks, the consume wall
    they reconcile against, and consume GB/s as a fraction of the
    slowest rank's H2D probe. None when no rank profiled (takes, or
    pre-snapxray restores)."""
    noted = [
        s.get("consume_profile")
        for s in summaries
        if s and s.get("consume_profile")
    ]
    if not noted:
        return None
    substeps: Dict[str, Dict[str, float]] = {}
    for p in noted:
        for name, entry in (p.get("substeps") or {}).items():
            acc = substeps.setdefault(name, {"seconds": 0.0, "bytes": 0})
            acc["seconds"] = round(
                acc["seconds"] + float(entry.get("seconds") or 0.0), 6
            )
            acc["bytes"] = int(acc["bytes"]) + int(entry.get("bytes") or 0)
    out: Dict[str, Any] = {
        "substeps": {k: substeps[k] for k in sorted(substeps)},
        "consume_s": round(
            sum(float(p.get("consume_s") or 0.0) for p in noted), 6
        ),
    }
    gbps = [p.get("consume_gbps") for p in noted if p.get("consume_gbps")]
    if gbps:
        out["consume_gbps"] = round(min(gbps), 6)
    fractions = [
        p.get("h2d_fraction") for p in noted if p.get("h2d_fraction")
    ]
    if fractions:
        out["h2d_fraction"] = round(min(fractions), 6)
    probes = [
        p.get("h2d_probe_gbps") for p in noted if p.get("h2d_probe_gbps")
    ]
    if probes:
        out["h2d_probe_gbps"] = round(min(probes), 4)
    return out


def _wire_totals(
    summaries: List[Optional[Dict[str, Any]]]
) -> Optional[Dict[str, Any]]:
    """Aggregate per-rank ``wire`` blocks (wiretap windows) into the
    digest's ``wire`` field: RPC/miss/retry totals plus the single
    worst deadline-pressure op and the slowest op across all ranks —
    the headline the timeline trends without carrying every op row.
    None when no rank put traffic on any transport."""
    noted = [s.get("wire") for s in summaries if s and s.get("wire")]
    if not noted:
        return None
    rpcs = 0
    misses = 0
    retries = 0
    worst_margin: Optional[float] = None
    worst_margin_op: Optional[str] = None
    slowest_p99: Optional[float] = None
    slowest_op: Optional[str] = None
    for block in noted:
        for op_key, entry in block.items():
            if not isinstance(entry, dict):
                continue
            rpcs += int(entry.get("count") or 0)
            misses += int(entry.get("deadline_misses") or 0)
            retries += int(entry.get("retries") or 0)
            m = entry.get("margin_p99")
            if m is not None and (worst_margin is None or m > worst_margin):
                worst_margin = float(m)
                worst_margin_op = op_key
            p99 = entry.get("p99_s")
            if p99 is not None and (
                slowest_p99 is None or p99 > slowest_p99
            ):
                slowest_p99 = float(p99)
                slowest_op = op_key
    out: Dict[str, Any] = {
        "rpcs": rpcs,
        "deadline_misses": misses,
        "retries": retries,
    }
    if worst_margin is not None:
        out["worst_margin_p99"] = round(worst_margin, 4)
        out["worst_margin_op"] = worst_margin_op
    if slowest_p99 is not None:
        out["slowest_p99_s"] = slowest_p99
        out["slowest_op"] = slowest_op
    return out


def _memory_totals(
    summaries: List[Optional[Dict[str, Any]]]
) -> Optional[Dict[str, Any]]:
    """Aggregate per-rank ``memory`` blocks (memwatch windows) into the
    digest's ``memory`` field: the worst per-domain window high-water
    and residual across ranks, the worst-rank aggregate high-water,
    the minimum observed headroom, and the total overcommit forecasts.
    Residuals take the MAX across ranks — the sentinel wants the worst
    drifter, and summing would scale the signal with world size. None
    when no rank registered a domain."""
    noted = [s.get("memory") for s in summaries if s and s.get("memory")]
    if not noted:
        return None
    domains: Dict[str, Dict[str, Any]] = {}
    agg_hwm = 0
    headroom: Optional[int] = None
    forecasts = 0
    for block in noted:
        for name, d in (block.get("domains") or {}).items():
            if not isinstance(d, dict):
                continue
            out = domains.setdefault(name, {"high_water_bytes": 0})
            out["high_water_bytes"] = max(
                out["high_water_bytes"],
                int(d.get("high_water_bytes") or 0),
            )
            if d.get("residual_bytes") is not None:
                out["residual_bytes"] = max(
                    int(out.get("residual_bytes") or 0),
                    int(d.get("residual_bytes") or 0),
                )
            if d.get("cap_bytes") is not None:
                out["cap_bytes"] = int(d["cap_bytes"])
        agg_hwm = max(agg_hwm, int(block.get("high_water_bytes") or 0))
        h = block.get("headroom_bytes")
        if h is not None:
            headroom = int(h) if headroom is None else min(headroom, int(h))
        forecasts += len(block.get("forecasts") or [])
    out_doc: Dict[str, Any] = {
        "domains": domains,
        "high_water_bytes": agg_hwm,
    }
    if headroom is not None:
        out_doc["headroom_bytes"] = headroom
    if forecasts:
        out_doc["forecasts"] = forecasts
    return out_doc


def digest_from_report(report: Dict[str, Any]) -> Dict[str, Any]:
    """Fold a merged flight report (take or restore) into one ledger
    record. Runs the doctor over the report so the record carries the
    rule ids that fired — timeline folds this history across takes."""
    from .doctor import diagnose_report

    totals = report.get("totals") or {}
    summaries = report.get("ranks") or []
    wall_s = float(totals.get("wall_s") or 0.0)
    nbytes = int(totals.get("bytes") or 0)
    world = int(report.get("world_size") or 1)
    stall_s = float(totals.get("stall_s") or 0.0)
    goodput = next(
        (s.get("goodput") for s in summaries if s and s.get("goodput")),
        None,
    )
    try:
        doctor_rules = [f.rule for f in diagnose_report(report)]
    except Exception:  # snapcheck: disable=swallowed-exception -- telemetry digest must not fail the commit
        doctor_rules = []
    return {
        "format_version": LEDGER_FORMAT_VERSION,
        "kind": report.get("kind", "?"),
        "ts_epoch_s": round(time.time(), 3),
        "path": report.get("path", ""),
        "step": None,  # stamped by append_for_snapshot
        "take_id": report.get("take_id"),
        "world_size": world,
        "wall_s": round(wall_s, 6),
        "bytes": nbytes,
        "gbps": (
            round(nbytes / (1 << 30) / wall_s, 6) if wall_s > 0 else None
        ),
        "stall_s": round(stall_s, 6),
        "stall_pct": (
            round(100.0 * stall_s / (world * wall_s), 3)
            if wall_s > 0
            else None
        ),
        "retries": totals.get("retries", 0),
        "faults": totals.get("faults", 0),
        "phases": _phase_max(summaries),
        "goodput": goodput,
        "churn": _churn_totals(summaries, nbytes),
        "tier": _tier_totals(summaries),
        "read_plane": _read_plane_totals(summaries),
        "consume": _consume_totals(summaries),
        "wire": _wire_totals(summaries),
        "memory": _memory_totals(summaries),
        # Null by construction at commit time (see the schema note);
        # the hot tier's drain appends a `tierdown` event record that
        # carries the closed window.
        "durability_lag_s": None,
        "doctor": doctor_rules,
    }


def tierdown_record(
    path: str,
    durability_lag_s: Optional[float],
    drained_objects: int = 0,
    write_through_objects: int = 0,
    take_id: Optional[str] = None,
) -> Dict[str, Any]:
    """The drain event record (kind ``tierdown``) the hot tier appends
    when a committed root fully tiers down — the ledger's durable copy
    of the durability-lag measurement (timeline/slo fold over it)."""
    return {
        "format_version": LEDGER_FORMAT_VERSION,
        "kind": "tierdown",
        "ts_epoch_s": round(time.time(), 3),
        "path": path,
        "step": None,  # stamped by append_for_snapshot
        "take_id": take_id,
        "durability_lag_s": (
            round(float(durability_lag_s), 6)
            if durability_lag_s is not None
            else None
        ),
        "drained_objects": int(drained_objects),
        "write_through_objects": int(write_through_objects),
    }


def repair_record(
    path: str,
    objects_repaired: int = 0,
    bytes_repaired: int = 0,
    repairs_failed: int = 0,
    escalated_write_throughs: int = 0,
    underreplicated_bytes: int = 0,
    take_id: Optional[str] = None,
) -> Dict[str, Any]:
    """The repair event record (kind ``repair``) the snapmend plane
    appends after a tick that re-replicated or escalated this root's
    objects — the ledger's durable trace of the self-healing loop
    (hottier/repair.py)."""
    return {
        "format_version": LEDGER_FORMAT_VERSION,
        "kind": "repair",
        "ts_epoch_s": round(time.time(), 3),
        "path": path,
        "step": None,  # stamped by append_for_snapshot
        "take_id": take_id,
        "objects_repaired": int(objects_repaired),
        "bytes_repaired": int(bytes_repaired),
        "repairs_failed": int(repairs_failed),
        "escalated_write_throughs": int(escalated_write_throughs),
        "underreplicated_bytes": int(underreplicated_bytes),
    }
