"""Per-snapshot flight recorder: the ``.report.json`` beside the manifest.

Every ``Snapshot.take`` (sync, async, incremental) records one
:class:`FlightRecorder` per rank: phase timings (capture → incremental →
write → commit), the scheduler's per-op byte/second aggregates and
budget stall/high-water, and the deltas of the process-wide telemetry
counters (storage-op latencies, retry attempts and backoff seconds,
injected-fault counts) attributable to the operation. At commit time the
per-rank summaries are gathered — through ``coord`` on the KV commit
route, through per-rank ``.report/<take_id>/<rank>`` storage objects on
the marker route (the async drain must not touch the coordinator) — and
rank 0 writes the merged report beside the metadata document.

``restore`` gathers every rank's read/consume/assemble breakdown over
the coordinator (the restore path is foreground-collective already) and
rank 0 writes one merged ``.report.restore.json`` digest — the document
that would have named BENCH_r05's 176s consume-dominated restore
without a trace viewer. Pre-digest snapshots may instead hold legacy
rank-local ``.report.restore.rank<N>.json`` files; readers accept both.

Reports are observability, not protocol: every write/read here is
best-effort and may never fail the snapshot operation it describes.

Schema (``format_version`` 1)::

    {
      "format_version": 1,
      "kind": "take" | "async_take" | "restore",
      "path": "<snapshot url>",
      "take_id": "<nonce or null>",
      "world_size": N,
      "ranks": [<rank summary>, ...],      # rank order; null = not received
      "totals": {"bytes": B, "wall_s": W, "retries": R, "faults": F,
                 "stall_s": S}
    }

Rank summary::

    {
      "rank": r,
      "wall_s": ...,                       # recorder lifetime so far
      "phases": {"<phase>_s": seconds, ...},
      "bytes": ...,                        # payload bytes written/read
      "throughput_mbps": ...,
      "budget": {"high_water_bytes": ..., "stall_s": ...},
      "scheduler_ops": {"stage": {"count","seconds","bytes"}, ...},  # exact
      "storage_ops": {"<backend>/<op>": {"count","seconds","bytes"}},
      "retries": {"total": n, "backoff_s": s, "by_op": {...}},
      "faults": {"<kind>": n}
    }

``scheduler_ops``/``bytes``/``budget`` come from the pipeline's own
stats and are exact per operation; ``storage_ops``/``retries``/
``faults`` are deltas of process-wide counters and are attributed
best-effort (concurrent snapshot operations in one process smear across
each other's reports).
"""

import json
import logging
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional

from .. import tracing
from ..io_types import IOReq, io_payload
from . import metrics as _m
from .metrics import REGISTRY, diff_snapshots, samples_by_label, sum_samples

logger = logging.getLogger(__name__)

REPORT_FORMAT_VERSION = 1
REPORT_FNAME = ".report.json"
# Listing prefix that covers every flight-record object a snapshot can
# hold: the merged .report.json, per-rank .report/<take_id>/<rank>
# summaries, and the .report.restore.json restore digest (plus legacy
# per-rank .report.restore.rank<N>.json records from older versions).
REPORT_PREFIX = ".report"
# Per-rank summary objects on the storage commit route, collected (and
# deleted) by rank 0 after the completion markers land.
RANK_REPORT_PREFIX = ".report/"
# Merged restore digest: restore summaries ride the coordinator (the
# restore path is foreground and already collective) and rank 0 writes
# ONE document with per-rank breakdowns — take/restore symmetry instead
# of N loose rank-local files.
RESTORE_REPORT_FNAME = ".report.restore.json"
# Prefix matching both the merged digest and legacy rank-local records.
RESTORE_REPORT_PREFIX = ".report.restore."


def rank_report_path(take_id: str, rank: int) -> str:
    return f"{RANK_REPORT_PREFIX}{take_id}/{rank}"


def restore_report_fname(rank: int) -> str:
    """Legacy rank-local restore record name (still read by inspect/
    doctor for snapshots written before the merged digest existed)."""
    return f".report.restore.rank{rank}.json"


class FlightRecorder:
    """One rank's record of one snapshot operation.

    Thread-safe: an async take's write/commit phases are timed from the
    background drain thread while the foreground may already be
    consulting the recorder.
    """

    def __init__(self, kind: str, path: str, rank: int) -> None:
        self.kind = kind
        self.path = path
        self.rank = rank
        self._t0 = time.monotonic()
        self._baseline = REGISTRY.snapshot()
        self._phases: Dict[str, float] = {}
        self._pipeline: Dict[str, Any] = {}
        self._lock = threading.Lock()
        # Take-side hot-tier replication window (snapwire): opened at
        # recorder birth so every commit route — sync, async, KV,
        # storage — attributes the same window. None when the tier is
        # off; best-effort by contract (observability never fails a
        # take).
        self._replication_token: Any = None
        if kind == "take":
            try:
                from torchsnapshot_tpu_torch import hottier

                self._replication_token = hottier.replication_stats_begin()
            except Exception:
                logger.debug("replication window open failed", exc_info=True)
        # Wire-observability window (wiretap/snapflight): opened for
        # both kinds, so the summary's ``wire`` block attributes every
        # RPC this operation put on any transport. Best-effort by the
        # same contract as the replication window.
        self._wire_token: Any = None
        try:
            from torchsnapshot_tpu_torch import wiretap

            self._wire_token = wiretap.window_begin()
        except Exception:
            logger.debug("wire window open failed", exc_info=True)
        # Host-memory window (memwatch/snapmem): phase-windowed
        # per-domain high-waters for this operation's ``memory`` block.
        # Same contract: best-effort, absent when nothing registered.
        self._mem_token: Any = None
        try:
            from torchsnapshot_tpu_torch.telemetry import memwatch

            self._mem_token = memwatch.window_begin()
        except Exception:
            logger.debug("memory window open failed", exc_info=True)

    @contextmanager
    def phase(self, name: str, span: Optional[str] = None, **args: Any) -> Iterator[None]:
        """Time a named phase; re-entry accumulates. The phase is also a
        tracing span, ``phase.<name>`` unless ``span`` names it, with
        ``args``."""
        t0 = time.monotonic()
        try:
            with tracing.span(span or f"phase.{name}", **args):
                yield
        finally:
            self.add_phase(name, time.monotonic() - t0)

    def add_phase(self, name: str, seconds: float) -> None:
        with self._lock:
            self._phases[name] = self._phases.get(name, 0.0) + seconds

    def note_pipeline(self, stats: Dict[str, Any]) -> None:
        """Merge one ``execute_write_reqs``/``execute_read_reqs`` stats
        dict (bytes/stall/high-water/per-op aggregates accumulate)."""
        with self._lock:
            p = self._pipeline
            p["bytes"] = p.get("bytes", 0) + stats.get("bytes", 0)
            p["stall_s"] = p.get("stall_s", 0.0) + stats.get("stall_s", 0.0)
            p["high_water_bytes"] = max(
                p.get("high_water_bytes", 0),
                stats.get("budget_high_water_bytes", 0),
            )
            ops = p.setdefault("ops", {})
            for op, agg in (stats.get("ops") or {}).items():
                acc = ops.setdefault(
                    op, {"count": 0, "seconds": 0.0, "bytes": 0}
                )
                acc["count"] += agg.get("count", 0)
                acc["seconds"] += agg.get("seconds", 0.0)
                acc["bytes"] += agg.get("bytes", 0)

    def note(self, **extra: Any) -> None:
        """Attach scalar facts (e.g. ``assemble_s``) to the summary."""
        with self._lock:
            self._pipeline.setdefault("extra", {}).update(extra)

    def rank_summary(self) -> Dict[str, Any]:
        delta = diff_snapshots(self._baseline, REGISTRY.snapshot())
        with self._lock:
            phases = {f"{k}_s": round(v, 6) for k, v in self._phases.items()}
            pipeline = json.loads(json.dumps(self._pipeline))  # deep copy
        wall_s = time.monotonic() - self._t0
        nbytes = pipeline.get("bytes", 0)
        summary: Dict[str, Any] = {
            "rank": self.rank,
            "wall_s": round(wall_s, 6),
            "phases": phases,
            "bytes": nbytes,
            "throughput_mbps": round(
                nbytes / (1 << 20) / wall_s if wall_s > 0 else 0.0, 3
            ),
            "budget": {
                "high_water_bytes": pipeline.get("high_water_bytes", 0),
                "stall_s": round(pipeline.get("stall_s", 0.0), 6),
            },
            "scheduler_ops": {
                op: {
                    "count": agg["count"],
                    "seconds": round(agg["seconds"], 6),
                    "bytes": agg["bytes"],
                }
                for op, agg in (pipeline.get("ops") or {}).items()
            },
            "storage_ops": _storage_ops_from_delta(delta),
            "retries": {
                "total": sum_samples(delta, _m.STORAGE_RETRIES),
                "backoff_s": round(
                    sum_samples(delta, _m.STORAGE_RETRY_BACKOFF), 6
                ),
                "by_op": {
                    op: v
                    for op, v in samples_by_label(
                        delta, _m.STORAGE_RETRIES, "op"
                    ).items()
                },
            },
            "faults": {
                kind: v
                for kind, v in samples_by_label(
                    delta, _m.FAULTS_INJECTED, "kind"
                ).items()
            },
        }
        summary.update(pipeline.get("extra", {}))
        if self._replication_token is not None:
            # Close the snapwire window: the take's tier.replication
            # block (pushes / delta_ratio / deadline misses / acked-
            # bytes split) — what the replication-degraded doctor rule
            # and the ledger's tier field read. Absent when the window
            # saw no wire traffic.
            try:
                from torchsnapshot_tpu_torch import hottier

                block = hottier.replication_stats_collect(self._replication_token)
            except Exception:
                logger.debug("replication window collect failed", exc_info=True)
                block = None
            if block:
                summary.setdefault("tier", {})["replication"] = block
        if self._wire_token is not None:
            # Close the wiretap window: per-op latency quantiles,
            # deadline margin, retries and outcome mix for every RPC this
            # operation issued — what the deadline-margin-collapsing
            # doctor rule and the ledger's wire field read. Absent when
            # the window saw no wire traffic.
            try:
                from torchsnapshot_tpu_torch import wiretap

                wire_block = wiretap.window_collect(self._wire_token)
            except Exception:
                logger.debug("wire window collect failed", exc_info=True)
                wire_block = None
            if wire_block:
                summary["wire"] = wire_block
        if self._mem_token is not None:
            # Close the memory window: per-domain high-waters inside
            # this operation, ending occupancy/residuals, counter
            # deltas, and any pressure forecasts — what the
            # host-memory doctor rules, the leak sentinel, and the
            # ledger's memory field read. Absent when no domain was
            # registered.
            try:
                from torchsnapshot_tpu_torch.telemetry import memwatch

                mem_block = memwatch.window_collect(self._mem_token)
            except Exception:
                logger.debug("memory window collect failed", exc_info=True)
                mem_block = None
            if mem_block:
                summary["memory"] = mem_block
        # Goodput attribution at summary time (present only once the
        # accountant saw a train loop or a checkpoint wait): the doctor's
        # checkpoint-overhead-above-budget rule and the ledger's goodput
        # trend both read it from here.
        from . import goodput as _goodput

        if _goodput.has_data():
            summary["goodput"] = _goodput.snapshot()
        return summary


def local_export(recorder: "FlightRecorder") -> None:
    """Honor the env auto-export knobs with this operation's summary
    (best-effort; see :func:`..export.maybe_export`)."""
    from .export import maybe_export

    summary = recorder.rank_summary()
    summary["kind"] = recorder.kind
    summary["path"] = recorder.path
    maybe_export(summary)


def _storage_ops_from_delta(delta: Dict[str, Any]) -> Dict[str, Any]:
    """``{"<backend>/<op>": {"count","seconds","bytes"}}`` from the
    storage-op histogram deltas."""
    out: Dict[str, Any] = {}

    def labels_of(key: str) -> Dict[str, str]:
        if "{" not in key:
            return {}
        inner = key[key.index("{") + 1 : -1]
        pairs = {}
        for part in inner.split(","):
            if "=" in part:
                k, v = part.split("=", 1)
                pairs[k] = v.strip('"')
        return pairs

    for key, value in delta.items():
        if not isinstance(value, dict):
            continue
        if key.startswith(_m.STORAGE_OP_SECONDS):
            field, scale = "seconds", 1.0
        elif key.startswith(_m.STORAGE_OP_BYTES):
            field, scale = "bytes", 1
        else:
            continue
        labels = labels_of(key)
        ident = f"{labels.get('backend', '?')}/{labels.get('op', '?')}"
        entry = out.setdefault(
            ident, {"count": 0, "seconds": 0.0, "bytes": 0}
        )
        if field == "seconds":
            entry["count"] += value.get("count", 0)
            entry["seconds"] = round(
                entry["seconds"] + value.get("sum", 0.0), 6
            )
        else:
            entry["bytes"] += int(value.get("sum", 0))
    return out


def build_report(
    kind: str,
    path: str,
    take_id: Optional[str],
    world_size: int,
    summaries: List[Optional[Dict[str, Any]]],
) -> Dict[str, Any]:
    """Merge per-rank summaries (rank order; None = summary never
    arrived, recorded as null so the gap itself is visible)."""
    present = [s for s in summaries if s]
    totals = {
        "bytes": sum(s.get("bytes", 0) for s in present),
        "wall_s": round(max((s.get("wall_s", 0.0) for s in present), default=0.0), 6),
        "retries": sum(
            (s.get("retries") or {}).get("total", 0) for s in present
        ),
        "faults": sum(
            sum((s.get("faults") or {}).values()) for s in present
        ),
        "stall_s": round(
            sum((s.get("budget") or {}).get("stall_s", 0.0) for s in present),
            6,
        ),
    }
    return {
        "format_version": REPORT_FORMAT_VERSION,
        "kind": kind,
        "path": path,
        "take_id": take_id,
        "world_size": world_size,
        "ranks": list(summaries),
        "totals": totals,
    }


async def awrite_json(storage: Any, path: str, doc: Dict[str, Any]) -> None:
    io_req = IOReq(
        path=path,
        data=json.dumps(doc, indent=2, sort_keys=True).encode("utf-8"),
    )
    await storage.write(io_req)


async def aread_json(storage: Any, path: str) -> Optional[Dict[str, Any]]:
    """Best-effort single-attempt JSON read: None when absent/torn."""
    try:
        io_req = IOReq(path=path)
        await storage.read(io_req)
        return json.loads(bytes(io_payload(io_req)).decode("utf-8"))
    except Exception as e:
        logger.debug("flight-record read of %s failed: %r", path, e)
        return None


def render_report(report: Dict[str, Any]) -> str:
    """Human-readable rendering for ``inspect --report``."""
    lines: List[str] = []
    totals = report.get("totals") or {}
    lines.append(
        f"{report.get('kind', '?')} report for {report.get('path', '?')}"
        + (
            f" (take_id {report['take_id']})"
            if report.get("take_id")
            else ""
        )
    )
    lines.append(
        f"world {report.get('world_size', '?')}: "
        f"{totals.get('bytes', 0)} bytes in {totals.get('wall_s', 0.0):.2f}s"
        f" | retries {totals.get('retries', 0):g}"
        f" | faults {totals.get('faults', 0):g}"
        f" | budget stall {totals.get('stall_s', 0.0):.2f}s"
    )
    lines.append(
        f"{'rank':>4s} {'bytes':>14s} {'MB/s':>9s} {'stall_s':>8s} "
        f"{'retries':>8s}  phases"
    )
    for i, s in enumerate(report.get("ranks") or []):
        if not s:
            lines.append(f"{i:4d} {'<no summary received>':>14s}")
            continue
        phases = " ".join(
            f"{k[:-2]}={v:.2f}s"
            for k, v in sorted((s.get("phases") or {}).items())
        )
        lines.append(
            f"{s.get('rank', i):4d} {s.get('bytes', 0):14d} "
            f"{s.get('throughput_mbps', 0.0):9.2f} "
            f"{(s.get('budget') or {}).get('stall_s', 0.0):8.2f} "
            f"{(s.get('retries') or {}).get('total', 0):8g}  {phases}"
        )
        ops = s.get("scheduler_ops") or {}
        if ops:
            op_str = " ".join(
                f"{op}[n={agg['count']} {agg['seconds']:.2f}s "
                f"{agg['bytes']}B]"
                for op, agg in sorted(ops.items())
            )
            lines.append(f"     {op_str}")
    return "\n".join(lines)
