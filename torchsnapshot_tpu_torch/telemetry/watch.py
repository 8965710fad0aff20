"""Live snapshot-operation watcher (snapwatch's reading half).

Usage::

    python -m torchsnapshot_tpu_torch.telemetry.watch <path> [--follow]

``<path>`` is either a snapshot URL (any storage backend — the watcher
lists ``.progress/<take_id>/<rank>`` objects published by an in-flight
async/storage-route take) or a local progress directory (the
``TPUSNAPSHOT_PROGRESS_DIR`` statusfiles any take/restore publishes).

For each rank: phase, bytes done/total, throughput, ETA, and heartbeat
age. Ranks whose heartbeat exceeds the staleness window
(``--stale-after``, default 3x the publish interval) are flagged
``STALE`` — the straggler/hang signature — and the summary line names
them with the same range-compressed rank spans coord's timeout errors
use (``ranks 17, 40-63``).

Exit codes: 0 = rendered at least one in-flight operation;
1 = nothing in flight; 2 = usage/storage error.
"""

import argparse
import asyncio
import sys
import time
from typing import Any, Dict, List, Optional

from . import progress as _progress

_DEFAULT_STALE_MULT = 3.0


def _fmt_ranks(ranks: List[int]) -> str:
    from ..coord import format_rank_list

    return format_rank_list(sorted(ranks))


def _human_bytes(n: Optional[int]) -> str:
    if n is None:
        return "?"
    value = float(n)
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if value < 1024 or unit == "TB":
            return f"{value:.0f}{unit}" if unit == "B" else f"{value:.1f}{unit}"
        value /= 1024
    return f"{value:.1f}TB"


def _rate_and_eta(rec: Dict[str, Any], now: float):
    """(MB/s since start, ETA seconds) — None where not derivable."""
    done = rec.get("bytes_done") or 0
    total = rec.get("bytes_total")
    elapsed = now - rec.get("started_at", now)
    if elapsed <= 0 or done <= 0:
        return None, None
    rate = done / elapsed
    eta = None
    if total and total > done and rate > 0:
        eta = (total - done) / rate
    return rate / (1 << 20), eta


def render_progress(
    records: Dict[int, Dict[str, Any]],
    now: Optional[float] = None,
    stale_after_s: float = _DEFAULT_STALE_MULT * 2.0,
) -> str:
    """One operation's per-rank table plus the straggler summary."""
    now = time.time() if now is None else now
    any_rec = next(iter(records.values()))
    world = any_rec.get("world_size") or (max(records) + 1)
    lines: List[str] = []
    head = (
        f"{any_rec.get('kind', '?')} in flight at "
        f"{any_rec.get('path', '?')}"
    )
    if any_rec.get("take_id"):
        head += f" (take_id {any_rec['take_id']})"
    lines.append(head)
    lines.append(
        f"{'rank':>4s} {'phase':<12s} {'done':>10s} {'total':>10s} "
        f"{'%':>6s} {'MB/s':>8s} {'ETA':>7s} {'beat':>7s}  flags"
    )
    stale: List[int] = []
    missing: List[int] = []
    for rank in range(world):
        rec = records.get(rank)
        if rec is None:
            missing.append(rank)
            lines.append(f"{rank:4d} {'<no record>':<12s}")
            continue
        done = rec.get("bytes_done") or 0
        total = rec.get("bytes_total")
        pct = (
            f"{100.0 * done / total:5.1f}%"
            if total
            else "     ?"
        )
        rate, eta = _rate_and_eta(rec, now)
        beat_age = max(0.0, now - rec.get("heartbeat_at", now))
        is_done = rec.get("phase") == _progress.DONE_PHASE
        is_stale = not is_done and beat_age > stale_after_s
        if is_stale:
            stale.append(rank)
        flags = "STALE" if is_stale else ("done" if is_done else "")
        lines.append(
            f"{rank:4d} {str(rec.get('phase', '?')):<12s} "
            f"{_human_bytes(done):>10s} {_human_bytes(total):>10s} "
            f"{pct:>6s} "
            f"{f'{rate:8.2f}' if rate is not None else '       ?'} "
            f"{f'{eta:6.0f}s' if eta is not None else '      ?'} "
            f"{beat_age:6.1f}s  {flags}"
        )
    if stale:
        lines.append(
            f"STRAGGLER: {_fmt_ranks(stale)} heartbeat older than "
            f"{stale_after_s:g}s — stuck in storage IO, a collective, "
            f"or crashed"
        )
    if missing:
        lines.append(
            f"note: {_fmt_ranks(missing)} published no progress record"
        )
    return "\n".join(lines)


def collect(path: str) -> Dict[str, Dict[int, Dict[str, Any]]]:
    """All in-flight operations observable at ``path``: local progress
    directory or snapshot storage URL. ``{operation key: {rank:
    record}}``."""
    import os

    if "://" not in path and os.path.isdir(path):
        records = _progress.collect_statusfiles(path)
        # Statusfiles may mix operations; group by (kind, take_id).
        grouped: Dict[str, Dict[int, Dict[str, Any]]] = {}
        for rank, rec in records.items():
            key = f"{rec.get('kind', '?')}:{rec.get('take_id') or 'local'}"
            grouped.setdefault(key, {})[rank] = rec
        return grouped

    from ..storage_plugin import url_to_storage_plugin

    storage = url_to_storage_plugin(path)
    try:
        return asyncio.run(_progress.acollect_storage_records(storage))
    finally:
        storage.close()


def _stale_after_s(arg: Optional[float]) -> float:
    if arg is not None:
        return arg
    return _DEFAULT_STALE_MULT * _progress._interval_s()


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m torchsnapshot_tpu_torch.telemetry.watch",
        description="Render live per-rank progress of an in-flight "
        "snapshot operation.",
    )
    parser.add_argument(
        "path",
        help="snapshot URL (reads .progress/<take_id>/<rank> objects) or "
        "a local TPUSNAPSHOT_PROGRESS_DIR directory",
    )
    parser.add_argument(
        "--stale-after",
        type=float,
        default=None,
        metavar="S",
        help="flag a rank as a straggler when its heartbeat is older "
        "than S seconds (default: 3x the publish interval)",
    )
    parser.add_argument(
        "--follow",
        action="store_true",
        help="keep polling and re-rendering instead of printing once",
    )
    parser.add_argument(
        "--interval",
        type=float,
        default=2.0,
        metavar="S",
        help="poll interval for --follow (default 2s)",
    )
    args = parser.parse_args(argv)
    stale_after = _stale_after_s(args.stale_after)
    while True:
        try:
            ops = collect(args.path)
        except Exception as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        # Statusfiles outlive their operation (the terminal "done"
        # record is the point), so an all-done group is a FINISHED
        # operation, not an in-flight one — render it for context, but
        # only live groups satisfy the exit-0 contract; otherwise
        # `watch dir || handle_idle` would never fire again after the
        # first completed take.
        live = {
            key: recs
            for key, recs in ops.items()
            if any(
                r.get("phase") != _progress.DONE_PHASE
                for r in recs.values()
            )
        }
        first = True
        for key in sorted(ops):
            if not first:
                print()
            print(render_progress(ops[key], stale_after_s=stale_after))
            first = False
        if not live and not args.follow:
            print(
                f"no in-flight progress records at {args.path}",
                file=sys.stderr,
            )
            return 1
        if not args.follow:
            return 0
        time.sleep(args.interval)


if __name__ == "__main__":
    sys.exit(main())
