"""Fold a snapshot Chrome trace into a per-phase table.

Usage::

    python -m torchsnapshot_tpu_torch.telemetry.summarize <trace.json> [--json]

Reads the trace written by ``TPUSNAPSHOT_TRACE=…`` (see ``tracing.py``)
and prints, per span name: count, total span-seconds, *busy* wall-clock
(union of intervals — the number that matters for a pipelined schedule),
overlap factor, and bytes/throughput where spans carry a ``bytes`` arg.

It then names the **dominant phase** among the pipeline ops
(stage/write on a take; read/consume on a restore), so the pathology
that motivated this tool — BENCH_r05's restore spending 176.3s in
``consume`` against 0.76s of ``read`` — is flagged automatically
instead of requiring a human to eyeball Perfetto.

``consume.<substep>`` spans (the snapxray micro-profiler,
``telemetry/consume_profile.py``) additionally fold into a **consume
breakdown** naming the dominant sub-step and each sub-step's share of
the consume phase's busy time — WHERE inside consume the time went.

A merged multi-process trace (``telemetry/merge.py``) appends the
cross-process critical path: which rank or read-plane server gated the
operation.

Exit codes: 0 = summarized; 1 = no spans in the trace; 2 = usage error.
"""

import argparse
import json
import sys
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

# The pipelined per-request ops, by direction. "Dominant" is judged on
# busy (unioned) seconds within a direction: total span-seconds double-
# counts concurrency, and comparing across directions is meaningless
# (a take has no consume; a restore has no stage).
_WRITE_OPS = ("stage", "write")
_READ_OPS = ("read", "consume")

# When the dominant phase's busy time is at least this multiple of its
# pipeline sibling's, the summary calls the run "<phase>-dominated" —
# the situation where optimizing the other phase buys nothing.
_DOMINANCE_RATIO = 3.0


def union_seconds(intervals: List[Tuple[float, float]]) -> float:
    """Wall-clock covered by the union of [begin, end) interval pairs."""
    total = 0.0
    end: Optional[float] = None
    for b, e in sorted(intervals):
        if end is None or b > end:
            total += e - b
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def load_events(path: str) -> List[Dict[str, Any]]:
    return load_doc(path)[0]


def load_doc(
    path: str,
) -> Tuple[List[Dict[str, Any]], Dict[str, Any]]:
    """``(events, trace metadata)`` — metadata is ``{}`` for bare-array
    traces and traces from before the identity stamp existed."""
    with open(path) as f:
        doc = json.load(f)
    if isinstance(doc, dict):
        meta = doc.get("metadata")
        return doc.get("traceEvents", []), meta if isinstance(meta, dict) else {}
    if isinstance(doc, list):  # bare-array Chrome trace variant
        return doc, {}
    raise ValueError(f"{path}: not a Chrome trace (dict or list expected)")


def fold_spans(
    events: List[Dict[str, Any]]
) -> Dict[str, Dict[str, Any]]:
    """Group span events by name: intervals (µs), bytes, and counts.

    Understands the async begin/end pairs ``tracing.span`` emits
    (``ph: b``/``e`` matched by id) and complete ``X`` events from other
    tools; instants (``i``) are tallied by name but carry no duration.
    """
    begins: Dict[Any, Dict[str, Any]] = {}
    spans: Dict[str, Dict[str, Any]] = {}

    def bucket(name: str) -> Dict[str, Any]:
        return spans.setdefault(
            name, {"intervals": [], "bytes": 0, "instants": 0}
        )

    for ev in events:
        ph = ev.get("ph")
        name = ev.get("name", "")
        if ph == "b":
            begins[(ev.get("id"), name)] = ev
        elif ph == "e":
            b = begins.pop((ev.get("id"), name), None)
            if b is None:
                continue
            entry = bucket(name)
            entry["intervals"].append((b["ts"], ev["ts"]))
            args = b.get("args") or {}
            if isinstance(args.get("bytes"), int):
                entry["bytes"] += args["bytes"]
        elif ph == "X":
            entry = bucket(name)
            entry["intervals"].append(
                (ev["ts"], ev["ts"] + ev.get("dur", 0))
            )
            args = ev.get("args") or {}
            if isinstance(args.get("bytes"), int):
                entry["bytes"] += args["bytes"]
        elif ph == "i":
            bucket(name)["instants"] += 1
    return spans


def summarize(spans: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
    """Per-phase stats plus the dominant-phase verdict, as plain data."""
    phases: Dict[str, Dict[str, Any]] = {}
    for name, entry in spans.items():
        ivs = entry["intervals"]
        if not ivs:
            if entry["instants"]:
                phases[name] = {
                    "count": entry["instants"],
                    "total_s": 0.0,
                    "busy_s": 0.0,
                    "bytes": 0,
                    "instant": True,
                }
            continue
        total = sum(e - b for b, e in ivs) / 1e6
        busy = union_seconds(ivs) / 1e6
        phases[name] = {
            "count": len(ivs),
            "total_s": round(total, 6),
            "busy_s": round(busy, 6),
            "overlap": round(total / busy, 2) if busy else 0.0,
            "bytes": entry["bytes"],
            "instant": False,
        }

    # Consume-breakdown fold (snapxray): consume.<substep> spans from
    # the micro-profiler, as shares of the consume phase's busy time.
    # Beside-the-wall sub-steps (read_wait; the fastlane overlap
    # engine's h2d_overlap/overlap_other) fold into the table for
    # visibility but carry NO consume share and are never named
    # dominant — engine transfers on a wire-bound restore would
    # otherwise always "dominate" a wall they are not part of (the same
    # exclusion doctor and bench_compare apply).
    _BESIDE_WALL = ("read_wait", "h2d_overlap", "overlap_other")
    consume_busy = (phases.get("consume") or {}).get("busy_s", 0.0)
    breakdown: Dict[str, Dict[str, Any]] = {}
    for name, p in phases.items():
        if not name.startswith("consume.") or p.get("instant"):
            continue
        sub = name[len("consume."):]
        beside = sub in _BESIDE_WALL
        breakdown[sub] = {
            "busy_s": p["busy_s"],
            "total_s": p["total_s"],
            "bytes": p["bytes"],
            "share": (
                round(min(1.0, p["busy_s"] / consume_busy), 4)
                if consume_busy and not beside
                else None
            ),
        }
        if beside:
            breakdown[sub]["beside_wall"] = True
    consume_breakdown: Optional[Dict[str, Any]] = None
    if breakdown:
        in_wall = {
            s: v
            for s, v in breakdown.items()
            if not v.get("beside_wall")
        }
        dominant = (
            max(in_wall, key=lambda s: in_wall[s]["busy_s"])
            if in_wall
            else None
        )
        consume_breakdown = {
            "substeps": breakdown,
            "dominant_substep": dominant,
            "consume_busy_s": consume_busy,
        }

    verdict: Optional[Dict[str, Any]] = None
    for ops in (_READ_OPS, _WRITE_OPS):
        present = [op for op in ops if op in phases and not phases[op]["instant"]]
        if len(present) < 2:
            continue
        ranked = sorted(present, key=lambda op: -phases[op]["busy_s"])
        top, sibling = ranked[0], ranked[1]
        top_busy = phases[top]["busy_s"]
        sib_busy = phases[sibling]["busy_s"]
        candidate = {
            "pipeline": "restore" if ops is _READ_OPS else "take",
            "dominant_phase": top,
            "busy_s": top_busy,
            "sibling": sibling,
            "sibling_busy_s": sib_busy,
            "dominated": bool(
                top_busy > 0
                and (sib_busy == 0 or top_busy / max(sib_busy, 1e-12) >= _DOMINANCE_RATIO)
            ),
        }
        if verdict is None or candidate["busy_s"] > verdict["busy_s"]:
            verdict = candidate
    out = {"phases": phases, "verdict": verdict}
    if consume_breakdown is not None:
        out["consume_breakdown"] = consume_breakdown
    return out


_ADVICE = {
    "consume": (
        "deserialization / host->device placement is the bottleneck, "
        "not storage reads"
    ),
    "read": "storage read bandwidth is the bottleneck",
    "stage": (
        "device->host transfer / serialization is the bottleneck, "
        "not storage writes"
    ),
    "write": "storage write bandwidth is the bottleneck",
}


def render(summary: Dict[str, Any]) -> str:
    phases = summary["phases"]
    lines: List[str] = []
    durations = [
        p for p in phases.values() if not p.get("instant")
    ]
    if durations:
        lines.append(
            f"{'span':24s} {'count':>7s} {'total_s':>10s} {'busy_s':>9s} "
            f"{'overlap':>8s} {'GB':>8s} {'GB/s(busy)':>11s}"
        )
        for name in sorted(
            (n for n, p in phases.items() if not p.get("instant")),
            key=lambda n: -phases[n]["total_s"],
        ):
            p = phases[name]
            gb = p["bytes"] / 1024**3
            rate = (
                f"{gb / p['busy_s']:11.3f}"
                if p["bytes"] and p["busy_s"]
                else " " * 11
            )
            lines.append(
                f"{name:24s} {p['count']:7d} {p['total_s']:10.2f} "
                f"{p['busy_s']:9.2f} {p.get('overlap', 0.0):7.1f}x "
                f"{gb:8.2f} {rate}"
            )
    instants = {n: p for n, p in phases.items() if p.get("instant")}
    for name in sorted(instants):
        lines.append(f"{name:24s} {instants[name]['count']:7d} (instants)")
    verdict = summary.get("verdict")
    if verdict is not None:
        lines.append("")
        lines.append(
            f"dominant phase: {verdict['dominant_phase']} "
            f"({verdict['busy_s']:.2f}s busy vs {verdict['sibling']} "
            f"{verdict['sibling_busy_s']:.2f}s)"
        )
        if verdict["dominated"]:
            advice = _ADVICE.get(verdict["dominant_phase"], "")
            lines.append(
                f"{verdict['pipeline']} is "
                f"{verdict['dominant_phase']}-dominated"
                + (f": {advice}" if advice else "")
            )
    breakdown = summary.get("consume_breakdown")
    if breakdown:
        lines.append("")
        dominant = breakdown["dominant_substep"]
        lines.append(
            "consume breakdown"
            + (
                f" (dominant sub-step: {dominant}):"
                if dominant
                else " (all sub-steps beside the consume wall):"
            )
        )
        for sub, p in sorted(
            breakdown["substeps"].items(),
            key=lambda kv: -kv[1]["busy_s"],
        ):
            share = p.get("share")
            if p.get("beside_wall"):
                share_str = "beside consume wall"
            elif share is not None:
                share_str = f"{100 * share:5.1f}% of consume"
            else:
                share_str = " " * 18
            lines.append(
                f"  consume.{sub:18s} {p['busy_s']:9.3f}s busy  "
                f"{share_str}  {p['bytes'] / 1024**3:8.2f} GB"
            )
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m torchsnapshot_tpu_torch.telemetry.summarize",
        description="Fold a snapshot Chrome trace into a per-phase table.",
    )
    parser.add_argument("trace", help="Chrome-trace JSON written by tracing.py")
    parser.add_argument(
        "--json",
        action="store_true",
        help="emit the summary as JSON instead of a table",
    )
    args = parser.parse_args(argv)
    try:
        events, meta = load_doc(args.trace)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    summary = summarize(fold_spans(events))
    if not summary["phases"]:
        print("no spans found", file=sys.stderr)
        return 1
    if meta.get("merged"):
        # A merged multi-process trace (telemetry/merge.py): append the
        # critical path (which rank, server or phase gated the operation)
        # and the per-process skew table the merge corrected with. Labels
        # cover only role processes (e.g. the snapserve server): rank
        # processes keep the bare "rank N" rendering.
        from .merge import critical_path

        labels = {
            int(p["pid"]): p["label"]
            for p in meta.get("processes") or []
            if p.get("role")
        }
        summary["cross_rank"] = {
            "ranks": meta.get("ranks"),
            "processes": meta.get("processes"),
            "skew_s": meta.get("skew_s"),
            "cross_process_flows": meta.get("cross_process_flows"),
            "critical_path": critical_path(events, labels=labels),
        }
    if args.json:
        print(json.dumps(summary, indent=2, sort_keys=True))
    else:
        print(render(summary))
        cross = summary.get("cross_rank")
        cp = (cross or {}).get("critical_path")
        if cp:
            print()
            print(
                f"critical path: "
                f"{cp.get('gating_process') or 'rank %s' % cp['gating_rank']} "
                f"gated the commit (last {cp['gating_phase']} ended at "
                f"{cp['gate_end_s']:.3f}s)"
            )
            skews = cross.get("skew_s") or {}
            # Role processes key the skew table by "<role>:<os-pid>",
            # not the merged pid the critical-path rows carry — join
            # through the processes table's skew_key.
            skew_by_pid = {
                int(p["pid"]): skews.get(p.get("skew_key"), 0.0)
                for p in cross.get("processes") or []
            }
            for row in cp["per_rank"]:
                label = row.get("process") or f"rank {row['rank']}"
                skew = skew_by_pid.get(
                    int(row["rank"]), skews.get(str(row["rank"]), 0.0)
                )
                print(
                    f"  {label}: last {row['last_phase']} "
                    f"ended {row['last_end_s']:.3f}s, slack "
                    f"{row['slack_s']:.3f}s  "
                    f"(clock skew {skew:+.6f}s)"
                )
    return 0


if __name__ == "__main__":
    sys.exit(main())
