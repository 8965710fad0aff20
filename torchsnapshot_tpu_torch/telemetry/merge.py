"""Cross-process Chrome-trace merge: one timeline, one clock, one verdict.

Usage::

    python -m torchsnapshot_tpu_torch.telemetry.merge rank0.json rank1.json \
        server.json ... -o merged.json [--json]

Each per-process trace written by ``tracing.py`` is self-describing:
its ``metadata`` carries ``clock_epoch_s`` (the wall-clock epoch of
trace ts 0), ``rank``, ``host``, ``pid``, and (for non-rank processes
like a snapserve server) ``role``. The merge

1. maps every event's monotonic ts onto the wall clock,
2. **corrects clock skew** — rank processes align on coord barrier
   instants (``barrier_exit``: every rank passes a given barrier
   generation at approximately one global moment, so per-rank deviation
   from the cross-rank median at shared generations IS that rank's
   clock skew); processes with no barriers (a snapserve server) align
   on **paired flow events**: a client's ``s``/``f`` pair brackets the
   server's ``t`` for the same flow id, so the NTP-style midpoint
   offset estimates the server's skew with the network latency
   cancelled,
3. emits a single Perfetto-loadable trace — each process rendered as
   its own track (rank processes keep ``pid = rank``, named
   ``rank N (host)``; role processes get ``<role> pid P (host)``),
   span ids namespaced per process so cross-process id collisions
   cannot pair a begin in one process with an end in another, all
   timestamps rebased to one monotonic non-negative clock. Flow events
   (``ph: s/t/f``) survive the merge with their shared ids intact —
   Perfetto draws the client→server→client arrows,
4. computes the **cross-process critical path**: which process's
   pipeline activity ended last (gating the operation every other
   process then waited for), that process's dominant phase, and each
   process's slack.

``telemetry.summarize`` recognizes a merged trace and appends the
critical-path section to its per-phase table.

Exit codes: 0 = merged; 1 = no events in any input; 2 = usage error.
"""

import argparse
import json
import statistics
import sys
from typing import Any, Dict, List, Optional, Tuple

# The pipelined ops whose completion can gate a commit/restore — client
# pipeline ops plus the read plane's serving ops (a server process's
# whole pipeline activity IS serving); instants and orchestration
# wrappers don't gate by themselves. hottier spans are deliberately
# absent: replication runs inside write spans, and the BACKGROUND
# drain completes after the commit by design — counting it would name
# the drain the "gater" of a commit that never waited for it.
_PIPELINE_OPS = (
    "stage",
    "write",
    "read",
    "consume",
    "snapserve.request",
    "snapserve.backend_fetch",
)

_BARRIER_INSTANT = "barrier_exit"
_COMMIT_INSTANTS = ("metadata_committed", "step_marker_committed")
_FLOW_PHASES = ("s", "t", "f")


def load_trace(path: str) -> Dict[str, Any]:
    with open(path) as f:
        doc = json.load(f)
    if isinstance(doc, list):  # bare-array Chrome trace variant
        doc = {"traceEvents": doc}
    if not isinstance(doc, dict):
        raise ValueError(f"{path}: not a Chrome trace")
    return doc


def trace_meta(doc: Dict[str, Any], fallback_rank: int) -> Dict[str, Any]:
    """The trace's identity metadata, tolerating traces from before the
    stamp existed (they merge as rank ``fallback_rank`` on an
    uncorrected clock)."""
    meta = doc.get("metadata") or {}
    return {
        "clock_epoch_s": float(meta.get("clock_epoch_s") or 0.0),
        "rank": int(meta["rank"]) if meta.get("rank") is not None else fallback_rank,
        "host": str(meta.get("host") or "?"),
        "pid": int(meta["pid"]) if meta.get("pid") is not None else 0,
        "role": str(meta["role"]) if meta.get("role") else None,
    }


def _process_label(meta: Dict[str, Any]) -> str:
    if meta["role"]:
        return f"{meta['role']} pid {meta['pid']} ({meta['host']})"
    return f"rank {meta['rank']} ({meta['host']})"


def _skew_key(meta: Dict[str, Any]) -> str:
    """The per-process key in the ``skew_s`` table. Rank processes keep
    the bare-rank key (backward compatible); role processes key as
    ``<role>:<pid>``."""
    if meta["role"]:
        return f"{meta['role']}:{meta['pid']}"
    return str(meta["rank"])


def _barrier_walls(
    doc: Dict[str, Any], epoch: float
) -> Dict[Any, float]:
    """``{barrier generation: wall time}`` for this trace's
    barrier-exit instants (first occurrence per generation)."""
    out: Dict[Any, float] = {}
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") == "i" and ev.get("name") == _BARRIER_INSTANT:
            gen = (ev.get("args") or {}).get("gen")
            if gen is not None and gen not in out:
                out[gen] = epoch + ev.get("ts", 0.0) / 1e6
    return out


def _flow_walls(
    doc: Dict[str, Any], epoch: float
) -> Dict[str, Dict[str, float]]:
    """``{flow id: {phase: wall}}`` for this trace's flow events (first
    occurrence per phase per id)."""
    out: Dict[str, Dict[str, float]] = {}
    for ev in doc.get("traceEvents", []):
        ph = ev.get("ph")
        if ph not in _FLOW_PHASES:
            continue
        fid = ev.get("id")
        if fid is None:
            continue
        entry = out.setdefault(str(fid), {})
        if ph not in entry:
            entry[ph] = epoch + ev.get("ts", 0.0) / 1e6
    return out


def _median(values: List[float]) -> float:
    # statistics.median averages even counts — the right call for NTP
    # offset estimates (two samples should not arbitrarily pick one).
    return float(statistics.median(values)) if values else 0.0


def compute_skews(
    docs: List[Dict[str, Any]], metas: List[Dict[str, Any]]
) -> List[float]:
    """Per-INPUT clock-skew estimate (seconds to SUBTRACT from that
    trace's wall times).

    Two anchor families, applied in order:

    - **barriers** — at each barrier generation shared by every
      barrier-bearing trace, a trace's deviation from the cross-trace
      median is skew plus barrier-exit jitter; averaged over
      generations.
    - **paired flows** — a trace with no barrier skew (a snapserve
      server) is aligned against already-corrected traces through
      matching flow ids: the client's ``s`` (request out) and ``f``
      (response in) bracket the server's ``t`` (handling), so
      ``t - (s + f)/2`` is the server's offset with the request/response
      latency cancelled (one-way flows fall back to ``t - s``). The
      median over all pairs is the skew.

    Traces with neither anchor get skew 0 (wall clock trusted as-is).
    """
    walls = [
        _barrier_walls(doc, meta["clock_epoch_s"])
        for doc, meta in zip(docs, metas)
    ]
    anchored = [i for i, w in enumerate(walls) if w]
    skews = [0.0] * len(docs)
    have_skew = [False] * len(docs)
    if anchored:
        shared = set(walls[anchored[0]])
        for i in anchored[1:]:
            shared &= set(walls[i])
        samples: Dict[int, List[float]] = {}
        for gen in shared:
            at = [walls[i][gen] for i in anchored]
            median = _median(at)
            for i in anchored:
                samples.setdefault(i, []).append(walls[i][gen] - median)
        for i, vals in samples.items():
            skews[i] = sum(vals) / len(vals)
            have_skew[i] = True

    # Rank processes are the reference frame for the flow pass: with no
    # barrier anchors at all, flow-aligning the CLIENT against an
    # uncorrected server would shift the wrong clock (the estimate is
    # order-dependent without a reference). Rank docs keep their
    # barrier skew (or 0); only role processes are flow-aligned.
    for i, meta in enumerate(metas):
        if meta["role"] is None:
            have_skew[i] = True

    flows = [
        _flow_walls(doc, meta["clock_epoch_s"])
        for doc, meta in zip(docs, metas)
    ]
    for i in range(len(docs)):
        if have_skew[i]:
            continue
        offsets: List[float] = []
        for j in range(len(docs)):
            if i == j or not have_skew[j]:
                continue
            for fid, mine in flows[i].items():
                theirs = flows[j].get(fid)
                if not theirs:
                    continue
                their_skew = skews[j]
                if "t" in mine and "s" in theirs:
                    # I handled a flow they initiated: their s/f
                    # bracket my t.
                    s = theirs["s"] - their_skew
                    f = theirs.get("f")
                    anchor = (s + (f - their_skew)) / 2 if f is not None else s
                    offsets.append(mine["t"] - anchor)
                elif "s" in mine and "t" in theirs:
                    # I initiated a flow they handled.
                    s = mine["s"]
                    f = mine.get("f")
                    anchor = (s + f) / 2 if f is not None else s
                    offsets.append(anchor - (theirs["t"] - their_skew))
        if offsets:
            skews[i] = _median(offsets)
            have_skew[i] = True
    return skews


def _assign_process_ids(
    metas: List[Dict[str, Any]]
) -> List[int]:
    """Output pid per input: rank processes keep ``pid = rank`` (the
    established convention summarize/tests rely on); role processes
    (and a second process claiming an already-taken rank — e.g. a
    forked child's re-suffixed trace) get distinct pids above the rank
    range."""
    taken: set = set()
    out: List[int] = []
    extra = None
    for meta in metas:
        if meta["role"] is None and meta["rank"] not in taken:
            taken.add(meta["rank"])
            out.append(meta["rank"])
        else:
            out.append(-1)  # assigned below, above the rank range
    base = max(taken, default=-1) + 1
    extra = base + 10000
    for i, pid in enumerate(out):
        if pid < 0:
            out[i] = extra
            extra += 1
    return out


def merge_traces(
    docs: List[Dict[str, Any]], skew_correct: bool = True
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Merge per-process traces onto one corrected clock.

    Returns ``(merged trace doc, info)`` where info carries the skew
    table, the cross-process flow count, and the critical-path verdict.
    """
    metas = [trace_meta(doc, i) for i, doc in enumerate(docs)]
    seen: Dict[Tuple, int] = {}
    for i, meta in enumerate(metas):
        ident = (meta["role"], meta["rank"], meta["pid"])
        if ident in seen:
            raise ValueError(
                f"duplicate process identity across input traces: "
                f"{_process_label(meta)} (inputs {seen[ident]} and {i}) "
                f"— each input must be a distinct process's trace"
            )
        seen[ident] = i
    skews = (
        compute_skews(docs, metas)
        if skew_correct
        else [0.0] * len(docs)
    )
    out_pids = _assign_process_ids(metas)
    # Per-process skew-table keys: first claimant of a rank keeps the
    # bare-rank key (backward compatible); a duplicate-rank process (a
    # forked child's re-suffixed trace) disambiguates by os pid so its
    # skew cannot silently overwrite the parent's.
    skew_keys: List[str] = []
    used_keys: set = set()
    for m in metas:
        key = _skew_key(m)
        if key in used_keys:
            key = f"{key}:{m['pid']}"
        used_keys.add(key)
        skew_keys.append(key)

    # Corrected wall time of every event; the merged clock starts at the
    # earliest event (ts >= 0, monotonic by construction: one shared
    # wall clock after skew subtraction).
    t_base: Optional[float] = None
    per_doc_events: List[List[Tuple[float, Dict[str, Any]]]] = []
    for doc, meta, skew in zip(docs, metas, skews):
        epoch = meta["clock_epoch_s"] - skew
        rows = []
        for ev in doc.get("traceEvents", []):
            if ev.get("ph") == "M":
                continue  # per-process metadata is re-emitted below
            wall = epoch + ev.get("ts", 0.0) / 1e6
            rows.append((wall, ev))
            t_base = wall if t_base is None else min(t_base, wall)
        per_doc_events.append(rows)
    if t_base is None:
        raise ValueError("no events in any input trace")

    # Cross-process flows: a flow id appearing in >= 2 inputs is a drawn
    # arrow (the acceptance telemetry for the snapxray CI smoke).
    flow_owners: Dict[str, set] = {}
    for i, doc in enumerate(docs):
        for ev in doc.get("traceEvents", []):
            if ev.get("ph") in _FLOW_PHASES and ev.get("id") is not None:
                flow_owners.setdefault(str(ev["id"]), set()).add(i)
    cross_flows = sum(1 for owners in flow_owners.values() if len(owners) > 1)

    labels = {
        out_pids[i]: _process_label(meta) for i, meta in enumerate(metas)
    }
    merged_events: List[Dict[str, Any]] = []
    for i, (meta, rows) in enumerate(zip(metas, per_doc_events)):
        pid = out_pids[i]
        merged_events.append(
            {
                "name": "process_name",
                "ph": "M",
                "pid": pid,
                "tid": 0,
                "args": {"name": labels[pid]},
            }
        )
        ns = f"r{pid}" if meta["role"] is None else f"p{pid}"
        for wall, ev in rows:
            out = dict(ev)
            out["ts"] = (wall - t_base) * 1e6
            out["pid"] = pid
            if "id" in out and ev.get("ph") not in _FLOW_PHASES:
                # Namespace span ids per process: every trace counts ids
                # from 1, and a cross-process collision would let a
                # begin in process A pair with an end in process B.
                # Flow ids are NOT namespaced — their whole point is to
                # match across processes.
                out["id"] = f"{ns}:{out['id']}"
                if "parent" in out:
                    out["parent"] = f"{ns}:{out['parent']}"
            merged_events.append(out)
    merged_events.sort(key=lambda e: e.get("ts", 0.0))

    info = {
        "ranks": sorted(m["rank"] for m in metas if m["role"] is None),
        "processes": [
            {
                "pid": out_pids[i],
                "label": labels[out_pids[i]],
                "rank": m["rank"] if m["role"] is None else None,
                "role": m["role"],
                # The process's key in the skew_s table (role processes
                # key by their ORIGINAL os pid, not the merged pid) —
                # what lets summarize join the two per merged pid.
                "skew_key": skew_keys[i],
            }
            for i, m in enumerate(metas)
        ],
        "skew_s": {
            skew_keys[i]: round(skews[i], 6) for i in range(len(metas))
        },
        "t_base_epoch_s": t_base,
        "cross_process_flows": cross_flows,
        "critical_path": critical_path(merged_events, labels=labels),
    }
    merged = {
        "traceEvents": merged_events,
        "displayTimeUnit": "ms",
        "metadata": {
            "merged": True,
            "ranks": info["ranks"],
            "processes": info["processes"],
            "skew_s": info["skew_s"],
            "cross_process_flows": cross_flows,
            "clock_epoch_s": t_base,
            "tracer": "torchsnapshot_tpu_torch",
        },
    }
    return merged, info


def critical_path(
    events: List[Dict[str, Any]],
    labels: Optional[Dict[int, str]] = None,
) -> Optional[Dict[str, Any]]:
    """Which process/phase gated the operation.

    Per process (merged pid), find the end time of its last pipeline-op
    span (the work completion waits for). The **gating process** is the
    one whose pipeline ended last; every other process's slack is how
    long it sat finished while the gater worked. The commit instant
    (when present) confirms the ordering: it can only land after the
    gating process's last write.

    ``gating_rank`` / per-row ``rank`` keep the merged pid for backward
    compatibility (rank processes merge with ``pid = rank``);
    ``gating_process`` / per-row ``process`` carry the human label when
    the merge supplied one.
    """
    labels = labels or {}
    begins: Dict[Any, Dict[str, Any]] = {}
    last_end: Dict[int, float] = {}
    last_phase: Dict[int, str] = {}
    commit_ts: Optional[float] = None
    for ev in events:
        ph = ev.get("ph")
        name = ev.get("name", "")
        if ph == "i" and name in _COMMIT_INSTANTS:
            ts = ev.get("ts", 0.0)
            commit_ts = ts if commit_ts is None else max(commit_ts, ts)
            continue
        if name not in _PIPELINE_OPS:
            continue
        if ph == "b":
            begins[(ev.get("pid"), ev.get("id"), name)] = ev
        elif ph == "e":
            b = begins.pop((ev.get("pid"), ev.get("id"), name), None)
            if b is None:
                continue
            rank = int(ev.get("pid", 0))
            end = ev.get("ts", 0.0)
            if end >= last_end.get(rank, -1.0):
                last_end[rank] = end
                last_phase[rank] = name
        elif ph == "X":
            rank = int(ev.get("pid", 0))
            end = ev.get("ts", 0.0) + ev.get("dur", 0)
            if end >= last_end.get(rank, -1.0):
                last_end[rank] = end
                last_phase[rank] = name
    if not last_end:
        return None
    gating = max(last_end, key=lambda r: last_end[r])
    gate_end = last_end[gating]
    return {
        "gating_rank": gating,
        "gating_process": labels.get(gating, f"rank {gating}"),
        "gating_phase": last_phase[gating],
        "gate_end_s": round(gate_end / 1e6, 6),
        "commit_at_s": (
            round(commit_ts / 1e6, 6) if commit_ts is not None else None
        ),
        "per_rank": [
            {
                "rank": r,
                "process": labels.get(r, f"rank {r}"),
                "last_phase": last_phase[r],
                "last_end_s": round(last_end[r] / 1e6, 6),
                "slack_s": round((gate_end - last_end[r]) / 1e6, 6),
            }
            for r in sorted(last_end)
        ],
    }


def render_info(info: Dict[str, Any]) -> str:
    lines: List[str] = []
    processes = info.get("processes") or []
    if any(p.get("role") for p in processes):
        lines.append(
            f"merged {len(processes)} process trace(s): "
            + ", ".join(p["label"] for p in processes)
        )
    else:
        lines.append(
            f"merged {len(info['ranks'])} rank trace(s): "
            f"ranks {', '.join(str(r) for r in info['ranks'])}"
        )
    flows = info.get("cross_process_flows") or 0
    if flows:
        lines.append(f"cross-process flow arrows: {flows}")
    skews = info.get("skew_s") or {}
    if any(abs(v) > 0 for v in skews.values()):
        lines.append("per-process clock skew (s, corrected):")
        # Numeric keys (ranks) in numeric order, then role keys.
        for r in sorted(
            skews, key=lambda k: (0, int(k), "") if k.isdigit() else (1, 0, k)
        ):
            lines.append(f"  {r}: {skews[r]:+.6f}")
    else:
        lines.append("per-process clock skew: none detected (or no "
                     "shared anchors)")
    cp = info.get("critical_path")
    if cp:
        lines.append(
            f"critical path: {cp.get('gating_process') or 'rank ' + str(cp['gating_rank'])} "
            f"gated the operation (last {cp['gating_phase']} ended at "
            f"{cp['gate_end_s']:.3f}s)"
        )
        for row in cp["per_rank"]:
            lines.append(
                f"  {row.get('process') or 'rank ' + str(row['rank'])}: "
                f"last {row['last_phase']} ended "
                f"{row['last_end_s']:.3f}s, slack {row['slack_s']:.3f}s"
            )
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m torchsnapshot_tpu_torch.telemetry.merge",
        description="Merge per-process snapshot traces (ranks + read-"
        "plane servers) onto one skew-corrected clock.",
    )
    parser.add_argument("traces", nargs="+", help="per-process trace JSONs")
    parser.add_argument(
        "-o",
        "--output",
        required=True,
        help="path for the merged Perfetto-loadable trace",
    )
    parser.add_argument(
        "--no-skew-correct",
        action="store_true",
        help="trust wall clocks as-is (skip barrier/flow alignment)",
    )
    parser.add_argument(
        "--json",
        action="store_true",
        help="emit the skew table + critical path as JSON on stdout",
    )
    args = parser.parse_args(argv)
    try:
        docs = [load_trace(p) for p in args.traces]
        merged, info = merge_traces(
            docs, skew_correct=not args.no_skew_correct
        )
    except (OSError, ValueError, json.JSONDecodeError) as e:
        if isinstance(e, ValueError) and "no events" in str(e):
            print(f"error: {e}", file=sys.stderr)
            return 1
        print(f"error: {e}", file=sys.stderr)
        return 2
    with open(args.output, "w") as f:
        json.dump(merged, f)
    if args.json:
        print(json.dumps(info, indent=2, sort_keys=True))
    else:
        print(render_info(info))
        print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
