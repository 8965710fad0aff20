"""Trend rendering + regression sentinel over the telemetry ledger.

Usage::

    python -m torchsnapshot_tpu_torch.telemetry.timeline <ledger-root-url>
    python -m torchsnapshot_tpu_torch.telemetry.timeline /path/ledger.jsonl
    python -m torchsnapshot_tpu_torch.telemetry.timeline <dir-of-BENCH_*.json>
    python -m torchsnapshot_tpu_torch.inspect <base> --timeline

Where ledger.py is the durable record, this is the reader that answers
the longitudinal questions: per-step trends of take seconds, GB/s,
budget-stall %, retries, manifest churn (incremental efficiency), and
goodput fraction — plus a **rolling-baseline regression sentinel**: for
every metric, each point is compared against the median/MAD of the
preceding window; a deviation in the *bad* direction past
``max(k * 1.4826 * MAD, rel_floor * |median|, min_dev)`` flags a
regression naming the metric and the first bad step. Median/MAD is the
robust choice here: one earlier outlier must not inflate the baseline
into hiding a real drift (the classic failure of mean/stddev baselines
on noisy shared-tenancy links).

The sentinel also folds the doctor-rule firing history recorded per
take — "retry-storm fired at steps 40, 45, 50" is a trend even when no
single metric trips.

A directory of ``BENCH_*.json`` round artifacts is accepted in place of
a ledger: the same sentinel runs over the cross-round headline series
(take GB/s, restore GB/s, ceiling ratios). Sections a round skipped
under its deadline (``gaps``, bench.py) are missing data, never zeros.

Exit codes: 0 = healthy; 1 = regression flagged; 2 = usage / no data.
"""

import argparse
import glob as _glob
import json
import os
import statistics
import sys
from typing import Any, Dict, List, Optional, Tuple

# (dotted field, label, bad direction, min absolute deviation,
#  per-metric relative floor — None defers to the CLI's --rel-floor).
# Normalized metrics (fractions, ratios in [0, 1]) carry a tight
# relative floor of their own: a goodput drop from 0.97 to 0.60 is a
# major regression that a 50%-of-median floor would wave through.
_MetricDef = Tuple[str, str, str, float, Optional[float]]
_TAKE_METRICS: List[_MetricDef] = [
    ("wall_s", "take seconds", "high", 0.05, None),
    ("gbps", "take GB/s", "low", 0.0, None),
    ("stall_pct", "budget stall %", "high", 10.0, None),
    ("retries", "storage retries", "high", 5.0, None),
    ("churn.efficiency", "incremental efficiency", "low", 0.1, 0.15),
    # Codec stage (chunkstore.py): stored/logical bytes through the
    # per-chunk codec — a RISING ratio means compression is buying
    # less (codec misconfigured, payload entropy shifted). None (no
    # codec ran) is missing data, never a regression.
    ("churn.codec_ratio", "codec ratio", "high", 0.02, 0.2),
    # The WINDOWED fraction (since the previous ledger record, stamped
    # at append time): the cumulative fraction flattens as a run grows,
    # so late-run overhead creep would hide inside it.
    ("goodput.window_fraction", "goodput fraction", "low", 0.02, 0.1),
]
_RESTORE_METRICS: List[_MetricDef] = [
    ("wall_s", "restore seconds", "high", 0.05, None),
    ("gbps", "restore GB/s", "low", 0.0, None),
    # snapxray consume profile: consume GB/s as a fraction of the H2D
    # probe — the number ROADMAP item 1's streaming-restore rewrite is
    # certified against. Dropping means consume is falling further
    # behind the hardware bound. Null (no probe / pre-snapxray records)
    # is missing data, never a regression.
    ("consume.h2d_fraction", "consume/H2D fraction", "low", 0.02, 0.3),
]
# Drain event records (kind "tierdown", appended by the hot tier when a
# committed root fully tiers down): the durability-lag trend — the RPO
# exposure window creeping up across a run is exactly the regression
# this sentinel exists to name.
_DRAIN_METRICS: List[_MetricDef] = [
    ("durability_lag_s", "durability lag s", "high", 0.05, None),
]
_BENCH_METRICS: List[_MetricDef] = [
    ("value", "take GB/s", "low", 0.0, None),
    ("restore_GBps", "restore GB/s", "low", 0.0, None),
    ("take_vs_ceiling", "take/ceiling", "low", 0.05, 0.2),
    ("restore_vs_ceiling", "restore/ceiling", "low", 0.05, 0.2),
    # Hot-tier headline numbers, regression-gated like the rest:
    # the hot-vs-durable restore ratio, the every-step hot-leg goodput
    # overhead, and the bench take's measured durability lag.
    ("hot_tier.hot_vs_durable", "hot/durable restore ratio", "low", 0.5, 0.3),
    ("hot_tier.durability_lag_s", "bench durability lag s", "high", 0.5, None),
    ("every_step.hot.overhead_pct", "every-step overhead %", "high", 0.5, 0.3),
    # Snapserve read-fanout headline numbers: backend-read
    # amplification at 32 concurrent clients (the service must hold it
    # near 1x — creep back toward per-client backend reads is THE
    # read-plane regression) and the aggregate served throughput.
    (
        "read_fanout.amplification_served",
        "read-fanout amplification",
        "high",
        0.1,
        0.15,
    ),
    ("read_fanout.served_gbps", "read-fanout GB/s", "low", 0.05, 0.3),
    # Chunk-store dedup + codec headline numbers (bench dedup_codec
    # section): the unchanged-retake physical fraction and the 10%-
    # dirty-leaf physical fraction creeping UP mean dedup is saving
    # fewer bytes; the effective (logical-bytes) throughput and codec
    # ratio guard the "move fewer bytes" win itself.
    (
        "dedup_codec.second_take_physical_pct",
        "2nd-take physical %",
        "high",
        0.5,
        0.5,
    ),
    (
        "dedup_codec.dirty10_physical_pct",
        "10%-dirty physical %",
        "high",
        1.0,
        0.5,
    ),
    ("dedup_codec.effective_gbps", "dedup effective GB/s", "low", 0.05, 0.3),
    ("dedup_codec.codec_ratio", "bench codec ratio", "high", 0.02, 0.2),
    # snapxray: bench's restore-section consume/H2D fraction — same
    # sentinel rationale as the ledger-mode consume.h2d_fraction.
    (
        "restore_consume_vs_h2d",
        "bench consume/H2D fraction",
        "low",
        0.02,
        0.3,
    ),
    # fastlane: the streaming restore pipeline's overlap-engine H2D
    # GB/s over the bracketed ceiling — ~1.0 means the restore is
    # wire-bound; a drop is the pipeline sliding back toward a
    # consume-serialized restore.
    (
        "restore_vs_h2d_ceiling",
        "bench restore-H2D/ceiling",
        "low",
        0.05,
        0.2,
    ),
    # snapfleet headline numbers (bench fleet section): aggregate
    # backend amplification across the fleet (per-client pushdown must
    # keep the SUM of fetched bytes near 1x the payload — creep means
    # clients re-fetching whole objects), and the small tenant's p95
    # grant-wait ratio vs the saturating tenant (fairness: the small
    # tenant must not queue behind the big one's whole backlog).
    ("fleet.amplification", "fleet backend amplification", "high", 0.1, 0.2),
    (
        "fleet.fairness_p95_ratio",
        "fleet tenant-fairness p95 ratio",
        "high",
        0.1,
        0.5,
    ),
]


def _get(doc: Dict[str, Any], dotted: str) -> Optional[float]:
    cur: Any = doc
    for part in dotted.split("."):
        if not isinstance(cur, dict):
            return None
        cur = cur.get(part)
    return float(cur) if isinstance(cur, (int, float)) else None


def _median(values: List[float]) -> float:
    return float(statistics.median(values))


# ------------------------------------------------------------- the sentinel


def detect_regressions(
    points: List[Tuple[str, Optional[float]]],
    direction: str,
    *,
    window: int = 8,
    min_history: int = 3,
    mad_k: float = 5.0,
    rel_floor: float = 0.5,
    min_dev: float = 0.0,
) -> Optional[Dict[str, Any]]:
    """First regression in a ``(label, value)`` series, or None.

    Missing values (``None`` — a skipped bench section, a record that
    predates the metric) are excluded from baselines and never flagged:
    missing data is not zero."""
    present: List[Tuple[str, float]] = [
        (lab, v) for lab, v in points if v is not None
    ]
    for i, (label, value) in enumerate(present):
        baseline = [v for _, v in present[max(0, i - window) : i]]
        if len(baseline) < min_history:
            continue
        med = _median(baseline)
        mad = _median([abs(v - med) for v in baseline])
        threshold = max(
            mad_k * 1.4826 * mad, rel_floor * abs(med), min_dev
        )
        deviation = (value - med) if direction == "high" else (med - value)
        if deviation > threshold:
            return {
                "label": label,
                "value": round(value, 6),
                "baseline_median": round(med, 6),
                "baseline_mad": round(mad, 6),
                "deviation": round(deviation, 6),
                "threshold": round(threshold, 6),
                "direction": direction,
            }
    return None


def run_sentinel(
    series: Dict[str, List[Tuple[str, Optional[float]]]],
    metric_defs: List[_MetricDef],
    **knobs: Any,
) -> List[Dict[str, Any]]:
    findings = []
    for field, label, direction, min_dev, rel_floor in metric_defs:
        metric_knobs = dict(knobs)
        if rel_floor is not None:
            metric_knobs["rel_floor"] = min(
                rel_floor, metric_knobs.get("rel_floor", rel_floor)
            )
        hit = detect_regressions(
            series.get(field, []),
            direction,
            min_dev=min_dev,
            **metric_knobs,
        )
        if hit is not None:
            findings.append(dict(hit, metric=label, field=field))
    return findings


# ------------------------------------------------------------ ledger mode


def _record_label(record: Dict[str, Any], index: int) -> str:
    step = record.get("step")
    return f"step {step}" if step is not None else f"#{index}"


def build_series(
    records: List[Dict[str, Any]],
    metric_defs: List[_MetricDef],
) -> Dict[str, List[Tuple[str, Optional[float]]]]:
    series: Dict[str, List[Tuple[str, Optional[float]]]] = {}
    for i, record in enumerate(records):
        label = _record_label(record, i)
        for field, *_ in metric_defs:
            value = _get(record, field)
            if (
                field == "churn.efficiency"
                and (record.get("churn") or {}).get("basis") == "full"
            ):
                # A deliberate full take (full_period, first save) has
                # efficiency 0 by construction, not by regression — it
                # is missing data for the dedup-efficiency trend.
                value = None
            series.setdefault(field, []).append((label, value))
    return series


def doctor_history(
    records: List[Dict[str, Any]],
) -> Dict[str, List[str]]:
    """rule id -> labels of the records it fired on."""
    out: Dict[str, List[str]] = {}
    for i, record in enumerate(records):
        for rule in record.get("doctor") or []:
            out.setdefault(rule, []).append(_record_label(record, i))
    return out


def _fmt(v: Optional[float], spec: str = "8.3f") -> str:
    return format(v, spec) if isinstance(v, (int, float)) else " " * (
        int(spec.split(".")[0]) - 1
    ) + "—"


def render_ledger(records: List[Dict[str, Any]]) -> List[str]:
    lines = [
        f"{'record':>9s} {'kind':>10s} {'wall_s':>8s} {'GB/s':>8s} "
        f"{'stall%':>7s} {'retry':>5s} {'churn':>6s} {'goodput':>7s} "
        f"{'durlag':>7s} {'c/h2d':>6s}  doctor"
    ]
    for i, r in enumerate(records):
        doctor = ",".join(r.get("doctor") or []) or "-"
        goodput_col = _get(r, "goodput.window_fraction")
        if goodput_col is None:
            goodput_col = _get(r, "goodput.goodput_fraction")
        lines.append(
            f"{_record_label(r, i):>9s} {str(r.get('kind', '?')):>10s} "
            f"{_fmt(r.get('wall_s'))} {_fmt(r.get('gbps'), '8.4f')} "
            f"{_fmt(_get(r, 'stall_pct'), '7.1f')} "
            f"{_fmt(r.get('retries'), '5.0f')} "
            f"{_fmt(_get(r, 'churn.efficiency'), '6.2f')} "
            f"{_fmt(goodput_col, '7.3f')} "
            f"{_fmt(_get(r, 'durability_lag_s'), '7.2f')} "
            f"{_fmt(_get(r, 'consume.h2d_fraction'), '6.2f')}  {doctor}"
        )
    return lines


def analyze_ledger(
    records: List[Dict[str, Any]], **knobs: Any
) -> Dict[str, Any]:
    takes = [r for r in records if r.get("kind") in ("take", "async_take")]
    restores = [r for r in records if r.get("kind") == "restore"]
    drains = [r for r in records if r.get("kind") == "tierdown"]
    findings = (
        run_sentinel(
            build_series(takes, _TAKE_METRICS), _TAKE_METRICS, **knobs
        )
        + run_sentinel(
            build_series(restores, _RESTORE_METRICS),
            _RESTORE_METRICS,
            **knobs,
        )
        + run_sentinel(
            build_series(drains, _DRAIN_METRICS), _DRAIN_METRICS, **knobs
        )
    )
    return {
        "n_records": len(records),
        "n_takes": len(takes),
        "n_restores": len(restores),
        "n_drains": len(drains),
        "doctor_history": doctor_history(records),
        "regressions": findings,
    }


# ------------------------------------------------------------- bench mode


def _load_bench_summary(path: str) -> Dict[str, Any]:
    """A BENCH_*.json as its bench-summary dict: either the bare summary
    bench.py prints or the wrapper whose ``tail`` embeds it."""
    with open(path) as f:
        doc = json.load(f)
    if "metric" in doc:
        return doc
    tail = doc.get("tail")
    if isinstance(tail, str):
        idx = tail.rfind('{"metric"')
        if idx >= 0:
            try:
                summary, _ = json.JSONDecoder().raw_decode(tail[idx:])
                if isinstance(summary, dict):
                    return summary
            except json.JSONDecodeError:
                pass
    return {}


def analyze_bench_dir(path: str, **knobs: Any) -> Dict[str, Any]:
    files = sorted(_glob.glob(os.path.join(path, "BENCH_*.json")))
    rows: List[Tuple[str, Dict[str, Any]]] = []
    for f in files:
        rows.append((os.path.splitext(os.path.basename(f))[0], _load_bench_summary(f)))
    series: Dict[str, List[Tuple[str, Optional[float]]]] = {}
    gaps: Dict[str, List[str]] = {}
    for label, doc in rows:
        for field, *_ in _BENCH_METRICS:
            series.setdefault(field, []).append((label, _get(doc, field)))
        for section in doc.get("gaps") or []:
            gaps.setdefault(label, []).append(section)
    return {
        "n_records": len(rows),
        "runs": [label for label, _ in rows],
        "gaps": gaps,
        "regressions": run_sentinel(series, _BENCH_METRICS, **knobs),
        "series": {
            field: [[lab, v] for lab, v in pts]
            for field, pts in series.items()
        },
    }


def render_bench(result: Dict[str, Any]) -> List[str]:
    lines = []
    by_run: Dict[str, Dict[str, Optional[float]]] = {}
    for field, pts in (result.get("series") or {}).items():
        for lab, v in pts:
            by_run.setdefault(lab, {})[field] = v
    lines.append(
        f"{'run':>12s} {'take GB/s':>10s} {'restore':>8s} "
        f"{'take/ceil':>9s} {'rest/ceil':>9s} {'hot/dur':>8s} "
        f"{'es-ovh%':>8s}  gaps"
    )
    for lab in result.get("runs") or []:
        vals = by_run.get(lab, {})
        gap = ",".join((result.get("gaps") or {}).get(lab, [])) or "-"
        lines.append(
            f"{lab:>12s} {_fmt(vals.get('value'), '10.4f')} "
            f"{_fmt(vals.get('restore_GBps'), '8.4f')} "
            f"{_fmt(vals.get('take_vs_ceiling'), '9.3f')} "
            f"{_fmt(vals.get('restore_vs_ceiling'), '9.3f')} "
            f"{_fmt(vals.get('hot_tier.hot_vs_durable'), '8.2f')} "
            f"{_fmt(vals.get('every_step.hot.overhead_pct'), '8.2f')}  "
            f"{gap}"
        )
    return lines


# -------------------------------------------------------------------- CLI


def _render_findings(result: Dict[str, Any]) -> List[str]:
    lines = []
    history = result.get("doctor_history") or {}
    if history:
        lines.append("doctor-rule history:")
        for rule, labels in sorted(history.items()):
            lines.append(
                f"  {rule}: fired {len(labels)}x ({', '.join(labels)})"
            )
    regressions = result.get("regressions") or []
    if not regressions:
        lines.append("sentinel: no regression — trends within baseline")
    else:
        lines.append(f"sentinel: {len(regressions)} regression(s)")
        for r in regressions:
            arrow = "rose" if r["direction"] == "high" else "fell"
            lines.append(
                f"  REGRESSION {r['metric']}: {arrow} to {r['value']:g} at "
                f"{r['label']} (baseline median {r['baseline_median']:g}, "
                f"deviation {r['deviation']:g} > threshold "
                f"{r['threshold']:g})"
            )
    return lines


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m torchsnapshot_tpu_torch.telemetry.timeline",
        description="Render per-step checkpoint telemetry trends from a "
        "ledger (or a directory of BENCH_*.json) and run the "
        "rolling-baseline regression sentinel.",
    )
    parser.add_argument(
        "path",
        help="ledger root URL (reads <path>/.telemetry/ledger.jsonl), a "
        "ledger .jsonl file, or a directory of BENCH_*.json artifacts",
    )
    parser.add_argument("--json", action="store_true", help="emit JSON")
    parser.add_argument(
        "--window", type=int, default=8, help="rolling baseline size"
    )
    parser.add_argument(
        "--min-history",
        type=int,
        default=3,
        help="records required before a point is judged",
    )
    parser.add_argument(
        "--mad-k",
        type=float,
        default=5.0,
        help="MAD multiplier for the deviation threshold",
    )
    parser.add_argument(
        "--rel-floor",
        type=float,
        default=0.5,
        help="minimum deviation as a fraction of the baseline median",
    )
    args = parser.parse_args(argv)
    knobs = {
        "window": args.window,
        "min_history": args.min_history,
        "mad_k": args.mad_k,
        "rel_floor": args.rel_floor,
    }

    bench_mode = (
        "://" not in args.path
        and os.path.isdir(args.path)
        and bool(_glob.glob(os.path.join(args.path, "BENCH_*.json")))
    )
    if bench_mode:
        result = analyze_bench_dir(args.path, **knobs)
        if result["n_records"] == 0:
            print(f"no BENCH_*.json under {args.path}", file=sys.stderr)
            return 2
        if args.json:
            print(json.dumps(result, indent=2, sort_keys=True))
        else:
            for line in render_bench(result) + _render_findings(result):
                print(line)
        return 1 if result["regressions"] else 0

    from . import ledger as _ledger

    try:
        records, skipped = _ledger.read_records(args.path)
    except Exception as e:
        print(f"error reading ledger at {args.path}: {e}", file=sys.stderr)
        return 2
    if not records:
        print(
            f"no ledger records at {args.path} (no committed takes, or "
            f"not a ledger root)",
            file=sys.stderr,
        )
        return 2
    result = analyze_ledger(records, **knobs)
    result["n_torn_lines_skipped"] = skipped
    if args.json:
        result["records"] = records
        print(json.dumps(result, indent=2, sort_keys=True))
    else:
        if skipped:
            print(
                f"note: {skipped} torn/corrupt ledger line(s) skipped",
                file=sys.stderr,
            )
        for line in render_ledger(records) + _render_findings(result):
            print(line)
    return 1 if result["regressions"] else 0


if __name__ == "__main__":
    sys.exit(main())
