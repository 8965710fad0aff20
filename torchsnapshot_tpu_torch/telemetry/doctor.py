"""Anomaly-diagnosing doctor: structured findings from a rule table.

Usage::

    python -m torchsnapshot_tpu_torch.telemetry.doctor <snapshot-path> [--json]
    python -m torchsnapshot_tpu_torch.telemetry.doctor report.json [--json]
    python -m torchsnapshot_tpu_torch.inspect <snapshot-path> --doctor

The doctor consumes a flight report (the ``.report.json`` /
``.report.restore.rank<N>.json`` documents the recorder commits beside
the manifest — or any JSON file of that schema) plus, optionally, a
trace summary and a metric snapshot, and emits findings from the rule
catalog below. Each finding names its rule id, the evidence that
triggered it, and a remediation hint — the difference between "this
restore was slow" and "this restore spent 176s deserializing against
0.8s of reads; storage is innocent" (the BENCH_r05 pathology that
motivated the whole telemetry subsystem).

Rule catalog (docs/OBSERVABILITY.md carries the narrative version):

========================  =============================================
id                        trigger
========================  =============================================
consume-dominated-restore consume phase >= 3x the read phase; when the
                          report carries the snapxray consume sub-phase
                          breakdown, evidence names the dominant
                          sub-step (decode/verify/reassemble/
                          device_put/…) and the remediation is
                          sub-step-specific
read-dominated-restore    read phase >= 3x the consume phase
stage-dominated-take      stage busy >= 3x write busy (scheduler ops)
budget-stall-dominated    budget stall >= 25% of a rank's wall time
retry-storm               storage retries >= 10 across the operation
straggler-rank            a rank's wall >= 1.5x the rank median (>2s)
imbalanced-stripe         max rank bytes >= 2x the rank median
checkpoint-overhead-      goodput attribution shows checkpointing over
above-budget              TPUSNAPSHOT_CKPT_BUDGET_PCT (default 5%)
missing-rank-summary      a rank's summary never arrived (null)
hot-tier-degraded         a restore fell back to the durable tier for
                          >0 objects (critical when >50% of bytes)
replication-degraded      a take's snapwire replication missed a
                          per-RPC deadline or failed a push (warn);
                          critical when those wire failures pushed
                          >50% of the acked bytes onto the synchronous
                          write-through path — acks stay honest but
                          pay storage latency. Capacity-caused
                          write-throughs without wire failures do not
                          fire it
read-plane-degraded       a restore routed via snapserve fell back to
                          direct backend reads for >0 objects
                          (critical when >50% of bytes) — the read
                          service was unreachable; bit-exactness held
fleet-degraded            a fleet-routed restore left the ring owner:
                          failovers / owner misses (warn), or the
                          whole fleet exhausted into direct fallback
                          (critical); bit-exactness held either way
durability-lag-above-     the take's ack→.tierdown window (stamped into
budget                    the report by the hot tier's drain) exceeded
                          TPUSNAPSHOT_SLO_DURABILITY_LAG_S (default
                          120s; critical at 2x). The SLO engine
                          (telemetry/slo.py) fires the same rule id
                          LIVE from sampler state, before the
                          watermark exists to prove it post-hoc.
deadline-margin-          an op's wiretap window shows p99 latency
collapsing                consuming >= TPUSNAPSHOT_WIRE_MARGIN_WARN
                          (default 0.70) of its per-RPC deadline —
                          the hand-tuned deadline knob is nearly
                          collapsed onto real latency (warn); critical
                          when the window recorded outright deadline
                          misses. The SLO engine fires the same rule
                          id LIVE from sampler wire blocks
dedup-ineffective         a chunked take's chunk-level dedup saved no
                          more bytes than leaf-level dedup would have
                          (every hit byte sat inside a fully-clean
                          leaf) over >= TPUSNAPSHOT_DEDUP_MIN_BYTES of
                          chunked payload — chunk-grid overhead
                          without sub-leaf savings (chunkstore.py)
replication-under-        LIVE-ONLY (telemetry/slo.py, like the live
replicated                arm of durability-lag-above-budget):
                          snapmend found committed undrained objects
                          below k live replicas past one repair
                          interval (warn), or the repair stalled past
                          TPUSNAPSHOT_REPAIR_DEADLINE_S with the
                          write-through escalation firing (critical).
                          Flight reports carry no membership state, so
                          this rule has no report-based arm here — the
                          ops/slo CLIs surface it with the same
                          exit-code contract
========================  =============================================

Findings are observability, not judgment: every rule errs toward
silence on thin evidence (tiny operations trip no ratios).

Exit codes: 0 = healthy (no findings); 1 = findings emitted;
2 = usage / no report found.
"""

import argparse
import json
import sys
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..utils.env import env_float, env_int

# Ratio thresholds, shared with summarize's dominance verdict where the
# same question is asked of a trace instead of a report.
_DOMINANCE_RATIO = 3.0
_STALL_FRACTION = 0.25
_RETRY_STORM_COUNT = 10
_STRAGGLER_RATIO = 1.5
_STRAGGLER_MIN_WALL_S = 2.0
_STRIPE_RATIO = 2.0
# Checkpoint-overhead budget: the goodput accountant's attribution must
# cover at least this much wall time before the budget verdict means
# anything (two steps of a toy loop prove nothing).
_CKPT_BUDGET_ENV_VAR = "TPUSNAPSHOT_CKPT_BUDGET_PCT"
_DEFAULT_CKPT_BUDGET_PCT = 5.0
_MIN_GOODPUT_WINDOW_S = 10.0
# Deadline-margin pressure threshold (wiretap): an op whose p99 latency
# consumes this fraction of its per-RPC deadline is one latency wobble
# from missing it — warn before the misses start.
_WIRE_MARGIN_WARN_ENV_VAR = "TPUSNAPSHOT_WIRE_MARGIN_WARN"
_DEFAULT_WIRE_MARGIN_WARN = 0.70
# Phases must clear this floor before a ratio means anything: a 0.05s
# consume "dominating" a 0.006s read is scheduler jitter on a tiny
# operation, not a pathology worth a remediation hint — the findings
# this doctor exists for are seconds-to-minutes (BENCH_r05: 176s).
_MIN_PHASE_S = 1.0


@dataclass
class Finding:
    rule: str
    severity: str  # "warn" | "critical"
    title: str
    evidence: Dict[str, Any] = field(default_factory=dict)
    remediation: str = ""

    def as_dict(self) -> Dict[str, Any]:
        return {
            "rule": self.rule,
            "severity": self.severity,
            "title": self.title,
            "evidence": self.evidence,
            "remediation": self.remediation,
        }


def _ranks(report: Dict[str, Any]) -> List[Dict[str, Any]]:
    return [s for s in (report.get("ranks") or []) if s]


def _phase_s(summary: Dict[str, Any], phase: str) -> float:
    return float((summary.get("phases") or {}).get(f"{phase}_s", 0.0))


def _median(values: List[float]) -> float:
    ordered = sorted(values)
    return ordered[len(ordered) // 2] if ordered else 0.0


# ----------------------------------------------------------------- the rules
#
# Each rule: (report) -> Optional[Finding]. Rules see the whole merged
# report so cross-rank rules (straggler, stripe) need no special casing.


# Per-sub-step remediation for the consume-dominated verdict (snapxray
# micro-profiler, telemetry/consume_profile.py): the generic "consume is
# slow" advice becomes an actionable name once the breakdown says WHICH
# sub-step dominates.
_CONSUME_SUBSTEP_REMEDIATION = {
    "decode": (
        "codec decode dominates: zlib inflate is single-threaded per "
        "buffer — switch to zstd (TPUSNAPSHOT_CODEC) or drop "
        "compression for restore-latency-critical snapshots; chunk-"
        "store decodes already overlap reads, so more chunks ≠ faster "
        "decode."
    ),
    "deserialize": (
        "object deserialization dominates: large pickled objects "
        "(optimizer states saved as raw Python objects) restore "
        "single-threaded — convert them to arrays so they take the "
        "zero-copy array path."
    ),
    "verify": (
        "integrity verification dominates: checksums/fingerprints are "
        "CPU-bound per buffer. Keep verification on (it is the "
        "corruption net) but check for double verification "
        "(TPUSNAPSHOT_STRICT_INTEGRITY forces whole-object reads + "
        "full checksums) and prefer the chunk store's on-device "
        "fingerprints for large arrays."
    ),
    "reassemble": (
        "host memcpy dominates: bytes are being copied into assembly "
        "buffers before device placement. Larger contiguous chunks "
        "(raise TPUSNAPSHOT_CHUNK_BYTES) and the streaming read path "
        "(uncompressed, chunk-aligned payloads) skip host reassembly "
        "entirely."
    ),
    "device_put": (
        "H2D transfers are running INSIDE consume executors instead of "
        "on the overlap engine — the streaming fast path is not "
        "engaging (regions too small, compressed payloads, or a "
        "resharded template). Check restore_consume_vs_h2d in the "
        "bench artifact / h2d_overlap_vs_probe in this report, raise "
        "the H2D depth (TPUSNAPSHOT_H2D_DEPTH) and the device restore "
        "budget (TPUSNAPSHOT_DEVICE_BUDGET_BYTES) so more regions "
        "stream concurrently."
    ),
    "pool_wait": (
        "consumes are blocking on staging-pool capacity: concurrent "
        "restores (or very large plans) exhausted the pooled staging "
        "bytes. Raise TPUSNAPSHOT_RESTORE_STAGING_POOL_BYTES (0 "
        "disables pooling outright) or lower restore concurrency."
    ),
    "staging_release": (
        "buffer release/accounting dominates — pathological; likely "
        "lock contention between consume executors. Report this with "
        "the trace."
    ),
    "other": (
        "unaccounted consume time dominates (event-loop/executor "
        "scheduling, GIL waits): the pipeline is overhead-bound, not "
        "work-bound. Fewer, larger objects (raise chunk sizes) cut "
        "per-request overhead."
    ),
}


def _consume_profiles(report: Dict[str, Any]) -> List[Dict[str, Any]]:
    return [
        s.get("consume_profile")
        for s in _ranks(report)
        if s.get("consume_profile")
    ]


def _rule_consume_dominated(report: Dict[str, Any]) -> Optional[Finding]:
    if report.get("kind") != "restore":
        return None
    consume = sum(_phase_s(s, "consume") for s in _ranks(report))
    read = sum(_phase_s(s, "read") for s in _ranks(report))
    if consume < _MIN_PHASE_S or consume < _DOMINANCE_RATIO * max(
        read, 1e-9
    ):
        return None
    evidence = {
        "consume_s": round(consume, 3),
        "read_s": round(read, 3),
        "ratio": round(consume / max(read, 1e-9), 1),
    }
    title = (
        f"restore spent {consume:.2f}s deserializing / placing "
        f"against {read:.2f}s of storage reads"
    )
    remediation = (
        "storage is innocent — the bottleneck is host-side "
        "deserialization / host->device placement. The streaming "
        "fast path should keep consume off the critical path: check "
        "compression settings (zlib inflate is single-threaded per "
        "buffer), confirm the overlap engine is engaging "
        "(h2d_overlap in the sub-step breakdown; tune "
        "TPUSNAPSHOT_H2D_DEPTH), give concurrent restores pool "
        "headroom (TPUSNAPSHOT_RESTORE_STAGING_POOL_BYTES), raise "
        "the device restore budget "
        "(TPUSNAPSHOT_DEVICE_BUDGET_BYTES), and confirm consumes "
        "overlap reads in the trace (summarize's overlap column)."
    )
    # Micro-profiler upgrade (snapxray): when rank summaries carry the
    # consume sub-phase breakdown, the finding names the dominant
    # sub-step and swaps in its specific remediation.
    profiles = _consume_profiles(report)
    if profiles:
        substeps: Dict[str, float] = {}
        overlap_s = 0.0
        for p in profiles:
            for name, entry in (p.get("substeps") or {}).items():
                # Beside-the-wall sub-steps: read_wait (scheduler
                # queueing), h2d_overlap (the streaming pipeline's
                # engine transfers), and overlap_other (engine-side
                # finalize work) overlap the consume wall — they must
                # not be named "the dominant consume sub-step".
                if name in ("read_wait", "overlap_other"):
                    continue
                if name == "h2d_overlap":
                    overlap_s += float(entry.get("seconds") or 0.0)
                    continue
                substeps[name] = substeps.get(name, 0.0) + float(
                    entry.get("seconds") or 0.0
                )
        if substeps:
            dominant = max(substeps, key=lambda s: substeps[s])
            evidence["dominant_substep"] = dominant
            evidence["dominant_substep_s"] = round(substeps[dominant], 3)
            evidence["substeps_s"] = {
                k: round(v, 3) for k, v in sorted(substeps.items())
            }
            fractions = [
                p.get("h2d_fraction")
                for p in profiles
                if p.get("h2d_fraction") is not None
            ]
            if fractions:
                evidence["consume_h2d_fraction"] = round(
                    min(fractions), 4
                )
            # Streaming-pipeline evidence: how hard the overlap engine
            # ran, and its delivered H2D vs the probe — named
            # restore_vs_h2d_ceiling to MATCH the bench key gating the
            # same quantity (consume_h2d_fraction above is the bench's
            # restore_consume_vs_h2d analog). A firing rule WITH
            # healthy overlap numbers points at host-side work
            # (decode/deserialize); without them the fast path never
            # engaged.
            if overlap_s:
                evidence["h2d_overlap_s"] = round(overlap_s, 3)
            overlap_fractions = [
                p.get("h2d_overlap_vs_probe")
                for p in profiles
                if p.get("h2d_overlap_vs_probe") is not None
            ]
            if overlap_fractions:
                evidence["restore_vs_h2d_ceiling"] = round(
                    min(overlap_fractions), 4
                )
            title += (
                f"; dominant sub-step: {dominant} "
                f"({substeps[dominant]:.2f}s)"
            )
            remediation = _CONSUME_SUBSTEP_REMEDIATION.get(
                dominant, remediation
            )
    return Finding(
        rule="consume-dominated-restore",
        severity="critical",
        title=title,
        evidence=evidence,
        remediation=remediation,
    )


def _rule_read_dominated(report: Dict[str, Any]) -> Optional[Finding]:
    if report.get("kind") != "restore":
        return None
    consume = sum(_phase_s(s, "consume") for s in _ranks(report))
    read = sum(_phase_s(s, "read") for s in _ranks(report))
    if read < _MIN_PHASE_S or read < _DOMINANCE_RATIO * max(consume, 1e-9):
        return None
    return Finding(
        rule="read-dominated-restore",
        severity="warn",
        title=(
            f"restore spent {read:.2f}s in storage reads against "
            f"{consume:.2f}s of consumes"
        ),
        evidence={
            "read_s": round(read, 3),
            "consume_s": round(consume, 3),
            "ratio": round(read / max(consume, 1e-9), 1),
        },
        remediation=(
            "storage read bandwidth is the bottleneck: check the "
            "backend's read concurrency cap, object sizes (many tiny "
            "objects pay per-request latency), and network egress "
            "limits."
        ),
    )


def _rule_stage_dominated(report: Dict[str, Any]) -> Optional[Finding]:
    if report.get("kind") not in ("take", "async_take"):
        return None
    stage = sum(
        float((s.get("scheduler_ops") or {}).get("stage", {}).get("seconds", 0.0))
        for s in _ranks(report)
    )
    write = sum(
        float((s.get("scheduler_ops") or {}).get("write", {}).get("seconds", 0.0))
        for s in _ranks(report)
    )
    if stage < _MIN_PHASE_S or stage < _DOMINANCE_RATIO * max(write, 1e-9):
        return None
    return Finding(
        rule="stage-dominated-take",
        severity="warn",
        title=(
            f"take spent {stage:.2f}s staging (device->host + "
            f"serialize) against {write:.2f}s of storage writes"
        ),
        evidence={
            "stage_s": round(stage, 3),
            "write_s": round(write, 3),
            "ratio": round(stage / max(write, 1e-9), 1),
        },
        remediation=(
            "device->host transfer / serialization is the bottleneck, "
            "not storage. Check compression cost, host CPU "
            "contention with the training step, and whether "
            "incremental takes (base=) could skip unchanged arrays."
        ),
    )


def _rule_budget_stall(report: Dict[str, Any]) -> Optional[Finding]:
    worst: Optional[Dict[str, Any]] = None
    for s in _ranks(report):
        wall = float(s.get("wall_s") or 0.0)
        stall = float((s.get("budget") or {}).get("stall_s", 0.0))
        if wall < 1.0 or stall < _STALL_FRACTION * wall:
            continue
        if worst is None or stall > worst["stall_s"]:
            worst = {
                "rank": s.get("rank"),
                "stall_s": round(stall, 3),
                "wall_s": round(wall, 3),
                "fraction": round(stall / wall, 2),
                "high_water_bytes": (s.get("budget") or {}).get(
                    "high_water_bytes", 0
                ),
            }
    if worst is None:
        return None
    return Finding(
        rule="budget-stall-dominated",
        severity="warn",
        title=(
            f"rank {worst['rank']} spent {worst['stall_s']:.2f}s "
            f"({100 * worst['fraction']:.0f}% of its wall time) stalled "
            f"on the memory budget"
        ),
        evidence=worst,
        remediation=(
            "the pipeline was ready to move bytes but the per-process "
            "memory budget said no. Raise "
            "TPUSNAPSHOT_PER_RANK_MEMORY_BUDGET_BYTES if host RAM "
            "allows, or reduce per-object sizes (chunked writes) so "
            "admission granularity is finer."
        ),
    )


def _rule_retry_storm(report: Dict[str, Any]) -> Optional[Finding]:
    totals = report.get("totals") or {}
    retries = float(totals.get("retries") or 0)
    if retries < _RETRY_STORM_COUNT:
        return None
    by_rank = {
        str(s.get("rank")): (s.get("retries") or {}).get("total", 0)
        for s in _ranks(report)
        if (s.get("retries") or {}).get("total", 0)
    }
    return Finding(
        rule="retry-storm",
        severity="critical",
        title=(
            f"{retries:g} storage retries across the operation — the "
            f"backend is throttling or flapping"
        ),
        evidence={"retries": retries, "by_rank": by_rank},
        remediation=(
            "check the storage backend's health/quota (429s = request "
            "rate or bandwidth quota; 503s = service brownout). The "
            "retry budget (TPUSNAPSHOT_STORAGE_RETRY_BUDGET_S) bounds "
            "how long each op keeps trying; fewer, larger objects "
            "reduce request-rate pressure."
        ),
    )


def _rule_straggler(report: Dict[str, Any]) -> Optional[Finding]:
    ranks = _ranks(report)
    if len(ranks) < 2:
        return None
    walls = [float(s.get("wall_s") or 0.0) for s in ranks]
    median = _median(walls)
    if median <= 0:
        return None
    worst = max(ranks, key=lambda s: float(s.get("wall_s") or 0.0))
    wall = float(worst.get("wall_s") or 0.0)
    if wall < _STRAGGLER_MIN_WALL_S or wall < _STRAGGLER_RATIO * median:
        return None
    return Finding(
        rule="straggler-rank",
        severity="warn",
        title=(
            f"rank {worst.get('rank')} took {wall:.2f}s against a "
            f"rank-median of {median:.2f}s"
        ),
        evidence={
            "rank": worst.get("rank"),
            "wall_s": round(wall, 3),
            "median_wall_s": round(median, 3),
            "ratio": round(wall / median, 2),
            "phases": worst.get("phases"),
        },
        remediation=(
            "one rank gated the whole operation. Compare its phase "
            "breakdown against the others (inspect --report): slow "
            "storage from one host, an imbalanced stripe, or host CPU "
            "contention. Cross-check with telemetry.merge's critical "
            "path on per-rank traces."
        ),
    )


def _rule_imbalanced_stripe(report: Dict[str, Any]) -> Optional[Finding]:
    ranks = _ranks(report)
    if len(ranks) < 2:
        return None
    sizes = [float(s.get("bytes") or 0) for s in ranks]
    median = _median(sizes)
    biggest = max(ranks, key=lambda s: float(s.get("bytes") or 0))
    top = float(biggest.get("bytes") or 0)
    if median <= 0 or top < _STRIPE_RATIO * median or top < 1 << 20:
        return None
    return Finding(
        rule="imbalanced-stripe",
        severity="warn",
        title=(
            f"rank {biggest.get('rank')} moved {top:.0f} bytes against "
            f"a rank-median of {median:.0f}"
        ),
        evidence={
            "rank": biggest.get("rank"),
            "bytes": int(top),
            "median_bytes": int(median),
            "ratio": round(top / median, 2),
        },
        remediation=(
            "byte load is skewed across ranks. For replicated values "
            "the striper balances by size estimates — non-array values "
            "estimate as 0 and spread by count, so one giant pickled "
            "object can skew a rank. Shard large values, or mark them "
            "replicated so the LPT striper can balance them."
        ),
    )


def _rule_checkpoint_overhead(report: Dict[str, Any]) -> Optional[Finding]:
    """Goodput verdict: checkpointing ate more than its wall-time budget
    (``TPUSNAPSHOT_CKPT_BUDGET_PCT``, default 5%). Needs a rank summary
    carrying the goodput accountant's attribution — i.e. a train loop
    that calls ``telemetry.goodput.step()``."""
    if report.get("kind") not in ("take", "async_take"):
        return None
    budget_pct = env_float(_CKPT_BUDGET_ENV_VAR, _DEFAULT_CKPT_BUDGET_PCT)
    worst: Optional[Dict[str, Any]] = None
    for s in _ranks(report):
        gp = s.get("goodput") or {}
        pct = gp.get("checkpoint_overhead_pct")
        window_s = (gp.get("train_s") or 0.0) + (gp.get("checkpoint_s") or 0.0)
        if pct is None or window_s < _MIN_GOODPUT_WINDOW_S:
            continue
        if pct > budget_pct and (worst is None or pct > worst["overhead_pct"]):
            worst = {
                "rank": s.get("rank"),
                "overhead_pct": pct,
                "budget_pct": budget_pct,
                "train_s": gp.get("train_s"),
                "checkpoint_s": gp.get("checkpoint_s"),
                "by_mode": gp.get("by_mode"),
            }
    if worst is None:
        return None
    return Finding(
        rule="checkpoint-overhead-above-budget",
        severity=(
            "critical" if worst["overhead_pct"] >= 2 * budget_pct else "warn"
        ),
        title=(
            f"checkpointing consumed {worst['overhead_pct']:.1f}% of wall "
            f"time against a {budget_pct:g}% budget"
        ),
        evidence=worst,
        remediation=(
            "checkpoint overhead exceeds the budget "
            f"({_CKPT_BUDGET_ENV_VAR}). by_mode names the spender: "
            "sync_take -> switch to async_save; async_stall -> stage="
            '"device" or shrink the cut; drain_wait -> the drain is '
            "slower than the save interval (raise the interval, use "
            "incremental takes, or check the storage backend); also see "
            "timeline's goodput trend for when the overhead started."
        ),
    )


def _rule_durability_lag(report: Dict[str, Any]) -> Optional[Finding]:
    """The hot tier's drain back-fills ``durability_lag_s`` (take ack →
    ``.tierdown``) into the committed report once the root fully tiers
    down; a window past the RPO budget means acked checkpoints rested
    on RAM replicas longer than the stated objective allows."""
    if report.get("kind") not in ("take", "async_take"):
        return None
    lag = report.get("durability_lag_s")
    if not isinstance(lag, (int, float)):
        return None
    from .slo import DURABILITY_LAG_ENV_VAR, durability_lag_budget_s

    budget_s = durability_lag_budget_s()
    if budget_s <= 0 or lag <= budget_s:
        return None
    return Finding(
        rule="durability-lag-above-budget",
        severity="critical" if lag >= 2 * budget_s else "warn",
        title=(
            f"take stayed undrained for {lag:.1f}s after its ack "
            f"(durability-lag budget {budget_s:g}s)"
        ),
        evidence={
            "durability_lag_s": round(float(lag), 3),
            "budget_s": budget_s,
            "take_id": report.get("take_id"),
        },
        remediation=(
            "the ack→.tierdown exposure window exceeded the RPO "
            "budget: a correlated host loss in that window would have "
            "cost an acked checkpoint. Tier-down bandwidth is below "
            "the take cadence — lower the save frequency, use "
            "incremental takes, check durable-backend health, or "
            f"re-state the budget ({DURABILITY_LAG_ENV_VAR})."
        ),
    )


def _rule_missing_summary(report: Dict[str, Any]) -> Optional[Finding]:
    ranks = report.get("ranks") or []
    missing = [i for i, s in enumerate(ranks) if not s]
    if not missing or report.get("kind") == "restore":
        # Restore reports are rank-local by design; their ranks list
        # holds one summary regardless of world size.
        return None
    return Finding(
        rule="missing-rank-summary",
        severity="warn",
        title=f"rank(s) {missing} contributed no flight summary",
        evidence={"missing_ranks": missing},
        remediation=(
            "the operation committed but those ranks' summaries never "
            "arrived — a crashed-and-restarted process, or a summary "
            "write that lost its race with the commit. If it recurs, "
            "check those hosts' logs."
        ),
    )


def _rule_hot_tier_degraded(report: Dict[str, Any]) -> Optional[Finding]:
    """A restore that should have been served from peer RAM leaked reads
    to the durable tier: >0 per-object fallbacks fire a warning, and a
    majority of the BYTES falling back (the hot tier effectively absent —
    preempted peers, corrupt replicas, an undersized
    TPUSNAPSHOT_HOT_TIER_BYTES) is critical. Evidence names the degraded
    peer hosts range-compressed, the same rendering as coord timeouts."""
    from ..coord import format_rank_list

    if report.get("kind") != "restore":
        return None
    tiers = [
        s.get("tier") for s in _ranks(report) if s.get("tier")
    ]
    if not tiers:
        return None
    fallback_objects = sum(int(t.get("fallback_objects") or 0) for t in tiers)
    if fallback_objects <= 0:
        return None
    fallback_bytes = sum(int(t.get("fallback_bytes") or 0) for t in tiers)
    hot_bytes = sum(int(t.get("hot_bytes") or 0) for t in tiers)
    total_bytes = hot_bytes + fallback_bytes
    fraction = fallback_bytes / total_bytes if total_bytes > 0 else 1.0
    peers = sorted(
        {int(p) for t in tiers for p in (t.get("degraded_peers") or [])}
    )
    reasons: Dict[str, int] = {}
    for t in tiers:
        for r, c in (t.get("fallback_reasons") or {}).items():
            reasons[r] = reasons.get(r, 0) + int(c)
    return Finding(
        rule="hot-tier-degraded",
        severity="critical" if fraction > 0.5 else "warn",
        title=(
            f"restore fell back to the durable tier for "
            f"{fallback_objects} object(s) "
            f"({100 * fraction:.0f}% of bytes); degraded "
            f"{format_rank_list(peers, noun='peer host')}"
        ),
        evidence={
            "fallback_objects": fallback_objects,
            "fallback_bytes": fallback_bytes,
            "hot_bytes": hot_bytes,
            "fallback_byte_fraction": round(fraction, 3),
            "degraded_peers": format_rank_list(peers, noun="peer host"),
            "reasons": reasons,
        },
        remediation=(
            "the hot tier could not serve these objects: 'dead' peers "
            "mean preempted/lost hosts (raise TPUSNAPSHOT_HOT_TIER_K if "
            "losses exceed k-1), 'missing' means replicas were evicted "
            "or never placed (raise TPUSNAPSHOT_HOT_TIER_BYTES), "
            "'corrupt' means a replica failed its fingerprint check "
            "(the fallback kept the restore correct; investigate the "
            "host's RAM). Durable-tier restores are storage-speed — "
            "expect minutes, not seconds, until the tier is healthy."
        ),
    )


def _rule_replication_degraded(report: Dict[str, Any]) -> Optional[Finding]:
    """A take whose k-replication rode the snapwire transport showed
    wire distress: any deadline-missed or failed push warns
    (replication is limping — acks still honest, but each failure
    burned a deadline/retry episode), and wire failures combined with a
    MAJORITY of the acked bytes having ridden the synchronous
    write-through path is critical — the transport is effectively
    absent and every "RAM-speed" ack is paying storage latency before
    it returns. Write-throughs WITHOUT wire failures (healthy pushes,
    full peers) are a capacity problem, not a transport one, and stay
    out of this rule."""
    if report.get("kind") != "take":
        return None
    reps = [
        (s.get("tier") or {}).get("replication")
        for s in _ranks(report)
        if (s.get("tier") or {}).get("replication")
    ]
    if not reps:
        return None
    deadline_misses = sum(
        int(r.get("deadline_misses") or 0) for r in reps
    )
    retries = sum(int(r.get("retries") or 0) for r in reps)
    push_failures = sum(int(r.get("push_failures") or 0) for r in reps)
    wt_bytes = sum(int(r.get("write_through_bytes") or 0) for r in reps)
    replicated_bytes = sum(
        int(r.get("replicated_ack_bytes") or 0) for r in reps
    )
    acked = wt_bytes + replicated_bytes
    fraction = wt_bytes / acked if acked > 0 else 0.0
    # The critical arm requires actual WIRE distress behind the
    # write-through bytes: a capacity-degraded take with a healthy
    # transport (every push acked, peers simply full) is a hot-tier
    # sizing problem, not a network one — misdiagnosing it critical
    # would send the operator chasing a phantom transport failure.
    wire_failed = deadline_misses > 0 or push_failures > 0
    if not wire_failed:
        return None
    severity = "critical" if fraction > 0.5 else "warn"
    pushes = sum(int(r.get("pushes") or 0) for r in reps)
    return Finding(
        rule="replication-degraded",
        severity=severity,
        title=(
            f"hot-tier replication degraded: {deadline_misses} deadline "
            f"miss(es), {100 * fraction:.0f}% of acked bytes rode the "
            f"synchronous write-through path"
        ),
        evidence={
            "deadline_misses": deadline_misses,
            "retries": retries,
            "pushes": pushes,
            "push_failures": push_failures,
            "write_through_bytes": wt_bytes,
            "replicated_ack_bytes": replicated_bytes,
            "write_through_byte_fraction": round(fraction, 3),
        },
        remediation=(
            "peer pushes are missing TPUSNAPSHOT_REPLICATION_DEADLINE_S "
            "or exhausting TPUSNAPSHOT_REPLICATION_RETRY_BUDGET_S: check "
            "peer-process health (hottier.peer logs), the address book "
            "(TPUSNAPSHOT_HOT_TIER_ADDRS), and network latency between "
            "hosts. Acks stay honest either way — degraded puts write "
            "through to the durable tier BEFORE acking — but every "
            "write-through ack pays storage latency instead of RAM "
            "latency, eroding the tier's whole point."
        ),
    )


def _rule_read_plane_degraded(report: Dict[str, Any]) -> Optional[Finding]:
    """A restore routed through the snapserve read plane leaked reads
    to direct backend access: >0 fallbacks fire a warning (the restore
    stayed bit-exact — that is the fallback's contract — but every
    fallback re-pays the backend read the service exists to
    deduplicate), and a majority of the BYTES falling back (the server
    effectively absent) is critical. Reasons: 'unreachable' = a dial or
    transport failure on that very read; 'down' = inside the
    post-failure cooldown window (the server was seen dead moments
    before)."""
    if report.get("kind") != "restore":
        return None
    planes = [
        s.get("read_plane") for s in _ranks(report) if s.get("read_plane")
    ]
    if not planes:
        return None
    fallback_objects = sum(
        int(p.get("fallback_objects") or 0) for p in planes
    )
    if fallback_objects <= 0:
        return None
    fallback_bytes = sum(int(p.get("fallback_bytes") or 0) for p in planes)
    remote_bytes = sum(int(p.get("remote_bytes") or 0) for p in planes)
    total_bytes = remote_bytes + fallback_bytes
    fraction = fallback_bytes / total_bytes if total_bytes > 0 else 1.0
    reasons: Dict[str, int] = {}
    for p in planes:
        for r, c in (p.get("fallback_reasons") or {}).items():
            reasons[r] = reasons.get(r, 0) + int(c)
    return Finding(
        rule="read-plane-degraded",
        severity="critical" if fraction > 0.5 else "warn",
        title=(
            f"restore fell back to direct backend reads for "
            f"{fallback_objects} object(s) "
            f"({100 * fraction:.0f}% of bytes) — the snapserve read "
            f"plane was unreachable"
        ),
        evidence={
            "fallback_objects": fallback_objects,
            "fallback_bytes": fallback_bytes,
            "remote_bytes": remote_bytes,
            "fallback_byte_fraction": round(fraction, 3),
            "reasons": reasons,
        },
        remediation=(
            "the restore stayed bit-exact (direct fallback is the "
            "degraded-mode contract), but each falling-back client "
            "re-pays backend reads the service would have "
            "deduplicated — at fleet fan-out that multiplies "
            "object-store egress. Check the snapserve server process "
            "and TPUSNAPSHOT_SNAPSERVE_ADDR routing; restart the "
            "server and clients reattach automatically on their next "
            "read (after the cooldown window)."
        ),
    )


def _rule_fleet_degraded(report: Dict[str, Any]) -> Optional[Finding]:
    """A fleet-routed restore did not get every object from its ring
    owner: failovers (a member failed mid-read and a replica served),
    owner misses (the owner was down-latched), or full fleet
    exhaustion (reason 'fleet-exhausted' direct fallbacks). Bytes
    stayed bit-exact — that is the ladder's contract — but every
    non-owner read lands on a member whose cache does NOT shard that
    key, duplicating cache footprint and backend egress fleet-wide.
    Critical when the fleet was exhausted (some reads went direct);
    warn otherwise."""
    if report.get("kind") != "restore":
        return None
    planes = [
        s.get("read_plane") for s in _ranks(report) if s.get("read_plane")
    ]
    if not planes:
        return None
    owner_misses = sum(int(p.get("owner_misses") or 0) for p in planes)
    failover = sum(int(p.get("failover_objects") or 0) for p in planes)
    exhausted = sum(
        int((p.get("fallback_reasons") or {}).get("fleet-exhausted") or 0)
        for p in planes
    )
    if owner_misses <= 0 and failover <= 0 and exhausted <= 0:
        return None
    servers: Dict[str, Dict[str, int]] = {}
    for p in planes:
        for addr, entry in (p.get("servers") or {}).items():
            agg = servers.setdefault(addr, {"objects": 0, "bytes": 0})
            agg["objects"] += int(entry.get("objects") or 0)
            agg["bytes"] += int(entry.get("bytes") or 0)
    return Finding(
        rule="fleet-degraded",
        severity="critical" if exhausted > 0 else "warn",
        title=(
            f"fleet-routed restore left the ring owner for "
            f"{owner_misses + failover + exhausted} object(s) "
            f"({failover} failover, {owner_misses} owner-miss, "
            f"{exhausted} fleet-exhausted direct fallback)"
        ),
        evidence={
            "owner_misses": owner_misses,
            "failover_objects": failover,
            "fleet_exhausted_fallbacks": exhausted,
            "servers": servers,
        },
        remediation=(
            "bytes stayed bit-exact (replica failover and direct "
            "fallback are the degraded-mode contract), but non-owner "
            "reads defeat the ring's cache sharding: each displaced "
            "key is now cached on (and fetched by) a member that "
            "doesn't own it. Check which members died or hung "
            "(tpusnapshot_snapserve_fleet_probes_total{result}), "
            "restart them — a respawn re-registers one generation up "
            "and reclaims its ring segment automatically — and verify "
            "TPUSNAPSHOT_SNAPSERVE_FLEET_ADDRS lists the same members "
            "on every client."
        ),
    )


# Chunking must have covered at least this much logical payload before
# the dedup-ineffective verdict means anything (a 2 MiB toy take proves
# nothing about chunk-grid fit).
_DEDUP_MIN_LOGICAL_BYTES = 32 << 20


def _rule_dedup_ineffective(report: Dict[str, Any]) -> Optional[Finding]:
    """Chunk-granular dedup (chunkstore.py) is pure overhead when every
    saved byte would have been saved by LEAF-granular dedup anyway:
    chunk hits ≤ bytes of fully-clean leaves means sub-leaf
    content-addressing bought nothing this take — the chunk grid does
    not match the workload's dirty pattern (or the model is fully
    clean/fully dirty)."""
    notes = [
        s.get("churn")
        for s in _ranks(report)
        if s.get("churn") and (
            (s["churn"].get("chunk_hits") or 0)
            + (s["churn"].get("chunk_misses") or 0)
        )
    ]
    if not notes:
        return None
    logical = sum(int(c.get("chunk_logical_bytes") or 0) for c in notes)
    hit = sum(int(c.get("chunk_hit_bytes") or 0) for c in notes)
    clean = sum(int(c.get("leaf_clean_bytes") or 0) for c in notes)
    misses = sum(int(c.get("chunk_misses") or 0) for c in notes)
    floor = int(
        env_float(
            "TPUSNAPSHOT_DEDUP_MIN_BYTES", _DEDUP_MIN_LOGICAL_BYTES
        )
    )
    if logical < floor or hit + clean == 0:
        return None  # first take / thin evidence: silence
    if hit > clean:
        return None  # sub-leaf dedup saved bytes leaf dedup could not
    return Finding(
        rule="dedup-ineffective",
        severity="warn",
        title=(
            f"chunk-granular dedup saved {hit / (1 << 20):.1f} MiB, all "
            f"of it inside fully-clean leaves "
            f"({clean / (1 << 20):.1f} MiB) — chunking overhead without "
            f"sub-leaf savings"
        ),
        evidence={
            "chunk_hit_bytes": hit,
            "leaf_clean_bytes": clean,
            "chunk_logical_bytes": logical,
            "chunk_misses": misses,
        },
        remediation=(
            "every deduplicated byte came from leaves that were "
            "entirely unchanged — leaf-granular incremental takes "
            "(base=/manager incremental mode) would have saved the "
            "same bytes without per-chunk fingerprints, store lookups, "
            "and manifest chunk records. If partially-dirty leaves "
            "exist, shrink TPUSNAPSHOT_CHUNK_BYTES so the grid "
            "resolves their dirty regions; otherwise disable chunking "
            "(TPUSNAPSHOT_CHUNKS=0) for this workload."
        ),
    )


def wire_margin_warn_threshold() -> float:
    return env_float(_WIRE_MARGIN_WARN_ENV_VAR, _DEFAULT_WIRE_MARGIN_WARN)


def wire_pressure_finding(
    ops: Dict[str, Any], source: str = "report"
) -> Optional[Finding]:
    """The shared deadline-margin verdict over wiretap per-op blocks —
    flight-report ``wire`` blocks post-hoc (this module), sampler
    ``wire`` blocks live (telemetry/slo.py): same rule id both ways.

    Critical when the window recorded outright deadline misses; warn
    when an op's p99 consumed >= TPUSNAPSHOT_WIRE_MARGIN_WARN of its
    per-RPC deadline — the hand-tuned knob is one latency wobble from
    collapsing onto real latency."""
    if not ops:
        return None
    warn_at = wire_margin_warn_threshold()
    misses = 0
    pressured: List[Any] = []
    for op_key, entry in ops.items():
        if not isinstance(entry, dict):
            continue
        op_misses = int(entry.get("deadline_misses") or 0)
        misses += op_misses
        margin = entry.get("margin_p99")
        if op_misses > 0 or (
            margin is not None and float(margin) >= warn_at
        ):
            pressured.append(
                (op_misses, float(margin or 0.0), op_key, entry)
            )
    if not pressured:
        return None
    pressured.sort(reverse=True)
    evidence = {
        "source": source,
        "deadline_misses": misses,
        "margin_warn_at": warn_at,
        "pressured_ops": [
            {
                "op": op_key,
                "margin_p99": round(margin, 4) if margin else None,
                "p99_s": entry.get("p99_s"),
                "deadline_s": entry.get("deadline_s"),
                "deadline_misses": op_misses,
            }
            for op_misses, margin, op_key, entry in pressured[:5]
        ],
    }
    worst = pressured[0]
    if misses > 0:
        title = (
            f"{misses} wire RPC(s) missed their deadline "
            f"(worst op: {worst[2]})"
        )
        severity = "critical"
    else:
        title = (
            f"wire op {worst[2]} p99 is consuming "
            f"{worst[1]:.0%} of its RPC deadline "
            f"(warn threshold {warn_at:.0%})"
        )
        severity = "warn"
    return Finding(
        rule="deadline-margin-collapsing",
        severity=severity,
        title=title,
        evidence=evidence,
        remediation=(
            "the per-RPC deadline budget is collapsing onto real "
            "latency for the ops listed. Either the knob is mis-sized "
            "— raise TPUSNAPSHOT_REPLICATION_DEADLINE_S (snapwire "
            "ops) / TPUSNAPSHOT_SNAPSERVE_TIMEOUT_S (snapserve ops) — "
            "or the wire got slower: check peer placement and payload "
            "sizes (delta replication + codec settings shrink push "
            "frames). Misses already take the safe degradation paths "
            "(write-through before the ack, direct-backend fallback "
            "reads), so correctness held; latency is paying for it."
        ),
    )


def _rule_deadline_margin_collapsing(
    report: Dict[str, Any]
) -> Optional[Finding]:
    # Merge per-rank wire blocks per op: counts sum, quantiles take the
    # worst rank (a p99 cannot be averaged across ranks).
    ops: Dict[str, Dict[str, Any]] = {}
    for s in _ranks(report):
        for op_key, entry in (s.get("wire") or {}).items():
            if not isinstance(entry, dict):
                continue
            acc = ops.get(op_key)
            if acc is None:
                ops[op_key] = dict(entry)
                continue
            for k in ("count", "deadline_misses", "retries"):
                acc[k] = int(acc.get(k) or 0) + int(entry.get(k) or 0)
            for k in ("p99_s", "margin_p99", "margin_max"):
                v = entry.get(k)
                if v is not None:
                    acc[k] = max(float(acc.get(k) or 0.0), float(v))
    return wire_pressure_finding(ops, source="report")


# -------------------------------------------------- host memory (snapmem)
#
# The memory rules read memwatch blocks — flight-report ``memory``
# windows post-hoc (the _rule_* wrappers below), sampler ``memory``
# blocks live (telemetry/slo.py), fleet stats RPC blocks (ops --mem) —
# through the two shared helpers, so every surface renders the same
# verdict for the same numbers.

# Cache-misfit heuristics only speak once the cache saw real traffic.
_CACHE_MIN_LOOKUPS = 20


def memory_pressure_finding(
    mem: Dict[str, Any], source: str = "report"
) -> Optional[Finding]:
    """The shared ``host-memory-overcommit`` verdict over one memwatch
    block (flight-report window, sampler sample, or fleet stats).

    Critical when committed bytes actually landed past a limit — a
    domain's high-water above its cap, or the aggregate high-water
    past the host budget. Warn when only the pre-storm forecast
    predicted an overcommit (the storm may still have fit — RSS
    headroom is elastic; the point is to say so BEFORE the OOM
    killer does)."""
    if not mem:
        return None
    over_domains: List[Dict[str, Any]] = []
    for name, d in sorted((mem.get("domains") or {}).items()):
        if not isinstance(d, dict) or d.get("cap_bytes") is None:
            continue
        hwm = int(
            d.get("high_water_bytes")
            if d.get("high_water_bytes") is not None
            else d.get("used_bytes") or 0
        )
        cap = int(d["cap_bytes"])
        if hwm > cap:
            over_domains.append(
                {"domain": name, "high_water_bytes": hwm, "cap_bytes": cap}
            )
    budget = mem.get("budget_bytes")
    agg_hwm = int(mem.get("high_water_bytes") or 0)
    budget_over = budget is not None and agg_hwm > int(budget)
    forecasts = mem.get("forecasts")
    n_forecasts = (
        len(forecasts)
        if isinstance(forecasts, list)
        else int(forecasts or 0)
    )
    if not over_domains and not budget_over and not n_forecasts:
        return None
    evidence: Dict[str, Any] = {
        "source": source,
        "high_water_bytes": agg_hwm,
        "budget_bytes": budget,
    }
    if over_domains:
        evidence["over_cap_domains"] = over_domains[:5]
    if n_forecasts:
        evidence["overcommit_forecasts"] = n_forecasts
    if over_domains:
        worst = over_domains[0]
        title = (
            f"domain {worst['domain']} high-water "
            f"{worst['high_water_bytes']} bytes exceeds its "
            f"{worst['cap_bytes']}-byte cap"
        )
        severity = "critical"
    elif budget_over:
        title = (
            f"committed host memory high-water {agg_hwm} bytes exceeds "
            f"the {budget}-byte host budget"
        )
        severity = "critical"
    else:
        title = (
            f"{n_forecasts} pre-storm forecast(s) predicted the "
            f"operation's byte demand would not fit live host headroom"
        )
        severity = "warn"
    return Finding(
        rule="host-memory-overcommit",
        severity=severity,
        title=title,
        evidence=evidence,
        remediation=(
            "the process's byte-capped domains are collectively "
            "promising more host RAM than the host gives. Lower the "
            "overcommitting domain's cap (scheduler "
            "TPUSNAPSHOT_PER_RANK_MEMORY_BUDGET_BYTES, pool "
            "TPUSNAPSHOT_RESTORE_STAGING_POOL_BYTES, snapserve cache/"
            "flow knobs), or raise/verify TPUSNAPSHOT_HOST_MEM_BUDGET "
            "if the detected limit is wrong. `ops --mem` shows which "
            "process and domain is the offender."
        ),
    )


def cache_misfit_finding(
    cache: Dict[str, Any], source: str = "report"
) -> Optional[Finding]:
    """The shared ``cache-cap-misfit`` verdict over ByteLRU counters
    (windowed deltas from a memory block, or cumulative server stats).

    Warn on THRASH — the cache runs at its cap while evicting nearly
    as fast as it inserts with a sub-50% hit ratio (the cap is too
    small for the working set) — and on OVERSIZE — plenty of traffic
    but occupancy never reached a quarter of the cap (RAM promised to
    a cache that does not need it)."""
    if not cache:
        return None
    hits = int(cache.get("hits") or 0)
    misses = int(cache.get("misses") or 0)
    evictions = int(cache.get("evictions") or 0)
    inserts = int(cache.get("inserts") or 0)
    lookups = hits + misses
    cap = cache.get("cap_bytes")
    hwm = int(cache.get("high_water_bytes") or 0)
    if lookups < _CACHE_MIN_LOOKUPS or not cap:
        return None
    cap = int(cap)
    hit_ratio = hits / lookups
    evidence = {
        "source": source,
        "hits": hits,
        "misses": misses,
        "evictions": evictions,
        "inserts": inserts,
        "hit_ratio": round(hit_ratio, 3),
        "cap_bytes": cap,
        "high_water_bytes": hwm,
    }
    if (
        hwm >= 0.95 * cap
        and hit_ratio < 0.5
        and inserts > 0
        and evictions >= 0.5 * inserts
    ):
        return Finding(
            rule="cache-cap-misfit",
            severity="warn",
            title=(
                f"read cache is thrashing: {hit_ratio:.0%} hit ratio at "
                f"a full {cap}-byte cap with {evictions} evictions "
                f"against {inserts} inserts"
            ),
            evidence=evidence,
            remediation=(
                "the working set does not fit the cache — entries are "
                "evicted before they are re-read. Raise "
                "TPUSNAPSHOT_SNAPSERVE_CACHE_BYTES (watch `ops --mem` "
                "headroom first), or accept backend re-reads if RAM is "
                "the scarcer resource."
            ),
        )
    if hwm < 0.25 * cap and lookups >= 2 * _CACHE_MIN_LOOKUPS:
        return Finding(
            rule="cache-cap-misfit",
            severity="warn",
            title=(
                f"read cache cap is oversized: occupancy never passed "
                f"{hwm} bytes of a {cap}-byte cap across "
                f"{lookups} lookups"
            ),
            evidence=evidence,
            remediation=(
                "the cap promises RAM the working set never uses — "
                "lower TPUSNAPSHOT_SNAPSERVE_CACHE_BYTES and give the "
                "headroom back to the host budget."
            ),
        )
    return None


def _merged_memory(report: Dict[str, Any]) -> Dict[str, Any]:
    """Merge per-rank memory windows for the rule wrappers: per-domain
    high-waters/residuals take the worst rank, the aggregate high-water
    takes the worst rank, forecasts sum."""
    merged: Dict[str, Any] = {"domains": {}}
    agg = 0
    budget = None
    forecasts = 0
    seen = False
    for s in _ranks(report):
        mem = s.get("memory")
        if not mem:
            continue
        seen = True
        for name, d in (mem.get("domains") or {}).items():
            if not isinstance(d, dict):
                continue
            acc = merged["domains"].setdefault(name, {})
            for k in ("high_water_bytes", "residual_bytes"):
                if d.get(k) is not None:
                    acc[k] = max(int(acc.get(k) or 0), int(d[k]))
            if d.get("cap_bytes") is not None:
                acc["cap_bytes"] = int(d["cap_bytes"])
            for ck, cv in (d.get("counters") or {}).items():
                counters = acc.setdefault("counters", {})
                counters[ck] = int(counters.get(ck, 0)) + int(cv)
        agg = max(agg, int(mem.get("high_water_bytes") or 0))
        if mem.get("budget_bytes") is not None:
            b = int(mem["budget_bytes"])
            budget = b if budget is None else min(budget, b)
        forecasts += len(mem.get("forecasts") or [])
    if not seen:
        return {}
    merged["high_water_bytes"] = agg
    merged["budget_bytes"] = budget
    if forecasts:
        merged["forecasts"] = forecasts
    return merged


def _rule_host_memory_overcommit(
    report: Dict[str, Any]
) -> Optional[Finding]:
    return memory_pressure_finding(
        _merged_memory(report), source="report"
    )


def _rule_memory_leak(report: Dict[str, Any]) -> Optional[Finding]:
    # Single-report residual check: a completed operation whose
    # residual-watched domain still holds real bytes. The cross-record
    # TREND (the sentinel proper) lives in memwatch.leak_findings over
    # a ledger series; this rule catches the egregious single-shot
    # case — bytes a finished take/restore plainly never gave back.
    from .memwatch import LEAK_MIN_BYTES_ENV_VAR

    floor = env_int(LEAK_MIN_BYTES_ENV_VAR, 1 << 20)
    merged = _merged_memory(report)
    worst: Optional[Tuple[int, str]] = None
    for name, d in sorted((merged.get("domains") or {}).items()):
        residual = d.get("residual_bytes")
        if residual is not None and int(residual) >= max(1, floor):
            if worst is None or int(residual) > worst[0]:
                worst = (int(residual), name)
    if worst is None:
        return None
    residual, name = worst
    return Finding(
        rule="memory-leak-suspected",
        severity="warn",
        title=(
            f"domain {name} still holds {residual} bytes after the "
            f"operation completed"
        ),
        evidence={
            "source": "report",
            "domain": name,
            "residual_bytes": residual,
        },
        remediation=(
            "a completed operation left live bytes in a domain that "
            "should return to baseline. Run the sentinel over the "
            "ledger (python -m torchsnapshot_tpu_torch.telemetry.memwatch "
            "<path>) to see whether the residual is growing across "
            "operations — a flat residual is retention, a growing one "
            "is a leak in the named domain's release path."
        ),
    )


def _rule_staging_pool_thrash(
    report: Dict[str, Any]
) -> Optional[Finding]:
    # Windowed pool counter deltas: waits mean acquisitions blocked at
    # the cap, and misses+waits dominating hits means the pool is too
    # small to ever serve its purpose — every acquire allocates or
    # stalls instead of reusing.
    merged = _merged_memory(report)
    pool = (merged.get("domains") or {}).get("staging_pool") or {}
    counters = pool.get("counters") or {}
    hits = int(counters.get("hits") or 0)
    misses = int(counters.get("misses") or 0)
    waits = int(counters.get("waits") or 0)
    if waits <= 0 or misses + waits <= hits:
        return None
    return Finding(
        rule="staging-pool-thrash",
        severity="warn",
        title=(
            f"staging pool thrashed this operation: {waits} capacity "
            f"wait(s), {misses} misses against {hits} hits"
        ),
        evidence={
            "source": "report",
            "hits": hits,
            "misses": misses,
            "waits": waits,
            "cap_bytes": pool.get("cap_bytes"),
            "high_water_bytes": pool.get("high_water_bytes"),
        },
        remediation=(
            "restore consumers blocked on the staging-pool cap and "
            "most acquisitions could not reuse a buffer. Raise "
            "TPUSNAPSHOT_RESTORE_STAGING_POOL_BYTES toward the "
            "restore's working set (watch `ops --mem` headroom), or "
            "lower read concurrency so fewer buffers are live at once."
        ),
    )


def _rule_cache_cap_misfit(report: Dict[str, Any]) -> Optional[Finding]:
    merged = _merged_memory(report)
    cache = (merged.get("domains") or {}).get("snapserve.cache") or {}
    counters = dict(cache.get("counters") or {})
    counters["cap_bytes"] = cache.get("cap_bytes")
    counters["high_water_bytes"] = cache.get("high_water_bytes")
    return cache_misfit_finding(counters, source="report")


RULES: List[Callable[[Dict[str, Any]], Optional[Finding]]] = [
    _rule_consume_dominated,
    _rule_read_dominated,
    _rule_stage_dominated,
    _rule_budget_stall,
    _rule_retry_storm,
    _rule_straggler,
    _rule_imbalanced_stripe,
    _rule_checkpoint_overhead,
    _rule_durability_lag,
    _rule_missing_summary,
    _rule_hot_tier_degraded,
    _rule_replication_degraded,
    _rule_read_plane_degraded,
    _rule_fleet_degraded,
    _rule_dedup_ineffective,
    _rule_deadline_margin_collapsing,
    _rule_host_memory_overcommit,
    _rule_memory_leak,
    _rule_staging_pool_thrash,
    _rule_cache_cap_misfit,
]

_SEVERITY_ORDER = {"critical": 0, "warn": 1}


def diagnose_report(report: Dict[str, Any]) -> List[Finding]:
    """Run the whole rule table over one flight report."""
    findings = [f for f in (rule(report) for rule in RULES) if f]
    findings.sort(key=lambda f: (_SEVERITY_ORDER.get(f.severity, 9), f.rule))
    return findings


def diagnose(
    reports: List[Dict[str, Any]],
    trace_summary: Optional[Dict[str, Any]] = None,
) -> List[Finding]:
    """Findings across several reports (a take report plus restore
    reports, as ``inspect --doctor`` collects them), plus the trace
    summarizer's dominance verdict when a summary is supplied and no
    report already made the same call."""
    findings: List[Finding] = []
    for report in reports:
        findings.extend(diagnose_report(report))
    verdict = (trace_summary or {}).get("verdict")
    if verdict and verdict.get("dominated"):
        rule = (
            f"{verdict['dominant_phase']}-dominated-"
            f"{verdict['pipeline']}"
        )
        if not any(f.rule.startswith(verdict["dominant_phase"]) for f in findings):
            findings.append(
                Finding(
                    rule=rule,
                    severity="warn",
                    title=(
                        f"trace: {verdict['pipeline']} is "
                        f"{verdict['dominant_phase']}-dominated "
                        f"({verdict['busy_s']:.2f}s busy vs "
                        f"{verdict['sibling']} "
                        f"{verdict['sibling_busy_s']:.2f}s)"
                    ),
                    evidence=dict(verdict),
                    remediation=(
                        "see telemetry.summarize's advice line for this "
                        "phase."
                    ),
                )
            )
    findings.sort(key=lambda f: (_SEVERITY_ORDER.get(f.severity, 9), f.rule))
    return findings


def render_findings(findings: List[Finding]) -> str:
    if not findings:
        return "doctor: no findings — nothing anomalous in the report(s)"
    lines = [f"doctor: {len(findings)} finding(s)"]
    for f in findings:
        lines.append(f"[{f.severity.upper():8s}] {f.rule}: {f.title}")
        if f.evidence:
            ev = ", ".join(f"{k}={v}" for k, v in sorted(f.evidence.items()))
            lines.append(f"           evidence: {ev}")
        if f.remediation:
            lines.append(f"           remediation: {f.remediation}")
    return "\n".join(lines)


def _collect_snapshot_reports(path: str) -> List[Dict[str, Any]]:
    """The take report + any restore reports a snapshot holds."""
    import asyncio

    from ..storage_plugin import url_to_storage_plugin
    from . import report as flight

    storage = url_to_storage_plugin(path)
    try:
        reports: List[Dict[str, Any]] = []
        take = asyncio.run(flight.aread_json(storage, flight.REPORT_FNAME))
        if take is not None:
            reports.append(take)
        for p in sorted(
            asyncio.run(storage.list_prefix(flight.REPORT_PREFIX)) or []
        ):
            if p.startswith(".report.restore."):
                doc = asyncio.run(flight.aread_json(storage, p))
                if doc is not None:
                    reports.append(doc)
        return reports
    finally:
        storage.close()


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m torchsnapshot_tpu_torch.telemetry.doctor",
        description="Diagnose a snapshot operation's flight report(s) "
        "against the anomaly rule table.",
    )
    parser.add_argument(
        "path",
        help="snapshot URL (reads its .report.json + restore reports) "
        "or a path to one report JSON file",
    )
    parser.add_argument(
        "--trace",
        help="optional Chrome trace to fold for a dominance verdict",
    )
    parser.add_argument(
        "--json", action="store_true", help="emit findings as JSON"
    )
    args = parser.parse_args(argv)

    import os

    reports: List[Dict[str, Any]]
    if "://" not in args.path and os.path.isfile(args.path):
        try:
            with open(args.path) as f:
                reports = [json.load(f)]
        except (OSError, json.JSONDecodeError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    else:
        try:
            reports = _collect_snapshot_reports(args.path)
        except Exception as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    if not reports:
        print(f"no flight report at {args.path}", file=sys.stderr)
        return 2

    trace_summary = None
    if args.trace:
        from . import summarize as _summarize

        try:
            trace_summary = _summarize.summarize(
                _summarize.fold_spans(_summarize.load_events(args.trace))
            )
        except (OSError, ValueError, json.JSONDecodeError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2

    findings = diagnose(reports, trace_summary=trace_summary)
    if args.json:
        print(
            json.dumps(
                [f.as_dict() for f in findings], indent=2, sort_keys=True
            )
        )
    else:
        print(render_findings(findings))
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
