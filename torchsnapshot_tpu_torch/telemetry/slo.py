"""snapscope's SLO engine: declarative objectives + burn rates over the
ledger and the live sampler state.

The doctor diagnoses one operation; the timeline sentinel flags drift
against a rolling baseline. Neither answers the operator question "are
we inside our stated objectives, and how fast are we burning the error
budget?" — the framing tf.data service (arXiv 2210.14826) argues a
disaggregated ML service layer needs. This module makes the objectives
explicit and evaluates them two ways:

- **ledger objectives** — each committed record is judged against its
  objective's target (a take's ``goodput.window_overhead_pct`` vs the
  checkpoint budget, a ``tierdown`` event's ``durability_lag_s`` vs the
  RPO budget, a restore's ``wall_s``, a take's ``gbps`` floor), and the
  violation *fraction* over a short and a long trailing window is
  divided by the objective's error-budget fraction — the classic
  multi-window **burn rate**. An objective breaches only when BOTH
  windows burn at >= 1x: the short window makes the alert fast, the
  long window keeps one flaky record from paging anyone.
- **live rules** — over the runtime sampler's samples
  (telemetry/sampler.py), three doctor-style rules that fire while
  there is still time to act: ``stranded-drains`` (objects whose drain
  attempts exhausted — the only copy is RAM; critical, names the
  roots), ``drain-backlog-growing`` (queue depth AND oldest-item age
  rising across the window — the drain is losing the race with the
  take cadence), and ``durability-lag-above-budget`` (the oldest
  committed-but-undrained object's age already exceeds the RPO budget,
  or a recorded ``tierdown`` lag did).

Objectives and their env knobs (unset = the default; a target <= 0
disables the objective):

=========================  ===================================  =======
objective                  env var                              default
=========================  ===================================  =======
durability-lag seconds     ``TPUSNAPSHOT_SLO_DURABILITY_LAG_S``     120
checkpoint overhead pct    ``TPUSNAPSHOT_CKPT_BUDGET_PCT``            5
restore seconds            ``TPUSNAPSHOT_SLO_RESTORE_S``            600
take GB/s floor            ``TPUSNAPSHOT_SLO_TAKE_GBPS``        0 (off)
=========================  ===================================  =======

CLI (CI-facing, same exit-code contract as ``timeline``)::

    python -m torchsnapshot_tpu_torch.telemetry.slo <ledger-root-or-.jsonl>
        [--samples-dir DIR] [--json]
    python -m torchsnapshot_tpu_torch.telemetry.slo --self-test

Exit codes: 0 = inside all objectives; 1 = an objective breached or a
live rule fired; 2 = usage / no data.
"""

import argparse
import json
import sys
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..utils.env import env_float, env_int
from .doctor import Finding, memory_pressure_finding, wire_pressure_finding
from .memwatch import LEAK_MIN_BYTES_ENV_VAR as _MEM_LEAK_MIN_BYTES_ENV_VAR

# The dotted-field numeric getter lives in timeline; re-implementing it
# here would be the package's third copy.
from .timeline import _get

DURABILITY_LAG_ENV_VAR = "TPUSNAPSHOT_SLO_DURABILITY_LAG_S"
DEFAULT_DURABILITY_LAG_S = 120.0
RESTORE_S_ENV_VAR = "TPUSNAPSHOT_SLO_RESTORE_S"
DEFAULT_RESTORE_S = 600.0
TAKE_GBPS_ENV_VAR = "TPUSNAPSHOT_SLO_TAKE_GBPS"
_CKPT_BUDGET_ENV_VAR = "TPUSNAPSHOT_CKPT_BUDGET_PCT"
_DEFAULT_CKPT_BUDGET_PCT = 5.0

# (short, long) trailing-window sizes, in ledger records per objective
# kind. Record-indexed, not wall-time: the ledger's cadence IS the take
# cadence, which is the unit an error budget is spent in.
DEFAULT_WINDOWS: Tuple[int, int] = (5, 20)
# Fraction of records allowed to violate before the budget is spent
# (burn rate 1.0 == violating at exactly the budgeted rate).
DEFAULT_BUDGET_FRACTION = 0.25

# Live-rule knobs: how many trailing samples the backlog-growth rule
# needs, and the minimum growth that counts (absolute queue items).
_BACKLOG_WINDOW = 3
_BACKLOG_MIN_GROWTH = 1


def durability_lag_budget_s() -> float:
    """The RPO budget: how long an acked take may stay undrained before
    the exposure window counts as a violation (<= 0 disables)."""
    return env_float(DURABILITY_LAG_ENV_VAR, DEFAULT_DURABILITY_LAG_S)


@dataclass
class Objective:
    """One declarative objective over ledger records."""

    name: str
    label: str
    kinds: Tuple[str, ...]  # ledger record kinds it judges
    field: str  # dotted field within the record
    target: float
    direction: str  # "max": violate when value > target; "min": < target
    budget_fraction: float = DEFAULT_BUDGET_FRACTION
    # The doctor rule id a breach surfaces as (defaults to slo-<name>).
    rule: Optional[str] = None

    def violates(self, value: float) -> bool:
        return (
            value > self.target
            if self.direction == "max"
            else value < self.target
        )


def default_objectives() -> List[Objective]:
    objectives = [
        Objective(
            name="durability-lag",
            label="durability lag s (ack -> .tierdown)",
            kinds=("tierdown",),
            field="durability_lag_s",
            target=durability_lag_budget_s(),
            direction="max",
            rule="durability-lag-above-budget",
        ),
        Objective(
            name="checkpoint-overhead",
            label="checkpoint overhead % of wall",
            kinds=("take", "async_take"),
            field="goodput.window_overhead_pct",
            target=env_float(
                _CKPT_BUDGET_ENV_VAR, _DEFAULT_CKPT_BUDGET_PCT
            ),
            direction="max",
        ),
        Objective(
            name="restore-seconds",
            label="restore seconds",
            kinds=("restore",),
            field="wall_s",
            target=env_float(RESTORE_S_ENV_VAR, DEFAULT_RESTORE_S),
            direction="max",
        ),
        Objective(
            name="take-gbps-floor",
            label="take GB/s floor",
            kinds=("take", "async_take"),
            field="gbps",
            target=env_float(TAKE_GBPS_ENV_VAR, 0.0),
            direction="min",
        ),
    ]
    return [o for o in objectives if o.target > 0]




# ----------------------------------------------------------- burn rates


def burn_rates(
    values: Sequence[float],
    objective: Objective,
    windows: Tuple[int, int] = DEFAULT_WINDOWS,
) -> Dict[str, Any]:
    """Multi-window burn-rate verdict for one objective's value series
    (oldest → newest). ``breached`` requires EVERY window to burn at
    >= 1x — the fast window alone is noise, the slow window alone is
    history."""
    out: Dict[str, Any] = {
        "name": objective.name,
        "label": objective.label,
        "target": objective.target,
        "direction": objective.direction,
        "budget_fraction": objective.budget_fraction,
        "n_points": len(values),
        "windows": [],
        "breached": False,
        "last_value": values[-1] if values else None,
    }
    if not values:
        return out
    burns: List[float] = []
    fully_observed = True
    for w in windows:
        tail = list(values)[-w:]
        bad = sum(1 for v in tail if objective.violates(v))
        frac = bad / len(tail)
        burn = frac / objective.budget_fraction
        burns.append(burn)
        if len(tail) < w:
            fully_observed = False
        out["windows"].append(
            {
                "window": w,
                "observed": len(tail),
                "violations": bad,
                "violation_fraction": round(frac, 6),
                "burn_rate": round(burn, 6),
            }
        )
    out["breached"] = bool(burns) and all(b >= 1.0 for b in burns)
    # On a YOUNG ledger both windows collapse onto all-of-history, so a
    # breach can rest on very few points (a single violating record, in
    # the limit). That still breaches — if every take so far violated
    # the objective, "inside SLO" would be a lie, and the deterministic
    # CI contract (one injected slow drain → nonzero exit) depends on
    # it — but it must not PAGE as critical until the long window has
    # real history behind it.
    out["fully_observed"] = fully_observed
    return out


def evaluate_ledger(
    records: List[Dict[str, Any]],
    objectives: Optional[List[Objective]] = None,
    windows: Tuple[int, int] = DEFAULT_WINDOWS,
) -> Dict[str, Any]:
    """Every objective's burn-rate verdict over the ledger history.
    Records lacking the field (e.g. takes with no goodput hook) are
    missing data, never violations."""
    if objectives is None:
        objectives = default_objectives()
    results: List[Dict[str, Any]] = []
    findings: List[Finding] = []
    for objective in objectives:
        values = [
            v
            for r in records
            if r.get("kind") in objective.kinds
            for v in [_get(r, objective.field)]
            if v is not None
        ]
        verdict = burn_rates(values, objective, windows=windows)
        results.append(verdict)
        if verdict["breached"]:
            rule = objective.rule or f"slo-{objective.name}"
            worst = max(
                w["burn_rate"] for w in verdict["windows"]
            )
            findings.append(
                Finding(
                    rule=rule,
                    severity=(
                        "critical"
                        if worst >= 2.0 and verdict["fully_observed"]
                        else "warn"
                    ),
                    title=(
                        f"SLO {objective.label} breached: last value "
                        f"{verdict['last_value']:g} vs target "
                        f"{objective.target:g} "
                        f"({objective.direction}), burn rate "
                        f"{worst:.1f}x across all windows"
                    ),
                    evidence={
                        "objective": objective.name,
                        "target": objective.target,
                        "last_value": verdict["last_value"],
                        "windows": verdict["windows"],
                    },
                    remediation=(
                        "the error budget is burning faster than "
                        "provisioned across BOTH windows — this is a "
                        "trend, not a blip. See the objective's env "
                        "knob to re-state the target, or the matching "
                        "doctor remediation (durability lag: drain "
                        "bandwidth / take cadence; overhead: "
                        "checkpoint-overhead-above-budget; restore/"
                        "take: storage health, timeline trends)."
                    ),
                )
            )
    return {"objectives": results, "findings": findings}


# ------------------------------------------------------------ live rules


def _hot_samples(
    samples: List[Dict[str, Any]]
) -> List[Dict[str, Any]]:
    return [
        s["hot_tier"]
        for s in samples
        if isinstance(s.get("hot_tier"), dict)
    ]


def rule_stranded_drains(
    samples: List[Dict[str, Any]]
) -> Optional[Finding]:
    """Objects (or watermarks) whose drain attempts exhausted: their
    hot replicas are the ONLY copy of committed bytes, and nothing
    re-drives them until a ``drain_now()``. Always critical."""
    hot = _hot_samples(samples)
    if not hot:
        return None
    latest = hot[-1]
    stranded = int(latest.get("stranded_objects") or 0)
    roots = list(latest.get("stranded_roots") or [])
    if stranded <= 0 and not roots:
        return None
    return Finding(
        rule="stranded-drains",
        severity="critical",
        title=(
            f"{stranded} stranded drain item(s); committed bytes are "
            f"hot-tier-only at root(s) {roots}"
        ),
        evidence={
            "stranded_objects": stranded,
            "stranded_roots": roots,
            "at_risk_bytes": latest.get("at_risk_bytes"),
        },
        remediation=(
            "the durable backend rejected these objects past the drain "
            "attempt budget. Check storage health, then force a "
            "re-drive (hottier.drain_now()); do NOT disable the tier "
            "with flush=False or kill these hosts — their RAM holds "
            "the only copy."
        ),
    )


def rule_drain_backlog_growing(
    samples: List[Dict[str, Any]]
) -> Optional[Finding]:
    """Queue depth and oldest-item age BOTH rising across the sample
    window: the drain is losing the race with the take cadence, and the
    durability-lag SLO is next."""
    hot = _hot_samples(samples)
    if len(hot) < _BACKLOG_WINDOW:
        return None
    tail = hot[-_BACKLOG_WINDOW:]
    depths = [
        int(h.get("queue_depth") or 0) + int(h.get("inflight") or 0)
        for h in tail
    ]
    ages = [h.get("oldest_pending_age_s") for h in tail]
    nondecreasing = all(b >= a for a, b in zip(depths, depths[1:]))
    grew = depths[-1] - depths[0] >= _BACKLOG_MIN_GROWTH
    ages_known = [a for a in ages if a is not None]
    aging = (
        len(ages_known) >= 2 and ages_known[-1] > ages_known[0]
    )
    if not (nondecreasing and grew and aging):
        return None
    return Finding(
        rule="drain-backlog-growing",
        severity="warn",
        title=(
            f"drain backlog grew {depths[0]} -> {depths[-1]} items "
            f"across {len(tail)} samples while the oldest item aged "
            f"{ages_known[0]:.1f}s -> {ages_known[-1]:.1f}s"
        ),
        evidence={
            "queue_depths": depths,
            "oldest_ages_s": ages,
            "at_risk_bytes": tail[-1].get("at_risk_bytes"),
        },
        remediation=(
            "tier-down bandwidth is below the take cadence's byte "
            "rate: the at-risk window grows every take. Lower the "
            "save frequency, shrink takes (incremental), or give the "
            "durable backend more write concurrency; watch "
            "durability-lag-above-budget next."
        ),
    )


def rule_durability_lag_live(
    samples: List[Dict[str, Any]],
    budget_s: Optional[float] = None,
) -> Optional[Finding]:
    """The oldest committed-but-undrained object is ALREADY older than
    the RPO budget — the lag SLO is being violated right now, before
    any ``.tierdown`` record exists to prove it post-hoc."""
    if budget_s is None:
        budget_s = durability_lag_budget_s()
    if budget_s <= 0:
        return None
    hot = _hot_samples(samples)
    if not hot:
        return None
    latest = hot[-1]
    # COMMITTED-roots-only age: an in-flight take's pending objects are
    # not an acked checkpoint's exposure window (introspect separates
    # the two precisely so this rule cannot pair an uncommitted root's
    # age with another root's at-risk bytes).
    age = latest.get("oldest_at_risk_age_s")
    at_risk = int(latest.get("at_risk_bytes") or 0)
    if age is None or age <= budget_s or at_risk <= 0:
        return None
    return Finding(
        rule="durability-lag-above-budget",
        severity="critical" if age >= 2 * budget_s else "warn",
        title=(
            f"oldest committed-but-undrained object is {age:.1f}s old "
            f"(budget {budget_s:g}s); {at_risk} byte(s) at risk"
        ),
        evidence={
            "oldest_at_risk_age_s": age,
            "budget_s": budget_s,
            "at_risk_bytes": at_risk,
            "at_risk_by_root": latest.get("at_risk_by_root"),
        },
        remediation=(
            "acked checkpoints are resting on RAM replicas past the "
            "durability budget: a correlated host loss now exceeds "
            "the stated RPO. Force a flush (hottier.drain_now() / "
            "wait_drained()), check durable-backend health, or raise "
            f"{DURABILITY_LAG_ENV_VAR} if the budget is wrong."
        ),
    )


def rule_replication_underreplicated(
    samples: List[Dict[str, Any]]
) -> Optional[Finding]:
    """snapmend: committed undrained objects are below k live replicas
    and the repair plane has had time to act. Warn once any object has
    been under-replicated past one repair interval (the loop should
    have repaired it by now); critical when the repair is STALLED —
    under-replication has outlived ``TPUSNAPSHOT_REPAIR_DEADLINE_S``
    and the plane is escalating to synchronous durable write-through
    (or died outright), so the replication invariant is not coming back
    on its own."""
    hot = _hot_samples(samples)
    if not hot:
        return None
    latest = hot[-1]
    repair = latest.get("repair")
    if not isinstance(repair, dict):
        return None
    under_objects = int(repair.get("underreplicated_objects") or 0)
    under_bytes = int(repair.get("underreplicated_bytes") or 0)
    oldest = repair.get("oldest_underreplicated_age_s")
    repair_error = repair.get("repair_error")
    # A dead plane IS the stall, independent of every age gate below:
    # the introspect snapshot FREEZES at the crash (ages stop
    # advancing, later losses are invisible), so gating critical on
    # the frozen oldest-age would keep a dead plane at warn forever —
    # and a loss after the crash would produce no finding at all.
    plane_dead = repair_error is not None
    interval_s = float(repair.get("interval_s") or 0.0)
    deadline_s = float(repair.get("deadline_s") or 0.0)
    dead_hosts = sorted(
        h
        for h, v in (repair.get("membership") or {}).items()
        if not v.get("alive")
    )
    if under_objects <= 0 or oldest is None:
        if not plane_dead:
            return None
        return Finding(
            rule="replication-underreplicated",
            severity="critical",
            title=(
                f"repair plane DEAD ({repair_error}); self-healing is "
                f"off and under-replication after the crash is "
                f"invisible to this snapshot"
            ),
            evidence={
                "underreplicated_objects": under_objects,
                "underreplicated_bytes": under_bytes,
                "repair_error": repair_error,
                "dead_hosts": dead_hosts,
            },
            remediation=(
                "the repair plane crashed (repair_error); no peer "
                "supervision, auto-restart, or re-replication is "
                "running. Re-enable the hot tier (or run "
                "hottier.repair_tick() manually) after fixing the "
                "cause — host losses since the crash are NOT reflected "
                "in this sample's counters."
            ),
        )
    if oldest < interval_s and not plane_dead:
        return None  # the loop has not had a full tick to act yet
    stats = repair.get("stats") or {}
    escalations = int(stats.get("escalated_write_throughs") or 0)
    # escalation_attempts counts every deadline-passed tick (including
    # loss-verdict debounce deferrals where no write-through ran yet) —
    # the repair being past its deadline is the stall, whether or not
    # a durable write has landed.
    attempts = int(
        stats.get("escalation_attempts") or 0
    )
    stalled = plane_dead or (
        oldest >= deadline_s and (attempts > 0 or escalations > 0)
    )
    return Finding(
        rule="replication-underreplicated",
        severity="critical" if stalled else "warn",
        title=(
            f"{under_objects} committed object(s) ({under_bytes} bytes) "
            f"below k live replicas for {oldest:.1f}s"
            + (
                f"; repair plane DEAD ({repair_error})"
                if plane_dead
                else (
                    f"; repair stalled past the {deadline_s:g}s deadline "
                    f"({escalations} write-through escalation(s))"
                    if stalled
                    else f" (repair interval {interval_s:g}s)"
                )
            )
        ),
        evidence={
            "underreplicated_objects": under_objects,
            "underreplicated_bytes": under_bytes,
            "oldest_underreplicated_age_s": oldest,
            "repair_interval_s": interval_s,
            "repair_deadline_s": deadline_s,
            "escalated_write_throughs": escalations,
            "repair_error": repair_error,
            "dead_hosts": dead_hosts,
        },
        remediation=(
            "a host loss (or repair failure) left committed bytes "
            "below their replication factor. Check peer-process health "
            "and the membership view (telemetry.ops repair section); "
            "lost restartable peers should respawn automatically "
            "(TPUSNAPSHOT_REPAIR_AUTO_RESTART). Escalated objects are "
            "already durable via write-through; if the plane died "
            "(repair_error), re-enable the hot tier or run "
            "hottier.repair_tick() after fixing the cause."
        ),
    )


def rule_wire_deadline_pressure(
    samples: List[Dict[str, Any]],
) -> Optional[Finding]:
    """snapflight: the wiretap sample block shows RPC latency eating
    into per-op deadline budgets. The sampler's ``wire`` block carries
    CUMULATIVE per-op counters, so with two or more wire-bearing
    samples in the window the rule scores the DELTA (misses/retries
    that happened inside the window — an old burst of misses must not
    page forever); with a single sample it falls back to the absolute
    block. Margin percentiles are not deltas — the latest sample's
    p99 is used as-is (it already reflects recent shape). Severity and
    thresholds are shared with the doctor's
    ``deadline-margin-collapsing`` rule via
    :func:`~.doctor.wire_pressure_finding`."""
    wired = [
        s["wire"]
        for s in samples
        if isinstance(s.get("wire"), dict) and s["wire"].get("ops")
    ]
    if not wired:
        return None
    latest = wired[-1]
    ops: Dict[str, Dict[str, Any]] = {}
    for key, stats in (latest.get("ops") or {}).items():
        if isinstance(stats, dict):
            ops[key] = dict(stats)
    if not ops:
        return None
    if len(wired) >= 2:
        first = wired[0].get("ops") or {}
        for key, stats in ops.items():
            base = first.get(key)
            if not isinstance(base, dict):
                continue
            for field in ("count", "deadline_misses", "retries"):
                delta = int(stats.get(field) or 0) - int(
                    base.get(field) or 0
                )
                stats[field] = max(0, delta)
        ops = {k: v for k, v in ops.items() if int(v.get("count") or 0) > 0}
        if not ops:
            return None
    return wire_pressure_finding(ops, source="live")


def rule_memory_pressure(
    samples: List[Dict[str, Any]],
) -> Optional[Finding]:
    """snapmem: the memwatch sample block shows host memory in trouble
    — live overcommit on the latest sample (a domain past its cap, or
    committed bytes past the host budget — verdict shared with the
    doctor's ``host-memory-overcommit`` rule via
    :func:`~.doctor.memory_pressure_finding`), or a residual-watched
    domain's bytes growing monotonically across the window
    (``memory-leak-suspected`` — occupancy in the sampler is a
    point-in-time reading, so the trend needs 3+ memory-bearing
    samples to speak)."""
    memed = [
        s["memory"]
        for s in samples
        if isinstance(s.get("memory"), dict) and s["memory"].get("domains")
    ]
    if not memed:
        return None
    latest = memed[-1]
    finding = memory_pressure_finding(latest, source="live")
    if finding is not None:
        return finding
    if len(memed) < 3:
        return None
    floor = env_int(_MEM_LEAK_MIN_BYTES_ENV_VAR, 1 << 20)
    worst: Optional[Tuple[int, int, str, List[int]]] = None
    for name in latest.get("domains") or {}:
        series: List[int] = []
        for mem in memed:
            d = (mem.get("domains") or {}).get(name)
            if not isinstance(d, dict):
                series = []
                break
            watch = d.get("watch_residual")
            if watch == "pinned":
                series.append(int(d.get("pinned_bytes") or 0))
            elif watch == "used":
                series.append(int(d.get("used_bytes") or 0))
            else:
                series = []
                break
        if len(series) < 3:
            continue
        growth = series[-1] - series[0]
        monotonic = all(b >= a for a, b in zip(series, series[1:]))
        if monotonic and growth >= max(1, floor) and series[-1] > 0:
            if worst is None or growth > worst[0]:
                worst = (growth, series[-1], name, series)
    if worst is None:
        return None
    growth, current, name, series = worst
    return Finding(
        rule="memory-leak-suspected",
        severity="warn",
        title=(
            f"domain {name} grew {growth} bytes across the sampler "
            f"window without ever shrinking (now {current} bytes)"
        ),
        evidence={
            "source": "live",
            "domain": name,
            "growth_bytes": growth,
            "current_bytes": current,
            "samples": len(series),
            "series_tail": series[-8:],
        },
        remediation=(
            "bytes the named domain should release between operations "
            "are only ever growing. Cross-check the ledger sentinel "
            "(python -m torchsnapshot_tpu_torch.telemetry.memwatch <path>) "
            "for the per-operation residual trend, and inspect the "
            "domain's lease/charge call sites."
        ),
    )


def evaluate_live(
    samples: List[Dict[str, Any]],
    budget_s: Optional[float] = None,
) -> List[Finding]:
    """Live rules over ONE rank's sample series. Samples from different
    ranks must not be mixed into one series — the latest-sample rules
    would see only the last rank, and the trend rule would read
    cross-rank steady-state differences as growth; use
    :func:`evaluate_live_by_rank` for a multi-rank collection."""
    findings = [
        f
        for f in (
            rule_stranded_drains(samples),
            rule_drain_backlog_growing(samples),
            rule_durability_lag_live(samples, budget_s=budget_s),
            rule_replication_underreplicated(samples),
            rule_wire_deadline_pressure(samples),
            rule_memory_pressure(samples),
        )
        if f is not None
    ]
    return findings


def evaluate_live_by_rank(
    samples_by_rank: Dict[int, List[Dict[str, Any]]],
    budget_s: Optional[float] = None,
) -> List[Finding]:
    """Run the live rules per rank (each rank is its own drain
    pipeline) and stamp the rank into the evidence."""
    findings: List[Finding] = []
    for rank in sorted(samples_by_rank):
        for f in evaluate_live(samples_by_rank[rank], budget_s=budget_s):
            f.evidence = dict(f.evidence, rank=rank)
            findings.append(f)
    return findings


def evaluate(
    records: Optional[List[Dict[str, Any]]] = None,
    samples: Optional[List[Dict[str, Any]]] = None,
    samples_by_rank: Optional[Dict[int, List[Dict[str, Any]]]] = None,
    objectives: Optional[List[Objective]] = None,
    windows: Tuple[int, int] = DEFAULT_WINDOWS,
) -> Dict[str, Any]:
    """The full verdict: ledger burn rates + live sampler rules.
    ``samples`` is a single rank's series; ``samples_by_rank`` runs the
    live rules independently per rank."""
    ledger_part = evaluate_ledger(
        records or [], objectives=objectives, windows=windows
    )
    findings = list(ledger_part["findings"])
    if samples:
        findings.extend(evaluate_live(samples))
    if samples_by_rank:
        findings.extend(evaluate_live_by_rank(samples_by_rank))
    return {
        "objectives": ledger_part["objectives"],
        "findings": findings,
        "healthy": not findings,
    }


# --------------------------------------------------------------- rendering


def render(result: Dict[str, Any], with_findings: bool = True) -> str:
    """``with_findings=False`` renders the objectives table alone (the
    ops view appends its own merged findings section)."""
    from .doctor import render_findings

    lines: List[str] = [
        f"{'objective':<34s} {'target':>10s} {'last':>10s} "
        f"{'burn(short/long)':>17s}  verdict"
    ]
    for o in result.get("objectives") or []:
        burns = [w["burn_rate"] for w in o.get("windows") or []]
        burn_s = "/".join(f"{b:.1f}" for b in burns) if burns else "—"
        last = o.get("last_value")
        lines.append(
            f"{o['label']:<34s} {o['target']:>10g} "
            f"{last if last is not None else '—':>10} "
            f"{burn_s:>17s}  "
            f"{'BREACHED' if o.get('breached') else 'ok'}"
        )
    if with_findings:
        lines.append(render_findings(result.get("findings") or []))
    return "\n".join(lines)


def _self_test() -> int:
    """Fixture check of the burn-rate math and the live rules, so CI
    can smoke the engine with no ledger run."""
    obj = Objective(
        name="durability-lag",
        label="durability lag s",
        kinds=("tierdown",),
        field="durability_lag_s",
        target=1.0,
        direction="max",
        rule="durability-lag-above-budget",
    )

    def recs(lags):
        return [
            {"kind": "tierdown", "durability_lag_s": v} for v in lags
        ]

    healthy = evaluate_ledger(recs([0.1] * 20), objectives=[obj])
    assert not healthy["findings"], healthy
    # A violating tail burns both windows (short 5/5, long 6/20 > 25%)
    # — fully observed history, so the 4x burn is critical.
    bad = evaluate_ledger(
        recs([0.1] * 14 + [5.0] * 6), objectives=[obj]
    )
    assert bad["findings"], bad
    assert bad["findings"][0].rule == "durability-lag-above-budget"
    assert bad["findings"][0].severity == "critical"
    # One blip burns the short window only: NOT a breach.
    blip = evaluate_ledger(
        recs([0.1] * 16 + [5.0] + [0.1] * 3), objectives=[obj]
    )
    assert not blip["findings"], blip
    # Young ledger: one record, and it violates — 100% of history is
    # outside the objective, so it breaches (the deterministic CI
    # contract), but with both windows under-observed it must not
    # page as critical.
    young = evaluate_ledger(recs([5.0]), objectives=[obj])
    assert young["findings"], young
    assert young["findings"][0].severity == "warn", young["findings"]
    # min-direction objective (throughput floor).
    floor = Objective(
        name="take-gbps-floor",
        label="take GB/s floor",
        kinds=("take",),
        field="gbps",
        target=1.0,
        direction="min",
    )
    slow = evaluate_ledger(
        [{"kind": "take", "gbps": 0.1}] * 20, objectives=[floor]
    )
    assert slow["findings"], slow

    def hot(depth, age, stranded=0, roots=(), at_risk_age=None):
        return {
            "hot_tier": {
                "queue_depth": depth,
                "inflight": 0,
                "oldest_pending_age_s": age,
                "oldest_at_risk_age_s": (
                    at_risk_age if at_risk_age is not None else age
                ),
                "at_risk_bytes": 123 if depth or stranded else 0,
                "at_risk_by_root": {},
                "stranded_objects": stranded,
                "stranded_roots": list(roots),
            }
        }

    growing = [hot(1, 0.5), hot(2, 1.5), hot(4, 3.0)]
    live = evaluate_live(growing)
    assert any(f.rule == "drain-backlog-growing" for f in live), live
    stranded = evaluate_live([hot(0, None, stranded=2, roots=["/r/s"])])
    assert any(
        f.rule == "stranded-drains" and "/r/s" in f.title
        for f in stranded
    ), stranded
    over = evaluate_live([hot(1, 99.0)], budget_s=10.0)
    assert any(
        f.rule == "durability-lag-above-budget" for f in over
    ), over
    under = evaluate_live([hot(1, 5.0)], budget_s=10.0)
    assert not under, under
    # An UNCOMMITTED root's old pending object is not an RPO breach:
    # the rule reads the committed-roots-only age.
    inflight = evaluate_live(
        [hot(1, 300.0, at_risk_age=2.0)], budget_s=10.0
    )
    assert not inflight, inflight
    # Live rules are per rank: rank 0's stranded state must surface
    # even when a healthier rank sorts after it, and cross-rank
    # steady-state depth differences are not a growth trend.
    by_rank = {
        0: [hot(0, None, stranded=1, roots=["/r/a"])],
        1: [hot(0, None)],
    }
    per_rank = evaluate_live_by_rank(by_rank)
    assert any(
        f.rule == "stranded-drains" and f.evidence.get("rank") == 0
        for f in per_rank
    ), per_rank
    steady = {r: [hot(r + 1, 1.0)] * 3 for r in range(3)}
    assert not evaluate_live_by_rank(steady), "steady state is not growth"

    # snapmend: the replication-underreplicated rule over the repair
    # block of the sample (warn past one interval; critical once the
    # repair stalled past deadline with escalation firing).
    def repair_sample(age, escalations=0, error=None, objs=1):
        s = hot(0, None)
        s["hot_tier"]["repair"] = {
            "interval_s": 2.0,
            "deadline_s": 30.0,
            "underreplicated_objects": objs,
            "underreplicated_bytes": 4096 * objs,
            "oldest_underreplicated_age_s": age,
            "repair_error": error,
            "stats": {"escalated_write_throughs": escalations},
            "membership": {"1": {"alive": False, "generation": 1}},
        }
        return s

    fresh = evaluate_live([repair_sample(0.5)])
    assert not any(
        f.rule == "replication-underreplicated" for f in fresh
    ), fresh
    warned = evaluate_live([repair_sample(5.0)])
    assert any(
        f.rule == "replication-underreplicated" and f.severity == "warn"
        for f in warned
    ), warned
    stalled = evaluate_live([repair_sample(45.0, escalations=2)])
    assert any(
        f.rule == "replication-underreplicated"
        and f.severity == "critical"
        for f in stalled
    ), stalled
    healed = evaluate_live([repair_sample(45.0, objs=0)])
    assert not any(
        f.rule == "replication-underreplicated" for f in healed
    ), healed
    # A dead plane is critical regardless of the FROZEN oldest-age
    # (introspect stops advancing at the crash)...
    dead_young = evaluate_live(
        [repair_sample(5.0, error="SimulatedCrash()")]
    )
    assert any(
        f.rule == "replication-underreplicated"
        and f.severity == "critical"
        for f in dead_young
    ), dead_young
    # ...and even with nothing recorded under-replicated: losses after
    # the crash are invisible to the frozen snapshot.
    dead_blind = evaluate_live(
        [repair_sample(45.0, objs=0, error="SimulatedCrash()")]
    )
    assert any(
        f.rule == "replication-underreplicated"
        and f.severity == "critical"
        and "DEAD" in f.title
        for f in dead_blind
    ), dead_blind
    # snapflight: wire deadline pressure over the sampler's wire block.
    def wire_sample(count, misses=0, margin=0.2, retries=0):
        return {
            "wire": {
                "ops": {
                    "snapwire/put": {
                        "count": count,
                        "deadline_misses": misses,
                        "retries": retries,
                        "margin_p99": margin,
                        "p99_s": margin * 2.0,
                        "deadline_s": 2.0,
                    }
                },
                "deadline_misses": misses,
                "retries": retries,
            }
        }

    healthy_wire = evaluate_live([wire_sample(10)])
    assert not any(
        f.rule == "deadline-margin-collapsing" for f in healthy_wire
    ), healthy_wire
    missed_wire = evaluate_live([wire_sample(10, misses=2)])
    assert any(
        f.rule == "deadline-margin-collapsing"
        and f.severity == "critical"
        for f in missed_wire
    ), missed_wire
    margin_wire = evaluate_live([wire_sample(10, margin=0.85)])
    assert any(
        f.rule == "deadline-margin-collapsing" and f.severity == "warn"
        for f in margin_wire
    ), margin_wire
    # Counters are CUMULATIVE: misses before the window must not fire,
    # and the windowed delta (not the running total) is the evidence.
    old_burst = evaluate_live(
        [wire_sample(100, misses=5), wire_sample(120, misses=5)]
    )
    assert not any(
        f.rule == "deadline-margin-collapsing" for f in old_burst
    ), old_burst
    fresh_burst = [
        f
        for f in evaluate_live(
            [wire_sample(100, misses=5), wire_sample(120, misses=8)]
        )
        if f.rule == "deadline-margin-collapsing"
    ]
    assert fresh_burst and fresh_burst[0].severity == "critical", (
        fresh_burst
    )
    assert fresh_burst[0].evidence["deadline_misses"] == 3, fresh_burst
    # A quiescent window (no new RPCs) is silent even with a sticky
    # high margin_p99 from earlier traffic.
    idle = evaluate_live(
        [wire_sample(100, margin=0.95), wire_sample(100, margin=0.95)]
    )
    assert not any(
        f.rule == "deadline-margin-collapsing" for f in idle
    ), idle
    # snapmem: host-memory pressure + leak drift over the sampler's
    # memory block.
    def mem_sample(used, cap=1 << 20, hwm=None, budget=1 << 30):
        return {
            "memory": {
                "domains": {
                    "t.pool": {
                        "used_bytes": used,
                        "pinned_bytes": used,
                        "cap_bytes": cap,
                        "high_water_bytes": (
                            hwm if hwm is not None else used
                        ),
                        "watch_residual": "pinned",
                    }
                },
                "committed_bytes": used,
                "high_water_bytes": hwm if hwm is not None else used,
                "budget_bytes": budget,
                "headroom_bytes": budget - used,
            }
        }

    healthy_mem = evaluate_live([mem_sample(1000)])
    assert not any(
        f.rule in ("host-memory-overcommit", "memory-leak-suspected")
        for f in healthy_mem
    ), healthy_mem
    # A domain's high-water past its cap: critical on the latest sample
    # (this is what a faultline mem_pressure cap-shrink trips).
    over_cap = evaluate_live([mem_sample(900, cap=512, hwm=900)])
    assert any(
        f.rule == "host-memory-overcommit" and f.severity == "critical"
        for f in over_cap
    ), over_cap
    # Monotonic growth of a residual-watched domain across 3+ samples.
    leak = evaluate_live(
        [mem_sample(0), mem_sample(2 << 20, cap=8 << 20),
         mem_sample(5 << 20, cap=8 << 20)]
    )
    leak = [f for f in leak if f.rule == "memory-leak-suspected"]
    assert leak and leak[0].evidence["domain"] == "t.pool", leak
    # Growth that comes back down is churn, not a leak.
    churn = evaluate_live(
        [mem_sample(0), mem_sample(5 << 20, cap=8 << 20), mem_sample(0)]
    )
    assert not any(
        f.rule == "memory-leak-suspected" for f in churn
    ), churn
    print("slo self-test OK")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m torchsnapshot_tpu_torch.telemetry.slo",
        description="Evaluate checkpointing SLOs (burn rates over the "
        "telemetry ledger, live rules over sampler state).",
    )
    parser.add_argument(
        "path",
        nargs="?",
        help="ledger root URL, a ledger .jsonl file, or a snapshot path",
    )
    parser.add_argument(
        "--samples-dir",
        help="directory of rank<N>.scope.jsonl sampler statusfiles to "
        "run the live rules over",
    )
    parser.add_argument("--json", action="store_true", help="emit JSON")
    parser.add_argument(
        "--self-test",
        action="store_true",
        help="run the built-in fixture checks and exit",
    )
    args = parser.parse_args(argv)
    if args.self_test:
        return _self_test()
    if not args.path:
        parser.error("a ledger path is required (or --self-test)")

    from . import ledger as _ledger

    try:
        records, _skipped = _ledger.read_records(args.path)
    except Exception as e:
        print(f"error reading ledger at {args.path}: {e}", file=sys.stderr)
        return 2
    samples_by_rank: Dict[int, List[Dict[str, Any]]] = {}
    if args.samples_dir:
        from . import sampler as _sampler

        samples_by_rank = _sampler.collect_statusfiles(args.samples_dir)
    if not records and not samples_by_rank:
        print(f"no ledger records or samples at {args.path}", file=sys.stderr)
        return 2
    result = evaluate(records=records, samples_by_rank=samples_by_rank)
    if args.json:
        doc = dict(
            result, findings=[f.as_dict() for f in result["findings"]]
        )
        print(json.dumps(doc, indent=2, sort_keys=True))
    else:
        print(render(result))
    return 0 if result["healthy"] else 1


if __name__ == "__main__":
    sys.exit(main())
