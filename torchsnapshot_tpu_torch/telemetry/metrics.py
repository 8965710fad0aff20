"""Always-on, thread-safe metrics primitives (beyond reference parity).

The reference's only instrumentation is a per-rank throughput log line
(SURVEY §5: "Tracing/profiling: none"); ``tracing.py`` spans are opt-in
and write-only. This module is the third leg: cheap counters, gauges,
and log-bucketed histograms that are ALWAYS recording, so "how many
storage retries did this job eat" and "what is the p99 write latency"
are answerable without having had the foresight to enable anything.

Design constraints:

- **Always on, cheap.** One dict lookup plus one short lock hold per
  observation; no background threads, no sockets, no deps. Callers on
  hot paths fetch the metric handle once and reuse it.
- **Thread-safe.** The scheduler observes from the event loop, staging
  observes from executor threads, async-take drains observe from the
  background thread. Every metric guards its state with its own lock
  (SNAP005 ``lockset`` analyzes this module).
- **Bounded cardinality.** Labels identify *types* (op kind, backend,
  phase) — never paths, steps, or ranks-at-pod-scale. A registry is a
  process-wide dict; unbounded label values would grow it forever.
- **Snapshot-able.** :meth:`MetricsRegistry.snapshot` returns plain
  JSON-able data; :func:`diff_snapshots` subtracts two snapshots so the
  flight recorder can attribute per-operation deltas.

Histogram buckets are log2-spaced (…, 0.25, 0.5, 1, 2, 4, …): one
bucket per power of two covers nanoseconds→hours and bytes→terabytes in
~60 buckets with a fixed relative error, with no per-unit tuning.
"""

import math
import threading
from typing import Any, Dict, Iterable, List, Optional, Tuple, Union

LabelsKey = Tuple[Tuple[str, str], ...]


def _labels_key(labels: Dict[str, str]) -> LabelsKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def format_sample_name(name: str, labels_key: LabelsKey) -> str:
    """Prometheus-style sample identity: ``name{k="v",...}`` (bare name
    when label-less). Used as the key in :meth:`MetricsRegistry.snapshot`
    output so snapshots read like exposition lines."""
    if not labels_key:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in labels_key)
    return f"{name}{{{inner}}}"


def bucket_le(value: float) -> float:
    """The log2 bucket upper bound covering ``value`` (inclusive)."""
    if value <= 0:
        return 0.0
    exp = math.ceil(math.log2(value))
    le = float(2.0 ** exp)
    # Guard the edge where float log2 of an exact power rounds down.
    if le < value:
        le = float(2.0 ** (exp + 1))
    return le


class Counter:
    """Monotonic accumulator (float-valued: backoff seconds count too)."""

    def __init__(self) -> None:
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: Union[int, float] = 1) -> None:
        if amount < 0:
            raise ValueError(f"Counter increments must be >= 0, got {amount}")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def collect(self) -> float:
        return self.value


class Gauge:
    """Point-in-time value; ``set_max`` tracks a high-water mark."""

    def __init__(self) -> None:
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: Union[int, float]) -> None:
        with self._lock:
            self._value = float(value)

    def set_max(self, value: Union[int, float]) -> None:
        with self._lock:
            if value > self._value:
                self._value = float(value)

    def add(self, amount: Union[int, float]) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def collect(self) -> float:
        return self.value


class Histogram:
    """Log2-bucketed distribution: sparse ``{le: count}`` + sum + count."""

    def __init__(self) -> None:
        self._buckets: Dict[float, int] = {}
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, value: Union[int, float]) -> None:
        le = bucket_le(float(value))
        with self._lock:
            self._buckets[le] = self._buckets.get(le, 0) + 1
            self._sum += value
            self._count += 1

    def collect(self) -> Dict[str, Any]:
        """``{"count", "sum", "buckets"}`` with buckets keyed by the
        stringified upper bound (JSON object keys must be strings)."""
        with self._lock:
            return {
                "count": self._count,
                "sum": self._sum,
                "buckets": {
                    f"{le:g}": n for le, n in sorted(self._buckets.items())
                },
            }

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum


MetricType = Union[Counter, Gauge, Histogram]


class MetricsRegistry:
    """Process-wide named metric store.

    ``counter``/``gauge``/``histogram`` get-or-create by (name, labels);
    a name is bound to exactly one metric kind — asking for the same
    name as a different kind raises (the exporter could not represent
    it, and the collision is always a bug).
    """

    def __init__(self) -> None:
        self._metrics: Dict[Tuple[str, LabelsKey], MetricType] = {}
        self._kinds: Dict[str, type] = {}
        self._lock = threading.Lock()

    def _get_or_create(
        self, name: str, kind: type, labels: Dict[str, str]
    ) -> MetricType:
        key = (name, _labels_key(labels))
        with self._lock:
            bound = self._kinds.get(name)
            if bound is not None and bound is not kind:
                raise ValueError(
                    f"Metric {name!r} is already registered as "
                    f"{bound.__name__}; cannot re-register as "
                    f"{kind.__name__}"
                )
            metric = self._metrics.get(key)
            if metric is None:
                metric = kind()
                self._metrics[key] = metric
                self._kinds[name] = kind
            return metric

    def counter(self, name: str, **labels: str) -> Counter:
        return self._get_or_create(name, Counter, labels)  # type: ignore[return-value]

    def gauge(self, name: str, **labels: str) -> Gauge:
        return self._get_or_create(name, Gauge, labels)  # type: ignore[return-value]

    def histogram(self, name: str, **labels: str) -> Histogram:
        return self._get_or_create(name, Histogram, labels)  # type: ignore[return-value]

    def kind_of(self, name: str) -> Optional[str]:
        with self._lock:
            kind = self._kinds.get(name)
        return None if kind is None else kind.__name__.lower()

    def items(self) -> List[Tuple[str, LabelsKey, MetricType]]:
        """Stable-ordered (name, labels, metric) triples."""
        with self._lock:
            entries = list(self._metrics.items())
        return sorted(
            ((name, lk, m) for (name, lk), m in entries),
            key=lambda t: (t[0], t[1]),
        )

    def snapshot(self) -> Dict[str, Any]:
        """All current values as plain data, keyed by the Prometheus-style
        sample identity: counters/gauges map to floats, histograms to
        ``{"count", "sum", "buckets"}`` dicts. This is the programmatic
        export API — JSON-able as-is."""
        out: Dict[str, Any] = {}
        for name, labels_key, metric in self.items():
            out[format_sample_name(name, labels_key)] = metric.collect()
        return out

    def reset(self) -> None:
        """Drop every metric (tests; never called by library code)."""
        with self._lock:
            self._metrics.clear()
            self._kinds.clear()


def diff_snapshots(
    before: Dict[str, Any], after: Dict[str, Any]
) -> Dict[str, Any]:
    """``after - before`` per sample, for attributing one operation's
    activity out of process-lifetime totals. Counters/gauges subtract;
    histograms subtract count/sum/buckets. Samples born after ``before``
    diff against zero; zero-delta samples are dropped."""
    out: Dict[str, Any] = {}
    for key, now in after.items():
        prev = before.get(key)
        if isinstance(now, dict):
            prev = prev if isinstance(prev, dict) else {}
            count = now.get("count", 0) - prev.get("count", 0)
            if count == 0:
                continue
            prev_buckets = prev.get("buckets", {})
            buckets = {
                le: n - prev_buckets.get(le, 0)
                for le, n in now.get("buckets", {}).items()
                if n - prev_buckets.get(le, 0)
            }
            out[key] = {
                "count": count,
                "sum": now.get("sum", 0.0) - prev.get("sum", 0.0),
                "buckets": buckets,
            }
        else:
            delta = now - (prev if isinstance(prev, (int, float)) else 0.0)
            if delta:
                out[key] = delta
    return out


def sum_samples(snapshot: Dict[str, Any], name: str) -> float:
    """Sum a scalar metric's samples across all label sets (histograms
    contribute their ``sum``)."""
    total = 0.0
    for key, value in snapshot.items():
        if key == name or key.startswith(name + "{"):
            total += value["sum"] if isinstance(value, dict) else value
    return total


def samples_by_label(
    snapshot: Dict[str, Any], name: str, label: str
) -> Dict[str, Any]:
    """``{label_value: sample}`` for one metric name. Samples lacking the
    label land under ``""``."""
    out: Dict[str, Any] = {}
    prefix = name + "{"
    needle = f'{label}="'
    for key, value in snapshot.items():
        if key != name and not key.startswith(prefix):
            continue
        label_value = ""
        if "{" in key:
            inner = key[key.index("{") + 1 : -1]
            for part in inner.split(","):
                if part.startswith(needle):
                    label_value = part[len(needle) : -1]
                    break
        out[label_value] = value
    return out


# The process-wide default registry: library instrumentation records
# here; ``telemetry.snapshot()`` / the exporters read it.
REGISTRY = MetricsRegistry()


# ------------------------------------------------------------ metric catalog
#
# Every metric the library records, by name (docs/OBSERVABILITY.md is the
# narrative companion). Label sets are bounded by construction: op kinds,
# backend protocols, fault kinds — never paths, steps, or object names.

STORAGE_OP_SECONDS = "tpusnapshot_storage_op_seconds"  # hist {backend,op}
STORAGE_OP_BYTES = "tpusnapshot_storage_op_payload_bytes"  # hist {backend,op}
# Bytes of ranged reads served as views of the stored object (memory://
# only; a whole read hands out the object).
STORAGE_READ_VIEW_BYTES = "tpusnapshot_storage_read_view_bytes_total"  # counter {backend}
STORAGE_RETRIES = "tpusnapshot_storage_retries_total"  # counter {op}
STORAGE_RETRY_BACKOFF = (
    "tpusnapshot_storage_retry_backoff_seconds_total"  # counter {op}
)
FAULTS_INJECTED = "tpusnapshot_faults_injected_total"  # counter {kind}
SCHED_OP_SECONDS = "tpusnapshot_scheduler_op_seconds"  # hist {op}
SCHED_OP_BYTES = "tpusnapshot_scheduler_op_bytes"  # hist {op}
SCHED_STALL_SECONDS = (
    "tpusnapshot_scheduler_budget_stall_seconds_total"  # counter {pipeline}
)
SCHED_BUDGET_HWM = (
    "tpusnapshot_scheduler_budget_high_water_bytes"  # gauge {pipeline}
)
COORD_WAIT_SECONDS = "tpusnapshot_coord_wait_seconds"  # hist {op}
MANAGER_STEP_MARKER_SECONDS = "tpusnapshot_manager_step_marker_seconds"  # hist
MANAGER_PRUNE_SECONDS = "tpusnapshot_manager_prune_seconds"  # hist
MANAGER_STEPS_PRUNED = "tpusnapshot_manager_steps_pruned_total"  # counter
TAKES_TOTAL = "tpusnapshot_takes_total"  # counter {mode}
RESTORES_TOTAL = "tpusnapshot_restores_total"  # counter
GOODPUT_TRAIN_SECONDS = (
    "tpusnapshot_goodput_train_seconds_total"  # counter
)
GOODPUT_CHECKPOINT_SECONDS = (
    "tpusnapshot_goodput_checkpoint_seconds_total"  # counter {mode}
)
GOODPUT_FRACTION = "tpusnapshot_goodput_fraction"  # gauge
LEDGER_RECORDS_TOTAL = "tpusnapshot_ledger_records_total"  # counter {kind}
LEDGER_APPEND_FAILURES = (
    "tpusnapshot_ledger_append_failures_total"  # counter
)
# Hot tier (hottier/): tier={hot|durable} on the read metrics; the
# fallback counter's reason={dead|missing|corrupt} names why a replica
# was unusable — all bounded label sets.
HOT_TIER_READS = "tpusnapshot_hot_tier_reads_total"  # counter {tier}
HOT_TIER_READ_BYTES = (
    "tpusnapshot_hot_tier_read_bytes_total"  # counter {tier}
)
HOT_TIER_REPLICAS = "tpusnapshot_hot_tier_replicas_total"  # counter
HOT_TIER_FALLBACKS = (
    "tpusnapshot_hot_tier_fallbacks_total"  # counter {reason}
)
HOT_TIER_DRAINED_BYTES = (
    "tpusnapshot_hot_tier_drained_bytes_total"  # counter
)
HOT_TIER_EVICTIONS = "tpusnapshot_hot_tier_evictions_total"  # counter
HOT_TIER_WRITE_THROUGH = (
    "tpusnapshot_hot_tier_write_through_total"  # counter
)
HOT_TIER_DEGRADED_PUTS = (
    # Puts that placed >= 1 but < k replicas and had to write through
    # to the durable tier before acknowledging.
    "tpusnapshot_hot_tier_degraded_puts_total"  # counter
)
HOT_TIER_BUFFERED_BYTES = "tpusnapshot_hot_tier_buffered_bytes"  # gauge
# snapwire (hottier/transport.py): the cross-host replication wire.
# pushes = acked replica pushes; bytes = logical payload bytes pushed;
# delta_bytes = bytes that actually crossed the wire after chunk-delta
# + codec (the unchanged-retake case sends <10% of payload); retries =
# transport-failure retry attempts under the jitter/budget policy;
# deadline_misses = RPCs that blew TPUSNAPSHOT_REPLICATION_DEADLINE_S.
HOT_TIER_REPLICATION_PUSHES = (
    "tpusnapshot_hot_tier_replication_pushes_total"  # counter
)
HOT_TIER_REPLICATION_BYTES = (
    "tpusnapshot_hot_tier_replication_bytes_total"  # counter
)
HOT_TIER_REPLICATION_DELTA_BYTES = (
    "tpusnapshot_hot_tier_replication_delta_bytes_total"  # counter
)
HOT_TIER_REPLICATION_RETRIES = (
    "tpusnapshot_hot_tier_replication_retries_total"  # counter
)
HOT_TIER_REPLICATION_DEADLINE_MISSES = (
    "tpusnapshot_hot_tier_replication_deadline_misses_total"  # counter
)
# Durability-lag accounting (snapscope): per-object ack→drained, the
# per-take commit-ack→.tierdown window, and the live undrained bytes of
# committed roots (the RPO exposure the sampler/SLO engine bound).
HOT_TIER_OBJECT_LAG = (
    "tpusnapshot_hot_tier_object_durability_lag_seconds"  # hist
)
HOT_TIER_TAKE_LAG = (
    "tpusnapshot_hot_tier_take_durability_lag_seconds"  # hist
)
HOT_TIER_AT_RISK_BYTES = "tpusnapshot_hot_tier_at_risk_bytes"  # gauge
# snapmend (hottier/repair.py): the self-healing repair plane's
# under-replication accounting — committed undrained bytes below k live
# replicas right now, what the anti-entropy loop repaired, and the
# deadline-bounded escalations to synchronous durable write-through.
HOT_TIER_UNDERREPLICATED_BYTES = (
    "tpusnapshot_hot_tier_underreplicated_bytes"  # gauge
)
HOT_TIER_REPAIR_OBJECTS = (
    "tpusnapshot_hot_tier_repair_objects_total"  # counter
)
HOT_TIER_REPAIR_BYTES = (
    "tpusnapshot_hot_tier_repair_bytes_total"  # counter
)
HOT_TIER_REPAIRS_FAILED = (
    "tpusnapshot_hot_tier_repairs_failed_total"  # counter
)
HOT_TIER_REPAIR_ESCALATIONS = (
    "tpusnapshot_hot_tier_repair_escalations_total"  # counter
)
HOT_TIER_REPAIR_TIME_TO_K = (
    "tpusnapshot_hot_tier_repair_time_to_k_seconds"  # histogram
)
# Live scheduler budget state (snapscope): bytes currently charged
# against the per-process memory budget and whether the pipeline is
# stalled on it RIGHT NOW (0/1) — the point-in-time companions of the
# stall-seconds counter and high-water gauge above.
SCHED_BUDGET_IN_USE = (
    "tpusnapshot_scheduler_budget_in_use_bytes"  # gauge {pipeline}
)
SCHED_BUDGET_STALLED = (
    "tpusnapshot_scheduler_budget_stalled"  # gauge {pipeline}
)
# Runtime sampler (telemetry/sampler.py): samples recorded and sampler
# loop errors swallowed (the crash-isolation contract made visible).
SAMPLER_SAMPLES = "tpusnapshot_sampler_samples_total"  # counter
SAMPLER_ERRORS = "tpusnapshot_sampler_errors_total"  # counter
# Read plane (snapserve/). Server side: request counts by op, content-
# cache events (hit/miss/corrupt/eviction), single-flight collapses
# (requests that piggybacked on another request's backend read),
# manifest-memo hits vs loads, backend ingress vs client egress bytes
# (their ratio is the read-amplification the service exists to kill),
# connected clients, and flow-control stall seconds. Client side:
# remote reads served vs direct-backend fallbacks by reason
# (unreachable — dial/transport failed; down — inside the post-failure
# cooldown window). All label sets bounded.
SNAPSERVE_REQUESTS = "tpusnapshot_snapserve_requests_total"  # counter {op}
SNAPSERVE_CACHE_EVENTS = (
    "tpusnapshot_snapserve_cache_events_total"  # counter {event}
)
SNAPSERVE_SINGLEFLIGHT_COLLAPSES = (
    "tpusnapshot_snapserve_singleflight_collapses_total"  # counter
)
SNAPSERVE_MANIFEST_MEMO = (
    "tpusnapshot_snapserve_manifest_memo_total"  # counter {event}
)
SNAPSERVE_BACKEND_READ_BYTES = (
    "tpusnapshot_snapserve_backend_read_bytes_total"  # counter
)
SNAPSERVE_EGRESS_BYTES = (
    "tpusnapshot_snapserve_egress_bytes_total"  # counter
)
SNAPSERVE_CLIENTS = "tpusnapshot_snapserve_connected_clients"  # gauge
SNAPSERVE_FLOW_STALL_SECONDS = (
    "tpusnapshot_snapserve_flow_control_stall_seconds_total"  # counter
)
SNAPSERVE_REMOTE_READS = (
    "tpusnapshot_snapserve_remote_reads_total"  # counter {result}
)
SNAPSERVE_FALLBACKS = (
    "tpusnapshot_snapserve_fallbacks_total"  # counter {reason}
)

# Read-plane fleet (snapfleet, snapserve/fleet.py) + multi-tenant
# admission. Route outcomes: "owner" (ring owner served), "owner_miss"
# (owner down-latched, a replica served without an attempt), "failover"
# (owner/replica attempted and failed mid-read, the next replica
# served), "fallback" (every member exhausted — the direct-backend
# degradation counted per reason in SNAPSERVE_FALLBACKS too). Probe
# results: up / hung / dead / stale (a refused stale generation).
# Tenant deferrals are over-quota requests parked for a deferred grant
# (never an error); grant-wait seconds accumulate the time they waited.
# Pushdown skipped bytes are content-chunk bytes a shard-sliced restore
# proved it did not need (io_preparer + the `plan` op share the math).
SNAPSERVE_FLEET_ROUTES = (
    "tpusnapshot_snapserve_fleet_routes_total"  # counter {outcome}
)
SNAPSERVE_FLEET_MEMBERS = (
    "tpusnapshot_snapserve_fleet_up_members"  # gauge
)
SNAPSERVE_FLEET_PROBES = (
    "tpusnapshot_snapserve_fleet_probes_total"  # counter {result}
)
SNAPSERVE_TENANT_DEFERRALS = (
    "tpusnapshot_snapserve_tenant_deferrals_total"  # counter
)
SNAPSERVE_TENANT_GRANT_WAIT_SECONDS = (
    "tpusnapshot_snapserve_tenant_grant_wait_seconds_total"  # counter
)
CHUNK_PUSHDOWN_SKIPPED_BYTES = (
    "tpusnapshot_chunk_pushdown_skipped_bytes_total"  # counter
)

# Content-addressed chunk store (chunkstore.py) + codec stage
# (codecs.py): chunk dedup outcomes, logical-vs-stored byte flow, and
# GC activity. `result` on CHUNKSTORE_BYTES is "hit" (logical bytes a
# present chunk saved) or "stored" (post-codec bytes actually written);
# CODEC_BYTES `dir` is "in" (logical) / "out" (encoded) per codec.
CHUNKSTORE_CHUNKS = (
    "tpusnapshot_chunkstore_chunks_total"  # counter {result}
)
CHUNKSTORE_BYTES = (
    "tpusnapshot_chunkstore_bytes_total"  # counter {result}
)
CHUNKSTORE_GC = (
    "tpusnapshot_chunkstore_gc_objects_total"  # counter {action}
)
CODEC_BYTES = "tpusnapshot_codec_bytes_total"  # counter {dir,codec}
CODEC_SECONDS = "tpusnapshot_codec_seconds_total"  # counter {op}
# Streaming restore fast path (fastlane): the staging-buffer pool's
# hit/miss/wait counters plus its retained-free gauge, and the H2D
# overlap engine's transfer accounting — the seconds/bytes the restore
# moved OFF the consume executors onto the overlap engine.
RESTORE_POOL_HITS = (
    "tpusnapshot_restore_staging_pool_hits_total"  # counter
)
RESTORE_POOL_MISSES = (
    "tpusnapshot_restore_staging_pool_misses_total"  # counter
)
RESTORE_POOL_WAITS = (
    "tpusnapshot_restore_staging_pool_waits_total"  # counter
)
RESTORE_POOL_RETAINED = (
    "tpusnapshot_restore_staging_pool_retained_bytes"  # gauge
)
H2D_OVERLAP_SECONDS = (
    "tpusnapshot_h2d_overlap_seconds_total"  # counter
)
H2D_OVERLAP_BYTES = "tpusnapshot_h2d_overlap_bytes_total"  # counter

# Wire observability (wiretap.py, "snapflight"): the shared per-op RPC
# telemetry layer every transport routes through — snapserve server +
# client (incl. the fleet ladder), the snapwire hot-tier transport/peer
# pair, and the repair/membership probes. `transport` is the PROTOCOL.md
# transport owning the frames ("snapserve" | "snapwire"); `op` is the
# wire op; both label sets are bounded by the op registries. Margin is
# the fraction of the per-RPC deadline the call consumed (1.0 == the
# whole budget); misses count RPCs that blew their deadline outright.
# Blackbox dumps count flight-recorder flushes by trigger reason.
WIRE_OP_SECONDS = "tpusnapshot_wire_op_seconds"  # hist {transport,op}
WIRE_OP_BYTES = (
    "tpusnapshot_wire_op_bytes_total"  # counter {transport,op,dir}
)
WIRE_OP_RESULTS = (
    "tpusnapshot_wire_op_results_total"  # counter {transport,op,result}
)
WIRE_DEADLINE_MARGIN = (
    "tpusnapshot_wire_deadline_margin"  # hist {transport,op}
)
WIRE_DEADLINE_MISSES = (
    "tpusnapshot_wire_deadline_misses_total"  # counter {transport,op}
)
WIRE_RETRIES = (
    "tpusnapshot_wire_retry_attempts_total"  # counter {transport,op}
)
WIRE_BLACKBOX_DUMPS = (
    "tpusnapshot_wire_blackbox_dumps_total"  # counter {reason}
)

# Host memory plane (telemetry/memwatch.py, "snapmem"): the process-wide
# memory-domain registry every byte-capped subsystem reconciles through.
# `domain` is the registered domain name ("staging_pool",
# "snapserve.cache", "scheduler.write", ...) — cardinality bounded by
# the registry. Committed/headroom are the cross-domain headline: the
# sum of non-external domain occupancy, and the host budget
# (TPUSNAPSHOT_HOST_MEM_BUDGET | cgroup limit | host RAM) minus process
# RSS. Forecast verdicts are "ok" / "overcommit" — the pre-storm check
# that fires a doctor finding instead of an OOM.
MEM_DOMAIN_USED = (
    "tpusnapshot_mem_domain_used_bytes"  # gauge {domain}
)
MEM_DOMAIN_HWM = (
    "tpusnapshot_mem_domain_high_water_bytes"  # gauge {domain}
)
MEM_DOMAIN_CAP = (
    "tpusnapshot_mem_domain_cap_bytes"  # gauge {domain}
)
MEM_COMMITTED = "tpusnapshot_mem_committed_bytes"  # gauge
MEM_HEADROOM = "tpusnapshot_mem_headroom_bytes"  # gauge
MEM_FORECASTS = (
    "tpusnapshot_mem_pressure_forecasts_total"  # counter {verdict}
)
RESTORE_POOL_LEASED = (
    "tpusnapshot_restore_staging_pool_leased_bytes"  # gauge
)
RESTORE_POOL_HWM = (
    "tpusnapshot_restore_staging_pool_high_water_bytes"  # gauge
)
SNAPSERVE_CACHE_BYTES = (
    "tpusnapshot_snapserve_cache_bytes"  # gauge
)
SNAPSERVE_CACHE_HWM = (
    "tpusnapshot_snapserve_cache_high_water_bytes"  # gauge
)
