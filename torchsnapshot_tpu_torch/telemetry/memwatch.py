"""snapmem: the process-wide host-memory plane.

The pipeline enforces byte caps in at least seven independent places —
the scheduler's write/read budget cells, the restore staging pool, the
hot tier's ``HostRamStore`` instances and their remote-shadow ledger,
the snapserve ``ByteLRU``, per-client flow control, tenant admission
quotas, and the wiretap ring — each with private accounting and, until
now, no process-wide view. An overcommit across domains (every budget
individually honored, their SUM past what the host can give) or a slow
leak in any one of them was invisible until the OS killed the process.
This module is the registry those budgets reconcile through:

- every byte-capped subsystem registers a :class:`MemDomain` handle
  (name, cap, used, pinned-vs-evictable split) and pushes its
  occupancy as it changes, or registers a **provider** callable that
  is polled at snapshot time (for stores whose mutation points are
  too many to instrument: hot-tier host stores, the wiretap ring);
- :func:`snapshot` produces one consistent cross-domain view under a
  single lock: per-domain occupancy/high-water, aggregate committed
  bytes, and headroom against ``TPUSNAPSHOT_HOST_MEM_BUDGET`` (or the
  detected cgroup limit / host RAM) minus the process RSS;
- :func:`window_begin`/:func:`window_collect` bracket one operation
  (a take, a restore, a bench section) and return the phase-windowed
  memory block flight reports embed — per-domain high-waters inside
  the window, ending occupancy, counter deltas, and any pressure
  forecasts that fired;
- :func:`forecast` is the pre-storm check: before a take/restore's
  allocation burst, compare the plan's byte demand against live
  headroom and emit a warning + counter + trace instant instead of
  letting the burst become an OOM (the doctor's
  ``host-memory-overcommit`` rule reads the recorded event from the
  report's memory block);
- :func:`leak_findings` is the leak/drift sentinel: over a ledger
  series it watches each domain's steady-state residual bytes across
  N completed takes/restores and names the drifting domain
  (``memory-leak-suspected``); the module CLI exposes it with the
  standard exit contract (0 healthy, 1 findings, 2 usage).

Domain semantics:

- ``pinned`` bytes cannot be released by the subsystem on demand
  (leased staging buffers, undrained hot-tier objects, in-flight
  response bytes); ``evictable`` = used - pinned (cache entries, free
  pooled buffers) could be dropped under pressure.
- ``transient`` domains must return to ~zero occupancy between
  operations (scheduler budget cells, flow control); a residual there
  is a leak signal by itself.
- ``watch_residual`` selects what the leak heuristics track for the
  domain: ``"used"`` (transient domains), ``"pinned"`` (pools whose
  free buffers are retained by design but whose leases must come
  back), or ``None`` (caches and stores whose retention is the
  point — excluded from leak detection).
- ``external=True`` marks accounting of bytes that live OUTSIDE this
  process (the hot tier's remote-shadow ledger of replicas parked on
  peers): reported in the domains table for visibility, EXCLUDED from
  ``committed_bytes`` and the headroom math so fleet-wide views do
  not double-count what the owning process already registers.

faultline's ``mem_pressure(domain, cap_bytes)`` schedule rule calls
:func:`force_cap` at a deterministic op boundary: the override shrinks
the REPORTED cap (the subsystem's real budget is untouched), so the
domain's high-water lands above its cap and the doctor/slo memory
rules trip deterministically in tests.

Like every telemetry surface here, the plane is observability, not
protocol: registration and updates are cheap dict/int mutations under
one lock, snapshots never raise into the pipeline (provider errors
drop the provider's domain from that snapshot), and nothing in this
module may fail the operation it measures.
"""

import argparse
import json
import logging
import sys
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..utils.env import env_int
from . import metrics as _m
from .metrics import REGISTRY

logger = logging.getLogger(__name__)

MEMORY_FORMAT_VERSION = 1

# The operator-declared host budget every domain reconciles against.
# Unset: fall back to the cgroup limit (v2 memory.max, then v1
# memory.limit_in_bytes), then total host RAM.
HOST_MEM_BUDGET_ENV_VAR = "TPUSNAPSHOT_HOST_MEM_BUDGET"
# Leak sentinel: how many consecutive same-kind ledger records a
# domain's residual must be non-decreasing across, and the minimum
# total growth (bytes) before the drift is named.
LEAK_RECORDS_ENV_VAR = "TPUSNAPSHOT_MEM_LEAK_RECORDS"
LEAK_MIN_BYTES_ENV_VAR = "TPUSNAPSHOT_MEM_LEAK_MIN_BYTES"
_DEFAULT_LEAK_RECORDS = 5
_DEFAULT_LEAK_MIN_BYTES = 1 << 20

# A window that is never collected (a crashed take) must not leak
# registry state: oldest windows are dropped past this many open.
_MAX_OPEN_WINDOWS = 64

_LOCK = threading.RLock()
_DOMAINS: Dict[str, List["MemDomain"]] = {}
_PROVIDERS: Dict[str, "_Provider"] = {}
_CAP_OVERRIDES: Dict[str, int] = {}
_WINDOWS: Dict[int, "_Window"] = {}
_NEXT_WINDOW_ID = 1
# Lifetime (since reset) high-water of the committed total, and the
# running committed/pinned totals maintained incrementally by domain
# updates (providers fold in at snapshot time only).
_TOTAL_USED = 0
_TOTAL_HWM = 0


class MemDomain:
    """One byte-capped subsystem's handle into the registry.

    Thread-safe through the registry lock. Multiple instances may share
    a name (one per hot-tier host store, one ``ByteLRU`` per server in
    a multi-server test process); snapshots aggregate by name so the
    label cardinality stays bounded.
    """

    __slots__ = (
        "name",
        "transient",
        "watch_residual",
        "external",
        "_cap",
        "_used",
        "_pinned",
        "_hwm",
        "_counters",
        "_alive",
    )

    def __init__(
        self,
        name: str,
        cap_bytes: Optional[int],
        transient: bool,
        watch_residual: Optional[str],
        external: bool,
    ) -> None:
        self.name = name
        self.transient = transient
        self.watch_residual = watch_residual
        self.external = external
        self._cap = cap_bytes
        self._used = 0
        self._pinned = 0
        self._hwm = 0
        self._counters: Dict[str, int] = {}
        self._alive = True

    # ------------------------------------------------------------ updates

    def set_cap(self, cap_bytes: Optional[int]) -> None:
        with _LOCK:
            self._cap = cap_bytes
        _set_domain_gauges(self.name)

    def set_used(
        self, used_bytes: int, pinned_bytes: Optional[int] = None
    ) -> None:
        """Publish the subsystem's current occupancy (absolute, not a
        delta). ``pinned_bytes`` defaults to sticky: unchanged if set
        before, else 0."""
        global _TOTAL_USED, _TOTAL_HWM
        used = max(0, int(used_bytes))
        with _LOCK:
            if not self._alive:
                return
            delta = used - self._used
            self._used = used
            if pinned_bytes is not None:
                self._pinned = max(0, min(used, int(pinned_bytes)))
            else:
                self._pinned = min(self._pinned, used)
            self._hwm = max(self._hwm, used)
            if not self.external:
                _TOTAL_USED += delta
                _TOTAL_HWM = max(_TOTAL_HWM, _TOTAL_USED)
            _window_observe_locked(self.name)
        _set_domain_gauges(self.name)

    def charge(self, nbytes: int, pinned: bool = False) -> None:
        with _LOCK:
            self.set_used(
                self._used + int(nbytes),
                self._pinned + int(nbytes) if pinned else None,
            )

    def release(self, nbytes: int, pinned: bool = False) -> None:
        with _LOCK:
            self.set_used(
                self._used - int(nbytes),
                self._pinned - int(nbytes) if pinned else None,
            )

    def counter(self, key: str, inc: int = 1) -> None:
        """Monotonic per-domain event counters (pool hits/misses/waits,
        cache hits/evictions); windows report their deltas, which is
        what the thrash/misfit doctor rules read."""
        with _LOCK:
            self._counters[key] = self._counters.get(key, 0) + int(inc)

    def close(self) -> None:
        """Unregister (idempotent). The domain's bytes leave the
        committed total — a closed pool/cache no longer holds them."""
        global _TOTAL_USED
        with _LOCK:
            if not self._alive:
                return
            self._alive = False
            if not self.external:
                _TOTAL_USED -= self._used
            insts = _DOMAINS.get(self.name)
            if insts is not None:
                insts = [d for d in insts if d is not self]
                if insts:
                    _DOMAINS[self.name] = insts
                else:
                    _DOMAINS.pop(self.name, None)
            _window_observe_locked(self.name)
        _set_domain_gauges(self.name)

    # ---------------------------------------------------------- inspection

    @property
    def used_bytes(self) -> int:
        with _LOCK:
            return self._used

    @property
    def cap_bytes(self) -> Optional[int]:
        with _LOCK:
            return _CAP_OVERRIDES.get(self.name, self._cap)

    @property
    def high_water_bytes(self) -> int:
        with _LOCK:
            return self._hwm


class _Provider:
    """A polled domain: ``fn() -> (used, pinned, cap)`` sampled at
    snapshot/window boundaries instead of pushed per mutation."""

    __slots__ = (
        "name", "fn", "transient", "watch_residual", "external", "_hwm"
    )

    def __init__(
        self,
        name: str,
        fn: Callable[[], Tuple[int, int, Optional[int]]],
        transient: bool,
        watch_residual: Optional[str],
        external: bool,
    ) -> None:
        self.name = name
        self.fn = fn
        self.transient = transient
        self.watch_residual = watch_residual
        self.external = external
        self._hwm = 0


class _Window:
    __slots__ = (
        "domain_hwm",
        "domain_cap",
        "domain_ext",
        "total_hwm",
        "counters0",
        "forecasts",
    )

    def __init__(self) -> None:
        self.domain_hwm: Dict[str, int] = {}
        # Caps/externality remembered per-domain so a transient domain
        # that closes before collection (a scheduler budget cell dying
        # with its pipeline run) still reports against its cap.
        self.domain_cap: Dict[str, Optional[int]] = {}
        self.domain_ext: Dict[str, bool] = {}
        self.total_hwm = 0
        self.counters0: Dict[str, Dict[str, int]] = {}
        self.forecasts: List[Dict[str, Any]] = []


# ------------------------------------------------------------ registration


def register(
    name: str,
    cap_bytes: Optional[int] = None,
    transient: bool = False,
    watch_residual: Optional[str] = None,
    external: bool = False,
) -> MemDomain:
    """Register one byte-capped subsystem instance. Call
    :meth:`MemDomain.close` when the instance goes away (pool reset,
    server stop); a ``weakref.finalize`` on the owning object is the
    idiomatic safety net."""
    d = MemDomain(name, cap_bytes, transient, watch_residual, external)
    with _LOCK:
        _DOMAINS.setdefault(name, []).append(d)
        # Stamp cap/externality into already-open windows so a domain
        # registered mid-window that never updates (an idle budget
        # cell) still reports its identity at collect time.
        _window_observe_locked(name)
    _set_domain_gauges(name)
    return d


def register_provider(
    name: str,
    fn: Callable[[], Tuple[int, int, Optional[int]]],
    transient: bool = False,
    watch_residual: Optional[str] = None,
    external: bool = False,
) -> None:
    """Register a polled domain (replaces any previous provider of the
    same name). ``fn`` runs under the registry lock at snapshot time
    and must be cheap and non-reentrant; an error drops the domain
    from that snapshot, never raises."""
    with _LOCK:
        _PROVIDERS[name] = _Provider(
            name, fn, transient, watch_residual, external
        )


def unregister_provider(name: str) -> None:
    with _LOCK:
        _PROVIDERS.pop(name, None)


def force_cap(name: str, cap_bytes: int) -> None:
    """faultline's ``mem_pressure`` lever: override the REPORTED cap of
    every current and future instance of ``name`` (the subsystem's
    real budget is untouched) so occupancy lands above cap and the
    memory rules trip deterministically. Cleared by
    :func:`clear_cap_overrides` / :func:`reset`."""
    with _LOCK:
        _CAP_OVERRIDES[name] = int(cap_bytes)
    _set_domain_gauges(name)


def clear_cap_overrides() -> None:
    with _LOCK:
        _CAP_OVERRIDES.clear()


def reset() -> None:
    """Tests only: drop every domain, provider, window, and override."""
    global _TOTAL_USED, _TOTAL_HWM
    with _LOCK:
        _DOMAINS.clear()
        _PROVIDERS.clear()
        _CAP_OVERRIDES.clear()
        _WINDOWS.clear()
        _TOTAL_USED = 0
        _TOTAL_HWM = 0


# ---------------------------------------------------------------- internals


def _agg_locked(name: str) -> Optional[Dict[str, Any]]:
    """Aggregate one name's live instances (lock held). None when the
    name has no live pushed instances."""
    insts = _DOMAINS.get(name)
    if not insts:
        return None
    used = sum(d._used for d in insts)
    pinned = sum(d._pinned for d in insts)
    hwm = sum(d._hwm for d in insts)
    caps = [d._cap for d in insts]
    cap: Optional[int] = (
        sum(c for c in caps if c is not None)
        if any(c is not None for c in caps)
        else None
    )
    if name in _CAP_OVERRIDES:
        cap = _CAP_OVERRIDES[name]
    counters: Dict[str, int] = {}
    for d in insts:
        for k, v in d._counters.items():
            counters[k] = counters.get(k, 0) + v
    first = insts[0]
    return {
        "used_bytes": used,
        "pinned_bytes": pinned,
        "evictable_bytes": used - pinned,
        "cap_bytes": cap,
        "high_water_bytes": hwm,
        "instances": len(insts),
        "transient": first.transient,
        "external": first.external,
        "watch_residual": first.watch_residual,
        "counters": counters,
    }


def _provider_agg_locked(p: _Provider) -> Optional[Dict[str, Any]]:
    try:
        used, pinned, cap = p.fn()
    except Exception:
        logger.debug(
            "memwatch provider %s failed; domain skipped this snapshot",
            p.name,
            exc_info=True,
        )
        return None
    used = max(0, int(used))
    pinned = max(0, min(used, int(pinned)))
    p._hwm = max(p._hwm, used)
    if p.name in _CAP_OVERRIDES:
        cap = _CAP_OVERRIDES[p.name]
    return {
        "used_bytes": used,
        "pinned_bytes": pinned,
        "evictable_bytes": used - pinned,
        "cap_bytes": int(cap) if cap is not None else None,
        "high_water_bytes": p._hwm,
        "instances": 1,
        "transient": p.transient,
        "external": p.external,
        "watch_residual": p.watch_residual,
        "counters": {},
    }


def _domains_locked(poll: bool = True) -> Dict[str, Dict[str, Any]]:
    out: Dict[str, Dict[str, Any]] = {}
    for name in sorted(_DOMAINS):
        agg = _agg_locked(name)
        if agg is not None:
            out[name] = agg
    if poll:
        for name, p in sorted(_PROVIDERS.items()):
            if name in out:
                continue  # a pushed registration shadows the provider
            agg = _provider_agg_locked(p)
            if agg is not None:
                out[name] = agg
    return out


def _residual_of(entry: Dict[str, Any]) -> Optional[int]:
    watch = entry.get("watch_residual")
    if watch == "used":
        return int(entry.get("used_bytes") or 0)
    if watch == "pinned":
        return int(entry.get("pinned_bytes") or 0)
    return None


def _window_observe_locked(name: str) -> None:
    """Raise every open window's high-waters after a domain update
    (lock held). Providers are not observed here — they are polled at
    window boundaries only."""
    if not _WINDOWS:
        return
    agg = _agg_locked(name)
    used = int(agg["used_bytes"]) if agg else 0
    for w in _WINDOWS.values():
        w.domain_hwm[name] = max(w.domain_hwm.get(name, 0), used)
        if agg is not None:
            w.domain_cap[name] = agg["cap_bytes"]
            w.domain_ext[name] = bool(agg["external"])
        w.total_hwm = max(w.total_hwm, _TOTAL_USED)


def _set_domain_gauges(name: str) -> None:
    """Mirror one domain's aggregate into the always-on gauges. Label
    cardinality is bounded by the registered domain names."""
    try:
        with _LOCK:
            agg = _agg_locked(name)
        if agg is None:
            REGISTRY.gauge(_m.MEM_DOMAIN_USED, domain=name).set(0)
            return
        REGISTRY.gauge(_m.MEM_DOMAIN_USED, domain=name).set(
            agg["used_bytes"]
        )
        REGISTRY.gauge(_m.MEM_DOMAIN_HWM, domain=name).set(
            agg["high_water_bytes"]
        )
        if agg["cap_bytes"] is not None:
            REGISTRY.gauge(_m.MEM_DOMAIN_CAP, domain=name).set(
                agg["cap_bytes"]
            )
    except Exception:  # pragma: no cover - observability never raises
        logger.debug("memwatch gauge update failed", exc_info=True)


# ------------------------------------------------------------- host budget


def host_budget_bytes() -> Tuple[Optional[int], str]:
    """``(budget, source)``: the operator knob, else the cgroup limit,
    else total host RAM, else ``(None, "unknown")``."""
    raw = env_int(HOST_MEM_BUDGET_ENV_VAR, 0)
    if raw > 0:
        return raw, "env"
    for path, source in (
        ("/sys/fs/cgroup/memory.max", "cgroup"),
        ("/sys/fs/cgroup/memory/memory.limit_in_bytes", "cgroup"),
    ):
        try:
            with open(path, "r", encoding="ascii") as f:
                text = f.read().strip()
            if text and text != "max":
                limit = int(text)
                # v1 reports an effectively-unlimited sentinel near
                # 2^63; treat anything over 1 PiB as no limit.
                if 0 < limit < (1 << 50):
                    return limit, source
        except (OSError, ValueError):
            continue
    try:
        import psutil

        return int(psutil.virtual_memory().total), "host"
    except (ImportError, OSError, RuntimeError):
        return None, "unknown"


def process_rss_bytes() -> Optional[int]:
    try:
        import psutil

        return int(psutil.Process().memory_info().rss)
    except (ImportError, OSError, RuntimeError):
        return None


def _headroom_fields() -> Dict[str, Any]:
    budget, source = host_budget_bytes()
    rss = process_rss_bytes()
    out: Dict[str, Any] = {
        "budget_bytes": budget,
        "budget_source": source,
        "rss_bytes": rss,
    }
    out["headroom_bytes"] = (
        budget - rss if budget is not None and rss is not None else None
    )
    return out


# --------------------------------------------------------------- snapshots


def snapshot() -> Dict[str, Any]:
    """One consistent cross-domain view: every domain's occupancy and
    lifetime high-water, the committed total (external domains
    excluded), and headroom against the host budget."""
    with _LOCK:
        domains = _domains_locked()
        total_hwm = _TOTAL_HWM
    committed = sum(
        d["used_bytes"] for d in domains.values() if not d["external"]
    )
    pinned = sum(
        d["pinned_bytes"] for d in domains.values() if not d["external"]
    )
    doc: Dict[str, Any] = {
        "format_version": MEMORY_FORMAT_VERSION,
        "domains": domains,
        "committed_bytes": committed,
        "pinned_bytes": pinned,
        "high_water_bytes": max(total_hwm, committed),
    }
    doc.update(_headroom_fields())
    try:
        REGISTRY.gauge(_m.MEM_COMMITTED).set(committed)
        if doc["headroom_bytes"] is not None:
            REGISTRY.gauge(_m.MEM_HEADROOM).set(doc["headroom_bytes"])
    except Exception:  # pragma: no cover - observability never raises
        logger.debug("memwatch headline gauges failed", exc_info=True)
    return doc


def sample_block() -> Dict[str, Any]:
    """Compact block for the runtime sampler and the stats RPCs: the
    per-domain occupancy table plus the headline headroom numbers the
    slo/ops consumers sort by. Empty ``domains`` when nothing is
    registered (callers omit the block then)."""
    snap = snapshot()
    domains = {
        name: {
            k: v
            for k, v in entry.items()
            if k
            in (
                "used_bytes",
                "pinned_bytes",
                "cap_bytes",
                "high_water_bytes",
                "external",
                "watch_residual",
            )
        }
        for name, entry in snap["domains"].items()
    }
    return {
        "domains": domains,
        "committed_bytes": snap["committed_bytes"],
        "high_water_bytes": snap["high_water_bytes"],
        "budget_bytes": snap["budget_bytes"],
        "budget_source": snap["budget_source"],
        "rss_bytes": snap["rss_bytes"],
        "headroom_bytes": snap["headroom_bytes"],
    }


# ----------------------------------------------------------------- windows


def window_begin() -> int:
    """Open a phase window (one per take/restore/bench section).
    Returns an opaque token for :func:`window_collect`. Windows are
    seeded with current occupancy so a domain that never moves inside
    the window still reports its standing bytes as the window
    high-water."""
    global _NEXT_WINDOW_ID
    with _LOCK:
        w = _Window()
        domains = _domains_locked()
        for name, entry in domains.items():
            w.domain_hwm[name] = int(entry["used_bytes"])
            w.domain_cap[name] = entry["cap_bytes"]
            w.domain_ext[name] = bool(entry["external"])
            w.counters0[name] = dict(entry.get("counters") or {})
        w.total_hwm = sum(
            d["used_bytes"] for d in domains.values() if not d["external"]
        )
        token = _NEXT_WINDOW_ID
        _NEXT_WINDOW_ID += 1
        _WINDOWS[token] = w
        while len(_WINDOWS) > _MAX_OPEN_WINDOWS:
            _WINDOWS.pop(min(_WINDOWS))
        return token


def window_collect(token: int) -> Dict[str, Any]:
    """Close a window and return the flight-report memory block:
    per-domain window high-waters + ending occupancy + counter deltas,
    the aggregate window high-water, headroom at close, and any
    pressure forecasts recorded inside the window. ``{}`` when no
    domain was ever registered (the caller omits the block)."""
    with _LOCK:
        w = _WINDOWS.pop(token, None)
        domains = _domains_locked()
        if w is not None:
            # Final poll: provider domains and push domains alike get
            # their closing occupancy folded into the window HWM.
            for name, entry in domains.items():
                w.domain_hwm[name] = max(
                    w.domain_hwm.get(name, 0), int(entry["used_bytes"])
                )
            w.total_hwm = max(
                w.total_hwm,
                sum(
                    d["used_bytes"]
                    for d in domains.values()
                    if not d["external"]
                ),
            )
    if w is None or (not w.domain_hwm and not w.forecasts):
        return {}
    out_domains: Dict[str, Any] = {}
    for name in sorted(w.domain_hwm):
        entry = domains.get(name)
        block: Dict[str, Any] = {
            "high_water_bytes": int(w.domain_hwm[name]),
            "end_used_bytes": int(entry["used_bytes"]) if entry else 0,
            "pinned_bytes": int(entry["pinned_bytes"]) if entry else 0,
            "cap_bytes": (
                entry["cap_bytes"]
                if entry
                else w.domain_cap.get(name)
            ),
        }
        if (entry and entry["external"]) or (
            entry is None and w.domain_ext.get(name)
        ):
            block["external"] = True
        residual = _residual_of(entry) if entry else None
        if residual is not None:
            block["residual_bytes"] = residual
        deltas = {}
        now_counters = (entry or {}).get("counters") or {}
        base = w.counters0.get(name) or {}
        for k in sorted(now_counters):
            d = int(now_counters[k]) - int(base.get(k, 0))
            if d:
                deltas[k] = d
        if deltas:
            block["counters"] = deltas
        out_domains[name] = block
    committed = sum(
        d["used_bytes"] for d in domains.values() if not d["external"]
    )
    block = {
        "format_version": MEMORY_FORMAT_VERSION,
        "domains": out_domains,
        "committed_bytes": committed,
        "high_water_bytes": int(w.total_hwm),
    }
    block.update(_headroom_fields())
    if w.forecasts:
        block["forecasts"] = list(w.forecasts)
    return block


# -------------------------------------------------------------- forecasting


def forecast(
    demand_bytes: int, kind: str = "take"
) -> Optional[Dict[str, Any]]:
    """Pre-storm pressure check: will ``demand_bytes`` of imminent
    allocations fit in live headroom? On predicted overcommit, records
    the event (returned, counted, traced, logged, and folded into
    every open window so the flight report's memory block carries it
    for the ``host-memory-overcommit`` doctor rule) — the deliberate
    alternative to discovering the answer as an OOM kill. Never
    raises; returns None when headroom is unknown or sufficient."""
    try:
        fields = _headroom_fields()
        headroom = fields.get("headroom_bytes")
        demand = max(0, int(demand_bytes))
        if headroom is None:
            return None
        if demand <= headroom:
            REGISTRY.counter(_m.MEM_FORECASTS, verdict="ok").inc()
            return None
        event = {
            "kind": kind,
            "demand_bytes": demand,
            "headroom_bytes": int(headroom),
            "budget_bytes": fields.get("budget_bytes"),
            "rss_bytes": fields.get("rss_bytes"),
            "overcommit": True,
        }
        REGISTRY.counter(_m.MEM_FORECASTS, verdict="overcommit").inc()
        from .. import tracing

        tracing.instant(
            "mem_pressure_forecast",
            kind=kind,
            demand_bytes=demand,
            headroom_bytes=int(headroom),
        )
        logger.warning(
            "memwatch: %s plans %d bytes against %d bytes of host "
            "headroom (budget %s, rss %s) — expect allocation pressure; "
            "lower the per-rank budget or raise %s",
            kind,
            demand,
            int(headroom),
            fields.get("budget_bytes"),
            fields.get("rss_bytes"),
            HOST_MEM_BUDGET_ENV_VAR,
        )
        with _LOCK:
            for w in _WINDOWS.values():
                w.forecasts.append(dict(event))
        return event
    except Exception:  # pragma: no cover - observability never raises
        logger.debug("memwatch forecast failed", exc_info=True)
        return None


# ----------------------------------------------------------- reconciliation


def reconcile(block: Dict[str, Any]) -> List[str]:
    """Violations of the memory block's internal contract (empty list
    = consistent): every non-external domain's window high-water must
    fit its cap (overridden caps excepted — that is the injected
    fault's point), and the aggregate high-water cannot exceed the sum
    of per-domain high-waters (each term is itself a max, so the sum
    bounds any instantaneous total)."""
    problems: List[str] = []
    domains = block.get("domains") or {}
    hwm_sum = 0
    for name, d in sorted(domains.items()):
        if not isinstance(d, dict):
            continue
        hwm = int(d.get("high_water_bytes") or 0)
        if not d.get("external"):
            hwm_sum += hwm
        cap = d.get("cap_bytes")
        with _LOCK:
            overridden = name in _CAP_OVERRIDES
        if cap is not None and not overridden and hwm > int(cap):
            problems.append(
                f"domain {name}: high water {hwm} exceeds cap {cap}"
            )
    agg = int(block.get("high_water_bytes") or 0)
    if agg > hwm_sum:
        problems.append(
            f"aggregate high water {agg} exceeds the sum of per-domain "
            f"high waters {hwm_sum}"
        )
    return problems


# ------------------------------------------------------------ leak sentinel


def leak_findings(
    records: List[Dict[str, Any]],
    min_records: Optional[int] = None,
    min_growth_bytes: Optional[int] = None,
) -> List[Any]:
    """The leak/drift sentinel over a ledger series: for every domain
    with residual tracking, fold the ``memory`` blocks of completed
    take/restore records and name any domain whose residual bytes were
    non-decreasing across the last N records while growing by at least
    the threshold — steady-state bytes that completed operations keep
    not giving back. Returns doctor ``Finding`` objects
    (``memory-leak-suspected``)."""
    from .doctor import Finding

    n = min_records or env_int(LEAK_RECORDS_ENV_VAR, _DEFAULT_LEAK_RECORDS)
    floor = (
        min_growth_bytes
        if min_growth_bytes is not None
        else env_int(LEAK_MIN_BYTES_ENV_VAR, _DEFAULT_LEAK_MIN_BYTES)
    )
    series: Dict[str, List[int]] = {}
    for r in records:
        if r.get("kind") not in ("take", "async_take", "restore"):
            continue
        mem = r.get("memory")
        if not isinstance(mem, dict):
            continue
        for name, d in (mem.get("domains") or {}).items():
            if not isinstance(d, dict):
                continue
            residual = d.get("residual_bytes")
            if residual is None:
                continue
            series.setdefault(name, []).append(int(residual))
    findings: List[Any] = []
    for name in sorted(series):
        vals = series[name]
        if len(vals) < max(2, n):
            continue
        tail = vals[-max(2, n):]
        growth = tail[-1] - tail[0]
        monotonic = all(b >= a for a, b in zip(tail, tail[1:]))
        if monotonic and growth >= max(1, floor) and tail[-1] > 0:
            findings.append(
                Finding(
                    rule="memory-leak-suspected",
                    severity="warn",
                    title=(
                        f"domain {name} retained {tail[-1]} bytes after "
                        f"the last completed operation, up {growth} "
                        f"bytes across {len(tail)} operations"
                    ),
                    evidence={
                        "domain": name,
                        "residual_bytes": tail[-1],
                        "growth_bytes": growth,
                        "records": len(tail),
                        "series_tail": tail,
                    },
                    remediation=(
                        "steady-state residual bytes are growing across "
                        "completed takes/restores — the named domain is "
                        "not releasing what it acquires. Inspect its "
                        "lease/charge call sites; compare the flight "
                        "reports' memory blocks (end_used_bytes per "
                        "domain) for the first operation that stopped "
                        "returning to baseline."
                    ),
                )
            )
    return findings


# ---------------------------------------------------------------- self-test


def _self_test() -> int:
    """Hermetic fixture check of the registry, windows, reconciliation,
    forecasting, cap overrides, and the leak sentinel — what CI smokes
    with no snapshot run."""
    reset()
    try:
        d = register(
            "t.pool", cap_bytes=1000, watch_residual="pinned"
        )
        d.set_used(0, pinned_bytes=0)
        token = window_begin()
        d.charge(600, pinned=True)
        d.release(400, pinned=True)
        d.counter("hits", 3)
        s = snapshot()
        assert s["domains"]["t.pool"]["used_bytes"] == 200, s
        assert s["domains"]["t.pool"]["high_water_bytes"] == 600, s
        assert s["committed_bytes"] == 200, s
        block = window_collect(token)
        assert block["domains"]["t.pool"]["high_water_bytes"] == 600, block
        assert block["domains"]["t.pool"]["end_used_bytes"] == 200, block
        assert block["domains"]["t.pool"]["residual_bytes"] == 200, block
        assert block["domains"]["t.pool"]["counters"] == {"hits": 3}, block
        assert block["high_water_bytes"] == 600, block
        assert reconcile(block) == [], reconcile(block)

        # Provider domains fold in at snapshot time; external domains
        # stay out of the committed total.
        register_provider("t.ring", lambda: (128, 0, 256))
        register_provider(
            "t.shadow", lambda: (4096, 4096, None), external=True
        )
        s = snapshot()
        assert s["domains"]["t.ring"]["used_bytes"] == 128, s
        assert s["domains"]["t.shadow"]["external"], s
        assert s["committed_bytes"] == 200 + 128, s

        # Cap override (the mem_pressure fault): reported cap shrinks,
        # occupancy exceeds it, reconcile still passes (the override
        # is the injected fault, not an accounting bug).
        force_cap("t.pool", 100)
        s = snapshot()
        assert s["domains"]["t.pool"]["cap_bytes"] == 100, s
        assert s["domains"]["t.pool"]["used_bytes"] > 100, s
        tok2 = window_begin()
        over = window_collect(tok2)
        assert reconcile(over) == [], reconcile(over)
        clear_cap_overrides()

        # A genuine over-cap high-water IS a reconciliation failure.
        bad = {
            "domains": {
                "x": {"high_water_bytes": 200, "cap_bytes": 100}
            },
            "high_water_bytes": 200,
        }
        assert any("exceeds cap" in p for p in reconcile(bad)), bad

        # close() retires the bytes.
        d.close()
        assert snapshot()["committed_bytes"] == 128, snapshot()

        # Forecast: an impossible demand records an overcommit event
        # into open windows (budget detection may legitimately be
        # unavailable in exotic sandboxes — then forecast is None by
        # contract and the window block simply has no forecasts).
        tok3 = window_begin()
        ev = forecast(1 << 62, kind="take")
        fblock = window_collect(tok3)
        if ev is not None:
            assert ev["overcommit"] and ev["demand_bytes"] == 1 << 62, ev
            assert fblock.get("forecasts"), fblock

        # Leak sentinel: the injected never-releasing domain is named;
        # a healthy domain that returns to baseline is not.
        def rec(leaky, healthy):
            return {
                "kind": "take",
                "memory": {
                    "domains": {
                        "leaky.domain": {"residual_bytes": leaky},
                        "healthy.pool": {"residual_bytes": healthy},
                    }
                },
            }

        records = [
            rec(1 << 20, 0),
            rec(3 << 20, 1 << 10),
            rec(5 << 20, 0),
            rec(7 << 20, 2 << 10),
            rec(9 << 20, 0),
        ]
        found = leak_findings(records, min_records=5)
        assert len(found) == 1, found
        assert found[0].rule == "memory-leak-suspected", found
        assert found[0].evidence["domain"] == "leaky.domain", found
        flat = leak_findings([rec(1 << 20, 0)] * 8, min_records=5)
        assert not flat, flat  # standing bytes without growth: no leak
        print("memwatch self-test OK")
        return 0
    finally:
        reset()


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m torchsnapshot_tpu_torch.telemetry.memwatch",
        description="Host-memory plane: leak/drift sentinel over a "
        "telemetry ledger series, or a live snapshot of this process's "
        "registered memory domains.",
    )
    parser.add_argument(
        "path",
        nargs="?",
        help="ledger root URL, a ledger .jsonl file, or a snapshot path "
        "to run the leak sentinel over",
    )
    parser.add_argument(
        "--min-records",
        type=int,
        default=None,
        metavar="N",
        help=f"consecutive records a residual must be non-decreasing "
        f"across (default {_DEFAULT_LEAK_RECORDS}, env "
        f"{LEAK_RECORDS_ENV_VAR})",
    )
    parser.add_argument(
        "--min-growth-bytes",
        type=int,
        default=None,
        metavar="B",
        help=f"minimum residual growth before a domain is named "
        f"(default {_DEFAULT_LEAK_MIN_BYTES}, env "
        f"{LEAK_MIN_BYTES_ENV_VAR})",
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
    from .doctor import render_findings

    try:
        records, _skipped = _ledger.read_records(args.path)
    except Exception as e:
        print(f"error reading ledger at {args.path}: {e}", file=sys.stderr)
        return 2
    if not records:
        print(f"no ledger records at {args.path}", file=sys.stderr)
        return 2
    findings = leak_findings(
        records,
        min_records=args.min_records,
        min_growth_bytes=args.min_growth_bytes,
    )
    if args.json:
        print(
            json.dumps(
                {"findings": [f.as_dict() for f in findings]},
                indent=2,
                sort_keys=True,
            )
        )
    else:
        print(render_findings(findings))
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
