"""Hot-tier runtime: replication, ack, background tier-down, reconcile.

The lifecycle the tiered backend implements (ROADMAP item 5):

1. **replicate** — every payload object a take writes is placed,
   k-replicated (``TPUSNAPSHOT_HOT_TIER_K``, default 2), into peer-host
   RAM stores (tier.py). Placement is rendezvous-deterministic: rank
   ``r``'s objects land on hosts ``r, r+1, … r+k-1 (mod world)``, the
   rank/world identities coming from the coord layer; a dead or full
   ring host is substituted by the next spare host around the ring.
2. **ack** — the write returns once k replicas are placed; the take's
   commit protocol (completion markers, metadata-last) proceeds
   unchanged, so ``async_take`` acknowledges at RAM speed. If fewer
   than k replicas could be placed anywhere (dead or full peers), the
   write degrades to a synchronous durable write-through BEFORE the
   ack — an acknowledged object is always either k-replicated in RAM
   or already durable, never resting on a lone RAM copy.
3. **tier-down** — a drainer persists each object to the durable plugin
   in the background and, once a committed root is fully drained,
   records a ``.tierdown`` watermark next to the manifest. A replica
   becomes evictable only after ITS durable write succeeded, so at
   every instant every manifest-referenced byte exists in >= 1 tier —
   the crash matrix enumerates every boundary of this pipeline
   (``hottier.replicate`` / ``hottier.drain`` / ``hottier.tierdown``
   op hooks) and proves it.
4. **restore** — reads prefer the hot tier (fingerprint-verified per
   object; see tier.py) and fall back per-object to the durable tier
   when replicas are dead, missing, or corrupt; fallbacks are counted
   and surface in the flight report / ledger / doctor
   (``hot-tier-degraded``).

Drain modes: ``"background"`` (production — a daemon thread drains as
the take proceeds) and ``"manual"`` (the fault harness — tier-down runs
synchronously via :func:`drain_now`, keeping faultline's op stream
deterministic so crash points replay exactly).

The durable plugin the drainer writes through is resolved via
``url_to_storage_plugin`` with THIS module's wrap bypassed (thread-
local), so it still passes every other installed wrapper — faultline's
FaultPlugin in particular: injected faults and crash points strike the
tier-down writes exactly as they would a foreground write, under the
real retry policy.
"""

import asyncio
import json
import logging
import os
import socket
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Deque, Dict, List, Optional, Set, Tuple

from .. import telemetry, tracing
from ..coord import Coordinator, get_coordinator
from ..io_types import IOReq, emit_storage_op, io_payload
from ..storage_plugin import is_ref_location
from ..telemetry import metrics as _metric_names
from ..utils.env import env_float, env_int
from . import tier

logger = logging.getLogger(__name__)

K_ENV_VAR = "TPUSNAPSHOT_HOT_TIER_K"
_DEFAULT_K = 2
BYTES_ENV_VAR = "TPUSNAPSHOT_HOT_TIER_BYTES"
_DEFAULT_CAPACITY_BYTES = 1 << 30

# The tier-down watermark, recorded next to the manifest once every
# payload object of a committed take reached the durable tier. Dot-
# prefixed (control plane): always written through, never hot-tiered.
TIERDOWN_FNAME = ".tierdown"
_METADATA_FNAME = ".snapshot_metadata"

_DRAIN_MAX_ATTEMPTS = 3

# Thread-local bypass: the drainer resolves the DURABLE plugin through
# url_to_storage_plugin with the hot-tier wrap skipped (other wraps —
# faultline — still apply); see module docstring.
_BYPASS = threading.local()


def is_payload_path(path: str) -> bool:
    """Payload objects ride the hot tier; everything dot-prefixed
    (metadata, markers, telemetry, reports, ``.tierdown``), incremental
    back-link markers (``refs/``), and base references (``@base…``) are
    control plane: written through to the durable tier synchronously —
    they ARE the commit protocol and must obey its durability ordering."""
    return not (
        path.startswith(".")
        or path.startswith("refs/")
        or is_ref_location(path)
    )


class _RootState:
    """Per-snapshot-root drain bookkeeping."""

    def __init__(self) -> None:
        self.pending: Set[str] = set()  # payload paths not yet durable
        # Content tag of the NEWEST bytes written at each pending path —
        # the tag a drain item must match to retire the path. A drain of
        # superseded bytes (the object was re-written while its drain
        # was queued or in flight) is recognized by the mismatch and
        # neither clears pending nor marks the new replicas evictable.
        self.tags: Dict[str, str] = {}
        # Ack timestamp (monotonic) and payload size per pending path:
        # the raw material of the durability-lag accounting (ack →
        # drained per object) and the sampler's at-risk-bytes view.
        self.ack_t: Dict[str, float] = {}
        self.sizes: Dict[str, int] = {}
        # Per-root tier-down progress: bytes enqueued for drain vs bytes
        # already durable (drained or written through) — what the
        # background drain's .progress/tierdown/<rank> records render.
        self.enqueued_bytes = 0
        self.drained_bytes = 0
        self.committed = False  # .snapshot_metadata observed
        self.commit_t: Optional[float] = None  # monotonic, at on_commit
        self.tierdown_done = False
        # Per-take durability lag (commit ack → .tierdown), recorded
        # when the watermark lands; also stamped INTO the watermark.
        self.durability_lag_s: Optional[float] = None
        self.drain_lost = 0  # objects whose every replica died pre-drain
        self.drained_objects = 0  # THIS root's objects tiered down
        self.write_through = 0  # THIS root's objects written through
        # The originating take's snapxray trace id (captured on the
        # take path at enqueue/commit): drain + tierdown spans adopt
        # it, so async tier-down appears in THAT take's causal trace
        # however long after the ack it runs.
        self.trace: Optional[str] = None
        # Items that exhausted their drain attempts: still pending (their
        # hot replicas stay unevictable — the only copy), re-driven by
        # the next drain_now(). wait_drained() reports them truthfully.
        self.stranded: Set[str] = set()
        self.tierdown_attempts = 0
        self.tierdown_stranded = False


class _DrainPluginCache:
    """Size-1 durable-plugin cache for one drain executor: a take's
    items share a root, so backend-client construction/teardown is paid
    per ROOT CHANGE instead of per drained object. close() after an
    item failure (the client may be poisoned) and when the executor
    exits."""

    def __init__(self, runtime: "HotTierRuntime") -> None:
        self._runtime = runtime
        self._root: Optional[str] = None
        self._plugin: Any = None

    def get(self, root: str) -> Any:
        if self._plugin is None or self._root != root:
            self.close()
            self._plugin = self._runtime._durable_plugin(root)
            self._root = root
        return self._plugin

    def close(self) -> None:
        plugin, self._plugin, self._root = self._plugin, None, None
        if plugin is not None:
            try:
                plugin.close()
            except Exception as e:
                logger.warning(f"drain plugin close failed: {e!r}")


class HotTierRuntime:
    """One process's hot-tier brain: placement, stats, the drain queue."""

    def __init__(
        self,
        rank: int,
        world: int,
        k: int,
        capacity_bytes: int,
        drain: str = "background",
    ) -> None:
        if drain not in ("background", "manual"):
            raise ValueError(
                f'drain must be "background" or "manual"; got {drain!r}'
            )
        self.rank = rank
        self.world = max(1, world)
        self.k = max(1, min(k, self.world))
        self.capacity_bytes = capacity_bytes
        self.drain_mode = drain
        self.active = True
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        # Queue items: (root, path, tag, attempts); a watermark-only
        # item is (root, None, None, 0).
        self._queue: Deque[
            Tuple[str, Optional[str], Optional[str], int]
        ] = deque()
        self._roots: Dict[str, _RootState] = {}
        self._inflight = 0
        # In-flight drain items by (root, path): what forget_object /
        # forget_root condition-wait on, so a delete returns only after
        # any drain already holding the object bytes has finished (and
        # its forgotten-root re-check has run).
        self._inflight_items: Dict[Tuple[str, Optional[str]], int] = {}
        # Roots dropped by forget_root. An in-flight drain re-checks
        # this around its durable write: a write that raced a delete is
        # skipped (pre-check) or undone (post-check) so a deleted
        # snapshot's objects are never resurrected as durable garbage.
        self._forgotten: Set[str] = set()
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self.drain_error: Optional[BaseException] = None
        # Drain executor heartbeat (monotonic): refreshed at every loop
        # iteration of the background drainer (and drain_now); the
        # sampler derives "drain event-loop lag" from its age while the
        # queue is non-empty.
        self._drain_beat: Optional[float] = None
        # Tier-down progress publication state, per root (background
        # drain only — manual mode keeps the op stream deterministic
        # for the fault harness): last emit monotonic, seq, started-at.
        self._progress_emit: Dict[str, float] = {}
        self._progress_seq: Dict[str, int] = {}
        self._progress_start: Dict[str, float] = {}
        # Cumulative counters (stats_snapshot/delta power the per-restore
        # tier summary; concurrent operations smear, same contract as the
        # process-wide telemetry counters).
        self._stats: Dict[str, int] = {
            "hot_objects": 0,
            "hot_bytes": 0,
            "fallback_objects": 0,
            "fallback_bytes": 0,
            "replicas": 0,
            "write_through": 0,
            "write_through_bytes": 0,
            "replicated_ack_bytes": 0,
            "degraded_puts": 0,
            "drained_objects": 0,
            "drained_bytes": 0,
            "drain_lost": 0,
        }
        self._peer_failures: Dict[int, int] = {}
        self._reason_counts: Dict[str, int] = {}
        # snapmend repair plane (repair.py): attached by enable_hot_tier
        # when a repair mode is configured; None = no self-healing.
        self.repair_plane: Any = None

    def request_repair_scan(self) -> None:
        """Nudge the repair plane (a degraded read just proved a
        replica is gone — no reason to wait out the full interval)."""
        plane = self.repair_plane
        if plane is not None:
            plane.request_scan()

    # ---------------------------------------------------------- placement

    def _placement_ring(self) -> List[int]:
        """Every host in this rank's deterministic placement order: the
        preferred ring hosts first, then the spares around the ring —
        derived from (rank, world) alone, the same information every
        peer derives from the coord rendezvous."""
        return [(self.rank + i) % self.world for i in range(self.world)]

    def replica_hosts(self) -> List[int]:
        """This rank's PREFERRED replica set: itself plus the next k-1
        hosts in ring order. hot_put tries these first and continues to
        the remaining ring hosts (spares) when they cannot give k
        replicas."""
        return self._placement_ring()[: self.k]

    @staticmethod
    def _key(root: str, path: str) -> str:
        return f"{root.rstrip('/')}/{path}"

    # -------------------------------------------------------- write side

    def hot_put(
        self, root: str, path: str, payload: bytes
    ) -> Tuple[int, str]:
        """Replicate one payload object into peer RAM; returns
        ``(placed, tag)`` — how many replicas were placed and the
        payload's content tag (so callers never recompute or re-read
        it). The ring hosts are tried first; if they cannot give k
        replicas (dead or full peers), placement continues around the
        ring to spare hosts outside the replica set, so a single lost
        peer does not silently halve the replication factor. Fewer than
        k placed = the ack-at-k contract cannot be met from RAM: the
        caller must write through to the durable tier before
        acknowledging (0 placed additionally means no hot copy at all).
        Each replica placement is a storage-op boundary
        (``hottier.replicate``) so the crash-point enumerator can strike
        between replicas."""
        key = self._key(root, path)
        tag = tier.payload_tag(payload)
        placed = 0
        # Runs on the take path: the span inherits the take's ambient
        # trace id, so peer replication shows up inside the take's
        # causal trace (the drain later re-adopts the same id).
        with tracing.span(
            "hottier.replicate", path=path, bytes=len(payload)
        ):
            for i, host in enumerate(self._placement_ring()):
                if i >= self.k and placed >= self.k:
                    break
                emit_storage_op("hottier.replicate", f"host{host}:{path}")
                try:
                    if tier.put_replica(
                        key, host, payload, tag, root.rstrip("/"),
                        capacity_bytes=self.capacity_bytes,
                    ):
                        placed += 1
                except tier.HostLostError:
                    self._note_peer_failure(host, "dead")
        if placed == 0:
            # No replica landed: any stale replicas of an earlier object
            # at this key must not survive a write they no longer match.
            tier.forget_key(key)
        else:
            # The replica set may have changed since the last write of
            # this key (dead ring peer, spare substitution): replicas of
            # superseded bytes on hosts this placement did not revisit
            # would serve stale reads and pin RAM undrained forever.
            tier.drop_stale_replicas(key, tag)
        with self._lock:
            self._stats["replicas"] += placed
        return placed, tag

    def _cancel_queued_locked(
        self, root: str, path: Optional[str] = None
    ) -> None:
        """``_cond`` held: remove queued drain items of ``root`` — one
        path, or (path None) every item of the root, watermark
        sentinels included."""
        self._queue = deque(
            item
            for item in self._queue
            if not (
                item[0] == root and (path is None or item[1] == path)
            )
        )

    def begin_write_through(self, root: str, path: str) -> None:
        """Quiesce the drain pipeline for ``path`` ahead of a
        synchronous durable write-through: the queued drain item (if
        any) is removed and any IN-FLIGHT drain of the path waited out,
        so a drain still holding superseded bytes can never land its
        durable write after (and over) the write-through's. The pending
        entry deliberately SURVIVES until :meth:`note_write_through`
        (success) or :meth:`abort_write_through` (failure) — a failed
        write-through must not silently retire the durability
        obligation. Call BEFORE the durable write."""
        root = root.rstrip("/")
        with self._cond:
            self._cancel_queued_locked(root, path)
            self._cond.notify_all()
            if not self._wait_inflight_locked(
                lambda: self._inflight_items.get((root, path), 0)
            ):
                logger.warning(
                    f"begin_write_through: in-flight drain of "
                    f"{root}/{path} did not finish in time; its durable "
                    f"write may land after the write-through's"
                )

    def abort_write_through(
        self, root: str, path: str, tag: Optional[str], placed: int
    ) -> None:
        """The synchronous durable write of a degraded put FAILED: the
        newest bytes exist only in the ``placed`` (< k) replicas hot_put
        left behind. Re-arm the drain pipeline for them so the
        obligation stays visible — pending/tags point at the newest tag
        and a drain item is re-queued; its hot replicas stay unevictable
        until it lands. With placed == 0 the bytes exist in NO tier and
        the failed write is propagating to the caller (the take fails):
        drop any stale pending entry so it cannot block another object's
        truthful bookkeeping."""
        root_key = root.rstrip("/")
        if placed > 0:
            self.enqueue_drain(root, path, tag)
            return
        with self._cond:
            state = self._roots.get(root_key)
            if state is not None:
                state.pending.discard(path)
                state.tags.pop(path, None)
                state.ack_t.pop(path, None)
                state.sizes.pop(path, None)
                state.stranded.discard(path)
            self._cond.notify_all()

    def note_write_through(
        self,
        root: str,
        path: str,
        tag: Optional[str],
        placed: int,
        nbytes: Optional[int] = None,
    ) -> None:
        """The object was written through to the durable tier
        synchronously before ack — either no replica landed (placed ==
        0) or fewer than k did (a DEGRADED put: durability is restored
        by the synchronous write, at storage speed instead of RAM
        speed). Retires the path's pending entry (the durable tier now
        holds the newest bytes) and marks surviving replicas of ``tag``
        drained, i.e. evictable and still serving hot reads. Call AFTER
        the durable write SUCCEEDED (and after
        :meth:`begin_write_through`)."""
        root = root.rstrip("/")
        key = self._key(root, path)
        degraded = 0 < placed < self.k
        watermark_due = False
        now = time.monotonic()
        with self._cond:
            self._stats["write_through"] += 1
            if nbytes is not None:
                # Acked-bytes attribution for the replication-degraded
                # doctor rule: bytes whose pre-ack durability came from
                # the synchronous write-through path, not k replicas.
                self._stats["write_through_bytes"] += nbytes
            if degraded:
                self._stats["degraded_puts"] += 1
            self._forgotten.discard(root)
            state = self._roots.setdefault(root, _RootState())
            state.write_through += 1
            # Ack→durable lag of a write-through: 0 unless the path
            # carried a pending obligation from an earlier ack (a
            # re-armed degraded write) — the object is durable AT its
            # ack, which is the whole point of the degraded path.
            ack = state.ack_t.pop(path, None)
            object_lag_s = max(0.0, now - ack) if ack is not None else 0.0
            size = state.sizes.pop(path, None)
            if nbytes is None:
                nbytes = size
            if nbytes is not None:
                if path not in state.pending and size is None:
                    # Brand-new write-through (never enqueued): count it
                    # into the root's tier-down progress totals so
                    # bytes_done/total stay commensurable.
                    state.enqueued_bytes += nbytes
                state.drained_bytes += nbytes
            state.pending.discard(path)
            state.tags.pop(path, None)
            state.stranded.discard(path)
            if (
                state.committed
                and not state.pending
                and not state.tierdown_done
            ):
                # This write-through retired the root's last pending
                # object after commit: no drain item will ever visit the
                # watermark path, so enqueue the watermark-only sentinel
                # here (idempotent — _maybe_tierdown checks
                # tierdown_done).
                self._queue.append((root, None, None, 0))
                watermark_due = True
            self._cond.notify_all()
        if tag is not None:
            tier.mark_drained(key, tag)
        telemetry.counter(_metric_names.HOT_TIER_WRITE_THROUGH).inc()
        telemetry.histogram(_metric_names.HOT_TIER_OBJECT_LAG).observe(
            object_lag_s
        )
        if degraded:
            telemetry.counter(_metric_names.HOT_TIER_DEGRADED_PUTS).inc()
            logger.warning(
                f"hot tier degraded: only {placed}/{self.k} replicas of "
                f"{key} could be placed; the object was written through "
                f"to the durable tier before ack"
            )
        if watermark_due and self.drain_mode == "background":
            self._ensure_thread()

    def enqueue_drain(
        self,
        root: str,
        path: str,
        tag: Optional[str] = None,
        nbytes: Optional[int] = None,
        ack_t: Optional[float] = None,
    ) -> None:
        """``nbytes``/``ack_t`` (new writes: the payload size and the
        ack moment, stamped by the plugin) feed the durability-lag and
        at-risk accounting; a re-arm (abort_write_through, stranded
        re-drive) passes neither — the ORIGINAL ack keeps the clock, the
        obligation is as old as the ack that created it."""
        root = root.rstrip("/")
        if tag is None:
            tag = tier.key_tag(self._key(root, path))
        if nbytes is None:
            nbytes = tier.key_size_bytes(self._key(root, path))
        ambient_trace = tracing.current_trace_id()
        with self._cond:
            self._forgotten.discard(root)
            state = self._roots.setdefault(root, _RootState())
            if ambient_trace is not None:
                # Newest take to touch this root owns its drain trace.
                state.trace = ambient_trace
            was_pending = path in state.pending
            prev = state.tags.get(path) if was_pending else None
            was_stranded = path in state.stranded
            state.stranded.discard(path)
            state.pending.add(path)
            if ack_t is not None or path not in state.ack_t:
                state.ack_t[path] = (
                    ack_t if ack_t is not None else time.monotonic()
                )
            if nbytes is not None:
                if not was_pending:
                    state.enqueued_bytes += nbytes
                elif path in state.sizes:
                    # Re-write while pending: the root's total tracks
                    # the NEWEST bytes at each path.
                    state.enqueued_bytes += nbytes - state.sizes[path]
                state.sizes[path] = nbytes
            if tag is not None:
                state.tags[path] = tag
            if was_pending:
                # Only a previously-pending path can have a queued or
                # in-flight item — the brand-new-object hot path (the
                # common case per take) skips the O(queue) scans below.
                if (
                    prev is not None
                    and prev == tag
                    and not was_stranded
                    and (
                        any(
                            i[0] == root and i[1] == path
                            for i in self._queue
                        )
                        or self._inflight_items.get((root, path), 0) > 0
                    )
                ):
                    # Retried write of the same bytes AND a queued or
                    # in-flight item actually owns it: nothing to do.
                    # The ownership check matters — begin_write_through
                    # cancels the queued item while leaving pending/tags
                    # intact, so a same-tag re-arm (abort_write_through)
                    # must re-queue or the obligation would be silently
                    # dropped.
                    return
                # A queued item for this path (if any) names superseded
                # bytes — replace it so the drain persists what the
                # replicas actually hold now. An IN-FLIGHT item of the
                # old bytes is left to finish: its tag mismatch makes it
                # a no-op.
                self._cancel_queued_locked(root, path)
            self._queue.append((root, path, tag, 0))
            self._cond.notify_all()
        if self.drain_mode == "background":
            self._ensure_thread()

    def on_commit(self, root: str) -> None:
        """The root's metadata document was written (the take's commit
        point). Once its pending set drains empty, the ``.tierdown``
        watermark goes down; a root that committed with nothing pending
        (all write-through, or drained already) gets a watermark-only
        queue item."""
        root = root.rstrip("/")
        ambient_trace = tracing.current_trace_id()
        with self._cond:
            self._forgotten.discard(root)
            state = self._roots.setdefault(root, _RootState())
            if ambient_trace is not None:
                state.trace = ambient_trace
            state.committed = True
            if state.commit_t is None:
                # The take's ack point: the durability-lag clock the
                # .tierdown watermark closes starts here.
                state.commit_t = time.monotonic()
            if not state.pending and not state.tierdown_done:
                self._queue.append((root, None, None, 0))
                self._cond.notify_all()
        if self.drain_mode == "background":
            self._ensure_thread()

    # --------------------------------------------------------- read side

    def hot_get(
        self, root: str, path: str, byte_range: Optional[tuple]
    ) -> Tuple[Optional[bytes], bool]:
        """``(payload, attempted)``: the object from the first healthy
        replica, fingerprint-verified — or ``(None, attempted)`` where
        ``attempted`` says whether the hot tier KNEW this object (and
        every replica failed: a genuine degraded fallback) vs. never saw
        it (a cold read that must not count as degradation)."""
        key = self._key(root, path)
        hosts = tier.replica_hosts_for(key)
        if not hosts:
            return None, False
        # Prefer the local host's replica (no network hop in production).
        ordered = sorted(hosts, key=lambda h: h != self.rank)
        for host in ordered:
            try:
                obj = tier.get_replica(key, host)
            except tier.HostLostError:
                self._note_peer_failure(host, "dead")
                continue
            except KeyError:
                self._note_peer_failure(host, "missing")
                continue
            if tier.payload_tag(obj.data) != obj.tag:
                # Corrupt replica: drop it so nothing reads it again.
                self._note_peer_failure(host, "corrupt")
                tier.drop_replica(key, host)
                continue
            data = obj.data
            if byte_range is not None:
                start, end = byte_range
                data = data[start:end]
            with self._lock:
                self._stats["hot_objects"] += 1
                self._stats["hot_bytes"] += len(data)
            telemetry.counter(_metric_names.HOT_TIER_READS, tier="hot").inc()
            telemetry.counter(
                _metric_names.HOT_TIER_READ_BYTES, tier="hot"
            ).inc(len(data))
            return data, True
        with self._lock:
            self._stats["fallback_objects"] += 1
        telemetry.counter(
            _metric_names.HOT_TIER_READS, tier="durable"
        ).inc()
        return None, True

    def note_replicated_ack(self, nbytes: int) -> None:
        """The object was acked AT k replicas (no write-through): the
        other half of the acked-bytes attribution the
        replication-degraded doctor rule splits."""
        with self._lock:
            self._stats["replicated_ack_bytes"] += nbytes

    def replication_stats_begin(self) -> Dict[str, Any]:
        """Token for per-take replication attribution: a snapshot of
        the runtime's put-side stats plus the snapwire transport's
        process totals (transport.wire_stats_snapshot)."""
        from . import transport

        return {
            "rt": self.stats_snapshot(),
            "wire": transport.wire_stats_snapshot(),
        }

    def replication_stats_collect(
        self, token: Optional[Dict[str, Any]]
    ) -> Optional[Dict[str, Any]]:
        """The ``tier.replication`` block for the operation since
        ``token``: pushes/bytes/wire-bytes (and their ratio —
        ``delta_ratio``, the certified unchanged-retake number),
        retries, deadline misses, and the acked-bytes split between
        k-replication and the degraded write-through path. None when
        the window saw no wire traffic at all (the in-process tier's
        behavior is unchanged — this block exists for real
        transports)."""
        from . import transport

        if token is None:
            return None
        rt_now = self.stats_snapshot()
        wire_now = transport.wire_stats_snapshot()

        def _dw(field: str) -> int:
            return int(wire_now.get(field, 0)) - int(
                (token.get("wire") or {}).get(field, 0)
            )

        def _dr(field: str) -> int:
            return int(rt_now.get(field, 0)) - int(
                (token.get("rt") or {}).get(field, 0)
            )

        pushes = _dw("pushes")
        push_failures = _dw("push_failures")
        retries = _dw("retries")
        deadline_misses = _dw("deadline_misses")
        if (
            pushes <= 0
            and push_failures <= 0
            and retries <= 0
            and deadline_misses <= 0
        ):
            return None
        payload_bytes = _dw("payload_bytes")
        wire_bytes = _dw("wire_bytes")
        block: Dict[str, Any] = {
            "pushes": pushes,
            "push_failures": push_failures,
            "payload_bytes": payload_bytes,
            "wire_bytes": wire_bytes,
            "delta_ratio": (
                round(wire_bytes / payload_bytes, 4)
                if payload_bytes > 0
                else None
            ),
            "retries": retries,
            "deadline_misses": deadline_misses,
            "replicated_ack_bytes": _dr("replicated_ack_bytes"),
            "write_through_objects": _dr("write_through"),
            "write_through_bytes": _dr("write_through_bytes"),
            "degraded_puts": _dr("degraded_puts"),
        }
        return block

    def note_fallback_bytes(self, nbytes: int) -> None:
        with self._lock:
            self._stats["fallback_bytes"] += nbytes
        telemetry.counter(
            _metric_names.HOT_TIER_READ_BYTES, tier="durable"
        ).inc(nbytes)

    def _note_peer_failure(self, host: int, reason: str) -> None:
        with self._lock:
            self._peer_failures[host] = self._peer_failures.get(host, 0) + 1
            self._reason_counts[reason] = (
                self._reason_counts.get(reason, 0) + 1
            )
        telemetry.counter(
            _metric_names.HOT_TIER_FALLBACKS, reason=reason
        ).inc()

    # -------------------------------------------------- delete/reconcile

    def _wait_inflight_locked(
        self, count_fn, timeout_s: float = 60.0
    ) -> bool:
        """Condition-wait (``_cond`` held) until ``count_fn()`` drops to
        zero; False on timeout."""
        deadline = time.monotonic() + timeout_s
        while count_fn() > 0:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return False
            self._cond.wait(timeout=min(0.2, remaining))
        return True

    def forget_object(self, root: str, path: str) -> bool:
        """Drop every replica of one object and cancel its pending drain
        (a deleted object must never be resurrected into the durable
        tier by a later drain): the queued item is removed and any
        IN-FLIGHT drain of the object is waited out, so by the time this
        returns the caller's own durable delete cannot be overtaken by a
        racing tier-down write. True if the hot tier held it."""
        key = self._key(root, path)
        existed = tier.forget_key(key)
        root = root.rstrip("/")
        with self._cond:
            state = self._roots.get(root)
            if state is not None and path in state.pending:
                state.pending.discard(path)
                state.tags.pop(path, None)
                state.ack_t.pop(path, None)
                state.sizes.pop(path, None)
                state.stranded.discard(path)
                self._cancel_queued_locked(root, path)
                existed = True
                self._cond.notify_all()
            if not self._wait_inflight_locked(
                lambda: self._inflight_items.get((root, path), 0)
            ):
                logger.warning(
                    f"forget_object: in-flight drain of {root}/{path} "
                    f"did not finish in time; its durable write may "
                    f"land after the delete"
                )
        return existed

    def forget_root(self, root: str) -> int:
        """Drop every buffered object of ``root`` and cancel its drains
        (``Snapshot.delete`` / prune). Queued items are removed, the
        root is latched forgotten (an in-flight drain re-checks the
        latch around its durable write and skips or undoes a write that
        raced the delete), and in-flight items are waited out so the
        caller's durable deletes run strictly after any tier-down write
        already holding the object bytes. Returns objects dropped."""
        root = root.rstrip("/")
        dropped = 0
        for key in tier.keys_for_root(root):
            if tier.forget_key(key):
                dropped += 1
        with self._cond:
            self._roots.pop(root, None)
            self._forgotten.add(root)
            self._cancel_queued_locked(root)
            self._cond.notify_all()
            if self._wait_inflight_locked(
                lambda: sum(
                    c
                    for (r, _p), c in self._inflight_items.items()
                    if r == root
                )
            ):
                # Nothing of this root remains queued or in flight:
                # drop the latch so it neither leaks (one entry per
                # pruned step, forever) nor sabotages a snapshot later
                # re-created at the same root.
                self._forgotten.discard(root)
            else:
                logger.warning(
                    f"forget_root: in-flight drain of {root} did not "
                    f"finish in time; its durable write is undone by "
                    f"the drain's own forgotten-root re-check"
                )
        return dropped

    def object_age_s(self, root: str, path: str) -> Optional[float]:
        return tier.key_age_s(self._key(root, path))

    def object_size_bytes(self, root: str, path: str) -> Optional[int]:
        return tier.key_size_bytes(self._key(root, path))

    # -------------------------------------------------------- drain side

    def _ensure_thread(self) -> None:
        with self._lock:
            if self.drain_error is not None:
                # A crashed drainer stays crashed (the fault model:
                # process death); wait_drained() reports it and only an
                # explicit reset_pending()/new runtime clears it.
                return
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop = False
            self._thread = threading.Thread(
                target=self._drain_loop, name="tpusnapshot-hottier-drain",
                daemon=True,
            )
            self._thread.start()

    def _inflight_begin_locked(
        self, root: str, path: Optional[str]
    ) -> None:
        self._inflight += 1
        item = (root, path)
        self._inflight_items[item] = self._inflight_items.get(item, 0) + 1

    def _inflight_end_locked(self, root: str, path: Optional[str]) -> None:
        self._inflight -= 1
        item = (root, path)
        n = self._inflight_items.get(item, 0) - 1
        if n <= 0:
            self._inflight_items.pop(item, None)
        else:
            self._inflight_items[item] = n
        self._cond.notify_all()

    def _pop_runnable_locked(
        self,
    ) -> Optional[Tuple[str, Optional[str], Optional[str], int]]:
        """``_cond`` held: pop the next item whose path has NO in-flight
        drain (None if the queue is empty or everything is deferred).
        Two executors (the background drainer plus a drain_now
        re-drive) must never drain the same path concurrently — the tag
        ordering between their durable writes would be lost, and a
        stale write landing last would leave superseded bytes durable."""
        for _ in range(len(self._queue)):
            item = self._queue.popleft()
            if (
                item[1] is not None
                and self._inflight_items.get((item[0], item[1]), 0)
            ):
                self._queue.append(item)  # deferred behind the in-flight
                continue
            return item
        return None

    def _drain_loop(self) -> None:
        cache = _DrainPluginCache(self)
        try:
            while True:
                with self._cond:
                    while True:
                        self._drain_beat = time.monotonic()
                        item = self._pop_runnable_locked()
                        if item is not None:
                            break
                        if self._stop and not self._queue:
                            return
                        self._cond.wait(timeout=0.2)
                    root, path, tag, attempts = item
                    self._inflight_begin_locked(root, path)
                try:
                    self._drain_item(
                        root, path, tag, attempts, plugin=cache.get(root)
                    )
                except Exception as e:
                    # Per-item failures (e.g. a transient .tierdown
                    # write error) must not kill the drainer — the
                    # item's own requeue/leave-pending handling already
                    # ran; later items (or drain_now) re-drive what's
                    # left. The cached client may be poisoned: drop it.
                    cache.close()
                    logger.warning(f"hot-tier drain item failed: {e!r}")
                except BaseException as e:  # crashed drainer stays crashed
                    self.drain_error = e
                    logger.warning(f"hot-tier drain died: {e!r}")
                    return  # inflight released by the finally below
                finally:
                    with self._cond:
                        self._inflight_end_locked(root, path)
        finally:
            cache.close()

    def _requeue_stranded(self) -> None:
        """Move every stranded object/watermark back into the queue with
        fresh attempt budgets — drain_now()'s re-drive of work that
        exhausted its attempts (a backend outage that outlasted the
        retry layer)."""
        with self._cond:
            for root, state in self._roots.items():
                for path in sorted(state.stranded):
                    self._queue.append(
                        (root, path, state.tags.get(path), 0)
                    )
                state.stranded.clear()
                if state.tierdown_stranded:
                    state.tierdown_stranded = False
                    state.tierdown_attempts = 0
                    self._queue.append((root, None, None, 0))
            self._cond.notify_all()

    def drain_now(self) -> None:
        """Synchronous tier-down of everything pending — including
        re-driving stranded items (manual mode and tests; also usable to
        force-flush a background drainer). Runs on the caller's thread
        so faultline's op stream stays deterministic; a SimulatedCrash
        propagates to the caller like any crash."""
        self._requeue_stranded()
        cache = _DrainPluginCache(self)
        try:
            while True:
                with self._cond:
                    if not self._queue:
                        # Force-flush contract: another executor (the
                        # background drainer) may still hold an item in
                        # flight — wait it out (it may also requeue on
                        # failure) before reporting flushed.
                        while self._inflight and not self._queue:
                            self._cond.wait(timeout=0.2)
                        if not self._queue:
                            return
                    self._drain_beat = time.monotonic()
                    item = self._pop_runnable_locked()
                    if item is None:
                        # Everything queued is deferred behind an
                        # in-flight drain of the same path (another
                        # executor): wait for it to finish, then re-try.
                        self._cond.wait(timeout=0.2)
                        continue
                    root, path, tag, attempts = item
                    self._inflight_begin_locked(root, path)
                try:
                    self._drain_item(
                        root, path, tag, attempts, plugin=cache.get(root)
                    )
                finally:
                    with self._cond:
                        self._inflight_end_locked(root, path)
        finally:
            cache.close()

    def _durable_plugin(self, root: str):
        from ..storage_plugin import url_to_storage_plugin

        _BYPASS.active = True
        try:
            return url_to_storage_plugin(root)
        finally:
            _BYPASS.active = False

    def _drain_item(
        self,
        root: str,
        path: Optional[str],
        tag: Optional[str],
        attempts: int,
        plugin: Any = None,
    ) -> None:
        owned = plugin is None
        if owned:
            plugin = self._durable_plugin(root)
        try:
            if path is not None:
                self._drain_object(plugin, root, path, tag, attempts)
            self._maybe_tierdown(plugin, root)
        finally:
            if owned:
                plugin.close()

    def _item_current_locked(
        self, root: str, path: str, tag: Optional[str]
    ) -> bool:
        """``_cond`` held: does (root, path, tag) still name work to do?
        False when the root was forgotten (delete), the path's drain was
        canceled, or the object was re-written since this item was
        queued (a newer item owns the path; draining OUR bytes would
        persist stale data)."""
        if root in self._forgotten:
            return False
        state = self._roots.get(root)
        if state is None or path not in state.pending:
            return False
        expected = state.tags.get(path)
        return tag is None or expected is None or expected == tag

    def _drain_object(
        self,
        plugin: Any,
        root: str,
        path: str,
        tag: Optional[str],
        attempts: int,
    ) -> None:
        key = self._key(root, path)
        with self._cond:
            if not self._item_current_locked(root, path, tag):
                return  # canceled or superseded while queued
            state_trace = (
                self._roots[root].trace if root in self._roots else None
            )
        data: Optional[bytes] = None
        data_tag: Optional[str] = tag
        for host in tier.replica_hosts_for(key) or []:
            try:
                obj = tier.get_replica(key, host)
            except (tier.HostLostError, KeyError):
                continue
            if tag is not None and obj.tag != tag:
                continue  # replica of a different write of this object
            if tier.payload_tag(obj.data) == obj.tag:
                data = obj.data
                data_tag = obj.tag
                break
        if data is None:
            requeued = False
            with self._cond:
                if not self._item_current_locked(root, path, tag):
                    return  # superseded mid-probe: not a loss
                if attempts + 1 < _DRAIN_MAX_ATTEMPTS:
                    # No matching replica RIGHT NOW — but a foreground
                    # re-write may be mid-flight between replacing the
                    # replicas (hot_put) and updating the drain
                    # bookkeeping (enqueue_drain / write-through), which
                    # would make this item stale, not the bytes lost.
                    # Re-drive instead of declaring loss; a real loss is
                    # declared once the budget is spent with the
                    # bookkeeping still naming this item.
                    self._queue.append((root, path, tag, attempts + 1))
                    self._cond.notify_all()
                    requeued = True
                else:
                    # Every replica died before tier-down: the bytes
                    # are gone. The loss is counted and the pending
                    # entry retired — the root can never tier down
                    # clean, and a restore of this object will fail
                    # loudly at the durable tier (detect, not silent
                    # corruption).
                    self._stats["drain_lost"] += 1
                    state = self._roots.get(root)
                    if state is not None:
                        state.pending.discard(path)
                        state.tags.pop(path, None)
                        state.ack_t.pop(path, None)
                        state.sizes.pop(path, None)
                        state.drain_lost += 1
            if requeued:
                # Give a mid-flight foreground re-write time to land
                # its bookkeeping before the re-probe — back-to-back
                # re-pops would burn the whole budget in microseconds
                # and declare a phantom loss.
                time.sleep(0.01 * (attempts + 1))
            else:
                logger.warning(
                    f"hot-tier drain: every replica of {key} lost before "
                    f"tier-down; the object was never persisted"
                )
            return
        emit_storage_op("hottier.drain", path)
        try:
            # The drain executor runs on its own thread long after the
            # take returned: adopt the ORIGINATING take's trace id so
            # this tier-down write appears in that take's causal trace.
            with tracing.adopt_trace(state_trace), tracing.span(
                "hottier.drain", path=path, bytes=len(data)
            ):
                asyncio.run(plugin.write(IOReq(path=path, data=data)))
        except Exception as e:
            if attempts + 1 < _DRAIN_MAX_ATTEMPTS:
                with self._cond:
                    self._queue.append((root, path, tag, attempts + 1))
                    self._cond.notify_all()
                logger.warning(
                    f"hot-tier drain of {key} failed "
                    f"(attempt {attempts + 1}): {e!r}; requeued"
                )
                return
            # Out of attempts: the object stays pending AND is marked
            # stranded — its hot replicas stay unevictable (the only
            # copy), wait_drained() reports the root un-flushed, and the
            # next drain_now() re-drives it; the root's .tierdown is
            # withheld, which is the truthful state.
            with self._cond:
                state = self._roots.get(root)
                if state is not None:
                    state.stranded.add(path)
                self._cond.notify_all()
            logger.warning(
                f"hot-tier drain of {key} failed permanently: {e!r}; "
                f"object remains hot-tier-only (re-driven by the next "
                f"drain_now; no .tierdown until it lands)"
            )
            return
        # Only replicas of the bytes actually written become evictable:
        # a re-write racing this drain keeps ITS replicas pinned until
        # its own item lands.
        tier.mark_drained(key, data_tag)
        now = time.monotonic()
        object_lag_s: Optional[float] = None
        with self._cond:
            forgotten = root in self._forgotten
            state = self._roots.get(root)
            # Retire the pending entry only if the ITEM tag is still the
            # path's expected tag (strict: a popped/changed entry means
            # the write raced a delete or supersession and a newer item
            # — deferred behind us by _pop_runnable_locked — owns it).
            current = state is not None and state.tags.get(path) == tag
            if current and not forgotten:
                # An undone (deleted-root) or superseded (re-converged
                # and counted by its own item) write must not inflate
                # the tier-down throughput accounting.
                self._stats["drained_objects"] += 1
                self._stats["drained_bytes"] += len(data)
            if current:
                state.pending.discard(path)
                state.tags.pop(path, None)
                ack = state.ack_t.pop(path, None)
                state.sizes.pop(path, None)
                if ack is not None:
                    object_lag_s = max(0.0, now - ack)
                state.drained_bytes += len(data)
                state.drained_objects += 1
        if current and not forgotten:
            telemetry.counter(_metric_names.HOT_TIER_DRAINED_BYTES).inc(
                len(data)
            )
            if object_lag_s is not None:
                # The per-object durability-lag distribution: how long
                # each acked object rested on RAM replicas alone.
                telemetry.histogram(
                    _metric_names.HOT_TIER_OBJECT_LAG
                ).observe(object_lag_s)
            self._publish_drain_progress(plugin, root)
        if forgotten:
            # The snapshot was deleted while our durable write was in
            # flight: the object must not outlive it as durable garbage.
            try:
                asyncio.run(plugin.delete(path))
            except Exception as e:
                logger.warning(
                    f"hot-tier drain: undo of {key} after delete "
                    f"failed: {e!r}"
                )
        elif not current:
            # Our write raced a supersession whose bookkeeping already
            # retired the path (e.g. a write-through that outlasted
            # begin_write_through's bounded wait): the durable tier may
            # now hold OUR superseded bytes on top of the newer write's.
            # Re-converge on the newest replicas (idempotent — if the
            # newer item is simply deferred behind us, enqueue_drain
            # dedupes against it).
            newest = tier.key_tag(key)
            if newest is not None and newest != tag:
                self.enqueue_drain(root, path, newest)

    def _maybe_tierdown(self, plugin: Any, root: str) -> None:
        with self._cond:
            state = self._roots.get(root)
            ready = (
                state is not None
                and state.committed
                and not state.pending
                and not state.tierdown_done
                and state.drain_lost == 0
            )
            if not ready:
                return
            drained_objects = state.drained_objects
            write_through = state.write_through
            commit_t = state.commit_t
            state_trace = state.trace
        # Per-take durability lag: the take's ack (its metadata commit,
        # observed by on_commit) → this watermark. THE number that
        # bounds the RPO exposure window the hot tier opened.
        durability_lag_s = (
            round(max(0.0, time.monotonic() - commit_t), 6)
            if commit_t is not None
            else None
        )
        emit_storage_op("hottier.tierdown", TIERDOWN_FNAME)
        # Counts are THIS root's and THIS process's: in a multi-rank job
        # every metadata-writing process records its own drain progress;
        # the watermark does not (yet) assert other ranks' objects
        # drained — cross-rank drain coordination is future work, and
        # the explicit scope field keeps operators/sweeps honest.
        doc = {
            "format_version": 1,
            "drained_objects": drained_objects,
            "write_through_objects": write_through,
            "durability_lag_s": durability_lag_s,
            "scope": "process",
            "ts_epoch_s": round(time.time(), 3),
        }
        try:
            with tracing.adopt_trace(state_trace), tracing.span(
                "hottier.tierdown", root=root
            ):
                asyncio.run(
                    plugin.write(
                        IOReq(
                            path=TIERDOWN_FNAME,
                            data=json.dumps(doc, sort_keys=True).encode(
                                "utf-8"
                            ),
                        )
                    )
                )
        except Exception as e:
            # A failed watermark write must leave a re-drive trigger: the
            # root is fully drained, so no object item will ever call
            # back here — requeue the watermark-only sentinel (bounded
            # attempts, then stranded for the next drain_now()).
            with self._cond:
                state = self._roots.get(root)
                if state is not None:
                    state.tierdown_attempts += 1
                    if state.tierdown_attempts < _DRAIN_MAX_ATTEMPTS:
                        self._queue.append((root, None, None, 0))
                    else:
                        state.tierdown_stranded = True
                self._cond.notify_all()
            logger.warning(
                f"hot-tier .tierdown write for {root} failed: {e!r}; "
                f"will re-drive"
            )
            return
        with self._cond:
            forgotten = root in self._forgotten
            state = self._roots.get(root)
            if state is not None:
                state.tierdown_done = True
                state.durability_lag_s = durability_lag_s
            self._cond.notify_all()
        if forgotten:
            # Deleted mid-watermark-write: take the marker back out.
            try:
                asyncio.run(plugin.delete(TIERDOWN_FNAME))
            except Exception as e:
                logger.warning(
                    f"hot-tier drain: undo of {root}/{TIERDOWN_FNAME} "
                    f"after delete failed: {e!r}"
                )
            return
        if durability_lag_s is not None:
            telemetry.histogram(_metric_names.HOT_TIER_TAKE_LAG).observe(
                durability_lag_s
            )
        # Post-watermark observability fan-out, all best-effort: stamp
        # durability_lag_s into the take's flight report, append the
        # drain event record to the telemetry ledger (the "null until
        # drained" contract — ledger.py), and retire the tier-down
        # progress record. None of it may fail the drain.
        self._annotate_report_lag(plugin, durability_lag_s)
        self._append_tierdown_ledger(
            root, durability_lag_s, drained_objects, write_through
        )
        self._retire_drain_progress(plugin, root)

    # ------------------------------------------- tier-down observability
    #
    # Everything below is observability fan-out from the drain pipeline:
    # best-effort by contract (an Exception is logged, never propagated
    # — a SimulatedCrash still rips through like everywhere else), and
    # the live-progress records are BACKGROUND-mode only so the manual
    # fault harness keeps its deterministic op stream.

    _DRAIN_PROGRESS_TAKE_ID = "tierdown"

    def _drain_progress_path(self) -> str:
        return f".progress/{self._DRAIN_PROGRESS_TAKE_ID}/{self.rank}"

    def _publish_drain_progress(
        self, plugin: Any, root: str, force: bool = False
    ) -> None:
        """Publish ``root``'s tier-down progress record (phase
        ``tierdown``, bytes drained/total) to
        ``.progress/tierdown/<rank>`` in the root's own prefix — the
        same transport and lifecycle as take/restore progress records,
        so ``watch``/``ops`` show the background drain instead of going
        dark after commit. Rate-limited on the progress cadence;
        swept by :meth:`_retire_drain_progress` at the watermark, by
        ``Snapshot.delete``, and by ``reconcile`` like all ``.progress``
        debris."""
        if self.drain_mode != "background":
            return
        from ..telemetry import progress as liveprog

        now = time.monotonic()
        if not force:
            last = self._progress_emit.get(root, 0.0)
            if now - last < liveprog._interval_s():
                return
        self._progress_emit[root] = now
        with self._cond:
            state = self._roots.get(root)
            if state is None:
                return
            seq = self._progress_seq.get(root, 0) + 1
            self._progress_seq[root] = seq
            started = self._progress_start.setdefault(root, time.time())
            record = {
                "format_version": liveprog.PROGRESS_FORMAT_VERSION,
                "kind": "tierdown",
                "path": root,
                "take_id": self._DRAIN_PROGRESS_TAKE_ID,
                "rank": self.rank,
                "world_size": self.world,
                "phase": "tierdown",
                "bytes_done": state.drained_bytes,
                "bytes_total": state.enqueued_bytes or None,
                "ops": {
                    "drain": state.drained_objects,
                    "write_through": state.write_through,
                },
                "retries": 0,
                "seq": seq,
                "host": socket.gethostname(),
                "pid": os.getpid(),
                "started_at": round(started, 3),
                "heartbeat_at": round(time.time(), 3),
            }
        try:
            asyncio.run(
                plugin.write(
                    IOReq(
                        path=self._drain_progress_path(),
                        data=json.dumps(record, sort_keys=True).encode(
                            "utf-8"
                        ),
                    )
                )
            )
        except Exception as e:
            logger.debug("tier-down progress write failed: %r", e)

    def _retire_drain_progress(self, plugin: Any, root: str) -> None:
        """The root fully tiered down: its progress record describes a
        finished operation — remove it (the drainer is the record's sole
        writer, so unlike take records there is no later sweep point and
        no republish race)."""
        if self.drain_mode != "background":
            return
        self._progress_emit.pop(root, None)
        self._progress_seq.pop(root, None)
        self._progress_start.pop(root, None)
        try:
            asyncio.run(plugin.delete(self._drain_progress_path()))
        except Exception as e:
            logger.debug("tier-down progress cleanup failed: %r", e)

    def _annotate_report_lag(
        self, plugin: Any, durability_lag_s: Optional[float]
    ) -> None:
        """Back-fill ``durability_lag_s`` into the committed take's
        ``.report.json`` so ``inspect --doctor`` (the
        ``durability-lag-above-budget`` rule) sees the closed exposure
        window. Best-effort: the report may not exist yet (a fast drain
        racing the commit route's report write) — the ledger's tierdown
        record still carries the number."""
        if durability_lag_s is None:
            return
        from ..io_types import io_payload as _io_payload
        from ..telemetry import report as flight

        try:

            async def _annotate() -> None:
                io_req = IOReq(path=flight.REPORT_FNAME)
                await plugin.read(io_req)
                doc = json.loads(bytes(_io_payload(io_req)).decode("utf-8"))
                doc["durability_lag_s"] = durability_lag_s
                await plugin.write(
                    IOReq(
                        path=flight.REPORT_FNAME,
                        data=json.dumps(
                            doc, indent=2, sort_keys=True
                        ).encode("utf-8"),
                    )
                )

            asyncio.run(_annotate())
        except Exception as e:
            logger.debug(
                "durability-lag report annotation skipped: %r", e
            )

    def _append_tierdown_ledger(
        self,
        root: str,
        durability_lag_s: Optional[float],
        drained_objects: int,
        write_through: int,
    ) -> None:
        """Append the drain event record (kind ``tierdown``) to the
        telemetry ledger: the take's own digest carries
        ``durability_lag_s: null`` (it is written at commit, when the
        window is still open); this record closes it."""
        from ..telemetry import ledger as runledger

        try:
            runledger.append_for_snapshot(
                root,
                runledger.tierdown_record(
                    path=root,
                    durability_lag_s=durability_lag_s,
                    drained_objects=drained_objects,
                    write_through_objects=write_through,
                ),
            )
        except Exception as e:
            telemetry.counter(_metric_names.LEDGER_APPEND_FAILURES).inc()
            logger.warning("tierdown ledger append failed: %r", e)

    # ----------------------------------------------------- introspection

    def introspect(self) -> Dict[str, Any]:
        """Lock-consistent snapshot of the drain pipeline's live state —
        what the runtime sampler (telemetry/sampler.py), the ops view,
        and tests consume. One pass under the runtime lock (per-host
        occupancy is read from the tier's own lock afterwards, so the
        two sections are each self-consistent)."""
        now = time.monotonic()
        with self._cond:
            queued_objects = sum(
                1 for it in self._queue if it[1] is not None
            )
            queued_watermarks = len(self._queue) - queued_objects
            roots: Dict[str, Any] = {}
            at_risk_bytes = 0
            at_risk_by_root: Dict[str, int] = {}
            pending_objects = 0
            stranded_objects = 0
            stranded_roots: List[str] = []
            oldest_age: Optional[float] = None
            oldest_at_risk_age: Optional[float] = None
            for root, st in sorted(self._roots.items()):
                pending_bytes = sum(
                    st.sizes.get(p, 0) for p in st.pending
                )
                pending_objects += len(st.pending)
                stranded_objects += len(st.stranded)
                if st.stranded or st.tierdown_stranded:
                    stranded_roots.append(root)
                at_risk = st.committed and not st.tierdown_done
                if at_risk:
                    at_risk_bytes += pending_bytes
                    if pending_bytes:
                        at_risk_by_root[root] = pending_bytes
                for p in st.pending:
                    t = st.ack_t.get(p)
                    if t is not None:
                        age = max(0.0, now - t)
                        if oldest_age is None or age > oldest_age:
                            oldest_age = age
                        # The RPO-relevant age is COMMITTED roots only:
                        # an in-flight take's pending objects are not
                        # an acked checkpoint's exposure window, and
                        # pairing their age with another root's at-risk
                        # bytes would fire a false lag alert.
                        if at_risk and (
                            oldest_at_risk_age is None
                            or age > oldest_at_risk_age
                        ):
                            oldest_at_risk_age = age
                roots[root] = {
                    "committed": st.committed,
                    "tierdown_done": st.tierdown_done,
                    "pending_objects": len(st.pending),
                    "pending_bytes": pending_bytes,
                    "stranded_objects": len(st.stranded),
                    "tierdown_stranded": st.tierdown_stranded,
                    "drain_lost": st.drain_lost,
                    "drained_bytes": st.drained_bytes,
                    "enqueued_bytes": st.enqueued_bytes,
                    "durability_lag_s": st.durability_lag_s,
                }
            beat = self._drain_beat
            plane = self.repair_plane
            doc: Dict[str, Any] = {
                "rank": self.rank,
                "world": self.world,
                "k": self.k,
                "drain_mode": self.drain_mode,
                "queue_depth": queued_objects,
                "queued_watermarks": queued_watermarks,
                "inflight": self._inflight,
                "pending_objects": pending_objects,
                "oldest_pending_age_s": (
                    round(oldest_age, 3) if oldest_age is not None else None
                ),
                "oldest_at_risk_age_s": (
                    round(oldest_at_risk_age, 3)
                    if oldest_at_risk_age is not None
                    else None
                ),
                "at_risk_bytes": at_risk_bytes,
                "at_risk_by_root": at_risk_by_root,
                "stranded_objects": stranded_objects,
                "stranded_roots": stranded_roots,
                "drain_error": (
                    repr(self.drain_error)
                    if self.drain_error is not None
                    else None
                ),
                "drain_heartbeat_age_s": (
                    round(max(0.0, now - beat), 3)
                    if beat is not None
                    else None
                ),
                "roots": roots,
                "stats": dict(self._stats),
            }
        doc["hosts"] = {
            str(h): occ for h, occ in tier.host_occupancy().items()
        }
        # snapmend: the repair/membership block (under-replication
        # accounting, per-host generation + liveness, repair stats) —
        # the sampler publishes it and the replication-underreplicated
        # live rule and the ops CLI read it.
        doc["repair"] = plane.introspect() if plane is not None else None
        telemetry.gauge(_metric_names.HOT_TIER_AT_RISK_BYTES).set(
            float(at_risk_bytes)
        )
        return doc

    def _dirty_pending_locked(self) -> bool:
        """``_cond`` held: is any pending path NOT accounted for by
        stranded? Such a path is owned by a queued/in-flight item or a
        foreground degraded write-through (queue-invisible between
        begin_write_through and note/abort) — work that is still
        resolving and must keep wait_drained waiting. Stranded paths
        are terminal until a drain_now() re-drive, so they exit the
        wait and fail the final cleanliness check instead."""
        return any(
            s.pending - s.stranded for s in self._roots.values()
        )

    def wait_drained(self, timeout_s: float = 120.0) -> bool:
        """Block until the drain queue is empty, nothing is in flight,
        and no non-stranded pending work remains (including a degraded
        write-through mid-flight on the foreground, which owns no queue
        item); True only on a genuinely clean flush — False on timeout,
        a dead drainer, or STRANDED work (objects/watermarks that
        exhausted their attempts and await a drain_now() re-drive):
        claiming success while committed bytes are still hot-tier-only
        would let a caller tear the tier down over the only copy."""
        deadline = time.monotonic() + timeout_s
        with self._cond:
            while (
                self._queue
                or self._inflight
                or self._dirty_pending_locked()
            ):
                if self.drain_error is not None:
                    return False
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(timeout=min(0.2, remaining))
            return not any(
                s.stranded or s.tierdown_stranded
                for s in self._roots.values()
            )

    def stop(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        thread = self._thread
        if thread is not None and thread.is_alive():
            thread.join(timeout=10.0)

    def root_state(self, root: str) -> Optional[_RootState]:
        with self._lock:
            return self._roots.get(root.rstrip("/"))

    # ------------------------------------------------------------- stats

    def stats_snapshot(self) -> Dict[str, Any]:
        with self._lock:
            snap: Dict[str, Any] = dict(self._stats)
            snap["peers"] = dict(self._peer_failures)
            snap["reasons"] = dict(self._reason_counts)
            return snap


# ---------------------------------------------------------- process-global

_RUNTIME: Optional[HotTierRuntime] = None
_PREV_HOOK: Any = None
_ENABLE_LOCK = threading.Lock()


def runtime() -> Optional[HotTierRuntime]:
    return _RUNTIME


def is_enabled() -> bool:
    return _RUNTIME is not None and _RUNTIME.active


def enable_hot_tier(
    rank: Optional[int] = None,
    world: Optional[int] = None,
    k: Optional[int] = None,
    capacity_bytes: Optional[int] = None,
    drain: str = "background",
    repair: Optional[str] = None,
    coord: Optional[Coordinator] = None,
) -> HotTierRuntime:
    """Turn the hot tier on process-wide: every storage plugin resolved
    from here on is wrapped in a :class:`~.plugin.TieredPlugin` (the
    same ``set_plugin_wrap_hook`` seam faultline uses; hooks chain, so
    enabling inside a faultline ``inject`` block — or vice versa —
    composes). ``rank``/``world`` default to the coord layer's identity
    (the ``torch.distributed`` job's, single-host otherwise); ``k`` and
    ``capacity_bytes`` default to ``TPUSNAPSHOT_HOT_TIER_K`` (2) and
    ``TPUSNAPSHOT_HOT_TIER_BYTES`` (1 GiB per host).

    ``repair`` attaches the snapmend self-healing plane (repair.py):
    ``"background"`` supervises peers and repairs under-replication on
    a daemon thread every ``TPUSNAPSHOT_REPAIR_INTERVAL_S``;
    ``"manual"`` constructs the plane but leaves ``repair_tick()`` to
    the caller (the fault harness's deterministic form); ``"off"``
    (the default, or ``TPUSNAPSHOT_REPAIR_MODE`` when unset here)
    disables it."""
    global _RUNTIME, _PREV_HOOK
    from .. import storage_plugin as _sp
    from .plugin import TieredPlugin
    from .repair import MODE_ENV_VAR, RepairPlane

    with _ENABLE_LOCK:
        if _RUNTIME is not None:
            raise RuntimeError(
                "hot tier is already enabled; disable_hot_tier() first"
            )
        if rank is None or world is None:
            coordinator = get_coordinator(coord)
            rank = coordinator.get_rank() if rank is None else rank
            world = (
                coordinator.get_world_size() if world is None else world
            )
        rt = HotTierRuntime(
            rank=rank,
            world=world,
            k=k if k is not None else env_int(K_ENV_VAR, _DEFAULT_K),
            capacity_bytes=(
                capacity_bytes
                if capacity_bytes is not None
                else env_int(BYTES_ENV_VAR, _DEFAULT_CAPACITY_BYTES)
            ),
            drain=drain,
        )
        if repair is None:
            repair = (
                os.environ.get(MODE_ENV_VAR) or "off"
            ).strip().lower() or "off"
        if repair != "off":
            rt.repair_plane = RepairPlane(rt, mode=repair)

        def _hook(plugin, url):
            base = (
                _PREV_HOOK(plugin, url) if _PREV_HOOK is not None else plugin
            )
            if getattr(_BYPASS, "active", False):
                return base  # drainer: durable tier, faults still apply
            return TieredPlugin(base, rt, url)

        _PREV_HOOK = _sp.set_plugin_wrap_hook(_hook)
        _RUNTIME = rt
        # Multi-host address book: TPUSNAPSHOT_HOT_TIER_ADDRS registers
        # real peer processes ("1=host:port,2=host:port") so replica
        # hosts named there are reached over the snapwire transport.
        from . import transport as _transport

        _transport.register_peers_from_env()
        if rt.repair_plane is not None:
            rt.repair_plane.start()
        return rt


def disable_hot_tier(flush: bool = True, timeout_s: float = 120.0) -> None:
    """Uninstall the hot tier (LIFO with any other wrap-hook users, like
    faultline's ``inject``). ``flush=True`` drains everything pending
    first so no committed bytes are stranded hot-only; plugins already
    resolved keep their wrapper but it deactivates (pass-through)."""
    global _RUNTIME, _PREV_HOOK
    from .. import storage_plugin as _sp

    with _ENABLE_LOCK:
        rt = _RUNTIME
        if rt is None:
            return
        try:
            if flush:
                if rt.drain_mode == "manual":
                    rt.drain_now()
                else:
                    rt._ensure_thread()
                    if not rt.wait_drained(timeout_s=timeout_s):
                        logger.warning(
                            "disable_hot_tier: drain did not flush "
                            f"within {timeout_s:g}s; undrained objects "
                            f"remain hot-tier-only"
                        )
        finally:
            # Uninstall UNCONDITIONALLY — a flush that raises (e.g. a
            # faultline SimulatedCrash striking a drain op) must not
            # leak the wrap hook and the runtime global, or the tier
            # could never be disabled or re-enabled again.
            if rt.repair_plane is not None:
                try:
                    rt.repair_plane.close()
                except Exception as e:
                    logger.warning(f"repair plane close failed: {e!r}")
            rt.stop()
            rt.active = False
            _sp.set_plugin_wrap_hook(_PREV_HOOK)
            _PREV_HOOK = None
            _RUNTIME = None


@contextmanager
def hot_tier(**kwargs):
    """``with hot_tier(world=4, k=2): ...`` — enable/disable scoped."""
    rt = enable_hot_tier(**kwargs)
    try:
        yield rt
    finally:
        disable_hot_tier()


# ------------------------------------------------------- module-level API


def drain_now() -> None:
    rt = _RUNTIME
    if rt is not None:
        rt.drain_now()


def repair_plane():
    """The attached snapmend repair plane (None when repair is off)."""
    rt = _RUNTIME
    return rt.repair_plane if rt is not None else None


def repair_tick() -> Optional[Dict[str, Any]]:
    """Run one synchronous supervise→restart→repair pass (manual-mode
    tests and the fault harness; also usable to force an immediate pass
    on a background plane). None when no plane is attached."""
    plane = repair_plane()
    return plane.tick() if plane is not None else None


def wait_drained(timeout_s: float = 120.0) -> bool:
    rt = _RUNTIME
    return rt.wait_drained(timeout_s=timeout_s) if rt is not None else True


def reset_pending() -> None:
    """Drop ALL drain bookkeeping (queue + per-root state + a dead
    drainer's error latch) without touching the stores — the fault
    harness's fresh-context hook: each crash-point replay starts from an
    empty op-relevant queue so the enumerated op stream is identical
    across replays."""
    rt = _RUNTIME
    if rt is None:
        return
    with rt._cond:
        rt._queue.clear()
        rt._roots.clear()
        rt._forgotten.clear()
        rt._progress_emit.clear()
        rt._progress_seq.clear()
        rt._progress_start.clear()
        rt.drain_error = None
        rt._cond.notify_all()
    plane = rt.repair_plane
    if plane is not None:
        # Crash-replay determinism: every replay starts with a fresh
        # under-replication clock and a live (un-crashed) plane.
        plane.reset_for_replay()


def introspect() -> Optional[Dict[str, Any]]:
    """Live drain-pipeline state (:meth:`HotTierRuntime.introspect`),
    or None when the tier is disabled — the sampler/ops entry point."""
    rt = _RUNTIME
    return rt.introspect() if rt is not None and rt.active else None


def durability_lag_s(root: str) -> Optional[float]:
    """The recorded per-take durability lag (commit ack → ``.tierdown``)
    for ``root``: None until the watermark landed (or tier disabled)."""
    rt = _RUNTIME
    if rt is None:
        return None
    state = rt.root_state(root)
    return state.durability_lag_s if state is not None else None


def forget_root(root: str) -> int:
    """Drop every hot replica of ``root`` and cancel its pending drains
    (``Snapshot.delete``/prune hook). Works with the runtime disabled
    too — registry-level state must not outlive its snapshot."""
    rt = _RUNTIME
    if rt is not None:
        return rt.forget_root(root)
    dropped = 0
    for key in tier.keys_for_root(root):
        if tier.forget_key(key):
            dropped += 1
    return dropped


def reconcile_hot_tier(
    base_path: str,
    keep_roots: Set[str],
    min_age_s: Optional[float] = None,
) -> List[str]:
    """Sweep orphaned hot-tier buffers under ``base_path``: roots not in
    ``keep_roots`` (the manager passes every step with committed
    metadata OR a step marker — so a committed-but-not-yet-drained
    take's replicas are structurally unreachable by this sweep) whose
    buffers have aged past the ``TPUSNAPSHOT_SWEEP_MIN_AGE_S`` guard,
    the same knob and fail-closed posture as every storage sweep.
    Returns the roots whose buffers were dropped."""
    if min_age_s is None:
        min_age_s = env_float("TPUSNAPSHOT_SWEEP_MIN_AGE_S", 3600.0)
    base = base_path.rstrip("/")
    keep = {r.rstrip("/") for r in keep_roots}
    dropped: List[str] = []
    for root, _nbytes in sorted(tier.buffered_roots().items()):
        if not (root == base or root.startswith(base + "/")):
            continue
        if root in keep:
            continue
        if min_age_s > 0:
            ages = [
                tier.key_age_s(key) for key in tier.keys_for_root(root)
            ]
            known = [a for a in ages if a is not None]
            # Fail closed: unknown age (or any young object) spares the
            # whole root — it may be an in-flight take's buffers.
            if not known or min(known) < min_age_s:
                continue
        forget_root(root)
        dropped.append(root)
    return dropped


def replication_stats_begin() -> Optional[Dict[str, Any]]:
    """Token for per-take replication attribution (None = tier off)."""
    rt = _RUNTIME
    return (
        rt.replication_stats_begin()
        if rt is not None and rt.active
        else None
    )


def replication_stats_collect(
    token: Optional[Dict[str, Any]]
) -> Optional[Dict[str, Any]]:
    """The take's ``tier.replication`` flight-report block since
    ``token`` (see :meth:`HotTierRuntime.replication_stats_collect`);
    None when the tier is off or the window had no wire traffic."""
    rt = _RUNTIME
    if token is None or rt is None:
        return None
    return rt.replication_stats_collect(token)


def restore_stats_begin() -> Optional[Dict[str, Any]]:
    """Token for per-restore tier attribution (None = tier disabled)."""
    rt = _RUNTIME
    return rt.stats_snapshot() if rt is not None and rt.active else None


def restore_stats_collect(
    token: Optional[Dict[str, Any]]
) -> Optional[Dict[str, Any]]:
    """The tier summary for the restore since ``token``: hot/fallback
    object+byte counts, the peers that failed, and why — the dict the
    flight report carries as ``tier`` and the ``hot-tier-degraded``
    doctor rule reads. None when the tier is off or saw no traffic."""
    rt = _RUNTIME
    if token is None or rt is None:
        return None
    now = rt.stats_snapshot()

    def _d(field: str) -> int:
        return int(now.get(field, 0)) - int(token.get(field, 0))

    summary = {
        "hot_objects": _d("hot_objects"),
        "hot_bytes": _d("hot_bytes"),
        "fallback_objects": _d("fallback_objects"),
        "fallback_bytes": _d("fallback_bytes"),
    }
    if not any(summary.values()):
        return None
    old_peers = token.get("peers") or {}
    summary["degraded_peers"] = sorted(
        h
        for h, c in (now.get("peers") or {}).items()
        if c > int(old_peers.get(h, 0))
    )
    old_reasons = token.get("reasons") or {}
    reasons = {
        r: c - int(old_reasons.get(r, 0))
        for r, c in (now.get("reasons") or {}).items()
        if c > int(old_reasons.get(r, 0))
    }
    if reasons:
        summary["fallback_reasons"] = reasons
    return summary
