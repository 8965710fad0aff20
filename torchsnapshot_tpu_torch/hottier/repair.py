"""snapmend: the hot tier's self-healing repair plane.

snapwire made ack-at-k real across processes, but the membership was
static: peers were reached by an address book, and one SIGKILL
permanently degraded every affected object to k-1 (or to write-through)
until the run ended. A disaggregated fleet only works if it tolerates
*continuous* worker churn — losses detected, capacity restored, and the
replication invariant **repaired**, not merely survived. This module is
that loop. Three duties, one deterministic ``tick()``:

1. **Peer supervision (generation-stamped membership).** Every
   registered remote peer is probed through the existing transport ping
   each tick. A peer whose subprocess exited, or whose pings have
   failed for ``TPUSNAPSHOT_REPAIR_DEADLINE_S``, is classified **lost**:
   its client handle is condemned (latched dead, connections aborted —
   the process itself may be hung, partitioned, or on another machine
   and is never assumed killable) and the client-side shadow index is
   invalidated for the host. Membership is *generation-stamped*: a
   replacement peer registers one generation up, and a stale
   predecessor that wakes later (SIGCONT after its id moved on) is
   refused by the ping's generation echo — a respawned peer holds an
   empty store and is recognized as *new*, never trusted to hold its
   predecessor's replicas. Peers latched into the transport's down
   cooldown are also re-probed here in the background, so a recovered
   host rejoins within one repair interval instead of waiting for the
   next foreground push to trip over it.

2. **Auto-restart.** A lost peer that this process spawned
   (``spawn_peer``) is respawned as a fresh subprocess at the next
   generation (``TPUSNAPSHOT_REPAIR_AUTO_RESTART``, default on), and
   the hot tier's address book is hot-reloaded: the host's
   ``TPUSNAPSHOT_HOT_TIER_ADDRS`` entry and its port-file (when one was
   configured) are rewritten in place, so rejoin needs no process
   restart anywhere.

3. **Anti-entropy repair + deadline-bounded escalation.** The loop
   scans the runtime's committed, undrained objects and counts *live*
   replicas (``tier.live_replicas`` — current-generation state only,
   never the rendezvous claim). An object below k is re-replicated
   from a surviving fingerprint-verified replica onto ring/spare hosts
   through the existing delta/codec push path, honoring every
   hard-won invariant: **tag-strict** (a source replica must carry the
   path's current tag — superseded bytes are never repaired, and a
   re-write racing the repair drops the stale placements),
   **forget-root latch** (a root deleted mid-repair has the placements
   undone — a deleted snapshot's objects are never resurrected), and
   **drain bookkeeping** (an object that tiered down mid-repair gets
   its repaired replicas marked drained/evictable). An object that
   cannot reach k within ``TPUSNAPSHOT_REPAIR_DEADLINE_S`` of first
   being observed under-replicated **escalates** to the existing
   synchronous durable write-through ladder (the drain item runs
   inline under the same serialization, latch re-checks, and undo
   paths as the background drainer), so at-risk bytes are a
   deadline-bounded quantity, not an unbounded exposure —
   ``tpusnapshot_hot_tier_underreplicated_bytes`` returns to 0.

Modes mirror the drainer: ``"background"`` runs ``tick()`` on a daemon
thread every ``TPUSNAPSHOT_REPAIR_INTERVAL_S``; ``"manual"`` leaves the
tick to the caller (the fault harness — repair op boundaries
``hottier.repair`` enter the deterministic crash-point stream only when
the test drives them). A read that fell back to the durable tier nudges
the plane (``request_scan``) so repair starts within one tick of the
first degraded read, not the next full interval.
"""

import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional

from .. import telemetry, tracing
from ..io_types import emit_storage_op
from ..telemetry import metrics as _metric_names
from ..utils.env import env_float, env_int
from . import tier

logger = logging.getLogger(__name__)

MODE_ENV_VAR = "TPUSNAPSHOT_REPAIR_MODE"
INTERVAL_ENV_VAR = "TPUSNAPSHOT_REPAIR_INTERVAL_S"
_DEFAULT_INTERVAL_S = 2.0
DEADLINE_ENV_VAR = "TPUSNAPSHOT_REPAIR_DEADLINE_S"
_DEFAULT_DEADLINE_S = 30.0
AUTO_RESTART_ENV_VAR = "TPUSNAPSHOT_REPAIR_AUTO_RESTART"

# The attempt index an escalation passes to _drain_item: past the
# drain's own attempt budget, so a failed escalation STRANDS the object
# (pending, replicas pinned, stranded-drains fires) instead of churning
# the drain queue from two sides — the next tick re-escalates.
_ESCALATE_ATTEMPT = 10**6

# How many consecutive ticks an escalation may find NO matching source
# replica before the loss verdict is made official. A foreground
# re-write can be mid-flight between replacing the replicas (hot_put)
# and updating the drain bookkeeping — one tick's "no replica" is
# stale bookkeeping, not loss; three full intervals apart is not.
_ESCALATE_NOREPLICA_TICKS = 3

# Condemned hung peers are kept unsignalled (the process may be merely
# paused, or unreachable rather than dead) so close() can reap spawned
# ones — but under continuous churn the handles, and the hung
# subprocesses pinning their replica RAM, must not accumulate for the
# life of the run. Beyond this many, the oldest are reaped eagerly.
_MAX_CONDEMNED = 8


def repair_interval_s() -> float:
    return env_float(INTERVAL_ENV_VAR, _DEFAULT_INTERVAL_S)


def repair_deadline_s() -> float:
    return env_float(DEADLINE_ENV_VAR, _DEFAULT_DEADLINE_S)


def _auto_restart_enabled() -> bool:
    return env_int(AUTO_RESTART_ENV_VAR, 1) != 0


def _update_addrs_env(host_id: int, addr: str) -> None:
    """Hot-reload the address book: rewrite (or append) the host's
    ``TPUSNAPSHOT_HOT_TIER_ADDRS`` entry in THIS process's environment
    so any later ``enable_hot_tier``/``register_peers_from_env`` sees
    the respawned peer — no process restart needed. A job that never
    set the address book keeps not having one."""
    from .transport import ADDRS_ENV_VAR, parse_addrs_spec

    spec = (os.environ.get(ADDRS_ENV_VAR) or "").strip()
    if not spec:
        return
    entries = parse_addrs_spec(spec)
    entries[str(host_id)] = addr
    os.environ[ADDRS_ENV_VAR] = ",".join(
        f"{h}={a}"
        for h, a in sorted(
            entries.items(), key=lambda kv: int(kv[0]) if kv[0].isdigit() else 1 << 30
        )
    )


# Serializes respawns of any host: a faultline flap revival (op-stream
# thread) and the background plane's _restart can race on the same
# lost host — without the lock both spawn a subprocess and the losing
# registration's process handle is dropped untracked (a leak no reap
# ever finds). Under the lock the second caller sees the first's
# replacement alive and returns it instead.
_RESPAWN_LOCK = threading.Lock()


def respawn_host(host_id: int) -> Optional[Any]:
    """Replace a lost wire-backed host with a FRESH peer subprocess one
    membership generation up, re-register it, and hot-reload the
    address book (env entry + port-file). The new process starts with
    an empty store — the repair loop re-replicates what belongs there.
    Returns the new RemotePeer, or None when the host id is not
    wire-backed (in-process hosts revive via ``tier.revive_host``).
    Idempotent under races: when a concurrent caller already respawned
    the host, its live replacement is returned rather than spawning a
    second (orphaned) process."""
    from .peer import spawn_peer

    with _RESPAWN_LOCK:
        return _respawn_host_locked(host_id, spawn_peer)


def _respawn_host_locked(host_id: int, spawn_peer: Any) -> Optional[Any]:
    old = tier.remote_host(host_id)
    if old is None:
        return None
    if getattr(old, "alive", False):
        # A racing caller's replacement is already up: callers only
        # respawn LOST hosts, so an alive registered peer IS the
        # replacement.
        return old
    capacity = getattr(old, "capacity_bytes", None)
    port_file = getattr(old, "spawn_port_file", None)
    gen = tier.host_generation(host_id) + 1
    _proc, addr, peer = spawn_peer(
        host_id,
        capacity_bytes=capacity,
        register=True,
        generation=gen,
        port_file=port_file,
    )
    _update_addrs_env(host_id, addr)
    logger.warning(
        f"snapmend: host {host_id} respawned as generation {gen} at "
        f"{addr}"
    )
    return peer


class _HostView:
    """One host's membership row: what the supervisor believes."""

    def __init__(self, host_id: int, peer: Any) -> None:
        self.host_id = host_id
        # The peer OBJECT this row describes: a replacement registered
        # over the host id (respawn, or an external supervisor's
        # connect_peer — possibly at the same generation number) is a
        # different object and gets a fresh row, so a stale LOST view
        # can never outlive the peer it judged.
        self.peer = peer
        self.generation = int(getattr(peer, "generation", 0))
        self.addr = getattr(peer, "addr_str", None)
        self.restartable = getattr(peer, "process", None) is not None
        self.lost = False
        self.failed_since: Optional[float] = None
        self.last_ok_t: Optional[float] = None

    def as_dict(self, now: float) -> Dict[str, Any]:
        return {
            "generation": self.generation,
            "addr": self.addr,
            "alive": not self.lost,
            "restartable": self.restartable,
            "failing_for_s": (
                round(now - self.failed_since, 3)
                if self.failed_since is not None
                else None
            ),
            "last_ok_age_s": (
                round(now - self.last_ok_t, 3)
                if self.last_ok_t is not None
                else None
            ),
        }


class RepairPlane:
    """One process's repair brain: supervision + anti-entropy loop over
    its :class:`~.runtime.HotTierRuntime`."""

    def __init__(self, runtime: Any, mode: str = "background") -> None:
        if mode not in ("background", "manual"):
            raise ValueError(
                f'repair mode must be "background" or "manual"; got {mode!r}'
            )
        self._rt = runtime
        self.mode = mode
        self._lock = threading.RLock()
        self._wake = threading.Condition(self._lock)
        # One tick at a time: a manual tick and the background thread
        # (or two callers) must not interleave repair placements.
        self._tick_lock = threading.Lock()
        self._views: Dict[int, _HostView] = {}
        # Lost peers we condemned but could not (or must not) signal:
        # their handles are kept so close() can reap spawned processes.
        self._condemned: List[Any] = []
        # key -> monotonic time the object was FIRST observed below k;
        # the escalation deadline and the time-to-k histogram both
        # measure from here.
        self._under_since: Dict[str, float] = {}
        # key -> consecutive escalation ticks that found NO matching
        # source replica (the loss-verdict debounce — see _escalate).
        self._esc_noreplica: Dict[str, int] = {}
        self._under_bytes = 0
        self._under_objects = 0
        self._oldest_under_age_s: Optional[float] = None
        self._stats: Dict[str, int] = {
            "objects_repaired": 0,
            "bytes_repaired": 0,
            "repairs_failed": 0,
            "escalation_attempts": 0,
            "escalated_write_throughs": 0,
            "peer_restarts": 0,
            "hosts_lost": 0,
            "reprobes": 0,
        }
        self._last_tick_t: Optional[float] = None
        self.repair_error: Optional[BaseException] = None
        self._scan_requested = False
        self._stop = False
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        if self.mode != "background":
            return
        with self._lock:
            if self.repair_error is not None:
                return  # a crashed plane stays crashed (process death)
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop = False
            self._thread = threading.Thread(
                target=self._loop,
                name="tpusnapshot-hottier-repair",
                daemon=True,
            )
            self._thread.start()

    def reset_for_replay(self) -> None:
        """Crash-replay determinism hook (``runtime.reset_pending``):
        every replay starts with a fresh under-replication clock and a
        live plane. Taken under ``_tick_lock`` so a concurrently
        running tick cannot interleave with the clear; a background
        loop that died on a SimulatedCrash is restarted (a replayed
        process is a NEW process — its plane runs again)."""
        with self._tick_lock:
            with self._lock:
                self._under_since.clear()
                self._esc_noreplica.clear()
                self.repair_error = None
        self.start()  # no-op in manual mode / when already running

    def request_scan(self) -> None:
        """Wake the background loop early (a degraded read just proved
        a replica is gone — start repairing within one tick, not one
        full interval). Latched, not just notified: a nudge landing
        while a tick is IN PROGRESS (no thread waiting on the
        condition) must trigger the next tick immediately, not be
        silently dropped back to a full-interval wait. No-op in manual
        mode."""
        with self._wake:
            self._scan_requested = True
            self._wake.notify_all()

    def close(self, kill_condemned: bool = True) -> None:
        with self._wake:
            self._stop = True
            self._wake.notify_all()
        thread = self._thread
        if thread is not None and thread.is_alive():
            thread.join(timeout=10.0)
        if kill_condemned:
            with self._lock:
                condemned, self._condemned = self._condemned, []
            for peer in condemned:
                try:
                    peer.kill()
                except Exception as e:
                    logger.warning(
                        f"snapmend: condemned-peer reap failed: {e!r}"
                    )

    def _loop(self) -> None:
        while True:
            with self._wake:
                if self._stop:
                    return
                if not self._scan_requested:
                    self._wake.wait(timeout=repair_interval_s())
                self._scan_requested = False
                if self._stop:
                    return
            try:
                self.tick()
            except Exception as e:
                # A failing tick must not kill the plane: supervision
                # retries next interval (transient probe/storage
                # errors are its weather).
                logger.warning(f"snapmend tick failed: {e!r}")
            except BaseException as e:
                # A crash (SimulatedCrash) rips the plane dead, like
                # the drainer: a dead process does not keep repairing.
                self.repair_error = e
                logger.warning(f"snapmend repair plane died: {e!r}")
                return

    # ----------------------------------------------------------------- tick

    def tick(self) -> Dict[str, Any]:
        """One synchronous supervise→restart→repair pass. Deterministic
        given the op stream (the fault harness drives it in manual
        mode); returns a summary of what this pass did."""
        with self._tick_lock:
            lost = self._supervise()
            restarted = self._restart(lost)
            summary = self._repair_pass()
            summary["hosts_lost"] = lost
            summary["peer_restarts"] = restarted
            with self._lock:
                self._last_tick_t = time.monotonic()
            return summary

    # ---------------------------------------------------------- supervision

    def _supervise(self) -> List[int]:
        """Probe every registered remote peer; classify the dead and the
        deadline-hung as LOST (condemn + shadow invalidation). Returns
        the host ids newly lost this tick."""
        from .transport import DEADLINE_ENV_VAR, _DEFAULT_DEADLINE_S

        now = time.monotonic()
        deadline = repair_deadline_s()
        # Probes run serially under the tick lock: bound each one below
        # the full wire RPC deadline so one hung (SIGSTOP'd) peer can't
        # stall the whole tick — and every other host's repair — for
        # 5s per interval until it is classified.
        probe_deadline = max(
            0.5,
            min(
                env_float(DEADLINE_ENV_VAR, _DEFAULT_DEADLINE_S),
                repair_interval_s(),
            ),
        )
        newly_lost: List[int] = []
        remotes = tier.remote_hosts()
        with self._lock:
            # Prune views of hosts that were UNREGISTERED (condemned
            # hosts stay registered, so lost-host views survive): a
            # stale view would report a nonexistent host in the
            # membership block forever and feed _restart a candidate
            # whose respawn can never succeed.
            for host_id in [h for h in self._views if h not in remotes]:
                del self._views[host_id]
        for host_id, peer in sorted(remotes.items()):
            with self._lock:
                view = self._views.get(host_id)
                if view is None or peer is not view.peer:
                    view = _HostView(host_id, peer)
                    self._views[host_id] = view
            if not getattr(peer, "alive", False):
                # Already latched dead (kill_host / a prior condemn):
                # membership reflects it; restart may still apply.
                if not view.lost:
                    view.lost = True
                    with self._lock:
                        self._stats["hosts_lost"] += 1
                    newly_lost.append(host_id)
                continue
            proc = getattr(peer, "process", None)
            if proc is not None and proc.poll() is not None:
                # The subprocess exited — the RAM is gone with it; no
                # deadline needed to know.
                self._declare_lost(host_id, peer, view, reason="exited")
                newly_lost.append(host_id)
                continue
            # The existing transport ping IS the liveness probe. It
            # doubles as the down-cooldown background re-probe: probe()
            # bypasses the cooldown gate and clears it on success, so a
            # recovered peer rejoins within one repair interval instead
            # of waiting for the next foreground push to trip over it.
            was_down = bool(getattr(peer, "in_cooldown", False))
            ok = False
            try:
                ok = bool(peer.probe(deadline_s=probe_deadline))
            except Exception as e:
                # A failed probe IS the signal: the deadline clock below
                # acts on it. Log the cause for the ops trail.
                logger.debug(
                    "snapmend: probe of host %d failed: %r", host_id, e
                )
                ok = False
            if ok:
                view.failed_since = None
                view.last_ok_t = time.monotonic()
                if was_down:
                    with self._lock:
                        self._stats["reprobes"] += 1
                continue
            if view.failed_since is None:
                view.failed_since = now
                continue
            if now - view.failed_since >= deadline:
                # Hung-not-dead (SIGSTOP, partition): past the repair
                # deadline the peer is LOST whether or not its process
                # still exists somewhere.
                self._declare_lost(
                    host_id, peer, view, reason="probe deadline"
                )
                newly_lost.append(host_id)
        return newly_lost

    def _declare_lost(
        self, host_id: int, peer: Any, view: _HostView, reason: str
    ) -> None:
        logger.warning(
            f"snapmend: host {host_id} (gen {view.generation}) classified "
            f"LOST ({reason}); condemning and invalidating its shadow"
        )
        # A declared host loss is postmortem time: flush this process's
        # flight recorder so the victim's last RPCs survive on disk.
        try:
            from .. import wiretap

            wiretap.note_degrade(
                "host_lost", peer=getattr(peer, "addr_str", None)
            )
        except Exception:  # pragma: no cover - defensive
            logger.debug("snapmend: blackbox dump failed", exc_info=True)
        # Latch the JUDGED peer object directly, and clear the host's
        # shadow only while that object is still the registered one
        # (only_if): a replacement registered mid-tick must never be
        # condemned on its predecessor's probe failures.
        condemn = getattr(peer, "condemn", None)
        if condemn is not None:
            condemn()
        tier.condemn_host(host_id, only_if=peer)
        view.lost = True
        reap: List[Any] = []
        with self._lock:
            self._stats["hosts_lost"] += 1
            if getattr(peer, "process", None) is not None:
                self._condemned.append(peer)
                while len(self._condemned) > _MAX_CONDEMNED:
                    reap.append(self._condemned.pop(0))
        for old in reap:
            # Bound the churn leak: beyond the cap the oldest condemned
            # hung subprocesses (each pinning its replica RAM) are
            # reaped now instead of at close().
            try:
                old.kill()
            except Exception as e:
                logger.warning(
                    f"snapmend: condemned-peer reap failed: {e!r}"
                )

    def _restart(self, lost_hosts: List[int]) -> int:
        """Respawn lost hosts this process spawned (auto-restart);
        non-restartable hosts (remote machines from the address book)
        stay lost until an external supervisor replaces them — repair
        re-replicates around them either way. Candidates are EVERY
        still-lost restartable view, not just this tick's losses: a
        respawn that failed (spawn timeout, transient fork error) is
        retried next tick instead of forfeiting the host for the run."""
        if not _auto_restart_enabled():
            return 0
        with self._lock:
            candidates = sorted(
                set(lost_hosts)
                | {
                    h
                    for h, v in self._views.items()
                    if v.lost and v.restartable
                }
            )
        restarted = 0
        for host_id in candidates:
            view = self._views.get(host_id)
            if view is None or not view.restartable or not view.lost:
                continue
            peer = tier.remote_host(host_id)
            if peer is not None and getattr(peer, "alive", False):
                continue  # a replacement already took the id over
            try:
                peer = respawn_host(host_id)
            except Exception as e:
                logger.warning(
                    f"snapmend: respawn of host {host_id} failed: {e!r}"
                )
                continue
            if peer is None:
                continue
            with self._lock:
                self._views[host_id] = _HostView(host_id, peer)
                self._views[host_id].last_ok_t = time.monotonic()
                self._stats["peer_restarts"] += 1
            restarted += 1
        return restarted

    # --------------------------------------------------------------- repair

    def _scan_targets(self) -> List[Dict[str, Any]]:
        """Committed, undrained objects (the at-risk set) snapshotted
        under the runtime lock — the repair work list."""
        rt = self._rt
        targets: List[Dict[str, Any]] = []
        with rt._cond:
            for root, state in sorted(rt._roots.items()):
                if not state.committed or root in rt._forgotten:
                    continue
                for path in sorted(state.pending):
                    targets.append(
                        {
                            "root": root,
                            "path": path,
                            "tag": state.tags.get(path),
                            "nbytes": state.sizes.get(path),
                        }
                    )
        return targets

    def _repair_pass(self) -> Dict[str, Any]:
        rt = self._rt
        now = time.monotonic()
        deadline = repair_deadline_s()
        with self._lock:
            attempts0 = self._stats["escalation_attempts"]
        repaired = 0
        escalated = 0
        failed = 0
        remaining_bytes = 0
        remaining_objects = 0
        oldest_age: Optional[float] = None
        live_keys = set()
        by_root: Dict[str, Dict[str, int]] = {}
        for t in self._scan_targets():
            key = rt._key(t["root"], t["path"])
            live_keys.add(key)
            live = tier.live_replicas(key, t["tag"])
            if len(live) >= rt.k:
                self._under_since.pop(key, None)
                # A recovered object also resets the loss-verdict
                # debounce: stale misses from an earlier incident must
                # not let the NEXT incident's first no-replica tick
                # jump straight to the drain's loss budget.
                self._esc_noreplica.pop(key, None)
                continue
            first = self._under_since.setdefault(key, now)
            rec = by_root.setdefault(
                t["root"],
                {
                    "objects": 0,
                    "bytes": 0,
                    "failed": 0,
                    "escalated": 0,
                    "remaining": 0,
                },
            )
            fixed = False
            if now - first >= deadline:
                # Past the at-risk deadline: stop waiting for peers
                # and make the bytes durable NOW via the existing
                # synchronous write-through ladder. An object with
                # ZERO surviving replicas escalates too — the drain
                # item owns the loss verdict (after the phantom-loss
                # guard below), and only that verdict can retire the
                # obligation; silently skipping it would leave the
                # worst state (unrecoverable committed bytes) the one
                # state that never goes critical.
                with self._lock:
                    self._stats["escalation_attempts"] += 1
                fixed, wrote = self._escalate(
                    t["root"], t["path"], t["tag"]
                )
                if wrote:
                    # Count only escalations that actually RAN the
                    # drain item (a durable write attempt or the loss
                    # verdict) — debounce deferrals and drainer-owned
                    # no-ops are attempts, not write-throughs, and
                    # inflating this count misreports the ledger and
                    # the ops view.
                    escalated += 1
                    rec["escalated"] += 1
                    with self._lock:
                        self._stats["escalated_write_throughs"] += 1
                    telemetry.counter(
                        _metric_names.HOT_TIER_REPAIR_ESCALATIONS
                    ).inc()
            else:
                outcome = self._repair_object(
                    t["root"], t["path"], t["tag"], live
                )
                if outcome is None:
                    failed += 1
                    rec["failed"] += 1
                else:
                    placed_bytes, reached_k = outcome
                    if placed_bytes:
                        repaired += 1
                        rec["objects"] += 1
                        rec["bytes"] += placed_bytes
                    fixed = reached_k
                    if reached_k:
                        telemetry.histogram(
                            _metric_names.HOT_TIER_REPAIR_TIME_TO_K
                        ).observe(max(0.0, time.monotonic() - first))
            if fixed:
                self._under_since.pop(key, None)
                self._esc_noreplica.pop(key, None)
            else:
                remaining_objects += 1
                remaining_bytes += int(t["nbytes"] or 0)
                rec["remaining"] += int(t["nbytes"] or 0)
                age = time.monotonic() - first
                if oldest_age is None or age > oldest_age:
                    oldest_age = age
        # Objects that drained/vanished since last tick must not pin a
        # stale under-replication clock (or loss-verdict debounce).
        for key in [k for k in self._under_since if k not in live_keys]:
            del self._under_since[key]
        for key in [k for k in self._esc_noreplica if k not in live_keys]:
            del self._esc_noreplica[key]
        with self._lock:
            self._stats["repairs_failed"] += failed
            self._under_bytes = remaining_bytes
            self._under_objects = remaining_objects
            self._oldest_under_age_s = oldest_age
        telemetry.gauge(_metric_names.HOT_TIER_UNDERREPLICATED_BYTES).set(
            float(remaining_bytes)
        )
        if repaired or escalated:
            self._append_repair_ledger(by_root)
        with self._lock:
            attempts = self._stats["escalation_attempts"] - attempts0
        return {
            "objects_repaired": repaired,
            "escalation_attempts": attempts,
            "escalated_write_throughs": escalated,
            "repairs_failed": failed,
            "underreplicated_objects": remaining_objects,
            "underreplicated_bytes": remaining_bytes,
        }

    def _repair_object(
        self,
        root: str,
        path: str,
        tag: Optional[str],
        live: List[int],
    ) -> Optional[tuple]:
        """Re-replicate one under-replicated object from a surviving
        verified replica. Returns ``(bytes_placed, reached_k)`` or None
        when no usable source replica survives (the drain loop owns the
        loss verdict)."""
        rt = self._rt
        key = rt._key(root, path)
        data: Optional[bytes] = None
        src_tag: Optional[str] = tag
        unusable = set()
        for host in live:
            try:
                obj = tier.get_replica(key, host)
            except (tier.HostLostError, KeyError):
                unusable.add(host)
                continue
            if tag is not None and obj.tag != tag:
                unusable.add(host)
                continue  # tag-strict: never repair superseded bytes
            if tier.payload_tag(obj.data) != obj.tag:
                tier.drop_replica(key, host)  # corrupt source
                unusable.add(host)
                continue
            data = bytes(obj.data)
            src_tag = obj.tag
            break
        if data is None:
            telemetry.counter(_metric_names.HOT_TIER_REPAIRS_FAILED).inc()
            return None
        placed_hosts: List[int] = []
        # A host whose replica the loop just disproved (dead, missing,
        # wrong tag, corrupt-dropped) does NOT count toward k — leaving
        # it in would stop the placement loop one replica short.
        holders = set(live) - unusable
        with tracing.span(
            "hottier.repair", path=path, bytes=len(data)
        ):
            for host in rt._placement_ring():
                if len(holders) + len(placed_hosts) >= rt.k:
                    break
                if host in holders:
                    continue
                # A repair placement is a storage-op boundary: the
                # crash-point enumerator strikes between placements
                # exactly as it does between foreground replications.
                emit_storage_op("hottier.repair", f"host{host}:{path}")
                try:
                    if tier.put_replica(
                        key,
                        host,
                        data,
                        src_tag or tier.payload_tag(data),
                        root,
                        capacity_bytes=rt.capacity_bytes,
                    ):
                        placed_hosts.append(host)
                except tier.HostLostError:
                    continue
        placed_bytes = len(data) * len(placed_hosts)
        # Post-placement invariants: the world may have moved while the
        # placements were in flight.
        with rt._cond:
            forgotten = root in rt._forgotten
            state = rt._roots.get(root)
            current_tag = state.tags.get(path) if state is not None else None
            still_pending = state is not None and path in state.pending
        if forgotten or state is None:
            # Deleted mid-repair: a deleted snapshot's objects are never
            # resurrected — take every replica (ours included) back out.
            tier.forget_key(key)
            return (0, False)
        if (
            src_tag is not None
            and current_tag is not None
            and current_tag != src_tag
        ):
            # Re-written mid-repair: our placements hold superseded
            # bytes; drop everything not matching the newest tag.
            tier.drop_stale_replicas(key, current_tag)
            return (0, False)
        if not still_pending and src_tag is not None:
            # Tiered down (or written through) mid-repair: repaired
            # replicas inherit the drained/evictable state.
            tier.mark_drained(key, src_tag)
        if placed_hosts:
            with self._lock:
                self._stats["objects_repaired"] += 1
                self._stats["bytes_repaired"] += placed_bytes
            telemetry.counter(_metric_names.HOT_TIER_REPAIR_OBJECTS).inc()
            telemetry.counter(_metric_names.HOT_TIER_REPAIR_BYTES).inc(
                placed_bytes
            )
        reached_k = len(tier.live_replicas(key, current_tag or src_tag)) >= rt.k
        return (placed_bytes, reached_k)

    def _escalate(
        self, root: str, path: str, tag: Optional[str]
    ) -> tuple:
        """Deadline exceeded: make the object durable NOW through the
        existing synchronous write-through ladder. The drain item runs
        inline under the drainer's own serialization (never two
        executors on one path) and inherits every latch re-check and
        undo path — a racing delete or re-write behaves exactly as it
        does against the background drainer. Returns
        ``(retired, wrote)``: ``retired`` when the durability
        obligation is gone (written through, loss verdict, superseded,
        or deleted); ``wrote`` only when the drain item actually RAN —
        debounce deferrals and drainer-owned no-ops must not count as
        write-throughs in the stats/ledger."""
        rt = self._rt
        key = rt._key(root, path)
        logger.warning(
            f"snapmend: {root}/{path} under-replicated past the "
            f"{repair_deadline_s():g}s repair deadline; escalating to "
            f"synchronous durable write-through"
        )
        if not tier.live_replicas(key, tag):
            # No matching source replica RIGHT NOW. A foreground
            # re-write may be mid-flight between replacing the replicas
            # (hot_put) and updating the drain bookkeeping — that is
            # stale bookkeeping, not loss, and _drain_item at the
            # escalation attempt index would declare loss on the FIRST
            # probe (no re-drive budget left). Debounce across ticks:
            # each retry is a full interval apart, far longer than any
            # bookkeeping race; only a persistent absence makes the
            # loss verdict official below.
            with rt._cond:
                current = rt._item_current_locked(root, path, tag)
            if not current:
                self._esc_noreplica.pop(key, None)
                return (True, False)  # superseded/deleted: nothing left
            misses = self._esc_noreplica.get(key, 0) + 1
            self._esc_noreplica[key] = misses
            if misses < _ESCALATE_NOREPLICA_TICKS:
                logger.warning(
                    f"snapmend: escalation of {root}/{path} found no "
                    f"matching source replica (tick {misses}/"
                    f"{_ESCALATE_NOREPLICA_TICKS}); deferring the loss "
                    f"verdict one interval"
                )
                return (False, False)
        else:
            self._esc_noreplica.pop(key, None)
        with rt._cond:
            if not rt._item_current_locked(root, path, tag):
                self._esc_noreplica.pop(key, None)
                return (True, False)  # superseded/deleted: nothing left
            if rt._inflight_items.get((root, path), 0):
                # The drainer already owns it; let it land.
                return (False, False)
            rt._cancel_queued_locked(root, path)
            rt._inflight_begin_locked(root, path)
        try:
            rt._drain_item(root, path, tag, attempts=_ESCALATE_ATTEMPT)
        except Exception as e:
            logger.warning(
                f"snapmend: escalation of {root}/{path} failed: {e!r}"
            )
            return (False, True)
        finally:
            with rt._cond:
                rt._inflight_end_locked(root, path)
        with rt._cond:
            state = rt._roots.get(root)
            retired = state is None or path not in state.pending
        if retired:
            self._esc_noreplica.pop(key, None)
        return (retired, True)

    # --------------------------------------------------------- observability

    def _append_repair_ledger(
        self, by_root: Dict[str, Dict[str, int]]
    ) -> None:
        from ..telemetry import ledger as runledger

        for root, rec in sorted(by_root.items()):
            if not (rec["objects"] or rec["escalated"] or rec["failed"]):
                continue
            try:
                runledger.append_for_snapshot(
                    root,
                    runledger.repair_record(
                        path=root,
                        objects_repaired=rec["objects"],
                        bytes_repaired=rec["bytes"],
                        repairs_failed=rec["failed"],
                        escalated_write_throughs=rec["escalated"],
                        # THIS root's deficit, not the pass-global one:
                        # a fully-repaired root's durable record must
                        # not claim another root's at-risk bytes.
                        underreplicated_bytes=rec["remaining"],
                    ),
                )
            except Exception as e:
                telemetry.counter(
                    _metric_names.LEDGER_APPEND_FAILURES
                ).inc()
                logger.warning(f"repair ledger append failed: {e!r}")

    def introspect(self) -> Dict[str, Any]:
        """The repair/membership block of ``hottier.introspect()`` —
        what the sampler publishes and the ``replication-
        underreplicated`` live rule and the ops CLI consume."""
        now = time.monotonic()
        with self._lock:
            doc: Dict[str, Any] = {
                "mode": self.mode,
                "interval_s": repair_interval_s(),
                "deadline_s": repair_deadline_s(),
                "underreplicated_bytes": self._under_bytes,
                "underreplicated_objects": self._under_objects,
                "oldest_underreplicated_age_s": (
                    round(self._oldest_under_age_s, 3)
                    if self._oldest_under_age_s is not None
                    else None
                ),
                "last_tick_age_s": (
                    round(now - self._last_tick_t, 3)
                    if self._last_tick_t is not None
                    else None
                ),
                "repair_error": (
                    repr(self.repair_error)
                    if self.repair_error is not None
                    else None
                ),
                "stats": dict(self._stats),
                "membership": {
                    str(h): v.as_dict(now)
                    for h, v in sorted(self._views.items())
                },
            }
        for h, v in doc["membership"].items():
            v["current_generation"] = tier.host_generation(int(h))
        return doc
