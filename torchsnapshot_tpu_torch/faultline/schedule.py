"""Fault model and scriptable schedules for deterministic injection.

A :class:`FaultSchedule` is an ordered list of :class:`FaultRule`\\ s plus
an optional global crash point. Every storage-op boundary — plugin-level
ops emitted by :class:`~torchsnapshot_tpu_torch.faultline.plugin.FaultPlugin`
("write", "read", "delete", "list", "age", "size", "durable", "close")
and backend sub-steps emitted through
:func:`torchsnapshot_tpu_torch.io_types.emit_storage_op` ("fs.write.tmp",
"fs.write.fsync", "fs.write.rename", "fs.write.dirsync") — consults the
schedule through a shared :class:`FaultController`, which also assigns
each boundary a monotonically increasing **op index**. The crash point is
expressed against that index: op N *onward* raises
:class:`SimulatedCrash`, modeling a process that stops executing.

Fault kinds:

- **transient** — a cloud-shaped retryable error (429/503 with a
  structured ``.code``), fired a bounded number of times; the real retry
  layer must absorb it.
- **permanent** — an error that fires on every match; retries exhaust and
  the failure propagates.
- **torn write** — the payload is truncated at byte ``keep_bytes`` and
  written through before the error raises: the backend now holds a
  partial object, exactly what an interrupted upload leaves.
- **latency** — a sleep before the op proceeds.
- **crash** — :class:`SimulatedCrash` from this boundary onward, forever
  (a dead process never comes back).
- **mem_pressure** — a memwatch domain's reported cap shrinks, so the
  doctor's ``host-memory-overcommit`` rule trips.
- **host loss** — a hot-tier peer host is preempted at a deterministic
  op boundary (its RAM replicas vanish; ``hottier.kill_host``). For a
  host backed by a real peer process, ``kill_host`` SIGKILLs the process
  and aborts its in-flight connections, so a blocked read observes the
  loss within the RPC deadline.
- **host flap** (``flap_host``) — the host is lost as by ``lose_host``,
  then revived ``revive_after_ops`` boundaries later: a wire-backed peer
  as a fresh subprocess one membership generation up
  (``hottier.repair.respawn_host``), an in-process host alive and empty.
- **wire faults** (``drop_conn`` / ``torn_frame`` / ``slow_wire``) —
  armed at a ``hottier.replicate`` boundary and consumed by the next
  matching RPC: the socket aborts before the request leaves, half a
  frame is sent before the abort (the receiver never acks), or the RPC
  sleeps into its ``TPUSNAPSHOT_REPLICATION_DEADLINE_S`` deadline. Each
  surfaces as a transport failure and walks the retry → spare host →
  write-through ladder.
- **server kill** — every in-process snapserve read service dies at a
  ``snapserve.request`` boundary (``snapserve.kill_local_servers``):
  sockets abort, the listening port closes, and the client must degrade
  to direct backend reads (counted, bit-exact).
- **fleet member faults** (``kill_fleet_member`` / ``slow_fleet_member``)
  — one named in-process member (from
  ``snapserve.fleet.start_local_fleet``) dies or turns slow at a
  ``snapserve.request`` boundary. A kill surfaces as the client's
  ring-replica failover (never an error, never a direct fallback while
  replicas live); a slow member as hung-not-dead to the supervisor.

Every injected fault bumps ``FAULTS_INJECTED{kind}`` and emits a
``fault_injected`` trace instant.

The schedule is deterministic by construction: rules fire on the *n*-th
match of their (op-glob, path-glob) pattern, and the crash point on a
fixed op index — replaying the same pipeline replays the same faults.
"""

import fnmatch
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

from .. import telemetry, tracing
from ..telemetry import metrics as _metric_names


class SimulatedCrash(BaseException):
    """Process death at a storage-op boundary.

    Deliberately a ``BaseException``: a crash must rip through the retry
    layer, schedulers, and ``except Exception`` recovery paths the way a
    real ``SIGKILL`` would — nothing inside the pipeline may absorb it.
    """


class InjectedTransientError(Exception):
    """Cloud-shaped retryable failure (429/503).

    Carries a structured ``.code`` plus an ``errors`` attribute so the
    structural classifiers in ``io_types`` read it exactly like a
    google-api-core exception: NOT not-found, NOT range-not-satisfiable —
    hence retryable.
    """

    errors: Tuple = ()

    def __init__(self, status: int, op: str, path: str) -> None:
        super().__init__(f"injected {status} on {op}({path})")
        self.code = status


class InjectedPermanentError(Exception):
    """A failure that never goes away; retries must exhaust and surface it."""

    def __init__(self, op: str, path: str) -> None:
        super().__init__(f"injected permanent failure on {op}({path})")


# Actions a matched rule hands back to the plugin. Raising faults raise
# inside FaultController.on_op; the torn-write action must be APPLIED by
# the write path (only it holds the payload), so it travels back as data.
@dataclass
class TornWrite:
    keep_bytes: int
    # What strikes after the partial payload landed: "transient" (the
    # retry layer gets a chance to rewrite the object whole), "permanent",
    # or "crash" (a power-cut mid-upload).
    then: str = "transient"
    status: int = 503


@dataclass
class FaultRule:
    """One scheduled fault: fires on the ``nth`` .. ``nth+times-1``-th ops
    matching ``(op, path)`` globs (1-based; ``times=None`` = forever)."""

    kind: str  # "transient" | "permanent" | "error" | "torn" | "latency"
    #          | "crash" | "mem_pressure" (shrink a memory domain's cap)
    #          | "hostloss" | "flap" (lose, then revive, a hot-tier host)
    #          | "drop_conn" | "torn_frame" | "slow_wire" (snapwire)
    #          | "killserver" | "killmember" | "slowmember" (read plane)
    op: str = "*"
    path: str = "*"
    nth: int = 1
    times: Optional[int] = 1
    status: int = 503
    seconds: float = 0.0
    torn: Optional[TornWrite] = None
    error_factory: Optional[Callable[[str, str], Exception]] = None
    # mem_pressure: which memwatch domain shrinks, and to what cap.
    domain: Optional[str] = None
    cap_bytes: Optional[int] = None
    host: Optional[int] = None  # hostloss/flap/wire faults: which peer host
    # flap: how many further op boundaries after the loss until the host
    # comes back (a wire-backed peer as a fresh subprocess one membership
    # generation up; an in-process host empty).
    revive_after_ops: Optional[int] = None
    member: Optional[str] = None  # killmember/slowmember: fleet member name
    _hits: int = field(default=0, repr=False)
    _fired: int = field(default=0, repr=False)

    def matches(self, op: str, path: str) -> bool:
        return fnmatch.fnmatchcase(op, self.op) and fnmatch.fnmatchcase(
            path, self.path
        )

    def should_fire(self) -> bool:
        """Advance the match counter; report whether the rule fires now."""
        self._hits += 1
        if self._hits < self.nth:
            return False
        if self.times is not None and self._fired >= self.times:
            return False
        self._fired += 1
        return True


class FaultSchedule:
    """Builder for a deterministic fault script.

    ::

        sched = (
            FaultSchedule()
            .transient(op="write", path=".steps/*", times=2)
            .torn_write(path="0/model/*", keep_bytes=7)
            .latency(op="read", seconds=0.01)
            .crash_at(17)                 # op 17 onward: SimulatedCrash
        )
    """

    def __init__(self) -> None:
        self.rules: List[FaultRule] = []
        self.crash_at_op: Optional[int] = None

    # ------------------------------------------------------------ builders

    def transient(
        self,
        op: str = "*",
        path: str = "*",
        nth: int = 1,
        times: Optional[int] = 1,
        status: int = 503,
    ) -> "FaultSchedule":
        self.rules.append(
            FaultRule(
                kind="transient", op=op, path=path, nth=nth, times=times,
                status=status,
            )
        )
        return self

    def permanent(
        self, op: str = "*", path: str = "*", nth: int = 1
    ) -> "FaultSchedule":
        self.rules.append(
            FaultRule(kind="permanent", op=op, path=path, nth=nth, times=None)
        )
        return self

    def error(
        self,
        factory: Callable[[str, str], Exception],
        op: str = "*",
        path: str = "*",
        nth: int = 1,
        times: Optional[int] = 1,
    ) -> "FaultSchedule":
        """Inject an arbitrary exception built by ``factory(op, path)`` —
        for backend-specific shapes the named kinds do not cover."""
        self.rules.append(
            FaultRule(
                kind="error", op=op, path=path, nth=nth, times=times,
                error_factory=factory,
            )
        )
        return self

    def torn_write(
        self,
        path: str = "*",
        keep_bytes: int = 0,
        nth: int = 1,
        times: Optional[int] = 1,
        then: str = "transient",
    ) -> "FaultSchedule":
        self.rules.append(
            FaultRule(
                kind="torn", op="write", path=path, nth=nth, times=times,
                torn=TornWrite(keep_bytes=keep_bytes, then=then),
            )
        )
        return self

    def latency(
        self,
        op: str = "*",
        path: str = "*",
        seconds: float = 0.01,
        nth: int = 1,
        times: Optional[int] = None,
    ) -> "FaultSchedule":
        self.rules.append(
            FaultRule(
                kind="latency", op=op, path=path, nth=nth, times=times,
                seconds=seconds,
            )
        )
        return self

    def crash_at(self, op_index: int) -> "FaultSchedule":
        """Crash at global op index ``op_index`` (1-based) and every
        boundary after it — the crash-point enumerator's lever."""
        self.crash_at_op = op_index
        return self

    def crash_on(
        self, op: str = "*", path: str = "*", nth: int = 1
    ) -> "FaultSchedule":
        """Crash at the ``nth`` op matching the globs (and stay crashed)."""
        self.rules.append(
            FaultRule(kind="crash", op=op, path=path, nth=nth, times=None)
        )
        return self

    def slow_drain(
        self,
        seconds: float = 0.2,
        path: str = "*",
        nth: int = 1,
        times: Optional[int] = None,
    ) -> "FaultSchedule":
        """Latency at the hot tier's ``hottier.drain`` boundaries: every
        matched tier-down write pays ``seconds`` first, which stretches
        the ack → ``.tierdown`` window past a durability-lag budget so
        the ``durability-lag-above-budget`` doctor rule fires."""
        return self.latency(
            op="hottier.drain", path=path, seconds=seconds, nth=nth, times=times
        )

    def lose_host(
        self, host: int, op: str = "*", path: str = "*", nth: int = 1
    ) -> "FaultSchedule":
        """Preempt hot-tier peer ``host`` at the ``nth`` op matching the
        globs: its RAM store is dropped and it goes dead
        (``hottier.kill_host``). The op itself then proceeds; the loss is
        observed by whichever replica read or drain touches the host
        next."""
        self.rules.append(
            FaultRule(kind="hostloss", op=op, path=path, nth=nth, times=1, host=host)
        )
        return self

    def flap_host(
        self,
        host: int,
        revive_after_ops: int = 1,
        op: str = "*",
        path: str = "*",
        nth: int = 1,
    ) -> "FaultSchedule":
        """Lose peer ``host`` as :meth:`lose_host` does at the ``nth``
        matching op, then revive it ``revive_after_ops`` op boundaries
        later: a wire-backed host as a fresh subprocess one membership
        generation up (``repair.respawn_host``; its empty store is never
        trusted with its predecessor's replicas), an in-process host
        through ``tier.revive_host`` (alive, empty). Both ride the op
        stream, so a replay replays the same churn."""
        self.rules.append(
            FaultRule(
                kind="flap", op=op, path=path, nth=nth, times=1,
                host=host, revive_after_ops=max(1, int(revive_after_ops)),
            )
        )
        return self

    def drop_conn(
        self,
        host: Optional[int] = None,
        op: str = "hottier.replicate",
        path: str = "*",
        nth: int = 1,
        times: Optional[int] = 1,
    ) -> "FaultSchedule":
        """The connection to peer ``host`` (None: any peer) dies at the
        ``nth`` matching op boundary: the next RPC to that host aborts its
        socket before the request leaves and fails as a transport
        error, which the retry layer absorbs by dialling again."""
        self.rules.append(
            FaultRule(kind="drop_conn", op=op, path=path, nth=nth, times=times, host=host)
        )
        return self

    def torn_frame(
        self,
        host: Optional[int] = None,
        op: str = "hottier.replicate",
        path: str = "*",
        nth: int = 1,
        times: Optional[int] = 1,
    ) -> "FaultSchedule":
        """The next matching RPC to peer ``host`` sends half its frame and
        aborts the connection: the receiver sees the tear and never acks,
        and the client retries or degrades."""
        self.rules.append(
            FaultRule(kind="torn_frame", op=op, path=path, nth=nth, times=times, host=host)
        )
        return self

    def slow_wire(
        self,
        seconds: float = 0.05,
        host: Optional[int] = None,
        op: str = "hottier.replicate",
        path: str = "*",
        nth: int = 1,
        times: Optional[int] = 1,
    ) -> "FaultSchedule":
        """The next matching RPC to peer ``host`` pays ``seconds`` on the
        wire before its request is sent: above
        ``TPUSNAPSHOT_REPLICATION_DEADLINE_S`` it misses its deadline
        (``tpusnapshot_hot_tier_replication_deadline_misses_total``) and
        enters the retry → spare host → write-through ladder."""
        self.rules.append(
            FaultRule(
                kind="slow_wire", op=op, path=path, nth=nth, times=times,
                seconds=seconds, host=host,
            )
        )
        return self

    def kill_server(
        self, op: str = "snapserve.request", path: str = "*", nth: int = 1
    ) -> "FaultSchedule":
        """Kill every in-process snapserve server at the ``nth`` op
        matching the globs (by default the ``nth`` client RPC attempt).
        The boundary fires before the RPC touches the network, so the
        matched request already finds the server dead; the client's
        degraded direct-read fallback is the behaviour under test."""
        self.rules.append(FaultRule(kind="killserver", op=op, path=path, nth=nth, times=1))
        return self

    def kill_fleet_member(
        self, member: str, op: str = "snapserve.request", path: str = "*", nth: int = 1
    ) -> "FaultSchedule":
        """Kill one named in-process fleet member (``"m1"`` from
        :func:`..snapserve.fleet.start_local_fleet`) at the ``nth``
        matching op boundary, before the RPC dials; the client's
        ring-replica failover is the behaviour under test."""
        self.rules.append(
            FaultRule(kind="killmember", op=op, path=path, nth=nth, times=1, member=member)
        )
        return self

    def slow_fleet_member(
        self,
        member: str,
        seconds: float = 0.05,
        op: str = "snapserve.request",
        path: str = "*",
        nth: int = 1,
    ) -> "FaultSchedule":
        """Add ``seconds`` of latency to every request one named fleet
        member answers from the ``nth`` matching boundary on: slow but
        alive, which the supervisor must classify hung-not-dead."""
        self.rules.append(
            FaultRule(
                kind="slowmember", op=op, path=path, nth=nth, times=1,
                member=member, seconds=seconds,
            )
        )
        return self

    def slow_server(
        self,
        seconds: float = 0.05,
        path: str = "*",
        nth: int = 1,
        times: Optional[int] = None,
    ) -> "FaultSchedule":
        """Latency at the snapserve client's ``snapserve.request``
        boundaries: every matched RPC pays ``seconds`` before it dials."""
        return self.latency(
            op="snapserve.request", path=path, seconds=seconds, nth=nth, times=times
        )

    def mem_pressure(
        self,
        domain: str,
        cap_bytes: int,
        op: str = "*",
        path: str = "*",
        nth: int = 1,
    ) -> "FaultSchedule":
        """At the ``nth`` matching op boundary, shrink the REPORTED cap of
        the named memwatch domain (``"staging_pool"``, ...) to
        ``cap_bytes`` through :func:`..telemetry.memwatch.force_cap`. The
        subsystem's real budget is untouched: its occupancy lands above
        the shrunk cap, so the doctor's ``host-memory-overcommit`` rule
        trips as it would on a host whose limit came down under the
        workload. Cleared by ``memwatch.reset()`` /
        ``clear_cap_overrides()``."""
        self.rules.append(
            FaultRule(
                kind="mem_pressure", op=op, path=path, nth=nth, times=1,
                domain=domain, cap_bytes=int(cap_bytes),
            )
        )
        return self


@dataclass
class FaultRecord:
    op_index: int
    op: str
    path: str
    kind: str


class FaultController:
    """Shared state of one injection session: the op counter, the
    schedule, the crash latch, and the injection log.

    One controller observes EVERY plugin the pipeline resolves (take,
    finalize, prune each open their own) plus backend sub-step hooks, so
    op indices form a single global sequence. Thread-safe: fs sub-steps
    fire from executor threads while plugin ops fire on the event loop.
    """

    def __init__(self, schedule: Optional[FaultSchedule] = None) -> None:
        self.schedule = schedule if schedule is not None else FaultSchedule()
        self.op_index = 0
        self.crashed = False
        self.records: List[FaultRecord] = []
        self._lock = threading.Lock()
        # flap_host revivals due at a future op index: (revive_at, host).
        # Popped at boundary entry and performed outside the lock (a
        # wire-backed revival spawns a subprocess).
        self._pending_revivals: List[Tuple[int, int]] = []

    def _record(self, idx: int, op: str, path: str, kind: str) -> None:
        # Lock held by caller. Each fault is counted and marked with a
        # trace instant beside the retry layer's storage_retry instants:
        # one increment per instant, so the two counts agree.
        self.records.append(FaultRecord(idx, op, path, kind))
        telemetry.counter(_metric_names.FAULTS_INJECTED, kind=kind).inc()
        tracing.instant("fault_injected", op=op, path=path, kind=kind, op_index=idx)

    def _revive_flapped_host(self, host: int, op: str, path: str) -> None:
        """Bring a flapped host back (lock not held: a wire-backed revival
        spawns a subprocess): a remote peer as a fresh process one
        membership generation up, an in-process host alive and empty.
        Either way it holds none of its predecessor's replicas;
        re-replication is the repair plane's job."""
        from ..hottier import repair as ht_repair
        from ..hottier import tier as ht_tier

        try:
            if ht_tier.remote_host(host) is not None:
                ht_repair.respawn_host(host)
            else:
                ht_tier.revive_host(host)
        except Exception as e:
            # A failed rejoin is a host that stayed lost: the repair plane
            # keeps re-replicating around it.
            logging.getLogger(__name__).warning(
                f"flap_host revival of host {host} failed: {e!r}"
            )
            return
        with self._lock:
            # The revival is in place when this boundary's op runs, and
            # on_op has not counted it yet: stamp the index it will get.
            self._record(self.op_index + 1, op, path, "revive")

    def on_op(self, op: str, path: str) -> Optional[TornWrite]:
        """Announce one op boundary. Raises the scheduled fault, if any;
        returns a :class:`TornWrite` the caller must apply, or None."""
        sleep_s = 0.0
        torn: Optional[TornWrite] = None
        due_revivals: List[int] = []
        with self._lock:
            if self._pending_revivals and not self.crashed:
                upcoming = self.op_index + 1
                still_pending: List[Tuple[int, int]] = []
                for at, host in self._pending_revivals:
                    if at <= upcoming:
                        due_revivals.append(host)
                    else:
                        still_pending.append((at, host))
                self._pending_revivals = still_pending
        for host in due_revivals:
            # Before this boundary's own faults: a revival scheduled N ops
            # after the loss is in place when the Nth op runs.
            self._revive_flapped_host(host, op, path)
        with self._lock:
            if self.crashed:
                raise SimulatedCrash(f"(post-crash) {op}({path})")
            self.op_index += 1
            idx = self.op_index
            crash_at = self.schedule.crash_at_op
            if crash_at is not None and idx >= crash_at:
                self.crashed = True
                self._record(idx, op, path, "crash")
                raise SimulatedCrash(f"op {idx}: {op}({path})")
            for rule in self.schedule.rules:
                if not rule.matches(op, path):
                    continue
                if not rule.should_fire():
                    continue
                if rule.kind == "latency":
                    self._record(idx, op, path, "latency")
                    sleep_s += rule.seconds
                    continue
                if rule.kind == "crash":
                    self.crashed = True
                    self._record(idx, op, path, "crash")
                    raise SimulatedCrash(f"op {idx}: {op}({path})")
                if rule.kind == "torn":
                    self._record(idx, op, path, "torn")
                    torn = rule.torn
                    break
                if rule.kind == "transient":
                    self._record(idx, op, path, "transient")
                    raise InjectedTransientError(rule.status, op, path)
                if rule.kind == "permanent":
                    self._record(idx, op, path, "permanent")
                    raise InjectedPermanentError(op, path)
                if rule.kind == "error":
                    self._record(idx, op, path, "error")
                    raise rule.error_factory(op, path)
                if rule.kind == "mem_pressure":
                    self._record(idx, op, path, "mem_pressure")
                    from ..telemetry import memwatch

                    # Only the reported cap shrinks; the guarded op goes on.
                    memwatch.force_cap(rule.domain or "", int(rule.cap_bytes or 0))
                    continue
                if rule.kind in ("hostloss", "flap"):
                    self._record(idx, op, path, rule.kind)
                    from ..hottier import kill_host

                    # A wire-backed peer is really SIGKILLed.
                    kill_host(rule.host)
                    if rule.kind == "flap":
                        self._pending_revivals.append(
                            (idx + (rule.revive_after_ops or 1), rule.host)
                        )
                    continue
                if rule.kind in ("drop_conn", "torn_frame", "slow_wire"):
                    self._record(idx, op, path, rule.kind)
                    from ..hottier import transport

                    # Armed here; the next RPC to the matched host consumes
                    # it (at the hottier.replicate boundary, the RPC this
                    # boundary guards: the emit fires just before the put
                    # dials).
                    transport.script_wire_fault(rule.kind, host=rule.host, seconds=rule.seconds)
                    continue
                if rule.kind == "killserver":
                    self._record(idx, op, path, "killserver")
                    from ..snapserve.server import kill_local_servers

                    # Returns once the server loops have aborted their
                    # sockets (never waiting on this lock), so the op this
                    # boundary guards already finds the server dead.
                    kill_local_servers()
                    continue
                if rule.kind in ("killmember", "slowmember"):
                    self._record(idx, op, path, rule.kind)
                    from ..snapserve import fleet

                    if rule.kind == "killmember":
                        fleet.kill_local_member(rule.member or "")
                    else:
                        fleet.slow_local_member(rule.member or "", rule.seconds)
                    continue
                raise ValueError(f"unknown fault rule kind {rule.kind!r}")
        if sleep_s > 0.0:
            # Outside the lock. time.sleep (not asyncio): this runs both
            # on the event loop and inside executor threads; briefly
            # blocking the loop is the injected latency, by design.
            time.sleep(sleep_s)
        return torn

    def torn_followup(self, torn: TornWrite, op: str, path: str) -> None:
        """Raise the failure that struck after a torn payload landed."""
        if torn.then == "crash":
            with self._lock:
                self.crashed = True
            raise SimulatedCrash(f"torn write crash: {op}({path})")
        if torn.then == "permanent":
            raise InjectedPermanentError(op, path)
        raise InjectedTransientError(torn.status, op, path)

    # Sub-step hook (registered via io_types.add_storage_op_hook). Torn
    # actions make no sense at sub-step granularity; raising faults do.
    def on_subop(self, op: str, path: str) -> None:
        self.on_op(op, path)

    def fault_counts(self) -> dict:
        with self._lock:
            out: dict = {}
            for r in self.records:
                out[r.kind] = out.get(r.kind, 0) + 1
            return out
