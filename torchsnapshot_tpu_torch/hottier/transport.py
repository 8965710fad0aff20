"""snapwire client: the hot tier's cross-host replication transport.

tier.py models peer hosts as in-process failure domains; this module
makes k of them *real*: a :class:`RemotePeer` speaks the shared
:mod:`torchsnapshot_tpu_torch.wire` framing to a ``hottier.peer`` process
(peer.py) holding that host's RAM store, so an ``ack-at-k`` from
``hot_put`` means k replicas actually crossed a process (and, in
production, host) boundary and were fingerprint-verified by the
receiver BEFORE the ack came back.

The client side owns three robustness mechanisms:

- **Per-RPC deadlines** — every RPC is dispatched onto a shared
  background event loop and awaited with
  ``TPUSNAPSHOT_REPLICATION_DEADLINE_S``; a miss aborts the connection
  (a half-sent frame cannot be reused), counts
  ``tpusnapshot_hot_tier_replication_deadline_misses_total``, and is
  retried like any transport failure.
- **Decorrelated-jitter retry under an elapsed budget** — transport
  failures (dial refused, dropped/torn connection, deadline miss)
  retry with the same jitter shape as ``retry_storage_op``
  (uniform over ``[floor, prev*3]``, capped by
  ``TPUSNAPSHOT_REPLICATION_RETRY_CAP_S``) until
  ``TPUSNAPSHOT_REPLICATION_RETRY_BUDGET_S`` elapses; then the peer is
  marked down for a cooldown and :class:`~.tier.HostLostError` is
  raised — ``hot_put`` substitutes a spare host, and if k still cannot
  be placed the TieredPlugin degrades to the synchronous durable
  write-through *before the ack*. Ack-at-k is never a lie.
- **Delta replication + the codec stage** — each push carries
  chunk-granular deltas against the peer's *acknowledged previous cut*
  of the same object path (chunk fingerprints via
  ``fingerprint_host_chunked`` are the diff key): unchanged chunks
  travel as ``ref`` frames (offset+length only, the receiver copies
  from its stored base replica), changed chunks as ``raw`` frames
  encoded through the codec stage (``TPUSNAPSHOT_REPLICATION_CODEC``:
  ``auto`` = zstd when importable else uncompressed; ``zlib``/``zstd``
  explicit; ``none`` off) — and opt-in lossy int8 for optimizer-moment
  paths matched by ``TPUSNAPSHOT_REPLICATION_INT8_GLOBS`` (the
  EQuARX-style trade: the remote replica stores the dequantized
  moments, bounded by ``codecs.quant_error_bound``; the durable tier
  is never written from a lossy replica because the drain's tag match
  skips them — the local exact replica drains). The receiver
  reconstructs and fingerprint-verifies the full object before acking,
  so a bad basis or torn payload can only produce a NACK, never a
  wrong replica. A peer that lost the basis (eviction, restart)
  answers ``stale_basis`` and the client re-pushes full.

Deterministic wire faults (faultline's ``drop_conn`` / ``torn_frame``
/ ``slow_wire`` schedule rules) are scripted through
:func:`script_wire_fault` and consumed by the next matching RPC: a
*drop* aborts the connection before the request leaves, a *torn frame*
sends a truncated frame then aborts (the receiver's ``readexactly``
sees the tear; it never acks), a *slow* wire sleeps the RPC into its
deadline. All three surface as ordinary transport failures and take
the retry → spare-host → write-through degradation path above.

Everything here is called synchronously from tier.py (the existing
tier interface is unchanged); socket IO runs on one shared daemon
event loop so calls work from the scheduler's loop thread and drain
executor threads alike.
"""

import asyncio
import concurrent.futures
import fnmatch
import logging
import os
import random
import signal
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from .. import telemetry, tracing, wire, wiretap
from ..fingerprint import fingerprint_host, fingerprint_host_chunked
from ..telemetry import metrics as _metric_names
from ..utils.env import env_float, env_int
from .tier import HostLostError, HotObject

logger = logging.getLogger(__name__)

ADDRS_ENV_VAR = "TPUSNAPSHOT_HOT_TIER_ADDRS"
DEADLINE_ENV_VAR = "TPUSNAPSHOT_REPLICATION_DEADLINE_S"
_DEFAULT_DEADLINE_S = 5.0
RETRY_BUDGET_ENV_VAR = "TPUSNAPSHOT_REPLICATION_RETRY_BUDGET_S"
_DEFAULT_RETRY_BUDGET_S = 10.0
RETRY_CAP_ENV_VAR = "TPUSNAPSHOT_REPLICATION_RETRY_CAP_S"
_DEFAULT_RETRY_CAP_S = 1.0
DOWN_COOLDOWN_ENV_VAR = "TPUSNAPSHOT_REPLICATION_DOWN_COOLDOWN_S"
_DEFAULT_DOWN_COOLDOWN_S = 2.0
CHUNK_ENV_VAR = "TPUSNAPSHOT_REPLICATION_CHUNK_BYTES"
_DEFAULT_CHUNK_BYTES = 1 << 20
DELTA_ENV_VAR = "TPUSNAPSHOT_REPLICATION_DELTA"
CODEC_ENV_VAR = "TPUSNAPSHOT_REPLICATION_CODEC"
INT8_GLOBS_ENV_VAR = "TPUSNAPSHOT_REPLICATION_INT8_GLOBS"

_RETRY_FLOOR_S = 0.05

# Deliberately unseeded, same contract as the storage retry layer:
# concurrent ranks must draw DIFFERENT delays.
_retry_rng = random.Random()

# Transport-level failures (the peer could not be spoken to). Server
# verdicts (stale_basis, capacity refusal, corrupt push) come back in
# well-formed response frames and are handled per-op.
_WIRE_ERRORS = (
    ConnectionError,
    OSError,
    EOFError,
    asyncio.IncompleteReadError,
    asyncio.TimeoutError,
    wire.ProtocolError,
)


# ------------------------------------------------------ snapwire op registry
#
# The single source of truth for the snapwire protocol: every op kind
# the client may put on the wire, the peer-server handler method that
# answers it, and the per-op policy (retry shape, idempotency). Runtime
# dispatch (peer.PeerServer._dispatch) and the static protocol checker
# (analysis/protocol.py, rules SNAP010/SNAP012) both read THIS dict, so
# a kind string cannot drift between client and server — an op added
# here without a matching ``_do_*`` method (or vice versa) is a lint
# failure before it is a runtime bad_request.
#
# ``retry``: "budget" ops go through the full decorrelated-jitter retry
# stack in ``_call``; "best_effort" ops try once and fail fast;
# "probe" is the un-retried liveness ping. Every op is idempotent by
# construction (put re-stores the same verified bytes under the same
# tag), which is what makes blind retry after an ambiguous failure
# safe — SNAP012 enforces that any op reaching the retry loop is
# declared in IDEMPOTENT_OPS below.
HOT_TIER_OPS: Dict[str, Dict[str, Any]] = {
    "put": {"handler": "_do_put", "retry": "budget"},
    "get": {"handler": "_do_get", "retry": "budget"},
    "query": {"handler": "_do_query", "retry": "budget"},
    "drop": {"handler": "_do_drop", "retry": "best_effort"},
    "mark_drained": {"handler": "_do_mark_drained", "retry": "best_effort"},
    "drop_stale": {"handler": "_do_drop_stale", "retry": "best_effort"},
    "stats": {"handler": "_do_stats", "retry": "budget"},
    "ping": {"handler": "_do_ping", "retry": "probe"},
}

# Ops that may be blindly re-sent after an ambiguous transport failure
# (the attempt may or may not have reached the peer). All of snapwire
# qualifies; the registry exists so the next non-idempotent op must
# make that decision explicitly.
IDEMPOTENT_OPS = frozenset(HOT_TIER_OPS)


class _WireFailure(Exception):
    """One RPC attempt failed at the transport level; retryable."""


class _DeadlineMiss(Exception):
    """The RPC's wire exchange blew TPUSNAPSHOT_REPLICATION_DEADLINE_S.
    Internal marker so _call_once counts the miss; converted to a
    retryable :class:`_WireFailure`."""


# ------------------------------------------------------- shared event loop

_LOOP_LOCK = threading.Lock()
_LOOP: Optional[asyncio.AbstractEventLoop] = None


def _loop() -> asyncio.AbstractEventLoop:
    """The shared snapwire event loop (daemon thread, lazily started)."""
    global _LOOP
    with _LOOP_LOCK:
        if _LOOP is not None and _LOOP.is_running():
            return _LOOP
        loop = asyncio.new_event_loop()
        ready = threading.Event()

        def _run() -> None:
            asyncio.set_event_loop(loop)
            loop.call_soon(ready.set)
            loop.run_forever()

        threading.Thread(
            target=_run, name="tpusnapshot-snapwire", daemon=True
        ).start()
        ready.wait(timeout=10.0)
        _LOOP = loop
        return loop


# ------------------------------------------------------------- wire stats

_TOTALS_LOCK = threading.Lock()
_TOTALS: Dict[str, int] = {
    "pushes": 0,
    "push_failures": 0,
    "payload_bytes": 0,
    "wire_bytes": 0,
    "retries": 0,
    "deadline_misses": 0,
}


def _bump(key: str, amount: int = 1) -> None:
    with _TOTALS_LOCK:
        _TOTALS[key] = _TOTALS.get(key, 0) + amount


def wire_stats_snapshot() -> Dict[str, int]:
    """Process-lifetime replication transport totals — the raw material
    of the per-take ``tier.replication`` window (runtime.py computes
    deltas between two snapshots)."""
    with _TOTALS_LOCK:
        return dict(_TOTALS)


# ---------------------------------------------------- scripted wire faults
#
# faultline's drop_conn / torn_frame / slow_wire schedule rules fire at
# deterministic op boundaries (hottier.replicate) and script the fault
# here; the next RPC to a matching host consumes and applies it. The
# indirection keeps the schedule deterministic (rules fire on the op
# stream) while the fault itself strikes the actual socket.

_SCRIPT_LOCK = threading.Lock()
_SCRIPT: List[Dict[str, Any]] = []


def script_wire_fault(
    kind: str, host: Optional[int] = None, seconds: float = 0.0
) -> None:
    """Arm one wire fault (``drop_conn`` | ``torn_frame`` |
    ``slow_wire``) for the next RPC to ``host`` (None = any host)."""
    if kind not in ("drop_conn", "torn_frame", "slow_wire"):
        raise ValueError(f"unknown wire fault kind {kind!r}")
    with _SCRIPT_LOCK:
        _SCRIPT.append({"kind": kind, "host": host, "seconds": seconds})


def clear_wire_faults() -> None:
    with _SCRIPT_LOCK:
        _SCRIPT.clear()


def _consume_faults(host_id: int) -> List[Dict[str, Any]]:
    """Pop at most ONE armed fault for this RPC (oldest matching): each
    scripted fault strikes exactly one RPC attempt, so arming N faults
    tears/drops/slows N successive attempts — the deterministic way to
    exhaust a retry budget."""
    with _SCRIPT_LOCK:
        for i, f in enumerate(_SCRIPT):
            if f["host"] is None or f["host"] == host_id:
                return [_SCRIPT.pop(i)]
        return []


# ------------------------------------------------------------- codec plan


def _resolve_codec(path: str) -> Optional[str]:
    """The per-frame codec for one object path: lossy int8 when the
    path matches an explicit ``TPUSNAPSHOT_REPLICATION_INT8_GLOBS``
    glob (comma-separated; opt-in only), else the lossless codec named
    by ``TPUSNAPSHOT_REPLICATION_CODEC`` (``auto`` = zstd when a
    backend is importable, uncompressed otherwise)."""
    from .. import codecs

    globs = (os.environ.get(INT8_GLOBS_ENV_VAR) or "").strip()
    if globs:
        for pattern in globs.split(","):
            pattern = pattern.strip()
            if pattern and fnmatch.fnmatchcase(path, pattern):
                return "int8"
    spec = (os.environ.get(CODEC_ENV_VAR) or "auto").strip().lower()
    if spec in ("none", "identity", "off", "0"):
        return None
    if spec == "auto":
        return "zstd" if "zstd" in codecs.available_codecs() else None
    codecs.check_codec(spec)
    return spec


def _lossless_fallback() -> Optional[str]:
    """The lossless codec an unsuitable int8 frame degrades to (the
    user's configured lossless choice, never another lossy codec)."""
    from .. import codecs

    spec = (os.environ.get(CODEC_ENV_VAR) or "auto").strip().lower()
    if spec in ("none", "identity", "off", "0", "int8"):
        return None
    if spec == "auto":
        return "zstd" if "zstd" in codecs.available_codecs() else None
    return spec


def _chunk_bytes() -> int:
    chunk = max(4, env_int(CHUNK_ENV_VAR, _DEFAULT_CHUNK_BYTES))
    return chunk - (chunk % 4)


def _delta_enabled() -> bool:
    return env_int(DELTA_ENV_VAR, 1) != 0


# ------------------------------------------------------------- RemotePeer


class RemotePeer:
    """Client handle for one remote peer host's RAM store.

    Implements the remote-host protocol tier.py routes to (put / get /
    drop / mark_drained / drop_stale / query / ping / kill). All
    methods are synchronous and thread-safe; RPCs are serialized per
    peer on the shared wire loop. ``process`` (when this client
    spawned the peer) enables the real ``lose_host`` semantics: a kill
    SIGKILLs the subprocess AND aborts in-flight connections so a
    blocked socket read observes the loss within the RPC deadline."""

    def __init__(
        self,
        host_id: int,
        addr: str,
        process: Any = None,
        capacity_bytes: Optional[int] = None,
        generation: int = 0,
    ) -> None:
        self.host_id = host_id
        self.addr_str = addr
        # Membership generation (snapmend): which incarnation of the
        # host this client speaks to. A ping answered by a server of a
        # DIFFERENT generation (a SIGCONT'd predecessor, a stale
        # process on a reused port) is refused — probe() returns False
        # instead of reviving a peer whose store belongs to a dead
        # membership view.
        self.generation = int(generation)
        host, _, port = addr.rpartition(":")
        self._addr = (host or "127.0.0.1", int(port))
        self.process = process
        self.capacity_bytes = (
            capacity_bytes
            if capacity_bytes is not None
            else env_int("TPUSNAPSHOT_HOT_TIER_BYTES", 1 << 30)
        )
        self._killed = False
        self._down_until = 0.0
        self._lock = threading.Lock()
        # Per-path delta basis: the peer's last ACKED cut of this
        # object path — {"key","stored_tag","fps","chunk","size"}.
        self._basis: Dict[str, Dict[str, Any]] = {}
        # Connection state lives on the wire loop; the asyncio.Lock is
        # created there on first use (single-threaded between awaits).
        self._conn: Optional[Tuple[Any, Any]] = None
        self._conn_lock: Optional[asyncio.Lock] = None

    # ------------------------------------------------------------ liveness

    @property
    def alive(self) -> bool:
        return not self._killed

    def _mark_down(self) -> None:
        cooldown = env_float(
            DOWN_COOLDOWN_ENV_VAR, _DEFAULT_DOWN_COOLDOWN_S
        )
        with self._lock:
            self._down_until = time.monotonic() + cooldown
        # A latched-down peer is a degrade event: flush the flight
        # recorder so the last RPCs against it survive a later crash.
        try:
            wiretap.note_degrade("peer_down", peer=self.addr_str)
        except Exception:  # pragma: no cover - defensive
            logger.debug("snapwire: blackbox dump failed", exc_info=True)

    def _is_down(self) -> bool:
        with self._lock:
            return time.monotonic() < self._down_until

    @property
    def in_cooldown(self) -> bool:
        """Inside the post-failure down cooldown right now (the repair
        tick's background re-probe targets exactly these peers, so a
        recovered host rejoins within one repair interval instead of
        waiting for the next foreground push to trip over it)."""
        return self._is_down()

    def probe(self, deadline_s: Optional[float] = None) -> bool:
        """Liveness probe: one un-retried ping RPC. A success clears a
        down cooldown early. A server answering with a DIFFERENT
        membership generation is not a success — a stale predecessor
        process (SIGCONT'd after its id moved on) must be refused, not
        revived."""
        if self._killed:
            return False
        try:
            resp, _ = self._call_once(
                {"v": wire.PROTOCOL_VERSION, "op": "ping"},
                b"",
                deadline_s or env_float(DEADLINE_ENV_VAR, _DEFAULT_DEADLINE_S),
            )
        except (_WireFailure, HostLostError):
            return False
        if resp.get("ok"):
            server_gen = resp.get("generation")
            if server_gen is not None and int(server_gen) < self.generation:
                logger.warning(
                    f"snapwire: peer at {self.addr_str} answered with "
                    f"stale generation {server_gen} (expected "
                    f"{self.generation}); refusing it"
                )
                return False
            if server_gen is not None and int(server_gen) > self.generation:
                # The SERVER is newer than this client's view — a
                # respawned (gen-up) peer reached through a client
                # rebuilt from the address book / port-file, which
                # carry no generation and default to 0. The stale side
                # is us, not the server: adopt its generation (and
                # sync the tier's membership view) instead of
                # condemning a healthy peer forever. Only a LOWER
                # generation marks a stale predecessor.
                logger.info(
                    f"snapwire: peer at {self.addr_str} answers "
                    f"generation {server_gen} (client view was "
                    f"{self.generation}); adopting"
                )
                self.generation = int(server_gen)
                from . import tier

                tier.note_host_generation(self.host_id, self.generation)
            with self._lock:
                self._down_until = 0.0
            return True
        return False

    def condemn(self) -> None:
        """Latch the peer dead WITHOUT signalling its process (snapmend:
        a hung/unreachable host is declared lost by the supervisor — the
        process may still exist, possibly on another machine). Every
        later op raises :class:`~.tier.HostLostError`; in-flight socket
        reads are aborted so nothing blocks out its full deadline."""
        with self._lock:
            if self._killed:
                return
            self._killed = True
        self.abort_connections()

    def abort_connections(self) -> None:
        """Abort the pooled connection from any thread (deadline miss,
        host kill): a blocked ``readexactly`` on it raises immediately
        instead of hanging until its own timeout."""
        loop = _LOOP
        if loop is None or not loop.is_running():
            return
        done = threading.Event()

        def _abort() -> None:
            try:
                self._abort_conn_on_loop()
            finally:
                done.set()

        loop.call_soon_threadsafe(_abort)
        done.wait(timeout=5.0)

    def _abort_conn_on_loop(self) -> None:
        conn, self._conn = self._conn, None
        if conn is not None:
            try:
                conn[1].transport.abort()
            except Exception:
                logger.debug("snapwire conn abort failed", exc_info=True)

    def kill(self) -> None:
        """The real ``lose_host``: SIGKILL the peer process (when this
        client spawned it) and abort in-flight connections, then latch
        the peer dead — every later op raises
        :class:`~.tier.HostLostError` immediately. A peer already
        latched by :meth:`condemn` (which deliberately does NOT signal)
        still gets its subprocess signalled here: kill() IS the reap,
        and early-returning on the latch would leave a condemned hung
        subprocess alive past every later reap, pinning its RAM for
        the run."""
        with self._lock:
            self._killed = True
        proc = self.process
        if proc is not None and proc.poll() is None:
            try:
                proc.send_signal(signal.SIGKILL)
                proc.wait(timeout=10.0)
            except Exception:
                logger.warning(
                    f"snapwire: SIGKILL of peer host {self.host_id} "
                    f"failed",
                    exc_info=True,
                )
        self.abort_connections()

    def close(self, kill_spawned: bool = True) -> None:
        """Release the peer handle (test teardown / reset): abort
        connections; a spawned subprocess is killed so nothing leaks."""
        if kill_spawned and self.process is not None:
            self.kill()
        else:
            self.abort_connections()

    # ------------------------------------------------------------- RPC core

    async def _exchange(
        self,
        header: Dict[str, Any],
        payload: bytes,
        torn: bool,
        slow_s: float = 0.0,
    ) -> Tuple[Dict[str, Any], bytes]:
        """Dial (if needed) + one framed request/response on the pooled
        connection. Caller holds ``_conn_lock``. ``slow_s`` is the
        scripted slow_wire latency — inside the deadline window, so a
        slow wire above the deadline deterministically misses it."""
        if slow_s > 0:
            await asyncio.sleep(slow_s)
        if self._conn is None:
            self._conn = await asyncio.open_connection(*self._addr)
        reader, writer = self._conn
        if torn:
            frame = wire.encode_frame(header, payload)
            writer.write(frame[: max(1, len(frame) // 2)])
            await writer.drain()
            self._abort_conn_on_loop()
            raise ConnectionResetError("injected torn_frame")
        await wire.send_frame(writer, header, payload)
        return await wire.recv_frame(reader)

    async def _rpc(
        self, header: Dict[str, Any], payload: bytes, deadline_s: float
    ) -> Tuple[Dict[str, Any], bytes]:
        # Wire faults strike replication PUSHES only (the
        # hottier.replicate boundary that arms them guards a push): a
        # concurrent drain/query RPC consuming the fault would make the
        # schedule's replay nondeterministic under the background drain.
        faults = (
            _consume_faults(self.host_id)
            if header.get("op") == "put"
            else []
        )
        slow_s = sum(
            f["seconds"] for f in faults if f["kind"] == "slow_wire"
        )
        if self._conn_lock is None:
            self._conn_lock = asyncio.Lock()
        async with self._conn_lock:
            if self._killed:
                raise ConnectionResetError("peer killed while queued")
            if any(f["kind"] == "drop_conn" for f in faults):
                self._abort_conn_on_loop()
                raise ConnectionResetError("injected drop_conn")
            torn = any(f["kind"] == "torn_frame" for f in faults)
            try:
                # The per-RPC deadline bounds the WIRE EXCHANGE (dial +
                # send + recv), measured from when this RPC owns the
                # connection — time spent queued behind another RPC on
                # the same peer is not a miss, and a miss here aborts
                # only a connection this RPC actually owns (never a
                # neighbor's in-flight transfer).
                return await asyncio.wait_for(
                    self._exchange(header, payload, torn, slow_s=slow_s),
                    deadline_s,
                )
            except asyncio.TimeoutError:
                self._abort_conn_on_loop()
                raise _DeadlineMiss(
                    f"RPC deadline ({deadline_s:g}s) exceeded"
                ) from None
            except BaseException:
                self._abort_conn_on_loop()
                raise

    def _tap(
        self,
        op: str,
        start: float,
        outcome: str,
        sent: int,
        received: int,
        attempt: int,
        deadline_s: float,
    ) -> None:
        """Best-effort wiretap record for one attempt — observability
        must never take the transport down with it."""
        try:
            wiretap.record(
                "snapwire",
                op,
                seconds=time.monotonic() - start,
                outcome=outcome,
                bytes_out=sent,
                bytes_in=received,
                attempt=attempt,
                deadline_s=deadline_s,
                peer=self.addr_str,
            )
        except Exception:  # pragma: no cover - defensive
            logger.debug("snapwire: wiretap record failed", exc_info=True)

    def _call_once(
        self,
        header: Dict[str, Any],
        payload: bytes,
        deadline_s: float,
        attempt: int = 0,
    ) -> Tuple[Dict[str, Any], bytes]:
        op = header.get("op")
        if op not in HOT_TIER_OPS:
            # Programming error, not a wire condition: never retried,
            # never sent — the registry is the protocol.
            raise ValueError(f"unknown snapwire op {op!r}")
        if self._killed:
            raise HostLostError(
                f"peer host {self.host_id} ({self.addr_str}) is dead"
            )
        # Stamp the ambient snapxray trace onto the frame so the peer's
        # server-side wiretap events join the same merged trace.
        trace_id = tracing.current_trace_id()
        if trace_id is not None:
            header["trace"] = trace_id
        start = time.monotonic()
        fut = asyncio.run_coroutine_threadsafe(
            self._rpc(header, payload, deadline_s), _loop()
        )
        # The coroutine self-bounds its exchange with the deadline; the
        # outer wait only backstops a wedged wire loop. The queue wait
        # behind other RPCs on this peer is bounded by THEIR deadlines.
        backstop_s = deadline_s * 8 + 60.0
        try:
            resp, resp_payload = fut.result(timeout=backstop_s)
        except _DeadlineMiss as e:
            self._tap(
                op, start, "deadline_miss", len(payload), 0, attempt,
                deadline_s,
            )
            _bump("deadline_misses")
            telemetry.counter(
                _metric_names.HOT_TIER_REPLICATION_DEADLINE_MISSES
            ).inc()
            raise _WireFailure(str(e)) from None
        except concurrent.futures.TimeoutError:
            self._tap(
                op, start, "transport", len(payload), 0, attempt, deadline_s
            )
            fut.cancel()
            self.abort_connections()
            raise _WireFailure(
                f"RPC backstop ({backstop_s:g}s) exceeded"
            ) from None
        except _WIRE_ERRORS as e:
            self._tap(
                op,
                start,
                wiretap.classify_error(e),
                len(payload),
                0,
                attempt,
                deadline_s,
            )
            raise _WireFailure(repr(e)) from e
        outcome = (
            "ok"
            if resp.get("ok")
            else wiretap.outcome_from_wire_error(resp.get("error"))
        )
        self._tap(
            op,
            start,
            outcome,
            len(payload),
            len(resp_payload),
            attempt,
            deadline_s,
        )
        return resp, resp_payload

    def _call(
        self,
        header: Dict[str, Any],
        payload: bytes = b"",
        deadline_s: Optional[float] = None,
        best_effort: bool = False,
    ) -> Tuple[Dict[str, Any], bytes]:
        """One RPC with the full robustness stack: per-attempt deadline,
        decorrelated-jitter retry under the elapsed budget, down-
        cooldown, and :class:`~.tier.HostLostError` when the peer
        cannot be reached within the budget. ``best_effort`` ops
        (drop / mark_drained — side-effects a dead peer already has by
        being dead) try ONCE and fail fast instead of paying the whole
        retry budget per call against an unreachable peer."""
        if self._killed or self._is_down():
            raise HostLostError(
                f"peer host {self.host_id} ({self.addr_str}) is "
                f"{'dead' if self._killed else 'in down cooldown'}"
            )
        deadline = (
            deadline_s
            if deadline_s is not None
            else env_float(DEADLINE_ENV_VAR, _DEFAULT_DEADLINE_S)
        )
        if best_effort:
            try:
                return self._call_once(header, payload, deadline)
            except _WireFailure as e:
                self._mark_down()
                raise HostLostError(
                    f"peer host {self.host_id} ({self.addr_str}) "
                    f"unreachable (best-effort): {e}"
                ) from e
        budget = env_float(RETRY_BUDGET_ENV_VAR, _DEFAULT_RETRY_BUDGET_S)
        cap = env_float(RETRY_CAP_ENV_VAR, _DEFAULT_RETRY_CAP_S)
        if cap <= 0:
            cap = _DEFAULT_RETRY_CAP_S
        floor = min(_RETRY_FLOOR_S, cap)
        prev_delay = floor
        start = time.monotonic()
        attempt = 0
        while True:
            attempt += 1
            try:
                return self._call_once(
                    header, payload, deadline, attempt=attempt - 1
                )
            except _WireFailure as e:
                delay = min(
                    cap,
                    _retry_rng.uniform(floor, max(floor, prev_delay * 3.0)),
                )
                prev_delay = delay
                elapsed = time.monotonic() - start
                if elapsed + delay > budget:
                    self._mark_down()
                    raise HostLostError(
                        f"peer host {self.host_id} ({self.addr_str}) "
                        f"unreachable after {attempt} attempt(s), "
                        f"{elapsed:.1f}s of {budget:g}s budget: {e}"
                    ) from e
                _bump("retries")
                telemetry.counter(
                    _metric_names.HOT_TIER_REPLICATION_RETRIES
                ).inc()
                tracing.instant(
                    "snapwire.retry",
                    op=header.get("op"),
                    peer=self.addr_str,
                    attempt=attempt,
                    delay_s=round(delay, 3),
                )
                logger.warning(
                    f"snapwire: RPC to peer host {self.host_id} failed "
                    f"(attempt {attempt}): {e}; retrying in {delay:.2f}s"
                )
                time.sleep(delay)

    # ----------------------------------------------------------- operations

    @staticmethod
    def _object_path(root: str, key: str) -> str:
        prefix = root.rstrip("/") + "/"
        return key[len(prefix):] if key.startswith(prefix) else key

    def _encode_raw_frame(
        self, chunk: bytes, off: int, codec_name: Optional[str]
    ) -> Tuple[List[Any], bytes, bool]:
        """One raw frame: ``([kind, off, length, enc_len, codec],
        encoded_bytes, lossy)``. Incompressible or codec-unsuitable
        chunks degrade to uncompressed, never fail the push."""
        from .. import codecs

        length = len(chunk)
        enc = chunk
        name: Optional[str] = None
        lossy = False
        if codec_name == "int8":
            try:
                import numpy as _np

                # The wire layer has no dtype metadata: the glob opt-in
                # asserts float32 moments, and the finiteness probe
                # (chunkstore's plan-time gate, as close as a byte
                # stream allows) rejects payloads whose float32 view is
                # not finite — a wrong-dtype leaf usually reads as
                # inf/nan somewhere and degrades to lossless instead of
                # quantizing garbage. Non-float32 payloads that survive
                # the probe are the opt-in's known hazard: keep the
                # globs narrow.
                view = _np.frombuffer(chunk, dtype=_np.float32)
                if not bool(_np.isfinite(view).all()):
                    raise ValueError(
                        "int8 opt-in payload is not finite float32"
                    )
                enc = codecs.encode("int8", chunk, dtype_name="float32")
                name, lossy = "int8", True
            except Exception:
                logger.debug(
                    "snapwire int8 frame degraded to lossless",
                    exc_info=True,
                )
                codec_name = _lossless_fallback()
        if not lossy and codec_name:
            try:
                cand = codecs.encode(codec_name, chunk)
                if len(cand) < length:
                    enc, name = cand, codec_name
            except Exception:
                logger.debug(
                    "snapwire codec encode degraded to raw", exc_info=True
                )
        return ["raw", off, length, len(enc), name], enc, lossy

    def put(
        self,
        key: str,
        data: bytes,
        tag: str,
        root: str,
        capacity_bytes: Optional[int] = None,
    ) -> Tuple[bool, str]:
        """Push one object replica, delta-encoded against the peer's
        acknowledged previous cut of the same path. Returns
        ``(stored, stored_tag)`` — ``stored`` False on a capacity
        refusal (the caller substitutes a spare host), ``stored_tag``
        the content tag of the bytes the peer actually holds (differs
        from ``tag`` only for lossy int8 pushes). Raises
        :class:`~.tier.HostLostError` when the peer cannot be reached
        within the deadline+retry budget."""
        path = self._object_path(root, key)
        size = len(data)
        codec_name = _resolve_codec(path)
        chunk_bytes = _chunk_bytes()
        delta_on = _delta_enabled()
        with self._lock:
            basis = dict(self._basis.get(path) or {})

        fps: Optional[List[str]] = None
        frames: List[List[Any]] = []
        parts: List[bytes] = []
        lossy = False
        used_refs = False
        if delta_on:
            fps = fingerprint_host_chunked(data, chunk_bytes)
            base_ok = bool(basis) and basis.get("chunk") == chunk_bytes
            base_fps = basis.get("fps") or []
            base_size = int(basis.get("size") or 0)
            for i, fp in enumerate(fps):
                off = i * chunk_bytes
                length = min(chunk_bytes, size - off)
                if (
                    base_ok
                    and i < len(base_fps)
                    and base_fps[i] == fp
                    and min(chunk_bytes, base_size - off) == length
                ):
                    frames.append(["ref", off, length])
                    used_refs = True
                else:
                    frame, enc, frame_lossy = self._encode_raw_frame(
                        data[off : off + length], off, codec_name
                    )
                    frames.append(frame)
                    parts.append(enc)
                    lossy = lossy or frame_lossy
        else:
            frame, enc, lossy = self._encode_raw_frame(data, 0, codec_name)
            frames.append(frame)
            parts.append(enc)

        header: Dict[str, Any] = {
            "v": wire.PROTOCOL_VERSION,
            "op": "put",
            "key": key,
            "root": root.rstrip("/"),
            "tag": tag,
            "size": size,
            "lossy": lossy,
            "frames": frames,
        }
        if used_refs:
            header["basis"] = {
                "key": basis["key"],
                "tag": basis["stored_tag"],
            }
        payload = b"".join(parts)
        try:
            resp, _ = self._call(header, payload)
        except HostLostError:
            # A push that could not reach the peer (dead, down, budget
            # exhausted): counted so the take's replication window (and
            # the replication-degraded doctor rule) sees wire distress
            # even when zero pushes succeeded.
            _bump("push_failures")
            raise
        if not resp.get("ok"):
            err = resp.get("error") or {}
            if err.get("kind") in ("stale_basis", "bad_frame") and (
                used_refs or basis
            ):
                # The peer no longer holds (or disagrees about) the
                # basis cut: drop it and re-push full — one level of
                # recursion by construction (no basis left).
                with self._lock:
                    self._basis.pop(path, None)
                _bump("retries")
                telemetry.counter(
                    _metric_names.HOT_TIER_REPLICATION_RETRIES
                ).inc()
                return self.put(key, data, tag, root, capacity_bytes)
            # A server-refused push (corrupt_push, bad_frame on a full
            # push) is a failed push too — the window and the doctor's
            # evidence must see it.
            _bump("push_failures")
            raise HostLostError(
                f"peer host {self.host_id} refused put({key}): {err!r}"
            )
        stored = bool(resp.get("stored"))
        if not stored:
            return False, tag  # capacity refusal; no ack, no basis
        stored_tag = str(resp.get("stored_tag") or tag)
        _bump("pushes")
        _bump("payload_bytes", size)
        _bump("wire_bytes", len(payload))
        telemetry.counter(
            _metric_names.HOT_TIER_REPLICATION_PUSHES
        ).inc()
        telemetry.counter(_metric_names.HOT_TIER_REPLICATION_BYTES).inc(
            size
        )
        telemetry.counter(
            _metric_names.HOT_TIER_REPLICATION_DELTA_BYTES
        ).inc(len(payload))
        with self._lock:
            if lossy or not delta_on:
                # A lossy push's stored bytes differ from ours — their
                # chunk fingerprints are unknown here, so it cannot
                # seed a delta basis.
                self._basis.pop(path, None)
            else:
                self._basis[path] = {
                    "key": key,
                    "stored_tag": stored_tag,
                    "fps": fps,
                    "chunk": chunk_bytes,
                    "size": size,
                }
        return True, stored_tag

    def get(self, key: str) -> HotObject:
        resp, payload = self._call(
            {"v": wire.PROTOCOL_VERSION, "op": "get", "key": key}
        )
        if not resp.get("ok"):
            err = resp.get("error") or {}
            if err.get("kind") == "not_found":
                raise KeyError(key)
            raise HostLostError(
                f"peer host {self.host_id} failed get({key}): {err!r}"
            )
        return HotObject(
            data=payload,
            tag=str(resp.get("tag") or ""),
            root=str(resp.get("root") or ""),
            put_t=float(resp.get("put_t") or 0.0),
            drained=bool(resp.get("drained")),
        )

    def query(self, key: str) -> Optional[Dict[str, Any]]:
        resp, _ = self._call(
            {"v": wire.PROTOCOL_VERSION, "op": "query", "key": key}
        )
        if not resp.get("ok") or not resp.get("found"):
            return None
        return {
            "tag": resp.get("tag"),
            "nbytes": resp.get("nbytes"),
            "put_t": resp.get("put_t"),
            "drained": resp.get("drained"),
        }

    def drop(self, key: str) -> None:
        self._call(
            {"v": wire.PROTOCOL_VERSION, "op": "drop", "key": key},
            best_effort=True,
        )

    def mark_drained(self, key: str, tag: Optional[str]) -> None:
        self._call(
            {
                "v": wire.PROTOCOL_VERSION,
                "op": "mark_drained",
                "key": key,
                "tag": tag,
            },
            best_effort=True,
        )

    def drop_stale(self, key: str, keep_tags: List[str]) -> None:
        self._call(
            {
                "v": wire.PROTOCOL_VERSION,
                "op": "drop_stale",
                "key": key,
                "keep_tags": list(keep_tags),
            },
            best_effort=True,
        )

    def occupancy(self) -> Optional[Dict[str, Any]]:
        try:
            resp, _ = self._call({"v": wire.PROTOCOL_VERSION, "op": "stats"})
        except HostLostError:
            return None
        return resp.get("occupancy") if resp.get("ok") else None

    def wire_stats(self) -> Optional[Dict[str, Any]]:
        """The peer's wiretap ``wire`` sample block (piggybacked on the
        ``stats`` op) — the ops CLI's fleet-wide wire view reads this.
        None when the peer is down or has recorded no RPCs yet. A
        probe, so best-effort: one attempt, no retry budget (the
        caller's verdict for an unreachable peer IS the answer)."""
        try:
            resp, _ = self._call(
                {"v": wire.PROTOCOL_VERSION, "op": "stats"},
                best_effort=True,
            )
        except HostLostError:
            return None
        block = resp.get("wire") if resp.get("ok") else None
        return block if isinstance(block, dict) else None

    def mem_stats(self) -> Optional[Dict[str, Any]]:
        """The peer's snapmem ``memory`` sample block (piggybacked on
        the ``stats`` op like :meth:`wire_stats`) — `ops --mem`'s
        fleet-wide memory table reads this. Best-effort probe."""
        try:
            resp, _ = self._call(
                {"v": wire.PROTOCOL_VERSION, "op": "stats"},
                best_effort=True,
            )
        except HostLostError:
            return None
        block = resp.get("memory") if resp.get("ok") else None
        return block if isinstance(block, dict) else None


# --------------------------------------------------------- registration


def connect_peer(
    host_id: int,
    addr: str,
    process: Any = None,
    capacity_bytes: Optional[int] = None,
    generation: int = 0,
) -> RemotePeer:
    """Create a :class:`RemotePeer` for ``addr`` and register it as the
    backing store of virtual host ``host_id`` — every tier operation
    addressing that host now crosses the wire. ``generation`` stamps
    the membership incarnation (respawned peers register one higher
    than their predecessor; see repair.py)."""
    from . import tier

    peer = RemotePeer(
        host_id,
        addr,
        process=process,
        capacity_bytes=capacity_bytes,
        generation=generation,
    )
    tier.register_remote_host(host_id, peer)
    return peer


def parse_addrs_spec(spec: str) -> Dict[str, str]:
    """Raw ``host=addr`` entries of an address-book spec (format
    ``"1=host:port,2=host:port"``), preserved verbatim — no validation,
    so a rewrite (repair.py's hot-reload) round-trips malformed-but-
    diagnosable entries instead of silently dropping them. The
    registration path validates what it consumes."""
    entries: Dict[str, str] = {}
    for entry in (spec or "").strip().split(","):
        entry = entry.strip()
        if not entry:
            continue
        host_part, sep, addr = entry.partition("=")
        # A separator-less entry is kept (with an empty addr) so the
        # registration path can still warn about it by name.
        entries[host_part.strip()] = addr.strip() if sep else ""
    return entries


def register_peers_from_env() -> Dict[int, RemotePeer]:
    """Register peers from ``TPUSNAPSHOT_HOT_TIER_ADDRS`` (format
    ``"1=host:port,2=host:port"``; host ids already registered are left
    alone). Called by ``enable_hot_tier`` so a multi-host deployment
    only needs the address book in the environment."""
    from . import tier

    out: Dict[int, RemotePeer] = {}
    for host_part, addr in parse_addrs_spec(
        os.environ.get(ADDRS_ENV_VAR) or ""
    ).items():
        if not host_part.isdigit() or ":" not in addr:
            logger.warning(
                f"snapwire: malformed {ADDRS_ENV_VAR} entry "
                f"{host_part + '=' + addr!r} (expected host_id=host:port); "
                f"skipped"
            )
            continue
        host_id = int(host_part)
        if tier.remote_host(host_id) is not None:
            continue
        out[host_id] = connect_peer(host_id, addr)
    return out
