"""snapserve client: the ``snapserve://host:port/<backend-url>`` plugin.

Reads go over the read service; writes, deletes, durability settles,
and enumeration go straight to the backend — the read plane never
proxies mutations, so a ``RemoteSnapshot`` writing its best-effort
flight report or appending the ledger behaves byte-identically to a
direct reader.

**Fleet mode** (snapfleet): the address part may list several servers
(``snapserve://h1:p1,h2:p2,h3:p3/<backend>``, or a single address plus
``TPUSNAPSHOT_SNAPSERVE_FLEET_ADDRS``). Each read routes to its
consistent-hash ring owner (:mod:`.fleet` — the same content keys the
server caches shard by), fails over to the next ring replica on a
transport failure or a down latch, and only past the LAST member
degrades to the direct-backend fallback — per-reason counted
(``owner_miss``: owner was latched down, a replica served without an
attempt; ``failover``: a member failed mid-read and the next one
served; ``fallback``: every member exhausted), and attributed
per-server in the restore flight report's ``read_plane`` block.

Degraded mode is the load-bearing contract: when the server (or every
fleet member) is unreachable, every read falls back to a DIRECT
backend read through the normal resolution path (retry policy and wrap
hooks included) — bit-exact, counted
(``tpusnapshot_snapserve_fallbacks_total{reason}``), surfaced in the
restore flight report's ``read_plane`` block, the
``read-plane-degraded`` / ``fleet-degraded`` doctor rules, and the
ledger — never an error. After a transport failure the client skips
RPC attempts to that server for a short cooldown
(``TPUSNAPSHOT_SNAPSERVE_DOWN_COOLDOWN_S``) so a dead server costs one
dial timeout, not one per object.

Every request carries a tenant id (``TPUSNAPSHOT_SNAPSERVE_TENANT``,
default ``"default"``) for the server's per-tenant admission; an
over-quota tenant's responses are DELAYED (deferred grant), never
failed, so the client needs no tenant-side handling.

Every RPC attempt announces a ``snapserve.request`` storage-op boundary
(:func:`torchsnapshot_tpu_torch.io_types.emit_storage_op`) BEFORE touching
the network, which is where faultline's ``kill_server`` /
``slow_server`` / ``kill_fleet_member`` / ``slow_fleet_member``
schedule rules hook in deterministically.
"""

import asyncio
import contextvars
import json
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from .. import telemetry, tracing, wiretap
from ..io_types import IOReq, StoragePlugin, emit_storage_op, io_payload
from ..telemetry import metrics as _metric_names
from ..utils.env import env_float
from . import fleet
from .protocol import (
    PROTOCOL_VERSION,
    ProtocolError,
    recv_frame,
    send_frame,
    wire_to_error,
)

logger = logging.getLogger(__name__)

ADDR_ENV_VAR = "TPUSNAPSHOT_SNAPSERVE_ADDR"
DOWN_COOLDOWN_ENV_VAR = "TPUSNAPSHOT_SNAPSERVE_DOWN_COOLDOWN_S"
_DEFAULT_DOWN_COOLDOWN_S = 5.0
TIMEOUT_ENV_VAR = "TPUSNAPSHOT_SNAPSERVE_TIMEOUT_S"
_DEFAULT_TIMEOUT_S = 60.0
TENANT_ENV_VAR = "TPUSNAPSHOT_SNAPSERVE_TENANT"
_DIAL_TIMEOUT_S = 5.0
_POOL_MAX_CONNS = 16

# Transport-level failures = "the server is unreachable" = fall back.
# Anything the server itself reports (not-found, range, backend error)
# is re-raised as the matching exception — it is the BACKEND speaking,
# and must behave identically to a direct read. The distinction cannot
# be made by exception TYPE alone (a remote not-found unmarshals to
# FileNotFoundError, which is an OSError like every socket failure), so
# _rpc_read wraps genuine transport failures in _TransportFailure and
# lets unmarshalled server verdicts fly bare.
_TRANSPORT_ERRORS = (
    ConnectionError,
    asyncio.IncompleteReadError,
    asyncio.TimeoutError,
    ProtocolError,
    OSError,
)


class _TransportFailure(Exception):
    """The server could not be spoken to (dial/send/recv/framing died).
    Internal: always caught by ``read()`` and converted to a fallback;
    ``__cause__`` carries the underlying failure."""


def _tap(
    op: str,
    start: float,
    outcome: str,
    timeout_s: float,
    *,
    bytes_in: int = 0,
    bytes_out: int = 0,
    peer: Optional[str] = None,
) -> None:
    """Best-effort wiretap record for one snapserve RPC attempt —
    observability must never take the client down with it."""
    try:
        wiretap.record(
            "snapserve",
            op,
            seconds=time.monotonic() - start,
            outcome=outcome,
            bytes_in=bytes_in,
            bytes_out=bytes_out,
            deadline_s=timeout_s,
            peer=peer,
        )
    except Exception:  # pragma: no cover - defensive
        logger.debug("snapserve: wiretap record failed", exc_info=True)


def parse_snapserve_url(spec: str) -> Tuple[str, str]:
    """``"host:port/<backend-url>"`` (the part after ``snapserve://``)
    → ``(addr, backend_url)``. The address part may be a comma-joined
    FLEET (``h1:p1,h2:p2,h3:p3`` — snapfleet routes over the member
    ring); the backend may itself carry a scheme (``memory://…``,
    ``gs://…``) or be a bare fs path (leading ``/``)."""
    addr, sep, backend = spec.partition("/")
    if not sep or not backend:
        raise ValueError(
            f"Malformed snapserve URL {spec!r}: expected "
            f"snapserve://host:port[,host:port...]/<backend-url>"
        )
    for one in addr.split(","):
        host, colon, port = one.rpartition(":")
        if not colon or not host or not port.isdigit():
            raise ValueError(
                f"Malformed snapserve address {one!r}: expected host:port"
            )
    if backend.startswith("snapserve://"):
        raise ValueError(
            "snapserve URLs do not nest: the backend of a snapserve URL "
            "must be a real storage backend"
        )
    if "://" not in backend and not backend.startswith("/"):
        # fs paths written without the leading slash after the addr
        # ("snapserve://h:p/tmp/x" parses backend "tmp/x") would point
        # somewhere surprising; require an absolute form.
        backend = "/" + backend
    return addr, backend


# --------------------------------------------------- client-side read stats
#
# Two layers. The module-level totals (stats_snapshot) are the
# process-lifetime counters tests/bench read. Per-RESTORE attribution —
# the flight report's read_plane block — is a contextvar-scoped
# accumulator instead of a delta over the globals: two restores running
# concurrently in one process (the bench fan-out / CI smoke pattern)
# must not absorb each other's fallbacks, or the read-plane-degraded
# rule fires against the wrong restore. The contextvar set in the
# restoring thread propagates into every asyncio.run() that thread
# issues (asyncio copies the ambient context), which is exactly where
# this plugin's reads execute.

_STATS_LOCK = threading.Lock()
_STATS: Dict[str, Any] = {
    "remote_objects": 0,
    "remote_bytes": 0,
    "fallback_objects": 0,
    "fallback_bytes": 0,
    "owner_misses": 0,
    "failover_objects": 0,
    "reasons": {},
    "servers": {},
}

_SCOPE: "contextvars.ContextVar[Optional[Dict[str, Any]]]" = (
    contextvars.ContextVar("snapserve_restore_scope", default=None)
)


def _note_remote(
    nbytes: int,
    server: Optional[str] = None,
    outcome: Optional[str] = None,
) -> None:
    def _apply(stats: Dict[str, Any]) -> None:
        stats["remote_objects"] += 1
        stats["remote_bytes"] += nbytes
        if outcome == "owner_miss":
            stats["owner_misses"] += 1
        elif outcome == "failover":
            stats["failover_objects"] += 1
        if server is not None:
            entry = stats["servers"].setdefault(
                server, {"objects": 0, "bytes": 0}
            )
            entry["objects"] += 1
            entry["bytes"] += nbytes

    with _STATS_LOCK:
        _apply(_STATS)
    scope = _SCOPE.get()
    if scope is not None:
        with _STATS_LOCK:
            _apply(scope)


def _note_fallback(nbytes: int, reason: str) -> None:
    with _STATS_LOCK:
        _STATS["fallback_objects"] += 1
        _STATS["fallback_bytes"] += nbytes
        _STATS["reasons"][reason] = _STATS["reasons"].get(reason, 0) + 1
    scope = _SCOPE.get()
    if scope is not None:
        with _STATS_LOCK:
            scope["fallback_objects"] += 1
            scope["fallback_bytes"] += nbytes
            scope["reasons"][reason] = scope["reasons"].get(reason, 0) + 1


def stats_snapshot() -> Dict[str, Any]:
    """Process-lifetime client totals (all operations, all threads)."""
    with _STATS_LOCK:
        out = dict(_STATS)
        out["reasons"] = dict(_STATS["reasons"])
        out["servers"] = {
            addr: dict(entry)
            for addr, entry in _STATS["servers"].items()
        }
        return out


def restore_stats_begin() -> Any:
    """Open a per-restore read-plane attribution scope (cheap; whether
    any snapserve traffic happens is only known at collect time)."""
    scope = {
        "remote_objects": 0,
        "remote_bytes": 0,
        "fallback_objects": 0,
        "fallback_bytes": 0,
        "owner_misses": 0,
        "failover_objects": 0,
        "reasons": {},
        "servers": {},
    }
    return scope, _SCOPE.set(scope)


def restore_stats_collect(token: Any) -> Optional[Dict[str, Any]]:
    """Close the scope opened by :func:`restore_stats_begin` and return
    its ``read_plane`` block: remote vs fallback object/byte counts and
    fallback reasons — THIS restore's traffic only, regardless of what
    other threads did meanwhile. None when the operation saw no
    snapserve traffic at all (direct snapshots)."""
    if token is None:
        return None
    scope, var_token = token
    try:
        _SCOPE.reset(var_token)
    except ValueError:
        # Reset from a different context than set (defensive; collect
        # runs in the same thread as begin in practice).
        logger.warning("read-plane scope reset crossed contexts")
    with _STATS_LOCK:
        summary = {
            "remote_objects": scope["remote_objects"],
            "remote_bytes": scope["remote_bytes"],
            "fallback_objects": scope["fallback_objects"],
            "fallback_bytes": scope["fallback_bytes"],
        }
        reasons = dict(scope["reasons"])
        owner_misses = scope["owner_misses"]
        failover_objects = scope["failover_objects"]
        servers = {
            addr: dict(entry)
            for addr, entry in scope["servers"].items()
        }
    if not any(summary.values()):
        return None
    if reasons:
        summary["fallback_reasons"] = reasons
    # Fleet attribution rides along only when a fleet was in play —
    # single-server restores keep the block byte-identical to before.
    if owner_misses:
        summary["owner_misses"] = owner_misses
    if failover_objects:
        summary["failover_objects"] = failover_objects
    if len(servers) > 1 or owner_misses or failover_objects:
        summary["servers"] = servers
    return summary


def ping_server(addr: str, timeout_s: float = 10.0) -> Dict[str, Any]:
    """One-shot ``ping`` RPC: the liveness probe for smoke scripts,
    doctor checks, and tests. Returns the response header (``server``
    names the service answering); raises on an unreachable or
    non-snapserve endpoint. Every wire wait — dial, send, recv — is
    bounded by ``timeout_s``."""

    async def _ping() -> Dict[str, Any]:
        host, _, port = addr.rpartition(":")
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(host, int(port)), timeout_s
        )
        try:
            await asyncio.wait_for(
                send_frame(
                    writer, {"v": PROTOCOL_VERSION, "op": "ping", "id": 0}
                ),
                timeout_s,
            )
            header, _ = await asyncio.wait_for(recv_frame(reader), timeout_s)
            if not header.get("ok"):
                raise RuntimeError(f"ping RPC failed: {header!r}")
            return header
        finally:
            writer.close()

    start = time.monotonic()
    try:
        result = asyncio.run(_ping())
    except BaseException as e:
        _tap("ping", start, wiretap.classify_error(e), timeout_s, peer=addr)
        raise
    _tap("ping", start, "ok", timeout_s, peer=addr)
    return result


def fetch_member_info(addr: str, timeout_s: float = 10.0) -> Dict[str, Any]:
    """One-shot ``membership`` RPC: the fleet supervisor's probe.
    Returns ``{"member", "generation"}`` — the answering server's fleet
    identity and incarnation stamp. Every wire wait is bounded by
    ``timeout_s``; unreachability raises (the supervisor classifies a
    timeout as a hung strike and a refused connection as death)."""

    async def _fetch() -> Dict[str, Any]:
        host, _, port = addr.rpartition(":")
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(host, int(port)), timeout_s
        )
        try:
            await asyncio.wait_for(
                send_frame(
                    writer,
                    {"v": PROTOCOL_VERSION, "op": "membership", "id": 0},
                ),
                timeout_s,
            )
            header, _ = await asyncio.wait_for(recv_frame(reader), timeout_s)
            if not header.get("ok"):
                raise RuntimeError(f"membership RPC failed: {header!r}")
            return {
                "member": header.get("member"),
                "generation": header.get("generation"),
            }
        finally:
            writer.close()

    start = time.monotonic()
    try:
        result = asyncio.run(_fetch())
    except BaseException as e:
        _tap(
            "membership", start, wiretap.classify_error(e), timeout_s,
            peer=addr,
        )
        raise
    _tap("membership", start, "ok", timeout_s, peer=addr)
    return result


def plan_remote(
    addr: str, doc: Dict[str, Any], timeout_s: float = 10.0
) -> Dict[str, Any]:
    """One-shot ``plan`` RPC (chunk pushdown): post a plan document
    (record layout + slice boxes, see
    :func:`.pushdown.plan_from_doc`) and return the server's record
    subset. The server computes with the SAME pushdown module the
    local cut uses, so this answer equals the local ground truth —
    tests pin the equality."""

    async def _plan() -> Dict[str, Any]:
        host, _, port = addr.rpartition(":")
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(host, int(port)), timeout_s
        )
        try:
            payload = json.dumps(doc, sort_keys=True).encode("utf-8")
            await asyncio.wait_for(
                send_frame(
                    writer,
                    {"v": PROTOCOL_VERSION, "op": "plan", "id": 0},
                    payload,
                ),
                timeout_s,
            )
            header, _ = await asyncio.wait_for(recv_frame(reader), timeout_s)
            if not header.get("ok"):
                raise wire_to_error(header.get("error"), "<plan>")
            return header.get("plan") or {}
        finally:
            writer.close()

    start = time.monotonic()
    try:
        result = asyncio.run(_plan())
    except BaseException as e:
        _tap("plan", start, wiretap.classify_error(e), timeout_s, peer=addr)
        raise
    _tap("plan", start, "ok", timeout_s, peer=addr)
    return result


class SnapServePlugin(StoragePlugin):
    """Storage plugin speaking to a snapserve server, with direct
    backend fallback. Resolved by ``url_to_storage_plugin`` for
    ``snapserve://`` URLs (and then wrapped in the normal retry layer,
    so transient SERVER-SIDE backend failures retry like direct ones)."""

    def __init__(self, spec: str) -> None:
        addr_spec, self._backend_url = parse_snapserve_url(spec)
        url_addrs = [a for a in addr_spec.split(",") if a]
        env_addrs = [
            a.strip()
            for a in os.environ.get(fleet.FLEET_ADDRS_ENV_VAR, "").split(",")
            if a.strip()
        ]
        # Env members are ADDITIVE: the URL pins the seed member(s), the
        # env widens the ring (e.g. one shared URL per job, per-host
        # member lists injected by the launcher).
        self._addrs: List[str] = url_addrs + [
            a for a in env_addrs if a not in url_addrs
        ]
        self._addr_str = self._addrs[0]
        self._fleet: Optional[fleet.FleetView] = (
            fleet.FleetView(self._addrs) if len(self._addrs) > 1 else None
        )
        self._direct: Optional[StoragePlugin] = None
        # Connection pools are per (event loop, server): Snapshot runs
        # each operation under its own asyncio.run(), and a socket
        # created on a dead loop cannot be awaited from a new one.
        # Entries hold the LOOP OBJECT alongside the conns and check
        # identity AND liveness on lookup — keying by id() alone could
        # hand a freshly-allocated loop a dead loop's sockets when
        # CPython recycles the address, and an id-recycled entry whose
        # old loop object is still reachable (so identity matches
        # nothing) would otherwise pin dead sockets forever. Closed-loop
        # entries are swept on every lookup.
        self._pools: Dict[
            Tuple[int, str], Tuple[Any, List[Tuple[Any, Any]]]
        ] = {}
        self._lock = threading.Lock()
        self._down_until = 0.0
        self._request_id = 0
        # Per-instance tenant id; falls back to the env knob. Lets one
        # process carry several tenants (tests/bench) — env is global.
        self.tenant_override: Optional[str] = None
        self.max_write_concurrency = 16
        self.max_read_concurrency = 16

    # ------------------------------------------------------------- plumbing

    def _direct_plugin(self) -> StoragePlugin:
        """The direct backend plugin (fallback reads + ALL mutations),
        resolved through the normal path so retries and wrap hooks
        apply exactly as they would for a non-snapserve reader."""
        with self._lock:
            plugin = self._direct
        if plugin is not None:
            return plugin
        from ..storage_plugin import url_to_storage_plugin

        plugin = url_to_storage_plugin(self._backend_url)
        with self._lock:
            if self._direct is None:
                self._direct = plugin
                return plugin
            keep = self._direct
        try:
            plugin.close()
        except Exception:
            logger.warning(
                "snapserve duplicate direct plugin close failed",
                exc_info=True,
            )
        return keep

    def _next_id(self) -> int:
        with self._lock:
            self._request_id += 1
            return self._request_id

    def _pool(self, addr: str) -> List[Tuple[Any, Any]]:
        loop = asyncio.get_running_loop()
        stale: List[Tuple[Any, Any]] = []
        with self._lock:
            # Sweep entries whose loop has been closed — their sockets
            # can never be awaited again, and leaving them in place is
            # the id-recycle hazard described in __init__.
            for key in [
                k for k, (lp, _c) in self._pools.items() if lp.is_closed()
            ]:
                stale.extend(self._pools.pop(key)[1])
            entry = self._pools.get((id(loop), addr))
            if entry is None or entry[0] is not loop:
                if entry is not None:
                    stale.extend(entry[1])
                entry = (loop, [])
                self._pools[(id(loop), addr)] = entry
        for _reader, writer in stale:
            try:
                writer.transport.abort()
            except Exception:
                logger.debug(
                    "snapserve stale pooled conn abort failed",
                    exc_info=True,
                )
        return entry[1]

    async def _checkout(self, addr: str) -> Tuple[Any, Any]:
        pool = self._pool(addr)
        with self._lock:
            while pool:
                conn = pool.pop()
                # A pooled conn the peer already closed would fail the
                # next send; skip it here (cheap) instead of burning a
                # failover attempt on it.
                if not conn[1].is_closing():
                    return conn
                try:
                    conn[1].transport.abort()
                except Exception:
                    logger.debug(
                        "snapserve closing pooled conn abort failed",
                        exc_info=True,
                    )
        host, _, port = addr.rpartition(":")
        return await asyncio.wait_for(
            asyncio.open_connection(host, int(port)), _DIAL_TIMEOUT_S
        )

    def _checkin(self, addr: str, conn: Tuple[Any, Any]) -> None:
        pool = self._pool(addr)
        with self._lock:
            if len(pool) < _POOL_MAX_CONNS:
                pool.append(conn)
                return
        try:
            conn[1].close()
        except Exception:
            logger.debug("snapserve pool overflow close failed", exc_info=True)

    def _mark_down(self) -> None:
        cooldown = env_float(
            DOWN_COOLDOWN_ENV_VAR, _DEFAULT_DOWN_COOLDOWN_S
        )
        # The degraded TRANSITION as a trace instant (stamped with the
        # restore's trace id by tracing): a mid-restore server death is
        # visible in the merged trace at the exact moment fallback
        # direct reads began — same causal chain, different data path.
        tracing.instant(
            "snapserve.degraded", addr=self._addr_str, cooldown_s=cooldown
        )
        with self._lock:
            self._down_until = time.monotonic() + cooldown
        try:
            wiretap.note_degrade("server_down", peer=self._addr_str)
        except Exception:  # pragma: no cover - defensive
            logger.debug("snapserve: blackbox dump failed", exc_info=True)

    def _is_down(self) -> bool:
        with self._lock:
            return time.monotonic() < self._down_until

    # ------------------------------------------------------------------ RPC

    async def _rpc_read(
        self, addr: str, path: str, byte_range: Optional[tuple]
    ) -> bytes:
        timeout_s = env_float(TIMEOUT_ENV_VAR, _DEFAULT_TIMEOUT_S)
        start = time.monotonic()
        # Causal context on the wire (snapxray): the restore root's
        # trace id + a flow id the server's spans bind to — the merged
        # trace draws the client→server arrow from this pair. Generated
        # even when THIS process records no events (a tracing-on server
        # still attributes its work to this restore).
        trace_id = tracing.current_trace_id()
        flow_id = tracing.flow_start(
            "snapserve.rpc", path=path, addr=addr
        )
        try:
            conn = await self._checkout(addr)
        except _TRANSPORT_ERRORS as e:
            _tap("read", start, "transport", timeout_s, peer=addr)
            raise _TransportFailure(f"dial {addr}: {e!r}") from e
        reader, writer = conn
        header_doc: Dict[str, Any] = {
            "v": PROTOCOL_VERSION,
            "op": "read",
            "id": self._next_id(),
            "backend": self._backend_url,
            "path": path,
            "range": list(byte_range) if byte_range else None,
            "tenant": self.tenant_override
            or os.environ.get(TENANT_ENV_VAR)
            or "default",
        }
        if trace_id is not None or flow_id is not None:
            header_doc["trace"] = {"id": trace_id, "flow": flow_id}
        try:
            # The send is deadline-bounded like the recv: a server that
            # accepts the dial but stops reading (wedged event loop,
            # full socket buffer) must degrade to the direct-read
            # fallback instead of hanging the restore (snapcheck
            # SNAP011).
            await asyncio.wait_for(
                send_frame(writer, header_doc), timeout_s
            )
            header, payload = await asyncio.wait_for(
                recv_frame(reader), timeout_s
            )
        except BaseException as e:
            try:
                writer.transport.abort()
            except Exception:
                logger.debug(
                    "snapserve conn abort failed", exc_info=True
                )
            # A wait_for expiry IS a blown per-RPC budget, distinct
            # from a dead peer — the deadline-margin story needs the
            # two separated.
            _tap(
                "read",
                start,
                "deadline_miss"
                if isinstance(e, asyncio.TimeoutError)
                else wiretap.classify_error(e),
                timeout_s,
                peer=addr,
            )
            if isinstance(e, _TRANSPORT_ERRORS):
                raise _TransportFailure(
                    f"rpc to {addr}: {e!r}"
                ) from e
            raise
        self._checkin(addr, conn)
        # The response hop closes the flow: a Perfetto arrow back from
        # the server's handling step to this client's enclosing read.
        tracing.flow_end("snapserve.rpc", flow_id, path=path)
        if not header.get("ok"):
            # The SERVER answered: this is the backend's verdict
            # (not-found / range / backend failure), not unreachability
            # — it propagates exactly as a direct read would raise it.
            _tap(
                "read",
                start,
                wiretap.outcome_from_wire_error(header.get("error")),
                timeout_s,
                peer=addr,
            )
            raise wire_to_error(header.get("error"), path)
        _tap(
            "read", start, "ok", timeout_s, bytes_in=len(payload), peer=addr
        )
        return payload

    # ---------------------------------------------------------------- reads

    async def read(self, io_req: IOReq) -> None:
        emit_storage_op("snapserve.request", io_req.path)
        if self._fleet is not None:
            await self._fleet_read(io_req)
            return
        if self._is_down():
            await self._fallback_read(io_req, reason="down")
            return
        try:
            payload = await self._rpc_read(
                self._addr_str, io_req.path, io_req.byte_range
            )
        except _TransportFailure as e:
            logger.warning(
                f"snapserve: server {self._addr_str} unreachable for "
                f"read({io_req.path}): {e.__cause__!r}; degrading to "
                f"direct backend reads"
            )
            self._mark_down()
            await self._fallback_read(io_req, reason="unreachable")
            return
        io_req.data = payload
        _note_remote(len(payload), server=self._addr_str)
        telemetry.counter(
            _metric_names.SNAPSERVE_REMOTE_READS, result="served"
        ).inc()

    async def _fleet_read(self, io_req: IOReq) -> None:
        """The failover ladder: ring owner first, then each further ring
        replica, direct backend only past the LAST member. Outcomes:
        ``owner`` (owner served), ``owner_miss`` (owner was latched down
        — no attempt burned — and a replica served), ``failover`` (a
        member FAILED mid-read and a later one served), fallback reason
        ``fleet-exhausted`` (nobody served). A member that fails is
        down-latched on the shared FleetView so the ladder costs one
        dial timeout per death, not one per object."""
        assert self._fleet is not None
        key = fleet.routing_key(self._backend_url, io_req.path)
        ladder = self._fleet.route(key)
        cooldown = env_float(
            DOWN_COOLDOWN_ENV_VAR, _DEFAULT_DOWN_COOLDOWN_S
        )
        owner_skipped = False
        attempted = 0
        for addr in ladder:
            if self._fleet.is_down(addr):
                if attempted == 0:
                    owner_skipped = True
                continue
            try:
                payload = await self._rpc_read(
                    addr, io_req.path, io_req.byte_range
                )
            except _TransportFailure as e:
                attempted += 1
                logger.warning(
                    f"snapserve fleet: member {addr} unreachable for "
                    f"read({io_req.path}): {e.__cause__!r}; trying next "
                    f"ring replica"
                )
                self._fleet.mark_down(addr, cooldown)
                tracing.instant(
                    "snapserve.fleet.member_down",
                    addr=addr,
                    cooldown_s=cooldown,
                )
                try:
                    wiretap.note_degrade("fleet_member_down", peer=addr)
                except Exception:  # pragma: no cover - defensive
                    logger.debug(
                        "snapserve: blackbox dump failed", exc_info=True
                    )
                continue
            if attempted > 0:
                outcome = "failover"
            elif owner_skipped:
                outcome = "owner_miss"
            else:
                outcome = "owner"
            io_req.data = payload
            _note_remote(len(payload), server=addr, outcome=outcome)
            telemetry.counter(
                _metric_names.SNAPSERVE_REMOTE_READS, result="served"
            ).inc()
            telemetry.counter(
                _metric_names.SNAPSERVE_FLEET_ROUTES, outcome=outcome
            ).inc()
            return
        telemetry.counter(
            _metric_names.SNAPSERVE_FLEET_ROUTES, outcome="fallback"
        ).inc()
        await self._fallback_read(io_req, reason="fleet-exhausted")

    async def _fallback_read(self, io_req: IOReq, reason: str) -> None:
        telemetry.counter(
            _metric_names.SNAPSERVE_FALLBACKS, reason=reason
        ).inc()
        telemetry.counter(
            _metric_names.SNAPSERVE_REMOTE_READS, result="fallback"
        ).inc()
        await self._direct_plugin().read(io_req)
        _note_fallback(len(io_payload(io_req)), reason)

    # ------------------------------------------------- mutations: direct only

    async def write(self, io_req: IOReq) -> None:
        await self._direct_plugin().write(io_req)

    async def delete(self, path: str) -> None:
        await self._direct_plugin().delete(path)

    async def list_prefix(self, prefix: str):
        return await self._direct_plugin().list_prefix(prefix)

    async def object_age_s(self, path: str) -> Optional[float]:
        return await self._direct_plugin().object_age_s(path)

    async def object_size_bytes(self, path: str) -> Optional[int]:
        return await self._direct_plugin().object_size_bytes(path)

    def ensure_durable(self) -> None:
        with self._lock:
            plugin = self._direct
        if plugin is not None:
            plugin.ensure_durable()

    def close(self) -> None:
        with self._lock:
            pools = list(self._pools.values())
            self._pools.clear()
            direct = self._direct
            self._direct = None
        for _loop, pool in pools:
            for _reader, writer in pool:
                try:
                    writer.transport.abort()
                except Exception:
                    logger.debug(
                        "snapserve pooled conn close failed", exc_info=True
                    )
        if direct is not None:
            direct.close()
