"""snapserve server: the caching snapshot read service.

Run standalone::

    python -m torchsnapshot_tpu_torch.snapserve.server --addr 127.0.0.1:7077

or in-process (tests, bench, CI)::

    server = start_local_server()
    snap = RemoteSnapshot("memory://bucket/run", addr=server.addr)

The service is transport + :class:`ReadService`. The transport is a
plain asyncio TCP server speaking :mod:`.protocol` frames; the service
holds all the read-plane smarts:

- **Manifest memoization** — ``.snapshot_metadata`` is fetched and
  parsed once per backend root (TTL-refreshed,
  ``TPUSNAPSHOT_SNAPSERVE_META_TTL_S``); every client after the first
  is served from the memo, and the parse also yields the per-location
  checksum map the content cache keys against.
- **Single-flight deduplication** — concurrent requests for one object
  await one backend read; 32 clients restoring the same snapshot cost
  ~1x backend traffic (the collapse count is a served metric).
- **Range-read coalescing** — a ranged request for a cache-worthy
  object fetches the WHOLE object once and slices; overlapping
  chunk-reads (elastic resharding) hit the same cached bytes instead
  of issuing N overlapping backend GETs. Objects too large to cache
  (> cache cap) pass ranged reads through untouched.
- **Content cache** — byte-capped fingerprint-verified LRU
  (:class:`.cache.ByteLRU`, ``TPUSNAPSHOT_SNAPSERVE_CACHE_BYTES``,
  default 256 MiB), keyed by backend + path + manifest checksum so a
  re-take under the same path can never be served stale.
- **Per-client flow control** — each connection's in-flight response
  bytes are bounded (``TPUSNAPSHOT_SNAPSERVE_CLIENT_INFLIGHT_BYTES``,
  default 256 MiB); a client that stops draining stalls only itself.

The server is read-only by construction: the only ops it understands
are ``read``, ``stats``, ``ping``, ``plan`` (chunk pushdown — pure
compute over the request document, :mod:`.pushdown`), and
``membership`` (the fleet supervision probe, :mod:`.fleet`). Writes,
deletes, and sweeps go from clients straight to the backend.

Multi-tenant admission layers on the per-client flow control: every
request carries a tenant id (client knob
``TPUSNAPSHOT_SNAPSERVE_TENANT``), per-tenant in-flight response bytes
are bounded by ``TPUSNAPSHOT_SNAPSERVE_TENANT_QUOTA_BYTES`` (0 =
unlimited), and over-quota requests park for a DEFERRED GRANT — never
an error — dequeued weighted-fair (smallest in-flight tenant first),
so a saturating tenant queues behind its own quota while a small
tenant's requests keep flowing.
"""

import argparse
import asyncio
import collections
import logging
import threading
import time
import weakref
from typing import Any, Awaitable, Callable, Dict, List, Optional, Tuple

from .. import telemetry, tracing, wiretap
from ..io_types import IOReq, StoragePlugin, io_payload
from ..telemetry import memwatch
from ..telemetry import metrics as _metric_names
from ..utils.env import env_float, env_int
from .cache import ByteLRU, content_fingerprint
from .protocol import (
    PROTOCOL_VERSION,
    READ_PLANE_OPS,
    ProtocolError,
    error_to_wire,
    recv_frame,
    send_frame,
)

logger = logging.getLogger(__name__)

CACHE_BYTES_ENV_VAR = "TPUSNAPSHOT_SNAPSERVE_CACHE_BYTES"
_DEFAULT_CACHE_BYTES = 256 << 20
META_TTL_ENV_VAR = "TPUSNAPSHOT_SNAPSERVE_META_TTL_S"
_DEFAULT_META_TTL_S = 15.0
CLIENT_INFLIGHT_ENV_VAR = "TPUSNAPSHOT_SNAPSERVE_CLIENT_INFLIGHT_BYTES"
_DEFAULT_CLIENT_INFLIGHT_BYTES = 256 << 20
TENANT_QUOTA_ENV_VAR = "TPUSNAPSHOT_SNAPSERVE_TENANT_QUOTA_BYTES"
_DEFAULT_TENANT_QUOTA_BYTES = 0  # 0 = unlimited (admission disabled)
# Bounded per-tenant grant-wait sample window for the p95 in stats().
_TENANT_WAIT_SAMPLES = 512
# Per-connection concurrent request cap: flow control bounds bytes; this
# bounds task count so a client cannot fork unbounded handler tasks with
# zero-byte requests.
_MAX_REQUESTS_PER_CONN = 64
# Per-client accounting is bounded: beyond this many distinct peers the
# oldest-idle entry is dropped (the aggregate counters keep counting).
_MAX_TRACKED_CLIENTS = 256

SNAPSHOT_METADATA_FNAME = ".snapshot_metadata"


class _ManifestMemo:
    """One backend root's parsed manifest state: the raw metadata bytes
    (served to clients), the location→checksum map (cache keys), the
    load timestamp (TTL), and ``tag`` — a fingerprint of the raw
    metadata document, used as the cache-key generation for locations
    the manifest records no checksum for (or when the parse failed):
    a re-take rewrites the metadata document, the TTL refresh changes
    the tag, and every un-checksummed cache key rolls over with it —
    stale bytes can never be served past the TTL even without
    per-entry checksums. ``error`` memoizes a *deterministic*
    not-found so an uncommitted root is not re-probed per object read."""

    __slots__ = ("raw", "checksums", "loaded_at", "error", "tag")

    def __init__(
        self,
        raw: Optional[bytes],
        checksums: Dict[str, str],
        error: Optional[Exception] = None,
    ) -> None:
        self.raw = raw
        self.checksums = checksums
        self.loaded_at = time.monotonic()
        self.error = error
        if raw is None:
            self.tag = "no-manifest"
        else:
            self.tag = f"meta:{content_fingerprint(raw)}"


class _ClientGate:
    """Bounded in-flight response bytes for one connection.

    A request acquires its payload size before the response is written
    and releases after the write drains. A single response larger than
    the cap is admitted alone (progress guarantee) — the bound is
    "never more than cap bytes PLUS one response in flight"."""

    def __init__(self, cap_bytes: int) -> None:
        self._cap = max(1, cap_bytes)
        self._outstanding = 0
        self._cond = asyncio.Condition()
        # snapmem: in-flight response bytes, all pinned (the write is
        # draining them) and transient — a residual after the
        # connection quiesces is a leaked release.
        self._mem_domain = memwatch.register(
            "snapserve.flow",
            cap_bytes=self._cap,
            transient=True,
            watch_residual="used",
        )
        weakref.finalize(self, self._mem_domain.close)

    async def acquire(self, nbytes: int) -> None:
        begin = time.monotonic()
        async with self._cond:
            while self._outstanding > 0 and (
                self._outstanding + nbytes > self._cap
            ):
                await self._cond.wait()
            self._outstanding += nbytes
            self._mem_domain.set_used(
                self._outstanding, pinned_bytes=self._outstanding
            )
        waited = time.monotonic() - begin
        if waited > 0.001:
            telemetry.counter(
                _metric_names.SNAPSERVE_FLOW_STALL_SECONDS
            ).inc(waited)

    async def release(self, nbytes: int) -> None:
        async with self._cond:
            self._outstanding -= nbytes
            self._mem_domain.set_used(
                max(0, self._outstanding),
                pinned_bytes=max(0, self._outstanding),
            )
            self._cond.notify_all()


class TenantAdmission:
    """Per-tenant in-flight-byte quotas over the whole transport.

    Layered ON TOP of :class:`_ClientGate` (which bounds one
    connection): a tenant's total in-flight response bytes across every
    connection are bounded by the quota. Over-quota requests are parked
    as futures — a DEFERRED GRANT, never an error — and dequeued
    weighted-fair when bytes release: tenants with the smallest
    in-flight go first (FIFO within a tenant), so a saturating tenant
    queues behind its own quota while a small tenant's occasional
    requests are granted immediately. A single response larger than the
    whole quota is admitted alone when its tenant is otherwise idle —
    the same progress guarantee the client gate makes.

    Quota 0 disables admission (accounting still runs; ``stats()``
    reports per-tenant traffic either way).
    """

    def __init__(self, quota_bytes: int) -> None:
        self._quota = max(0, int(quota_bytes))
        self._inflight: Dict[str, int] = {}
        self._waiters: Dict[str, List[Tuple[int, "asyncio.Future"]]] = {}
        # Stats are read by stats() from other threads; all waiter and
        # in-flight mutation happens on the server loop, but one lock
        # keeps every access uniform (holds are short). Reentrant so
        # the pump helper can assert the guard it needs even when the
        # caller already holds it.
        self._lock = threading.RLock()
        self._tenant_stats: Dict[str, Dict[str, Any]] = (
            collections.defaultdict(
                lambda: {
                    "requests": 0,
                    "egress_bytes": 0,
                    "deferrals": 0,
                    "waits": [],
                }
            )
        )
        # snapmem: total in-flight bytes across every tenant. The quota
        # is PER TENANT — there is no aggregate cap (two tenants may
        # legitimately sum past one quota), so the domain reports none.
        self._mem_domain = memwatch.register(
            "snapserve.tenant",
            transient=True,
            watch_residual="used",
        )
        weakref.finalize(self, self._mem_domain.close)

    def _publish_mem_locked(self) -> None:
        total = sum(self._inflight.values())
        self._mem_domain.set_used(max(0, total), pinned_bytes=max(0, total))

    def _tstats(self, tenant: str) -> Dict[str, Any]:
        # Lock held by caller; the defaultdict materializes the entry.
        return self._tenant_stats[tenant]

    def _admissible(self, tenant: str, nbytes: int) -> bool:
        # Lock held by caller.
        cur = self._inflight.get(tenant, 0)
        return cur == 0 or cur + nbytes <= self._quota

    async def acquire(self, tenant: str, nbytes: int) -> None:
        with self._lock:
            st = self._tstats(tenant)
            st["requests"] += 1
            st["egress_bytes"] += nbytes
            if self._quota <= 0 or self._admissible(tenant, nbytes):
                self._inflight[tenant] = (
                    self._inflight.get(tenant, 0) + nbytes
                )
                self._publish_mem_locked()
                # Immediate grants count as 0-wait samples so a
                # never-deferred tenant has a defined grant-wait p95
                # (the fairness bench compares tenants' p95s).
                samples = st["waits"]
                samples.append(0.0)
                if len(samples) > _TENANT_WAIT_SAMPLES:
                    del samples[0]
                return
            st["deferrals"] += 1
            fut: "asyncio.Future" = (
                asyncio.get_running_loop().create_future()
            )
            self._waiters.setdefault(tenant, []).append((nbytes, fut))
        telemetry.counter(
            _metric_names.SNAPSERVE_TENANT_DEFERRALS
        ).inc()
        begin = time.monotonic()
        try:
            await fut
        except asyncio.CancelledError:
            grants: List["asyncio.Future"] = []
            with self._lock:
                queue = self._waiters.get(tenant, [])
                if (nbytes, fut) in queue:
                    queue.remove((nbytes, fut))
                elif fut.done() and not fut.cancelled():
                    # Granted concurrently with the cancellation: the
                    # bytes were charged — give them back and let the
                    # grant flow to the next waiter.
                    self._inflight[tenant] = max(
                        0, self._inflight.get(tenant, 0) - nbytes
                    )
                    self._publish_mem_locked()
                    grants = self._pump_locked()
            for g in grants:
                if not g.done():
                    g.set_result(None)
            raise
        waited = time.monotonic() - begin
        telemetry.counter(
            _metric_names.SNAPSERVE_TENANT_GRANT_WAIT_SECONDS
        ).inc(waited)
        with self._lock:
            samples = self._tstats(tenant)["waits"]
            samples.append(waited)
            if len(samples) > _TENANT_WAIT_SAMPLES:
                del samples[0]

    def release(self, tenant: str, nbytes: int) -> None:
        with self._lock:
            self._inflight[tenant] = max(
                0, self._inflight.get(tenant, 0) - nbytes
            )
            self._publish_mem_locked()
            grants = self._pump_locked()
        for fut in grants:
            if not fut.done():
                fut.set_result(None)

    def _pump_locked(self) -> List["asyncio.Future"]:
        """Grant every waiting head that now fits, smallest-in-flight
        tenant first. Each tenant's queue is FIFO and blocks only on
        its OWN quota — one tenant's oversize head never heads-of-line
        another tenant."""
        granted: List["asyncio.Future"] = []
        # Callers hold the (reentrant) lock; taking it here keeps the
        # mutation guarded even if a future call site forgets.
        with self._lock:
            while True:
                progressed = False
                tenants = sorted(
                    (t for t, q in self._waiters.items() if q),
                    key=lambda t: (self._inflight.get(t, 0), t),
                )
                for tenant in tenants:
                    queue = self._waiters[tenant]
                    while queue and queue[0][1].cancelled():
                        queue.pop(0)
                    if not queue:
                        continue
                    nbytes, fut = queue[0]
                    if self._admissible(tenant, nbytes):
                        queue.pop(0)
                        self._inflight[tenant] = (
                            self._inflight.get(tenant, 0) + nbytes
                        )
                        self._publish_mem_locked()
                        granted.append(fut)
                        progressed = True
                if not progressed:
                    return granted

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            out: Dict[str, Any] = {}
            for tenant, st in self._tenant_stats.items():
                waits = sorted(st["waits"])
                p95 = (
                    waits[min(len(waits) - 1, int(len(waits) * 0.95))]
                    if waits
                    else 0.0
                )
                out[tenant] = {
                    "requests": st["requests"],
                    "egress_bytes": st["egress_bytes"],
                    "deferrals": st["deferrals"],
                    "inflight_bytes": self._inflight.get(tenant, 0),
                    "grant_wait_p95_s": round(p95, 6),
                }
            return out


class ReadService:
    """Transport-independent read-plane core (one per server process).

    ``backend_resolver`` resolves a backend URL to a plugin; the default
    is :func:`~torchsnapshot_tpu_torch.storage_plugin.url_to_storage_plugin`,
    which applies the process's retry policy and any installed wrap
    hooks (fault injection, modeled-bandwidth throttles) — the service
    reads storage exactly the way a direct reader would. Resolved
    plugins are memoized and live as long as the service.

    ``backend_prefixes`` optionally restricts which backend URLs the
    service will touch (an operator allowlist for shared deployments);
    empty/None = any.
    """

    def __init__(
        self,
        cache_bytes: Optional[int] = None,
        meta_ttl_s: Optional[float] = None,
        client_inflight_bytes: Optional[int] = None,
        backend_resolver: Optional[Callable[[str], StoragePlugin]] = None,
        backend_prefixes: Optional[List[str]] = None,
    ) -> None:
        if cache_bytes is None:
            cache_bytes = env_int(CACHE_BYTES_ENV_VAR, _DEFAULT_CACHE_BYTES)
        if meta_ttl_s is None:
            meta_ttl_s = env_float(META_TTL_ENV_VAR, _DEFAULT_META_TTL_S)
        if client_inflight_bytes is None:
            client_inflight_bytes = env_int(
                CLIENT_INFLIGHT_ENV_VAR, _DEFAULT_CLIENT_INFLIGHT_BYTES
            )
        self.cache = ByteLRU(cache_bytes)
        self.meta_ttl_s = meta_ttl_s
        self.client_inflight_bytes = client_inflight_bytes
        self._backend_resolver = backend_resolver
        self._backend_prefixes = list(backend_prefixes or [])
        self._backends: Dict[str, StoragePlugin] = {}
        self._manifests: Dict[str, _ManifestMemo] = {}
        # Single-flight maps: key → the TASK doing the fetch. Tasks
        # (not per-requester futures) so a cancelled requester — a
        # client that disconnected or timed out — never poisons the
        # piggybacked waiters: everyone shields the shared task, and
        # the fetch runs to completion (filling the cache) regardless.
        self._flights: Dict[str, "asyncio.Task[bytes]"] = {}
        self._meta_flights: Dict[str, "asyncio.Task[_ManifestMemo]"] = {}
        # Bounded size memo (oversize detection for ranged reads needs
        # a stat; one HEAD per object, not one per range request).
        self._sizes: Dict[str, Optional[int]] = {}
        # One lock guards the memo/backend/stats dicts; the in-flight
        # tasks are only touched from the service's event loop but
        # share the lock for uniformity (the hold is always short).
        self._lock = threading.Lock()
        self._stats: Dict[str, float] = {
            "requests": 0,
            "backend_reads": 0,
            "backend_read_bytes": 0,
            "egress_bytes": 0,
            "singleflight_collapses": 0,
            "manifest_loads": 0,
            "manifest_hits": 0,
        }
        self._clients: Dict[str, Dict[str, float]] = {}

    # ------------------------------------------------------------ plumbing

    def _bump(self, key: str, amount: float = 1) -> None:
        with self._lock:
            self._stats[key] = self._stats.get(key, 0) + amount

    def _client_bump(self, client: str, key: str, amount: float) -> None:
        with self._lock:
            entry = self._clients.get(client)
            if entry is None:
                if len(self._clients) >= _MAX_TRACKED_CLIENTS:
                    self._clients.pop(next(iter(self._clients)))
                entry = {"requests": 0, "egress_bytes": 0}
                self._clients[client] = entry
            entry[key] = entry.get(key, 0) + amount

    def _backend(self, url: str) -> StoragePlugin:
        if self._backend_prefixes and not any(
            url.startswith(p) for p in self._backend_prefixes
        ):
            raise PermissionError(
                f"backend {url!r} is outside this server's allowlist"
            )
        if url.startswith("snapserve://"):
            raise ValueError(
                "snapserve servers do not chain: the backend of a "
                "snapserve URL must be a real storage backend"
            )
        with self._lock:
            plugin = self._backends.get(url)
        if plugin is not None:
            return plugin
        from ..storage_plugin import url_to_storage_plugin

        resolver = self._backend_resolver or url_to_storage_plugin
        plugin = resolver(url)
        with self._lock:
            # A racing resolver for the same URL keeps the first one.
            existing = self._backends.get(url)
            if existing is not None:
                try:
                    plugin.close()
                except Exception:
                    logger.warning(
                        "duplicate backend plugin close failed", exc_info=True
                    )
                return existing
            self._backends[url] = plugin
        return plugin

    # ------------------------------------------------------- single-flight

    @staticmethod
    def _consume_task_failure(task: "asyncio.Task") -> None:
        """Done-callback marking a fetch task's exception as retrieved,
        so a task whose every waiter was cancelled cannot warn at GC
        time (the failure already reached whoever still cared)."""
        if task.cancelled():
            return
        try:
            task.exception()
        except Exception:  # snapcheck: disable=swallowed-exception -- retrieval marks the exception as consumed
            pass

    async def _single_flight(
        self, flights: Dict[str, "asyncio.Task"], key: str, fetch
    ) -> Tuple[Any, bool]:
        """Await ``fetch()`` deduplicated under ``key``: the first
        caller creates the task, everyone (creator included) awaits it
        SHIELDED — a cancelled requester leaves the fetch (and its
        cache fill) running for the others. Returns ``(result,
        collapsed)``."""
        with self._lock:
            flight = flights.get(key)
            created = flight is None
            if created:
                flight = asyncio.ensure_future(fetch())
                flight.add_done_callback(self._consume_task_failure)
                flight.add_done_callback(
                    lambda _t, flights=flights, key=key: self._drop_flight(
                        flights, key
                    )
                )
                flights[key] = flight
        return await asyncio.shield(flight), not created

    def _drop_flight(
        self, flights: Dict[str, "asyncio.Task"], key: str
    ) -> None:
        with self._lock:
            flights.pop(key, None)

    # ----------------------------------------------------------- manifests

    async def _manifest_memo(self, backend_url: str) -> _ManifestMemo:
        """The (possibly negative) manifest memo for one backend root,
        loading or TTL-refreshing it — single-flighted, so N cold
        clients (or a TTL-expiry herd) share ONE backend fetch + parse.
        Parse failures memoize as checksum-less (the service still
        serves raw bytes; the client parses and fails exactly as it
        would directly)."""
        with self._lock:
            memo = self._manifests.get(backend_url)
        if memo is not None and (
            time.monotonic() - memo.loaded_at < self.meta_ttl_s
        ):
            self._bump("manifest_hits")
            telemetry.counter(
                _metric_names.SNAPSERVE_MANIFEST_MEMO, event="hit"
            ).inc()
            return memo

        async def _load_and_store() -> _ManifestMemo:
            loaded = await self._load_manifest(backend_url)
            with self._lock:
                self._manifests[backend_url] = loaded
                # A new manifest generation invalidates the size memo
                # for this root (a re-take can change object sizes).
                for k in [
                    k for k in self._sizes if k.startswith(backend_url + "\n")
                ]:
                    del self._sizes[k]
            return loaded

        memo, collapsed = await self._single_flight(
            self._meta_flights, backend_url, _load_and_store
        )
        if collapsed:
            self._bump("manifest_hits")
            telemetry.counter(
                _metric_names.SNAPSERVE_MANIFEST_MEMO, event="hit"
            ).inc()
        return memo

    async def _load_manifest(self, backend_url: str) -> _ManifestMemo:
        from ..io_types import is_not_found_error

        self._bump("manifest_loads")
        telemetry.counter(
            _metric_names.SNAPSERVE_MANIFEST_MEMO, event="load"
        ).inc()
        plugin = self._backend(backend_url)
        io_req = IOReq(path=SNAPSHOT_METADATA_FNAME)
        try:
            await plugin.read(io_req)
        except Exception as e:
            if is_not_found_error(e):
                # Deterministic: memoize so per-object reads against an
                # uncommitted root don't re-probe the backend each time.
                return _ManifestMemo(None, {}, error=e)
            raise
        raw = bytes(io_payload(io_req))
        self._bump("backend_reads")
        self._bump("backend_read_bytes", len(raw))
        telemetry.counter(
            _metric_names.SNAPSERVE_BACKEND_READ_BYTES
        ).inc(len(raw))
        checksums: Dict[str, str] = {}
        try:
            from ..snapshot import (
                SnapshotMetadata,
                _decode_metadata_doc,
                _iter_payload_entries,
            )

            metadata = SnapshotMetadata.from_yaml(_decode_metadata_doc(raw))
            for entry in _iter_payload_entries(metadata.manifest):
                checksum = getattr(entry, "checksum", None)
                if checksum:
                    checksums[entry.location] = checksum
        except Exception:
            # Served bytes stay authoritative; only cache keying loses
            # the checksum component (content fingerprints still verify
            # hits). A corrupt manifest is the CLIENT's error to raise.
            logger.warning(
                f"snapserve: manifest parse failed for {backend_url!r}; "
                f"serving raw bytes without checksum keying",
                exc_info=True,
            )
        return _ManifestMemo(raw, checksums)

    # ---------------------------------------------------------------- reads

    async def handle_read(
        self,
        backend_url: str,
        path: str,
        byte_range: Optional[Tuple[int, int]] = None,
        client: str = "local",
    ) -> Tuple[bytes, Dict[str, Any]]:
        """Serve one read; returns ``(payload, meta)``. Raises the same
        exception taxonomy a direct backend read would (not-found,
        range-not-satisfiable, backend failures) — the wire layer
        marshals them."""
        self._bump("requests")
        self._client_bump(client, "requests", 1)
        telemetry.counter(
            _metric_names.SNAPSERVE_REQUESTS, op="read"
        ).inc()

        range_applied = False
        if path == SNAPSHOT_METADATA_FNAME:
            memo = await self._manifest_memo(backend_url)
            if memo.error is not None:
                raise memo.error
            data = memo.raw if memo.raw is not None else b""
            served = "memo"
        else:
            data, served, range_applied = await self._object_bytes(
                backend_url, path, byte_range
            )

        if byte_range is not None and not range_applied:
            start, end = int(byte_range[0]), int(byte_range[1])
            if start >= len(data) and not (start == 0 and end == 0):
                from .protocol import InvalidRange

                raise InvalidRange(
                    f"{path}: range [{start}, {end}) starts at or past "
                    f"the object end ({len(data)} bytes)"
                )
            data = data[start:end]
        self._bump("egress_bytes", len(data))
        self._client_bump(client, "egress_bytes", len(data))
        telemetry.counter(_metric_names.SNAPSERVE_EGRESS_BYTES).inc(
            len(data)
        )
        return data, {"served": served}

    @staticmethod
    def _is_control_path(path: str) -> bool:
        """Dot-prefixed control-plane objects (``.completed/*``,
        ``.progress/*``, ``.telemetry/*``, ``.tierdown``, reports) and
        ``refs/`` back-link markers are REWRITTEN in place over their
        lifetime — serving them from the content cache would pin their
        first version (a watcher polling progress through the service
        would see a frozen record forever). Payload locations
        (``<rank>/…``, ``replicated/…``, ``chunked/…``) are
        write-once-per-manifest and cache fine. Chunk-store GC state
        (``refs/``, ``intents/`` under a ``.chunkstore`` root) is
        mutable and bypasses too — but ``objects/…`` chunk payloads
        are content-addressed and cache best of all (keyed by their
        embedded content hash below)."""
        return (
            path.startswith(".")
            or path.startswith("refs/")
            or path.startswith("intents/")
        )

    async def _read_backend(
        self,
        backend_url: str,
        path: str,
        byte_range: Optional[Tuple[int, int]] = None,
    ) -> bytes:
        """One metered backend read (whole object or ranged)."""
        plugin = self._backend(backend_url)
        io_req = IOReq(path=path, byte_range=byte_range)
        with tracing.span("snapserve.backend_fetch", path=path):
            await plugin.read(io_req)
        data = bytes(io_payload(io_req))
        self._bump("backend_reads")
        self._bump("backend_read_bytes", len(data))
        telemetry.counter(
            _metric_names.SNAPSERVE_BACKEND_READ_BYTES
        ).inc(len(data))
        return data

    async def _object_size(
        self, backend_url: str, path: str
    ) -> Optional[int]:
        """Memoized size probe (oversize detection; one stat per
        object per manifest generation, not one per range request)."""
        size_key = f"{backend_url}\n{path}"
        with self._lock:
            if size_key in self._sizes:
                return self._sizes[size_key]
        plugin = self._backend(backend_url)
        try:
            size = await plugin.object_size_bytes(path)
        except Exception as e:
            logger.warning(
                f"snapserve: size probe failed for {path!r}: {e!r}; "
                f"treating as cache-eligible"
            )
            size = None
        with self._lock:
            if len(self._sizes) >= 4096:
                self._sizes.pop(next(iter(self._sizes)))
            self._sizes[size_key] = size
        return size

    async def _object_bytes(
        self,
        backend_url: str,
        path: str,
        byte_range: Optional[Tuple[int, int]] = None,
    ) -> Tuple[bytes, str, bool]:
        """Bytes for a payload path: cache → single-flight → backend.
        Returns ``(data, served, range_applied)``.

        Ordinary objects fetch WHOLE under single-flight and enter the
        cache; a ranged request is sliced from those bytes (range
        coalescing). Objects larger than the cache cap never fetch
        whole for a ranged request — the range passes through to the
        backend (single-flighted per distinct range), since the whole
        object could neither be cached nor afforded per request.
        Mutable control-plane objects bypass cache AND single-flight
        (pass-through reads)."""
        if self._is_control_path(path):
            data = await self._read_backend(backend_url, path)
            return data, "backend", False
        from ..chunkstore import content_address_of

        content_key = content_address_of(path)
        if content_key is not None:
            # Content-addressed chunk object (chunkstore.py): the path
            # EMBEDS the content identity, so the cache key needs no
            # manifest checksum map at all — a re-take of a mostly-
            # unchanged model references the same chunk keys, and the
            # fleet's cache stays warm across manifest generations
            # (manifest-tag keying would invalidate everything).
            checksum = content_key
        else:
            memo = await self._manifest_memo(backend_url)
            # Locations the manifest records no checksum for key
            # against the manifest GENERATION tag instead: a re-take
            # rolls the tag, so stale cache entries become unreachable
            # past the meta TTL.
            checksum = memo.checksums.get(path) or memo.tag
        key = f"{backend_url}\n{path}\n{checksum}"
        cached = self.cache.get(key)
        self._record_cache_events()
        if cached is not None:
            tracing.instant("snapserve.cache_hit", path=path)
            return cached, "cache", False
        tracing.instant("snapserve.cache_miss", path=path)

        if byte_range is not None:
            size = await self._object_size(backend_url, path)
            if size is not None and size > self.cache.cap_bytes:
                # Uncacheable whole: serve the range itself, deduped
                # per distinct range (chunk-overlap readers asking the
                # SAME range still collapse; different ranges each pay
                # one ranged GET instead of a whole-object fetch per
                # request).
                start, end = int(byte_range[0]), int(byte_range[1])
                range_key = f"{key}\n{start}-{end}"
                data, collapsed = await self._single_flight(
                    self._flights,
                    range_key,
                    lambda: self._read_backend(
                        backend_url, path, (start, end)
                    ),
                )
                if collapsed:
                    self._bump("singleflight_collapses")
                    telemetry.counter(
                        _metric_names.SNAPSERVE_SINGLEFLIGHT_COLLAPSES
                    ).inc()
                return data, "backend-range", True

        async def _fetch_whole() -> bytes:
            data = await self._read_backend(backend_url, path)
            self.cache.put(key, data)
            return data

        data, collapsed = await self._single_flight(
            self._flights, key, _fetch_whole
        )
        if collapsed:
            self._bump("singleflight_collapses")
            telemetry.counter(
                _metric_names.SNAPSERVE_SINGLEFLIGHT_COLLAPSES
            ).inc()
            # Waiter: this request piggybacked on another request's
            # backend fetch (whose span carries the LEADER's trace).
            tracing.instant("snapserve.singleflight_wait", path=path)
        return data, ("singleflight" if collapsed else "backend"), False

    def _record_cache_events(self) -> None:
        """Mirror the cache's internal counters into the telemetry
        registry (delta since last mirror), so exporters see them
        without the cache depending on telemetry."""
        stats = self.cache.stats()
        with self._lock:
            prev = getattr(self, "_cache_mirror", None) or {}
            for event in ("hits", "misses", "corrupt", "evictions"):
                delta = stats[event] - prev.get(event, 0)
                if delta > 0:
                    telemetry.counter(
                        _metric_names.SNAPSERVE_CACHE_EVENTS, event=event
                    ).inc(delta)
            self._cache_mirror = stats

    # ---------------------------------------------------------------- stats

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            out: Dict[str, Any] = dict(self._stats)
            out["clients"] = {
                peer: dict(entry) for peer, entry in self._clients.items()
            }
        cache = self.cache.stats()
        out["cache"] = cache
        hits, misses = cache["hits"], cache["misses"]
        out["cache_hit_ratio"] = (
            round(hits / (hits + misses), 4) if hits + misses else None
        )
        egress = out.get("egress_bytes", 0)
        out["amplification"] = (
            round(out.get("backend_read_bytes", 0) / egress, 4)
            if egress
            else None
        )
        return out

    def close(self) -> None:
        with self._lock:
            backends = list(self._backends.values())
            self._backends.clear()
            self._manifests.clear()
        for plugin in backends:
            try:
                plugin.close()
            except Exception:
                logger.warning(
                    "snapserve backend close failed", exc_info=True
                )


# ------------------------------------------------------------- the transport


class SnapServer:
    """Asyncio TCP transport around one :class:`ReadService`.

    Two modes: :meth:`serve_forever` on the current loop (the
    ``__main__`` path), or :func:`start_local_server`, which runs the
    loop in a daemon thread and returns once the socket is bound —
    the in-process mode tests/bench/CI use (it shares the process's
    ``memory://`` stores, so a snapshot taken in the test is visible
    to the server).
    """

    def __init__(
        self,
        service: Optional[ReadService] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        member_name: Optional[str] = None,
        generation: int = 0,
        tenant_quota_bytes: Optional[int] = None,
    ) -> None:
        self.service = service if service is not None else ReadService()
        self._host = host
        self._port = port
        # Fleet identity (snapfleet): the name + generation stamp the
        # ``membership`` op answers with. A respawned member comes back
        # one generation up; the fleet supervisor refuses stale ones.
        self.member_name = member_name
        self.generation = int(generation)
        if tenant_quota_bytes is None:
            tenant_quota_bytes = env_int(
                TENANT_QUOTA_ENV_VAR, _DEFAULT_TENANT_QUOTA_BYTES
            )
        self._tenants = TenantAdmission(tenant_quota_bytes)
        # faultline slow_fleet_member: a per-request injected delay — a
        # hung-not-dead member, without touching the backend path.
        self._injected_delay = 0.0
        self.addr: Optional[str] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._conn_writers: List[asyncio.StreamWriter] = []
        self._lock = threading.Lock()
        self._ready = threading.Event()
        self._startup_error: Optional[BaseException] = None
        self._killed = False

    # ------------------------------------------------------------- lifecycle

    async def start(self) -> str:
        loop = asyncio.get_running_loop()
        server = await asyncio.start_server(
            self._handle_conn, self._host, self._port
        )
        sock = server.sockets[0]
        host, port = sock.getsockname()[:2]
        addr = f"{host}:{port}"
        with self._lock:
            self._loop = loop
            self._server = server
            self.addr = addr
        logger.info(f"snapserve listening on {addr}")
        return addr

    async def serve_forever(self) -> None:
        if self._server is None:
            await self.start()
        assert self._server is not None
        async with self._server:
            await self._server.serve_forever()

    def set_injected_delay(self, seconds: float) -> None:
        """Arm a per-request delay (faultline ``slow_fleet_member``):
        every request answered from now on sleeps ``seconds`` first."""
        with self._lock:
            self._injected_delay = max(0.0, float(seconds))

    def kill(self, timeout_s: float = 5.0) -> None:
        """Abrupt death: close the listening socket and every live
        connection. Blocks (briefly) until the server loop has done it,
        so a faultline ``kill_server`` rule is deterministic — no RPC
        issued after this returns can reach the server."""
        with self._lock:
            if self._killed:
                return
            self._killed = True
            loop = self._loop
        if loop is None or not loop.is_running():
            return
        done = threading.Event()

        def _close() -> None:
            try:
                if self._server is not None:
                    self._server.close()
                with self._lock:
                    writers = list(self._conn_writers)
                    self._conn_writers.clear()
                for writer in writers:
                    try:
                        writer.transport.abort()
                    except Exception:
                        logger.debug(
                            "snapserve kill: transport abort failed",
                            exc_info=True,
                        )
            finally:
                done.set()

        loop.call_soon_threadsafe(_close)
        if not done.wait(timeout_s):
            logger.warning("snapserve kill did not settle in time")
        _unregister_local_server(self)

    def stop(self, timeout_s: float = 5.0) -> None:
        """Graceful shutdown (kill + join the thread if in-process +
        release backend plugins)."""
        self.kill(timeout_s)
        thread = self._thread
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout_s)
        self.service.close()

    # ------------------------------------------------------------ connections

    async def _handle_conn(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        peer = writer.get_extra_info("peername")
        client = f"{peer[0]}:{peer[1]}" if peer else "unknown"
        with self._lock:
            self._conn_writers.append(writer)
        telemetry.gauge(_metric_names.SNAPSERVE_CLIENTS).add(1)
        gate = _ClientGate(self.service.client_inflight_bytes)
        write_lock = asyncio.Lock()
        tasks: "set[asyncio.Task]" = set()
        task_slots = asyncio.Semaphore(_MAX_REQUESTS_PER_CONN)
        try:
            while True:
                try:
                    header, req_payload = await recv_frame(reader)
                except (
                    asyncio.IncompleteReadError,
                    ConnectionError,
                ):
                    break
                except ProtocolError:
                    logger.warning(
                        f"snapserve: protocol violation from {client}; "
                        f"closing connection",
                        exc_info=True,
                    )
                    break
                await task_slots.acquire()
                task = asyncio.ensure_future(
                    self._handle_request(
                        header, req_payload, writer, write_lock, gate,
                        client,
                    )
                )
                tasks.add(task)

                def _done(t: "asyncio.Task", slots=task_slots) -> None:
                    tasks.discard(t)
                    slots.release()
                    if not t.cancelled() and t.exception() is not None:
                        logger.warning(
                            f"snapserve request task failed: "
                            f"{t.exception()!r}"
                        )

                task.add_done_callback(_done)
        finally:
            for task in list(tasks):
                task.cancel()
            telemetry.gauge(_metric_names.SNAPSERVE_CLIENTS).add(-1)
            with self._lock:
                if writer in self._conn_writers:
                    self._conn_writers.remove(writer)
            try:
                writer.close()
            except Exception:
                logger.debug(
                    "snapserve connection close failed", exc_info=True
                )

    async def _handle_request(
        self,
        header: Dict[str, Any],
        req_payload: bytes,
        writer: asyncio.StreamWriter,
        write_lock: asyncio.Lock,
        gate: _ClientGate,
        client: str,
    ) -> None:
        req_id = header.get("id")
        op = header.get("op")
        tenant = str(header.get("tenant") or "default")
        payload = b""
        response: Dict[str, Any] = {"v": PROTOCOL_VERSION, "id": req_id}
        if self._injected_delay > 0:
            # faultline slow_fleet_member: a hung member answers, late.
            await asyncio.sleep(self._injected_delay)
        # Table-driven off the shared registry (.protocol): the ops this
        # server answers ARE the ops a client may send, by construction
        # — adding one means adding an ``_op_*`` method AND a registry
        # row, and snapcheck's SNAP010 fails the build if either half
        # drifts.
        meta = READ_PLANE_OPS.get(op) if isinstance(op, str) else None
        start = time.monotonic()
        try:
            if meta is None:
                response.update(
                    ok=False,
                    error={
                        "kind": "bad_request",
                        "message": f"unknown op {op!r}",
                    },
                )
            else:
                handler = getattr(self, meta["handler"])
                updates, payload = await handler(
                    header, req_payload, client
                )
                response.update(ok=True, **updates)
        except asyncio.CancelledError:
            raise
        except BaseException as e:
            # Includes injected SimulatedCrash from a fault-wrapped
            # backend: the SERVER survives (it is not the process under
            # test); the client sees a backend error. Real crashes of
            # the server itself are modeled by kill_server.
            response.update(ok=False, error=error_to_wire(e))
        if meta is not None:
            # Server half of the wiretap: handler time (admission and
            # flow-control stalls are the CLIENT's wait, accounted in
            # its own samples), joined to the client's snapxray trace
            # by the id it stamped on the frame. Unknown ops stay out —
            # the telemetry key space is exactly the PROTOCOL.md op
            # inventory.
            wire_trace = header.get("trace")
            if not isinstance(wire_trace, dict):
                wire_trace = {}
            req_trace = wire_trace.get("id")
            try:
                wiretap.record(
                    "snapserve",
                    op,
                    seconds=time.monotonic() - start,
                    outcome=(
                        "ok"
                        if response.get("ok")
                        else wiretap.outcome_from_wire_error(
                            response.get("error")
                        )
                    ),
                    bytes_in=len(req_payload),
                    bytes_out=len(payload),
                    peer=client,
                    trace_id=(
                        req_trace if isinstance(req_trace, str) else None
                    ),
                )
            except Exception:  # pragma: no cover - defensive
                logger.debug(
                    "snapserve: wiretap record failed", exc_info=True
                )
        # Admission order: tenant quota (fleet-wide fairness) outside,
        # per-connection flow control inside — a tenant over ITS quota
        # parks here without holding connection-gate capacity.
        await self._tenants.acquire(tenant, len(payload))
        try:
            await gate.acquire(len(payload))
            try:
                async with write_lock:
                    await send_frame(writer, response, payload)
            finally:
                await gate.release(len(payload))
        finally:
            self._tenants.release(tenant, len(payload))

    # ------------------------------------------------------------ op handlers
    #
    # One method per READ_PLANE_OPS row, uniform signature
    # ``(header, req_payload, client) -> (response_updates,
    # payload_bytes)``; the dispatcher stamps ``ok=True`` and marshals
    # exceptions. ``req_payload`` is the request frame's raw payload
    # (only ``plan`` carries one today).

    async def _op_read(
        self, header: Dict[str, Any], req_payload: bytes, client: str
    ) -> Tuple[Dict[str, Any], bytes]:
        byte_range = header.get("range")
        # snapxray causal context from the frame: the client's trace id
        # is adopted for everything this request does (every span below
        # stamps it), and the flow step is the server half of the
        # client's Perfetto arrow. Malformed context never fails a read.
        wire_trace = header.get("trace")
        if not isinstance(wire_trace, dict):
            wire_trace = {}
        trace_id = wire_trace.get("id")
        flow_id = wire_trace.get("flow")
        with tracing.adopt_trace(
            trace_id if isinstance(trace_id, str) else None
        ):
            tracing.flow_step(
                "snapserve.rpc",
                flow_id if isinstance(flow_id, str) else None,
                path=str(header.get("path", "")),
            )
            with tracing.span(
                "snapserve.request",
                path=str(header.get("path", "")),
                client=client,
            ):
                payload, meta = await self.service.handle_read(
                    str(header.get("backend", "")),
                    str(header.get("path", "")),
                    tuple(byte_range) if byte_range else None,
                    client=client,
                )
        return meta, payload

    async def _op_stats(
        self, header: Dict[str, Any], req_payload: bytes, client: str
    ) -> Tuple[Dict[str, Any], bytes]:
        telemetry.counter(
            _metric_names.SNAPSERVE_REQUESTS, op="stats"
        ).inc()
        stats = self.service.stats()
        stats["tenants"] = self._tenants.stats()
        # This member's own wire view rides the stats op so the ops
        # CLI's fleet-wide wire section can aggregate members without a
        # new op.
        try:
            block = wiretap.sample_block()
            if block.get("ops"):
                stats["wire"] = block
        except Exception:  # pragma: no cover - defensive
            logger.debug("snapserve: wiretap sample failed", exc_info=True)
        # The memory plane rides the same op: this process's snapmem
        # domain table (cache, flow, tenants, ...) for `ops --mem`.
        try:
            mem = memwatch.sample_block()
            if mem.get("domains"):
                stats["memory"] = mem
        except Exception:  # pragma: no cover - defensive
            logger.debug("snapserve: memwatch sample failed", exc_info=True)
        return {"stats": stats}, b""

    async def _op_ping(
        self, header: Dict[str, Any], req_payload: bytes, client: str
    ) -> Tuple[Dict[str, Any], bytes]:
        telemetry.counter(
            _metric_names.SNAPSERVE_REQUESTS, op="ping"
        ).inc()
        return {"server": "snapserve"}, b""

    async def _op_plan(
        self, header: Dict[str, Any], req_payload: bytes, client: str
    ) -> Tuple[Dict[str, Any], bytes]:
        """Chunk pushdown: the request payload is a JSON plan document
        (record layout + the slice boxes this client's shard needs);
        the answer is exactly the record subset to fetch. Pure compute
        — shared with the client's local cut via :mod:`.pushdown`, so
        RPC answer and local ground truth cannot drift."""
        import json

        from . import pushdown

        telemetry.counter(
            _metric_names.SNAPSERVE_REQUESTS, op="plan"
        ).inc()
        try:
            doc = (
                json.loads(req_payload.decode("utf-8"))
                if req_payload
                else {}
            )
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ValueError(f"malformed plan request: {e!r}") from e
        if not isinstance(doc, dict):
            raise ValueError(
                f"malformed plan request: not an object: {doc!r}"
            )
        return {"plan": pushdown.plan_from_doc(doc)}, b""

    async def _op_membership(
        self, header: Dict[str, Any], req_payload: bytes, client: str
    ) -> Tuple[Dict[str, Any], bytes]:
        """Fleet supervision probe: who am I, and which incarnation.
        The supervisor refuses answers whose generation is older than
        its record (a SIGCONT'd zombie of a replaced member)."""
        telemetry.counter(
            _metric_names.SNAPSERVE_REQUESTS, op="membership"
        ).inc()
        return {
            "member": self.member_name or "",
            "generation": self.generation,
            "server": "snapserve",
        }, b""


# ------------------------------------------------- in-process server registry
#
# start_local_server() keeps every live in-process server here so
# faultline's kill_server schedule rule (and test teardown) can find
# them without threading handles through the pipeline under test.

_LOCAL_SERVERS: List[SnapServer] = []
_LOCAL_LOCK = threading.Lock()


def _unregister_local_server(server: SnapServer) -> None:
    with _LOCAL_LOCK:
        if server in _LOCAL_SERVERS:
            _LOCAL_SERVERS.remove(server)


def kill_local_servers() -> int:
    """Abruptly kill every in-process server (faultline's
    ``kill_server`` action). Returns how many died."""
    with _LOCAL_LOCK:
        servers = list(_LOCAL_SERVERS)
    for server in servers:
        server.kill()
    return len(servers)


def start_local_server(
    service: Optional[ReadService] = None,
    host: str = "127.0.0.1",
    port: int = 0,
    member_name: Optional[str] = None,
    generation: int = 0,
    tenant_quota_bytes: Optional[int] = None,
) -> SnapServer:
    """Run a server on a daemon thread; returns once the socket is
    bound (``server.addr`` is set). The caller owns ``server.stop()``.
    ``member_name``/``generation`` stamp the fleet identity the
    ``membership`` op answers with (:func:`.fleet.start_local_fleet`
    passes them; a lone server needs neither).
    ``tenant_quota_bytes`` overrides the env quota (tests/bench)."""
    server = SnapServer(
        service=service, host=host, port=port,
        member_name=member_name, generation=generation,
        tenant_quota_bytes=tenant_quota_bytes,
    )

    def _run() -> None:
        async def _main() -> None:
            try:
                await server.start()
            except BaseException as e:
                server._startup_error = e
                server._ready.set()
                raise
            server._ready.set()
            assert server._server is not None
            try:
                async with server._server:
                    await server._server.serve_forever()
            except asyncio.CancelledError:
                logger.debug("snapserve local server loop cancelled")

        try:
            asyncio.run(_main())
        except Exception:
            logger.warning("snapserve local server exited", exc_info=True)

    thread = threading.Thread(
        target=_run, name="snapserve-server", daemon=True
    )
    server._thread = thread
    thread.start()
    if not server._ready.wait(timeout=10.0):
        raise RuntimeError("snapserve local server failed to bind in time")
    if server._startup_error is not None:
        raise RuntimeError(
            f"snapserve local server failed to start: "
            f"{server._startup_error!r}"
        )
    with _LOCAL_LOCK:
        _LOCAL_SERVERS.append(server)
    return server


def fetch_server_stats(addr: str, timeout_s: float = 10.0) -> Dict[str, Any]:
    """One-shot ``stats`` RPC (tests, bench, smoke scripts)."""

    async def _fetch() -> Dict[str, Any]:
        host, _, port = addr.rpartition(":")
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(host, int(port)), timeout_s
        )
        try:
            # The send is deadline-bounded like the dial and the recv: a
            # peer that stops reading (full socket buffer, wedged accept
            # loop) must not hang this one-shot helper forever
            # (snapcheck SNAP011).
            await asyncio.wait_for(
                send_frame(
                    writer, {"v": PROTOCOL_VERSION, "op": "stats", "id": 0}
                ),
                timeout_s,
            )
            header, _ = await asyncio.wait_for(recv_frame(reader), timeout_s)
            if not header.get("ok"):
                raise RuntimeError(f"stats RPC failed: {header!r}")
            return header["stats"]
        finally:
            writer.close()

    return asyncio.run(_fetch())


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m torchsnapshot_tpu_torch.snapserve.server",
        description="Caching snapshot read service: fronts any storage "
        "backend for snapserve:// clients.",
    )
    parser.add_argument(
        "--addr",
        default="127.0.0.1:0",
        help="host:port to bind (port 0 = ephemeral; the bound address "
        "is printed and optionally written to --port-file)",
    )
    parser.add_argument(
        "--cache-bytes",
        type=int,
        default=None,
        help=f"content-cache cap (default ${CACHE_BYTES_ENV_VAR} or "
        f"{_DEFAULT_CACHE_BYTES})",
    )
    parser.add_argument(
        "--meta-ttl-s",
        type=float,
        default=None,
        help="manifest memo TTL seconds",
    )
    parser.add_argument(
        "--backend-prefix",
        action="append",
        default=[],
        help="allowlist: only serve backends starting with this prefix "
        "(repeatable; default any)",
    )
    parser.add_argument(
        "--port-file",
        default=None,
        help="write the bound host:port here once listening (lets "
        "spawning scripts discover an ephemeral port)",
    )
    args = parser.parse_args(argv)
    host, _, port = args.addr.rpartition(":")

    # Standalone server process: its trace (if TPUSNAPSHOT_TRACE is
    # set) identifies as the read plane, so the multi-process merge
    # labels it "server" instead of a phantom extra rank.
    tracing.set_identity(role="server")

    service = ReadService(
        cache_bytes=args.cache_bytes,
        meta_ttl_s=args.meta_ttl_s,
        backend_prefixes=args.backend_prefix,
    )
    server = SnapServer(service=service, host=host or "127.0.0.1",
                        port=int(port or 0))

    async def _main() -> None:
        addr = await server.start()
        print(f"snapserve listening on {addr}", flush=True)
        if args.port_file:
            import os

            tmp = args.port_file + ".tmp"
            with open(tmp, "w") as f:
                f.write(addr)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, args.port_file)
        await server.serve_forever()

    try:
        asyncio.run(_main())
    except KeyboardInterrupt:
        logger.info("snapserve: interrupted; shutting down")
    finally:
        server.service.close()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
