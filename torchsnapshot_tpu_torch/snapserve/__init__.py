"""snapserve: the disaggregated snapshot read plane, in the JAX
package's wire format (a port client reads through a JAX server and the
reverse).

The paper's random-access property — one storage object per leaf,
fetchable in isolation — is wasted if every consumer pays its own
object-store read. tf.data service (arxiv 2210.14826) makes the
disaggregation argument for input pipelines: move the shared work into a
service and N consumers cost ~1x backend work instead of N x. The same
argument applies verbatim to checkpoint reads: inference replicas
pulling updated weights, eval jobs, and resharded fine-tune starts all
read the SAME objects.

Three pieces:

- **Server** (:mod:`.server`) — ``python -m
  torchsnapshot_tpu_torch.snapserve.server`` (or :func:`start_local_server`
  in-process): fronts any storage backend with manifest memoization
  (parse once, serve many), single-flight deduplication (concurrent
  requests for one object trigger exactly one backend read), range-read
  coalescing (overlapping chunk reads are served by slicing one
  whole-object fetch), a byte-capped fingerprint-verified LRU content
  cache (``TPUSNAPSHOT_SNAPSERVE_CACHE_BYTES``), and per-client flow
  control with bounded in-flight bytes.
- **Client plugin** (:mod:`.client`) — the ``snapserve://host:port/
  <backend-url>`` storage protocol: reads go over the service; writes,
  deletes, and enumeration go straight to the backend (the read plane
  never proxies mutations). When the server is unreachable the client
  degrades to direct backend reads — bit-exact, counted
  (``tpusnapshot_snapserve_fallbacks_total``), doctor-visible
  (``read-plane-degraded``), never an error.
- **RemoteSnapshot** (:mod:`.remote`) — the existing :class:`Snapshot`
  API (``restore``, ``read_object``, ``get_manifest``, ``verify``)
  unchanged over the service; the server address comes from the
  constructor or ``TPUSNAPSHOT_SNAPSERVE_ADDR``.

- **Fleet** (:mod:`.fleet`, snapfleet) — N servers behind one URL
  (``snapserve://h1:p1,h2:p2,.../<backend>`` or
  ``TPUSNAPSHOT_SNAPSERVE_FLEET_ADDRS``): a consistent-hash ring over
  chunk content keys shards the fleet's aggregate cache (one owner per
  object), clients fail over owner → ring replicas → direct backend
  (counted, bit-exact, never an error), and a generation-stamped
  membership doc with snapmend-style supervision (hung ≠ dead, stale
  generations refused) tracks the members. Chunk pushdown (the ``plan``
  op + the local cut in io_preparer) lets a differently-meshed restore
  fetch ≈ its shard fraction per client; per-tenant admission
  (``TPUSNAPSHOT_SNAPSERVE_TENANT`` /
  ``TPUSNAPSHOT_SNAPSERVE_TENANT_QUOTA_BYTES``) keeps one saturating
  tenant from starving the rest — over-quota responses are DELAYED,
  never failed.

Fault injection: the client announces every RPC attempt as a
``snapserve.request`` storage-op boundary, so faultline schedules can
``kill_server()`` / ``slow_server()`` — or the surgical
``kill_fleet_member(name)`` / ``slow_fleet_member(name, seconds)`` —
deterministically mid-restore (docs/FAULTS.md).
"""

from .cache import ByteLRU, content_fingerprint
from .client import (
    SnapServePlugin,
    fetch_member_info,
    parse_snapserve_url,
    ping_server,
    plan_remote,
    restore_stats_begin,
    restore_stats_collect,
    stats_snapshot,
)
from .fleet import (
    FleetMembership,
    FleetSupervisor,
    FleetView,
    HashRing,
    LocalFleet,
    StaleGenerationError,
    kill_local_member,
    routing_key,
    slow_local_member,
    start_local_fleet,
)
from .remote import RemoteSnapshot
from .server import (
    ReadService,
    SnapServer,
    fetch_server_stats,
    kill_local_servers,
    start_local_server,
)

__all__ = [
    "ByteLRU",
    "FleetMembership",
    "FleetSupervisor",
    "FleetView",
    "HashRing",
    "LocalFleet",
    "ReadService",
    "RemoteSnapshot",
    "SnapServePlugin",
    "SnapServer",
    "StaleGenerationError",
    "content_fingerprint",
    "fetch_member_info",
    "fetch_server_stats",
    "kill_local_member",
    "kill_local_servers",
    "parse_snapserve_url",
    "ping_server",
    "plan_remote",
    "restore_stats_begin",
    "restore_stats_collect",
    "routing_key",
    "slow_local_member",
    "start_local_fleet",
    "start_local_server",
    "stats_snapshot",
]
