"""Peer-host RAM stores: the storage substrate of the hot tier.

A *host* here is a failure domain that can be preempted as a unit — in
production one worker host of the job, in tests a virtual host id. Each host
exposes one :class:`HostRamStore`: a byte-capped in-RAM object store
holding hot replicas of recently taken snapshot objects. The rendezvous
index (``key → replica hosts``) records where each object's k replicas
landed so a reader probes exactly the hosts that hold it.

This module is deliberately transport-agnostic: in-process, the
"stores" are plain dicts (each virtual host a separate failure domain
the tests can kill independently); across hosts the same interface is
what the snapwire transport (transport.py, peer.py) implements —
the runtime only ever speaks ``put/get/drop`` plus the index. The
failure model the harness exercises — :func:`kill_host` drops a host's
RAM wholesale, exactly what preemption does — is identical either way.

Integrity: every object carries an xs128 content fingerprint
(fingerprint.py — the same algorithm that gates incremental dedup)
computed at put time over the exact payload bytes; ``get`` recomputes
and compares, so a corrupt replica is detected at the tier boundary and
the reader falls over to the next replica (or the durable tier) instead
of handing garbage to the consume path.

Eviction: only *drained* objects (already persisted to the durable
tier) are evictable, LRU per host. An undrained object is the only copy
of committed bytes outside its k-replica set — evicting it could leave
a manifest referencing bytes that exist in no tier, the exact invariant
the crash matrix proves we never violate. A put that cannot fit even
after evicting drained objects is *refused*; the caller degrades to a
synchronous durable write-through.

One module-wide lock guards hosts + objects + index: the structures are
tiny (metadata, not payload copies beyond the stored bytes) and a
single lock makes the cross-structure invariants (index entries always
name live replicas) trivially atomic.
"""

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .. import telemetry
from ..fingerprint import fingerprint_host
from ..telemetry import memwatch
from ..telemetry import metrics as _metric_names

import logging

logger = logging.getLogger(__name__)


class HostLostError(RuntimeError):
    """The addressed peer host is dead (preempted / unreachable)."""


def payload_tag(data) -> str:
    """Content fingerprint of raw payload bytes (xs128, fingerprint.py)."""
    return fingerprint_host(bytes(data))


@dataclass
class HotObject:
    data: bytes
    tag: str  # xs128 fingerprint of ``data`` at put time
    root: str  # snapshot root this object belongs to (reconcile grouping)
    put_t: float  # epoch seconds
    drained: bool = False  # persisted to the durable tier


class HostRamStore:
    """One host's RAM store. All mutation happens under ``_TIER_LOCK``
    (module-wide); the class only encapsulates per-host state."""

    def __init__(self, host_id: int, capacity_bytes: int) -> None:
        self.host_id = host_id
        self.capacity_bytes = capacity_bytes
        self.alive = True
        self.objects: "OrderedDict[str, HotObject]" = OrderedDict()
        self.used_bytes = 0


_TIER_LOCK = threading.RLock()
_HOSTS: Dict[int, HostRamStore] = {}
# Rendezvous index: key -> hosts holding a replica (in placement order).
# Remote placements are indexed here too, so every key lookup answers
# from one structure regardless of where the replica physically lives.
_KEY_HOSTS: Dict[str, List[int]] = {}

# ----------------------------------------------------------- remote hosts
#
# snapwire (transport.py / peer.py): a host id registered here is backed
# by a REAL peer process over TCP instead of an in-process dict. The
# registry lives in this module so every tier function can route without
# an import cycle; the registered object is duck-typed (RemotePeer).
# _REMOTE_SHADOW is the client-side ledger of what we placed on each
# remote host — (host_id, key) -> {root, nbytes, tag (the logical
# content tag hot_put computed), stored_tag (what the peer actually
# holds; differs only for lossy int8 pushes), put_t, drained} — feeding
# the same accounting (buffered_roots / occupancy / ages / key_tag) the
# local stores answer from their own dicts, without a per-query RPC.

_REMOTE: Dict[int, object] = {}
_REMOTE_SHADOW: Dict[tuple, Dict[str, object]] = {}

# Generation-stamped membership (snapmend, repair.py): each host id
# carries a monotonically increasing generation, bumped every time a
# NEW peer process takes the id over (register after a loss/respawn).
# A respawned peer starts with an empty store — trusting it to hold its
# predecessor's replicas would turn one SIGKILL into silent
# under-replication — so the client-side shadow for the host is
# invalidated at every generation change and every view answers only
# from entries of the CURRENT generation's peer.
_HOST_GEN: Dict[int, int] = {}

# Peer-SERVER scope (peer.py): when an in-process peer serves a host id
# this same process also has registered as remote, the server half must
# address the LOCAL store — otherwise its tier calls would route back
# through the RemotePeer into itself. Thread-local because the server
# handles requests on its own event-loop thread.
_LOCAL_ONLY = threading.local()


class serve_local:
    """``with tier.serve_local():`` — tier calls on this thread address
    local stores even for remotely-registered host ids (the peer-server
    side of an in-process wire)."""

    def __enter__(self) -> None:
        _LOCAL_ONLY.active = True

    def __exit__(self, *exc) -> None:
        _LOCAL_ONLY.active = False


def _route_peer(host_id: int):
    """The remote peer to route ``host_id`` through, or None for the
    local store (unregistered host, or inside a :class:`serve_local`
    scope)."""
    if getattr(_LOCAL_ONLY, "active", False):
        return None
    return remote_host(host_id)


def register_remote_host(host_id: int, peer) -> None:
    """Back virtual host ``host_id`` with a remote peer client
    (transport.RemotePeer): every tier operation addressing it crosses
    the wire from here on. Re-registering an id whose previous peer is
    gone (condemned/killed/closed) is a GENERATION CHANGE: the shadow
    entries of the predecessor are invalidated — the new process holds
    none of its replicas and must never be credited with them."""
    with _TIER_LOCK:
        if host_id in _HOSTS and _HOSTS[host_id].objects:
            raise RuntimeError(
                f"host {host_id} already holds in-process replicas; "
                f"cannot re-register it as remote"
            )
        _HOSTS.pop(host_id, None)
        prev = _REMOTE.get(host_id)
        if prev is not None and prev is not peer:
            for hk in [k for k in _REMOTE_SHADOW if k[0] == host_id]:
                del _REMOTE_SHADOW[hk]
        _REMOTE[host_id] = peer
        gen = getattr(peer, "generation", None)
        if gen is None:
            gen = _HOST_GEN.get(host_id, 0) + (0 if prev is None else 1)
        _HOST_GEN[host_id] = max(int(gen), _HOST_GEN.get(host_id, 0))
        _update_buffered_gauge()


def host_generation(host_id: int) -> int:
    """The membership generation of ``host_id``'s current peer (0 for a
    host never lost/re-registered)."""
    with _TIER_LOCK:
        return _HOST_GEN.get(host_id, 0)


def note_host_generation(host_id: int, generation: int) -> None:
    """Raise the membership view of ``host_id`` to ``generation``
    (monotonic; lower observations are ignored). Called by a transport
    probe that learned the server's true generation — a client rebuilt
    from the generation-less address book starts at 0 and adopts the
    respawned server's generation on first contact."""
    with _TIER_LOCK:
        _HOST_GEN[host_id] = max(int(generation), _HOST_GEN.get(host_id, 0))


def unregister_remote_host(host_id: int, kill_spawned: bool = True) -> None:
    with _TIER_LOCK:
        peer = _REMOTE.pop(host_id, None)
        for hk in [k for k in _REMOTE_SHADOW if k[0] == host_id]:
            del _REMOTE_SHADOW[hk]
    if peer is not None:
        try:
            peer.close(kill_spawned=kill_spawned)
        except Exception as e:
            logger.warning(f"remote peer close failed: {e!r}")


def remote_host(host_id: int):
    """The registered remote peer for ``host_id`` (None = in-process)."""
    with _TIER_LOCK:
        return _REMOTE.get(host_id)


def remote_hosts() -> Dict[int, object]:
    with _TIER_LOCK:
        return dict(_REMOTE)


def host_store(host_id: int, capacity_bytes: Optional[int] = None) -> HostRamStore:
    with _TIER_LOCK:
        store = _HOSTS.get(host_id)
        if store is None:
            store = HostRamStore(
                host_id,
                capacity_bytes if capacity_bytes is not None else (1 << 30),
            )
            _HOSTS[host_id] = store
        elif capacity_bytes is not None:
            store.capacity_bytes = capacity_bytes
        return store


def kill_host(host_id: int) -> None:
    """Simulate preemption: the host's RAM is gone and the host is dead.

    Index entries are NOT cleaned — a reader discovers the death on
    access (the ``dead`` fallback reason), exactly like a real
    unreachable peer.

    For a host backed by a REAL remote peer (snapwire), this is real:
    a spawned peer subprocess is SIGKILLed, and the host's in-flight
    transport connections are aborted so a blocked socket read observes
    the loss within the RPC deadline instead of hanging until timeout
    (the ``lose_host`` contract)."""
    peer = remote_host(host_id)
    if peer is not None:
        peer.kill()
        with _TIER_LOCK:
            # The dead process's RAM is gone: clear the client-side
            # shadow so buffered_roots/occupancy stop counting vanished
            # replicas (the local branch's objects.clear() analog).
            # Index entries stay, exactly like the local branch —
            # readers discover the death on access.
            for hk in [k for k in _REMOTE_SHADOW if k[0] == host_id]:
                del _REMOTE_SHADOW[hk]
            _update_buffered_gauge()
        return
    with _TIER_LOCK:
        store = host_store(host_id)
        store.alive = False
        store.objects.clear()
        store.used_bytes = 0
        _update_buffered_gauge()


def condemn_host(host_id: int, only_if: Optional[object] = None) -> None:
    """Classify a wire-backed host LOST without signalling its process
    (snapmend: a hung-not-dead peer — SIGSTOP, network partition —
    cannot be killed from here, but must stop being trusted). The
    RemotePeer is latched dead and its connections aborted, so every
    later op raises :class:`HostLostError`; the client-side shadow is
    cleared so occupancy/replica counting stops crediting the lost
    process. The peer stays REGISTERED (routing to a condemned host
    must fail loudly, never silently fall back to a fresh in-process
    store) until a replacement generation registers over it. For an
    in-process host this is exactly :func:`kill_host`.

    ``only_if`` pins the verdict to the peer OBJECT the caller judged:
    when a replacement has been registered over the id since (a
    respawn, an external supervisor's re-registration), the call is a
    no-op — a healthy fresh peer must never be condemned on a stale
    view of its predecessor."""
    with _TIER_LOCK:
        peer = _REMOTE.get(host_id)
        if (
            peer is not None
            and only_if is not None
            and peer is not only_if
        ):
            return
    if peer is None:
        if only_if is not None:
            return  # the judged remote peer is no longer registered
        kill_host(host_id)
        return
    condemn = getattr(peer, "condemn", None)
    if condemn is not None:
        condemn()
    else:  # duck-typed peer without the latch: a kill is the best we have
        peer.kill()
    with _TIER_LOCK:
        if _REMOTE.get(host_id) is not peer:
            # A replacement registered over the id while the judged
            # peer was being condemned outside the lock. Its
            # registration already invalidated the predecessor's
            # shadow, so every entry present now belongs to the
            # REPLACEMENT (it may already hold fresh replicas) and
            # must survive.
            return
        for hk in [k for k in _REMOTE_SHADOW if k[0] == host_id]:
            del _REMOTE_SHADOW[hk]
        _update_buffered_gauge()


def live_replicas(key: str, tag: Optional[str] = None) -> List[int]:
    """Hosts whose CURRENT store verifiably holds a replica of ``key``
    (with ``tag``, only replicas of exactly those bytes) — the repair
    plane's replica count. Unlike :func:`replica_hosts_for` (the
    rendezvous CLAIM, deliberately left stale so readers discover death
    on access), this answers from live state only: an in-process host
    must be alive and hold the object; a remote host must have a
    current-generation shadow entry (condemned/killed hosts had theirs
    invalidated)."""
    with _TIER_LOCK:
        out: List[int] = []
        for h in _KEY_HOSTS.get(key, []):
            if h in _REMOTE:
                peer = _REMOTE[h]
                if not getattr(peer, "alive", False):
                    continue
                shadow = _REMOTE_SHADOW.get((h, key))
                if shadow is not None and (
                    tag is None or shadow["tag"] == tag
                ):
                    out.append(h)
                continue
            store = _HOSTS.get(h)
            if store is None or not store.alive:
                continue
            obj = store.objects.get(key)
            if obj is not None and (tag is None or obj.tag == tag):
                out.append(h)
        return out


def replica_is_drained(key: str, host_id: int) -> Optional[bool]:
    """The drained flag of ``key``'s replica on ``host_id`` (None when
    no live replica there) — repaired replicas inherit it."""
    with _TIER_LOCK:
        shadow = _REMOTE_SHADOW.get((host_id, key))
        if shadow is not None:
            return bool(shadow["drained"])
        store = _HOSTS.get(host_id)
        obj = store.objects.get(key) if store is not None else None
        return None if obj is None else bool(obj.drained)


def revive_host(host_id: int) -> None:
    """Bring a host back (empty — preemption lost its RAM). Remote
    peers do not revive: a preempted host comes back as a NEW process
    (spawn + register again)."""
    if remote_host(host_id) is not None:
        logger.warning(
            f"revive_host({host_id}): remote peers do not revive; spawn "
            f"and register a new peer process instead"
        )
        return
    with _TIER_LOCK:
        host_store(host_id).alive = True


def live_hosts() -> List[int]:
    with _TIER_LOCK:
        hosts = {h for h, s in _HOSTS.items() if s.alive}
        hosts.update(h for h, p in _REMOTE.items() if p.alive)
        return sorted(hosts)


def reset_hot_tier() -> None:
    """Drop every host, object, index entry, and remote peer
    registration (tests). Spawned peer subprocesses are killed so no
    test leaks a process."""
    with _TIER_LOCK:
        peers = list(_REMOTE.values())
        _REMOTE.clear()
        _REMOTE_SHADOW.clear()
        _HOST_GEN.clear()
        _HOSTS.clear()
        _KEY_HOSTS.clear()
        _update_buffered_gauge()
    for peer in peers:
        try:
            peer.close(kill_spawned=True)
        except Exception as e:
            logger.warning(f"remote peer close failed: {e!r}")


def _update_buffered_gauge() -> None:
    # Lock held by caller. The client view: local stores of in-process
    # hosts plus the shadow of remote placements (a remote host's local
    # store — the in-process peer-server half — would double-count).
    telemetry.gauge(_metric_names.HOT_TIER_BUFFERED_BYTES).set(
        float(
            sum(
                s.used_bytes
                for h, s in _HOSTS.items()
                if h not in _REMOTE
            )
            + sum(int(s["nbytes"]) for s in _REMOTE_SHADOW.values())
        )
    )


def _evict_for(store: HostRamStore, need: int) -> None:
    """Free >= ``need`` bytes by evicting drained objects, oldest-touch
    first. Undrained objects are never evicted (see module docstring);
    the caller refuses the put if this cannot make room."""
    if store.used_bytes + need <= store.capacity_bytes:
        return
    for key in list(store.objects):
        if store.used_bytes + need <= store.capacity_bytes:
            return
        obj = store.objects[key]
        if not obj.drained:
            continue
        del store.objects[key]
        store.used_bytes -= len(obj.data)
        _index_remove(key, store.host_id)
        telemetry.counter(_metric_names.HOT_TIER_EVICTIONS).inc()


def _index_remove(key: str, host_id: int) -> None:
    hosts = _KEY_HOSTS.get(key)
    if hosts is not None:
        try:
            hosts.remove(host_id)
        except ValueError:
            pass
        if not hosts:
            del _KEY_HOSTS[key]


def put_replica(
    key: str, host_id: int, data: bytes, tag: str, root: str,
    capacity_bytes: Optional[int] = None,
) -> bool:
    """Place one replica on ``host_id``; returns False when refused for
    capacity. Raises :class:`HostLostError` on a dead host. Replaces any
    existing replica of ``key`` (a re-written object invalidates the old
    bytes — stale replicas cannot survive a successful re-put)."""
    peer = _route_peer(host_id)
    if peer is not None:
        # Over the wire (no tier lock held during the RPC): the peer
        # reconstructs the delta push, fingerprint-verifies, stores, and
        # only then acks — `stored` False is a capacity refusal. A dead
        # or down peer raises HostLostError from inside put (counted as
        # a push failure in the wire stats).
        stored, stored_tag = peer.put(
            key, bytes(data), tag, root, capacity_bytes=capacity_bytes
        )
        with _TIER_LOCK:
            if _REMOTE.get(host_id) is not peer:
                # The membership moved on mid-RPC (the peer was
                # condemned/replaced while our push was in flight): the
                # bytes may sit in a process nothing routes to anymore.
                # Do NOT credit the shadow — report the placement
                # failed so the caller places elsewhere (and the repair
                # plane's count stays honest).
                return False
            if stored:
                _REMOTE_SHADOW[(host_id, key)] = {
                    "root": root.rstrip("/"),
                    "nbytes": len(data),
                    "tag": tag,
                    "stored_tag": stored_tag,
                    "put_t": time.time(),
                    "drained": False,
                }
                hosts = _KEY_HOSTS.setdefault(key, [])
                if host_id not in hosts:
                    hosts.append(host_id)
                telemetry.counter(_metric_names.HOT_TIER_REPLICAS).inc()
                _update_buffered_gauge()
        return stored
    with _TIER_LOCK:
        store = host_store(host_id, capacity_bytes)
        if not store.alive:
            raise HostLostError(f"host {host_id} is dead")
        old = store.objects.pop(key, None)
        if old is not None:
            store.used_bytes -= len(old.data)
            _index_remove(key, host_id)
        _evict_for(store, len(data))
        if store.used_bytes + len(data) > store.capacity_bytes:
            _update_buffered_gauge()
            return False
        store.objects[key] = HotObject(
            data=bytes(data), tag=tag, root=root, put_t=time.time()
        )
        store.used_bytes += len(data)
        hosts = _KEY_HOSTS.setdefault(key, [])
        if host_id not in hosts:
            hosts.append(host_id)
        _update_buffered_gauge()
        telemetry.counter(_metric_names.HOT_TIER_REPLICAS).inc()
        return True


def get_replica(key: str, host_id: int) -> HotObject:
    """The replica on ``host_id`` — raises :class:`HostLostError` (dead
    host) or ``KeyError`` (missing). Verifying the content tag is the
    CALLER's job (the runtime counts corruption as a fallback reason)."""
    peer = _route_peer(host_id)
    if peer is not None:
        if not peer.alive:
            raise HostLostError(f"host {host_id} is dead")
        return peer.get(key)  # KeyError / HostLostError propagate
    with _TIER_LOCK:
        store = _HOSTS.get(host_id)
        if store is None or not store.alive:
            raise HostLostError(f"host {host_id} is dead")
        obj = store.objects[key]  # KeyError propagates: replica missing
        store.objects.move_to_end(key)  # LRU touch
        return obj


def replica_hosts_for(key: str) -> Optional[List[int]]:
    """The rendezvous answer: hosts that (claimed to) hold ``key``, in
    placement order — or None for a key the hot tier never saw."""
    with _TIER_LOCK:
        hosts = _KEY_HOSTS.get(key)
        return list(hosts) if hosts is not None else None


def _remote_quiet(peer, op: str, *args) -> None:
    """Best-effort remote side-effect: a dead/unreachable peer already
    IS the state we wanted (its replicas are gone with it)."""
    try:
        getattr(peer, op)(*args)
    except (HostLostError, KeyError):
        pass
    except Exception as e:
        logger.warning(f"remote {op} failed: {e!r}")


def drop_replica(key: str, host_id: int) -> None:
    """Remove one (e.g. corrupt) replica."""
    peer = _route_peer(host_id)
    if peer is not None:
        _remote_quiet(peer, "drop", key)
        with _TIER_LOCK:
            _REMOTE_SHADOW.pop((host_id, key), None)
            _index_remove(key, host_id)
            _update_buffered_gauge()
        return
    with _TIER_LOCK:
        store = _HOSTS.get(host_id)
        if store is not None:
            obj = store.objects.pop(key, None)
            if obj is not None:
                store.used_bytes -= len(obj.data)
        _index_remove(key, host_id)
        _update_buffered_gauge()


def forget_key(key: str) -> bool:
    """Drop every replica of ``key``; True if any existed."""
    remote_peers = []
    with _TIER_LOCK:
        hosts = _KEY_HOSTS.pop(key, None)
        existed = False
        for h in hosts or []:
            peer = _route_peer(h)
            if peer is not None:
                if _REMOTE_SHADOW.pop((h, key), None) is not None:
                    existed = True
                remote_peers.append(peer)
                continue
            store = _HOSTS.get(h)
            if store is None:
                continue
            obj = store.objects.pop(key, None)
            if obj is not None:
                store.used_bytes -= len(obj.data)
                existed = True
        _update_buffered_gauge()
    for peer in remote_peers:  # RPCs outside the tier lock
        _remote_quiet(peer, "drop", key)
    return existed


def mark_drained(key: str, tag: Optional[str] = None) -> None:
    """Flag replicas of ``key`` as persisted (hence evictable). With
    ``tag``, only replicas holding exactly those bytes are flagged — a
    replica of a NEWER re-write of the object is not durable just
    because an older version of it reached storage. A remote replica is
    flagged by its STORED tag (a lossy push's stored bytes differ from
    the logical object, but the logical object they derive from is
    durable — they are equally evictable)."""
    remote_ops = []
    with _TIER_LOCK:
        for h in _KEY_HOSTS.get(key, []):
            peer = _route_peer(h)
            if peer is not None:
                shadow = _REMOTE_SHADOW.get((h, key))
                if shadow is not None and (
                    tag is None or shadow["tag"] == tag
                ):
                    shadow["drained"] = True
                    remote_ops.append((peer, shadow["stored_tag"]))
                continue
            store = _HOSTS.get(h)
            if store is not None:
                obj = store.objects.get(key)
                if obj is not None and (tag is None or obj.tag == tag):
                    obj.drained = True
    for peer, stored_tag in remote_ops:  # RPCs outside the tier lock
        _remote_quiet(peer, "mark_drained", key, stored_tag)


def drop_stale_replicas(key: str, tag: str) -> None:
    """Drop replicas of ``key`` whose content tag differs from ``tag``
    — superseded bytes left on hosts outside the newest placement when
    the replica set changed between writes. They must not linger: a
    self-consistent stale replica would serve old bytes to readers,
    and being undrained it would pin host RAM forever. Remote staleness
    is judged against the client-side shadow's LOGICAL tag (a lossy
    push stores different bytes under the same logical tag and is not
    stale)."""
    remote_peers = []
    with _TIER_LOCK:
        for h in list(_KEY_HOSTS.get(key, [])):
            peer = _route_peer(h)
            if peer is not None:
                shadow = _REMOTE_SHADOW.get((h, key))
                if shadow is not None and shadow["tag"] != tag:
                    del _REMOTE_SHADOW[(h, key)]
                    _index_remove(key, h)
                    remote_peers.append(peer)
                continue
            store = _HOSTS.get(h)
            obj = store.objects.get(key) if store is not None else None
            if obj is not None and obj.tag != tag:
                del store.objects[key]
                store.used_bytes -= len(obj.data)
                _index_remove(key, h)
        _update_buffered_gauge()
    for peer in remote_peers:  # RPCs outside the tier lock
        _remote_quiet(peer, "drop", key)


def key_tag(key: str) -> Optional[str]:
    """The content tag of ``key``'s current replicas (None when no
    replica survives)."""
    with _TIER_LOCK:
        for h in _KEY_HOSTS.get(key, []):
            shadow = _REMOTE_SHADOW.get((h, key))
            if shadow is not None:
                return shadow["tag"]
            store = _HOSTS.get(h)
            obj = store.objects.get(key) if store is not None else None
            if obj is not None:
                return obj.tag
        return None


def key_age_s(key: str) -> Optional[float]:
    """Seconds since the newest replica of ``key`` was put (None when no
    replica survives) — the hot tier's analog of ``object_age_s``, used
    by the same age-guarded sweeps."""
    with _TIER_LOCK:
        newest: Optional[float] = None
        for h in _KEY_HOSTS.get(key, []):
            shadow = _REMOTE_SHADOW.get((h, key))
            put_t: Optional[float] = None
            if shadow is not None:
                put_t = float(shadow["put_t"])
            else:
                store = _HOSTS.get(h)
                obj = store.objects.get(key) if store is not None else None
                if obj is not None:
                    put_t = obj.put_t
            if put_t is not None and (newest is None or put_t > newest):
                newest = put_t
        return None if newest is None else max(0.0, time.time() - newest)


def key_size_bytes(key: str) -> Optional[int]:
    with _TIER_LOCK:
        for h in _KEY_HOSTS.get(key, []):
            shadow = _REMOTE_SHADOW.get((h, key))
            if shadow is not None:
                return int(shadow["nbytes"])
            store = _HOSTS.get(h)
            obj = store.objects.get(key) if store is not None else None
            if obj is not None:
                return len(obj.data)
        return None


def buffered_roots() -> Dict[str, int]:
    """``{snapshot_root: buffered_bytes}`` across all hosts — the
    accounting the leak checks and reconcile sweeps fold over. Bytes are
    summed over replicas (k copies of a root count k times). Remote
    replicas count from the client-side shadow; an in-process peer
    server's local store for a remotely-registered host is the SERVER
    half of the same replicas and is excluded (it would double-count)."""
    local_scope = getattr(_LOCAL_ONLY, "active", False)
    with _TIER_LOCK:
        out: Dict[str, int] = {}
        for host_id, store in _HOSTS.items():
            if not local_scope and host_id in _REMOTE:
                continue
            for obj in store.objects.values():
                out[obj.root] = out.get(obj.root, 0) + len(obj.data)
        if not local_scope:
            for shadow in _REMOTE_SHADOW.values():
                root = str(shadow["root"])
                out[root] = out.get(root, 0) + int(shadow["nbytes"])
        return out


def keys_for_root(root: str) -> List[str]:
    """Every key whose object belongs to ``root`` (any host)."""
    root = root.rstrip("/")
    with _TIER_LOCK:
        keys = set()
        for store in _HOSTS.values():
            for key, obj in store.objects.items():
                if obj.root == root:
                    keys.add(key)
        # Index entries whose replicas all died still address the root
        # by prefix (key = "<root>/<path>"): include them so forgetting
        # a root also clears dead-host index residue.
        for key in _KEY_HOSTS:
            if key.startswith(root + "/"):
                keys.add(key)
        return sorted(keys)


def total_buffered_bytes() -> int:
    local_scope = getattr(_LOCAL_ONLY, "active", False)
    with _TIER_LOCK:
        if local_scope:
            return sum(s.used_bytes for s in _HOSTS.values())
        return sum(
            s.used_bytes
            for h, s in _HOSTS.items()
            if h not in _REMOTE
        ) + sum(int(s["nbytes"]) for s in _REMOTE_SHADOW.values())


def host_occupancy() -> Dict[int, Dict[str, object]]:
    """Per-host occupancy for the runtime sampler / ops view: used vs
    capacity bytes, liveness, object count, and the undrained share —
    the bytes that are pinned (unevictable) because the durable tier
    does not hold them yet. One pass under the tier lock, so the view
    is self-consistent."""
    local_scope = getattr(_LOCAL_ONLY, "active", False)
    with _TIER_LOCK:
        out: Dict[int, Dict[str, object]] = {}
        for host_id, store in _HOSTS.items():
            undrained = sum(
                len(o.data) for o in store.objects.values() if not o.drained
            )
            out[host_id] = {
                "alive": store.alive,
                "used_bytes": store.used_bytes,
                "capacity_bytes": store.capacity_bytes,
                "objects": len(store.objects),
                "undrained_bytes": undrained,
            }
        for host_id, peer in [] if local_scope else _REMOTE.items():
            entries = [
                s for (h, _k), s in _REMOTE_SHADOW.items() if h == host_id
            ]
            out[host_id] = {
                "alive": peer.alive,
                "used_bytes": sum(int(s["nbytes"]) for s in entries),
                "capacity_bytes": int(
                    getattr(peer, "capacity_bytes", 0) or 0
                ),
                "objects": len(entries),
                "undrained_bytes": sum(
                    int(s["nbytes"]) for s in entries if not s["drained"]
                ),
                "remote": True,
            }
        return dict(sorted(out.items()))


# ----------------------------------------------------------- snapmem
#
# Polled memory domains (providers, not push handles): the tier mutates
# its stores at dozens of call sites under _TIER_LOCK, so snapmem polls
# a one-pass aggregate at snapshot time instead of instrumenting each.
# "hottier.host" is the local stores' real host RAM (undrained bytes
# pinned — evicting them would orphan committed bytes); the remote
# shadow is the client-side LEDGER of replicas parked on peer
# processes: real bytes, but not ours, so the domain is external
# (visible in the table, excluded from this process's committed/
# headroom math — the owning peer registers them itself).


def _mem_hosts_provider():
    with _TIER_LOCK:
        used = 0
        pinned = 0
        cap = 0
        for store in _HOSTS.values():
            used += store.used_bytes
            cap += store.capacity_bytes
            pinned += sum(
                len(o.data)
                for o in store.objects.values()
                if not o.drained
            )
        return used, pinned, (cap if _HOSTS else None)


def _mem_shadow_provider():
    with _TIER_LOCK:
        used = 0
        pinned = 0
        for s in _REMOTE_SHADOW.values():
            n = int(s["nbytes"])
            used += n
            if not s["drained"]:
                pinned += n
        return used, pinned, None


memwatch.register_provider("hottier.host", _mem_hosts_provider)
memwatch.register_provider(
    "hottier.shadow", _mem_shadow_provider, external=True
)
