"""snapfleet: a consistent-hashed fleet of snapserve read servers.

One snapserve process is a single point of failure and a single egress
bottleneck. The fleet layer shards the read plane over N servers with
a consistent-hash ring over chunk content keys — the SAME keys the
content cache uses (``chunkstore.content_address_of`` embeds the hash
in the path; non-chunked objects hash their location), so each object
has exactly one ring owner and the fleet's aggregate cache holds each
object once instead of N times.

Three cooperating pieces, all here:

- :class:`HashRing` — virtual-node consistent hashing
  (``TPUSNAPSHOT_SNAPSERVE_VNODES``, default 128 per member). Adding
  or losing one member remaps ~1/N of the keyspace; everything else
  keeps its owner (and its warm cache).
- :class:`FleetMembership` + :class:`FleetSupervisor` — the snapmend
  pattern applied to the read plane: a generation-stamped serializable
  membership doc (a respawned server re-registers one generation UP; a
  stale generation — a SIGCONT'd zombie of the previous incarnation —
  is refused), and probe-per-tick supervision where *hung ≠ dead*: a
  probe timeout is a strike (K strikes to go down), a refused
  connection is death, and a down member keeps being re-probed in the
  background so recovery is observed without a client in the loop.
- :class:`FleetView` — the client's routing state: the ring plus
  per-member down latches with cooldown. ``route(key)`` returns the
  failover ladder (owner first, then ring replicas); the client walks
  it and only past the last member degrades to the direct-backend
  fallback that has always existed.

In-process fleets (tests, bench, CI) come from
:func:`start_local_fleet`; members are NAMED, and faultline's
``kill_fleet_member(name)`` / ``slow_fleet_member(name, seconds)``
schedule rules resolve names through the registry here — a
deterministic mid-fan-out member death, like ``kill_server`` but
surgical.
"""

import asyncio
import hashlib
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

from .. import telemetry
from ..telemetry import metrics as _metric_names
from ..utils.env import env_float, env_int

logger = logging.getLogger(__name__)

VNODES_ENV_VAR = "TPUSNAPSHOT_SNAPSERVE_VNODES"
_DEFAULT_VNODES = 128
FLEET_ADDRS_ENV_VAR = "TPUSNAPSHOT_SNAPSERVE_FLEET_ADDRS"
PROBE_TIMEOUT_ENV_VAR = "TPUSNAPSHOT_SNAPSERVE_PROBE_TIMEOUT_S"
_DEFAULT_PROBE_TIMEOUT_S = 2.0
# A hung member (probe deadline missed) is not declared down until this
# many consecutive strikes — hung ≠ dead, the snapmend lesson.
_HUNG_STRIKES_TO_DOWN = 2


class StaleGenerationError(ValueError):
    """A member tried to (re-)register with a generation older than the
    one on record — a SIGCONT'd zombie of a previous incarnation. The
    doc keeps the newer record; the zombie must not rejoin."""


def routing_key(backend_url: str, path: str) -> str:
    """The ring key for one object read. Content-addressed chunk
    objects key by their embedded content hash (same key as the server
    cache — re-takes keep the same owner and its warm cache); anything
    else keys by its backend-qualified location."""
    from ..chunkstore import content_address_of

    content_key = content_address_of(path)
    if content_key is not None:
        return content_key
    return f"{backend_url}\n{path}"


class HashRing:
    """Consistent-hash ring with virtual nodes over member names."""

    def __init__(
        self, members: Sequence[str], vnodes: Optional[int] = None
    ) -> None:
        if vnodes is None:
            vnodes = env_int(VNODES_ENV_VAR, _DEFAULT_VNODES)
        self.vnodes = max(1, int(vnodes))
        self.members = list(dict.fromkeys(members))
        points: List[tuple] = []
        for member in self.members:
            for i in range(self.vnodes):
                points.append((self._hash(f"{member}#{i}"), member))
        points.sort()
        self._points = points

    @staticmethod
    def _hash(key: str) -> int:
        # Stable across processes and Python runs (never the builtin
        # randomized hash): every client and every server must agree on
        # ownership or the fleet's caches duplicate.
        digest = hashlib.blake2b(
            key.encode("utf-8"), digest_size=8
        ).digest()
        return int.from_bytes(digest, "big")

    def owner(self, key: str) -> Optional[str]:
        pref = self.preference(key, limit=1)
        return pref[0] if pref else None

    def preference(
        self, key: str, limit: Optional[int] = None
    ) -> List[str]:
        """Distinct members in ring order starting at ``key``'s point —
        the owner first, then the failover replicas."""
        if not self._points:
            return []
        want = len(self.members) if limit is None else min(
            limit, len(self.members)
        )
        h = self._hash(key)
        import bisect

        start = bisect.bisect_right(self._points, (h, ""))
        out: List[str] = []
        n = len(self._points)
        for i in range(n):
            member = self._points[(start + i) % n][1]
            if member not in out:
                out.append(member)
                if len(out) >= want:
                    break
        return out


# ------------------------------------------------------------- membership


@dataclass
class MemberRecord:
    name: str
    addr: str
    generation: int = 1
    status: str = "up"  # "up" | "down"
    strikes: int = field(default=0, repr=False)
    down_since: float = field(default=0.0, repr=False)

    def to_doc(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "addr": self.addr,
            "generation": int(self.generation),
            "status": self.status,
        }


class FleetMembership:
    """Generation-stamped membership doc (serializable, snapmend-style).

    ``register`` is the only way in: a fresh member registers at
    generation >= 1; a RESPAWNED member re-registers one generation up;
    a stale generation (older than the record) raises
    :class:`StaleGenerationError` and the doc is unchanged."""

    def __init__(self) -> None:
        self._members: Dict[str, MemberRecord] = {}
        self._lock = threading.Lock()

    def register(
        self, name: str, addr: str, generation: int = 1
    ) -> MemberRecord:
        generation = int(generation)
        with self._lock:
            current = self._members.get(name)
            if current is not None and generation < current.generation:
                raise StaleGenerationError(
                    f"member {name!r} re-registered at generation "
                    f"{generation} but generation {current.generation} "
                    f"is on record — refusing the stale incarnation"
                )
            record = MemberRecord(
                name=name, addr=addr, generation=generation
            )
            self._members[name] = record
            return record

    def get(self, name: str) -> Optional[MemberRecord]:
        with self._lock:
            return self._members.get(name)

    def members(self) -> List[MemberRecord]:
        with self._lock:
            return list(self._members.values())

    def up_members(self) -> List[MemberRecord]:
        return [m for m in self.members() if m.status == "up"]

    def mark(self, name: str, status: str) -> None:
        with self._lock:
            record = self._members.get(name)
            if record is None:
                return
            if status == "down" and record.status != "down":
                record.down_since = time.monotonic()
            record.status = status
            if status == "up":
                record.strikes = 0
                record.down_since = 0.0

    def to_doc(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "v": 1,
                "members": [
                    m.to_doc() for m in self._members.values()
                ],
            }

    @classmethod
    def from_doc(cls, doc: Dict[str, Any]) -> "FleetMembership":
        membership = cls()
        for m in doc.get("members", []):
            membership.register(
                str(m["name"]), str(m["addr"]), int(m.get("generation", 1))
            )
            if m.get("status") == "down":
                membership.mark(str(m["name"]), "down")
        return membership


class FleetSupervisor:
    """Probe-per-tick supervision of a fleet membership doc.

    Each :meth:`tick` probes EVERY member — up members for failure
    detection, down members as the background re-probe that observes
    recovery (a down member costs one bounded probe per tick, never a
    client's read latency). Verdicts:

    - answered, generation >= record → up (strikes cleared; a HIGHER
      generation is a respawn and re-registers the member one
      generation up);
    - answered, generation < record → a stale zombie (SIGCONT'd old
      incarnation): refused, the member stays in its current state and
      the refusal is counted;
    - probe deadline missed → a STRIKE (hung ≠ dead); only
      ``_HUNG_STRIKES_TO_DOWN`` consecutive strikes mark it down;
    - connection refused / reset → dead now.

    The probe callable defaults to the snapserve ``membership`` RPC
    (:func:`..snapserve.client.fetch_member_info`); tests inject their
    own and drive ``tick()`` directly for determinism.
    """

    def __init__(
        self,
        membership: FleetMembership,
        probe: Optional[Callable[[str, float], Dict[str, Any]]] = None,
        probe_timeout_s: Optional[float] = None,
        hung_strikes: int = _HUNG_STRIKES_TO_DOWN,
    ) -> None:
        self.membership = membership
        if probe_timeout_s is None:
            probe_timeout_s = env_float(
                PROBE_TIMEOUT_ENV_VAR, _DEFAULT_PROBE_TIMEOUT_S
            )
        self._probe = probe
        self._probe_timeout_s = probe_timeout_s
        self._hung_strikes = max(1, int(hung_strikes))
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.refused_generations = 0

    def _do_probe(self, addr: str) -> Dict[str, Any]:
        if self._probe is not None:
            return self._probe(addr, self._probe_timeout_s)
        from .client import fetch_member_info

        return fetch_member_info(addr, timeout_s=self._probe_timeout_s)

    def tick(self) -> None:
        for record in self.membership.members():
            try:
                info = self._do_probe(record.addr)
            except (asyncio.TimeoutError, TimeoutError, OSError) as e:
                # asyncio.TimeoutError is NOT the builtin TimeoutError
                # on this Python; both mean the probe deadline passed.
                hung = isinstance(
                    e, (asyncio.TimeoutError, TimeoutError)
                ) and not isinstance(e, ConnectionError)
                if hung and record.status == "up":
                    record.strikes += 1
                    telemetry.counter(
                        _metric_names.SNAPSERVE_FLEET_PROBES,
                        result="hung",
                    ).inc()
                    if record.strikes < self._hung_strikes:
                        continue
                else:
                    telemetry.counter(
                        _metric_names.SNAPSERVE_FLEET_PROBES,
                        result="dead",
                    ).inc()
                if record.status != "down":
                    logger.warning(
                        f"snapfleet: member {record.name!r} "
                        f"({record.addr}) is down: {e!r}"
                    )
                    # Down TRANSITION: flush the flight recorder so the
                    # dead member's last probes survive on disk.
                    try:
                        from .. import wiretap

                        wiretap.note_degrade(
                            "fleet_member_down", peer=record.addr
                        )
                    except Exception:  # pragma: no cover - defensive
                        logger.debug(
                            "snapfleet: blackbox dump failed",
                            exc_info=True,
                        )
                self.membership.mark(record.name, "down")
                continue
            generation = int(info.get("generation") or 0)
            if generation < record.generation:
                # A stale incarnation answering on the old address: it
                # must not rejoin (its cache keys and identity belong
                # to a generation the fleet already replaced).
                self.refused_generations += 1
                telemetry.counter(
                    _metric_names.SNAPSERVE_FLEET_PROBES,
                    result="stale",
                ).inc()
                logger.warning(
                    f"snapfleet: refused stale generation {generation} "
                    f"from member {record.name!r} (generation "
                    f"{record.generation} on record)"
                )
                continue
            telemetry.counter(
                _metric_names.SNAPSERVE_FLEET_PROBES, result="up"
            ).inc()
            if generation > record.generation:
                # Respawn: re-register one generation up (the new
                # incarnation's empty cache is trusted; the ring
                # position is unchanged, so it rewarms its own share).
                self.membership.register(
                    record.name, record.addr, generation
                )
            self.membership.mark(record.name, "up")
        telemetry.gauge(_metric_names.SNAPSERVE_FLEET_MEMBERS).set(
            len(self.membership.up_members())
        )

    def start(self, interval_s: float = 2.0) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def _run() -> None:
            while not self._stop.wait(interval_s):
                try:
                    self.tick()
                except Exception:
                    logger.warning(
                        "snapfleet supervisor tick failed", exc_info=True
                    )

        self._thread = threading.Thread(
            target=_run, name="snapfleet-supervisor", daemon=True
        )
        self._thread.start()

    def stop(self, timeout_s: float = 5.0) -> None:
        thread = self._thread
        if thread is None:
            return
        self._stop.set()
        thread.join(timeout_s)
        self._thread = None


# ------------------------------------------------------- client-side view


class FleetView:
    """The client's routing state over a fleet of server addresses: the
    consistent-hash ring plus per-member down latches with cooldown
    (the same cooldown knob as the single-server path,
    ``TPUSNAPSHOT_SNAPSERVE_DOWN_COOLDOWN_S`` — a dead member costs one
    dial failure, not one per object)."""

    def __init__(
        self, addrs: Sequence[str], vnodes: Optional[int] = None
    ) -> None:
        self.addrs = list(dict.fromkeys(addrs))
        self.ring = HashRing(self.addrs, vnodes=vnodes)
        self._down_until: Dict[str, float] = {}
        self._lock = threading.Lock()

    def route(self, key: str) -> List[str]:
        """The failover ladder for one key: ring owner first, then the
        remaining members in ring order."""
        return self.ring.preference(key)

    def mark_down(self, addr: str, cooldown_s: float) -> None:
        with self._lock:
            self._down_until[addr] = time.monotonic() + cooldown_s

    def is_down(self, addr: str) -> bool:
        with self._lock:
            return time.monotonic() < self._down_until.get(addr, 0.0)


# ------------------------------------------- in-process fleet (tests/bench)
#
# Named members in a module registry, so faultline's kill_fleet_member /
# slow_fleet_member rules can act on "m1" without threading handles
# through the pipeline under test — the fleet mirror of
# server._LOCAL_SERVERS.

_LOCAL_MEMBERS: Dict[str, Any] = {}
_LOCAL_LOCK = threading.Lock()


def register_local_member(name: str, server: Any) -> None:
    with _LOCAL_LOCK:
        _LOCAL_MEMBERS[name] = server


def unregister_local_member(name: str) -> None:
    with _LOCAL_LOCK:
        _LOCAL_MEMBERS.pop(name, None)


def local_member_names() -> List[str]:
    with _LOCAL_LOCK:
        return sorted(_LOCAL_MEMBERS)


def kill_local_member(name: str) -> bool:
    """Abruptly kill the named in-process fleet member (faultline's
    ``kill_fleet_member`` action). Returns whether it was alive."""
    with _LOCAL_LOCK:
        server = _LOCAL_MEMBERS.pop(name, None)
    if server is None:
        return False
    server.kill()
    return True


def slow_local_member(name: str, seconds: float) -> bool:
    """Arm a per-request injected delay on the named member (faultline's
    ``slow_fleet_member`` action): every request it answers from now on
    pays ``seconds`` first — a hung-not-dead member."""
    with _LOCAL_LOCK:
        server = _LOCAL_MEMBERS.get(name)
    if server is None:
        return False
    server.set_injected_delay(seconds)
    return True


class LocalFleet:
    """Handle on an in-process fleet: named servers, their addresses,
    the membership doc, and teardown."""

    def __init__(
        self, members: "Dict[str, Any]", membership: FleetMembership
    ) -> None:
        self.members = members
        self.membership = membership

    @property
    def addrs(self) -> List[str]:
        return [
            server.addr
            for _name, server in sorted(self.members.items())
            if server.addr
        ]

    @property
    def addr_spec(self) -> str:
        """The comma-joined address list a ``snapserve://`` URL (or
        ``TPUSNAPSHOT_SNAPSERVE_FLEET_ADDRS``) carries."""
        return ",".join(self.addrs)

    def stop(self) -> None:
        for name, server in self.members.items():
            unregister_local_member(name)
            try:
                server.stop()
            except Exception:
                logger.warning(
                    f"snapfleet: member {name!r} stop failed",
                    exc_info=True,
                )


def start_local_fleet(
    n: int = 3,
    service_factory: Optional[Callable[[], Any]] = None,
    name_prefix: str = "m",
) -> LocalFleet:
    """Start ``n`` named in-process snapserve servers (each with its own
    :class:`~.server.ReadService` unless ``service_factory`` supplies
    one), register them at generation 1, and return the fleet handle.
    The caller owns ``fleet.stop()``."""
    from .server import ReadService, start_local_server

    membership = FleetMembership()
    members: Dict[str, Any] = {}
    try:
        for i in range(int(n)):
            name = f"{name_prefix}{i}"
            service = (
                service_factory() if service_factory else ReadService()
            )
            server = start_local_server(
                service=service, member_name=name, generation=1
            )
            members[name] = server
            register_local_member(name, server)
            membership.register(name, server.addr or "", generation=1)
    except BaseException:
        for name, server in members.items():
            unregister_local_member(name)
            try:
                server.stop()
            except Exception:
                logger.warning(
                    "snapfleet partial-start teardown failed",
                    exc_info=True,
                )
        raise
    telemetry.gauge(_metric_names.SNAPSERVE_FLEET_MEMBERS).set(
        len(members)
    )
    return LocalFleet(members, membership)
