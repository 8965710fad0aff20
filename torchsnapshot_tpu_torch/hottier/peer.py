"""hottier.peer: one host's RAM store served over the wire.

The server half of snapwire (transport.py is the client): a small
asyncio TCP service speaking the shared :mod:`torchsnapshot_tpu_torch.wire`
framing, holding ONE virtual host's byte-capped RAM store — the same
:mod:`.tier` substrate the in-process model uses, scoped to this
process's ``--host-id``. Killing the process is killing the host:
``SIGKILL`` drops its RAM wholesale, exactly what preemption does,
which is what makes faultline's ``lose_host`` real.

Run standalone (one per peer host)::

    python -m torchsnapshot_tpu_torch.hottier.peer \\
        --host-id 1 --addr 127.0.0.1:0 --port-file /tmp/peer1.addr

or in-process (tests: real sockets, no subprocess spawn cost)::

    server = start_local_peer(host_id=1)   # registers the RemotePeer

Ops: ``put`` (delta reconstruct → codec decode → **fingerprint-verify
→ store → ack**; a torn payload, bad frame, or missing basis NACKs and
stores nothing — ack-at-k is backed by verified bytes or not given),
``get``, ``query``, ``drop``, ``mark_drained``, ``drop_stale``
(keep-tags form: a lossy replica's stored tag differs from the
client's logical tag, so staleness is judged against the set),
``stats``, ``ping``. Requests on one connection are handled
sequentially (the client serializes per peer anyway); concurrency
comes from connections.
"""

import argparse
import asyncio
import logging
import os
import subprocess
import sys
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from .. import tracing, wire, wiretap
from ..utils.env import env_int
from . import tier

# The op registry is the client module's single source of truth
# (transport.py defines the protocol; this server half answers it).
# Importing it here is cycle-free: transport never imports peer — the
# two halves meet only over the wire (and in start_local_peer's lazy
# connect_peer import).
from .transport import HOT_TIER_OPS

logger = logging.getLogger(__name__)

_SPAWN_TIMEOUT_S = 120.0


class PeerServer:
    """Asyncio TCP server exposing one host's RAM store (tier.py,
    scoped to ``host_id``) over the snapwire ops."""

    def __init__(
        self,
        host_id: int,
        host: str = "127.0.0.1",
        port: int = 0,
        capacity_bytes: Optional[int] = None,
        generation: int = 0,
    ) -> None:
        self.host_id = host_id
        # Membership generation (snapmend): stamped by whoever spawned
        # this incarnation and echoed in every ping, so a supervisor
        # can refuse a stale predecessor process that wakes up after
        # its host id moved on to a fresh generation.
        self.generation = int(generation)
        self.capacity_bytes = (
            capacity_bytes
            if capacity_bytes is not None
            else env_int(
                "TPUSNAPSHOT_HOT_TIER_BYTES", 1 << 30
            )
        )
        self._host = host
        self._port = port
        self.addr: Optional[str] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._conn_writers: List[asyncio.StreamWriter] = []
        self._lock = threading.Lock()
        self._ready = threading.Event()
        self._startup_error: Optional[BaseException] = None
        self._killed = False
        # Ensure the host store exists (and carries the capacity) even
        # before the first put.
        tier.host_store(host_id, self.capacity_bytes)

    # ------------------------------------------------------------ lifecycle

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
        logger.info(f"hottier.peer host {self.host_id} listening on {addr}")
        return addr

    async def serve_forever(self) -> None:
        if self._server is None:
            await self.start()
        assert self._server is not None
        async with self._server:
            await self._server.serve_forever()

    def kill(self, timeout_s: float = 5.0) -> None:
        """Abrupt in-process death (the subprocess form dies by real
        SIGKILL instead): close the listening socket and abort every
        live connection."""
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
                            "hottier.peer kill: abort failed", exc_info=True
                        )
            finally:
                done.set()

        loop.call_soon_threadsafe(_close)
        if not done.wait(timeout_s):
            logger.warning("hottier.peer kill did not settle in time")

    def stop(self, timeout_s: float = 5.0) -> None:
        self.kill(timeout_s)
        thread = self._thread
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout_s)

    # ---------------------------------------------------------- connections

    async def _handle_conn(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        with self._lock:
            self._conn_writers.append(writer)
        try:
            while True:
                try:
                    header, payload = await wire.recv_frame(reader)
                except (
                    asyncio.IncompleteReadError,
                    ConnectionError,
                ):
                    break  # torn frame / dropped conn: no ack, ever
                except wire.ProtocolError:
                    logger.warning(
                        "hottier.peer: protocol violation; closing "
                        "connection",
                        exc_info=True,
                    )
                    break
                response, resp_payload = self._handle_request(
                    header, payload
                )
                try:
                    await wire.send_frame(writer, response, resp_payload)
                except (ConnectionError, OSError):
                    break
        finally:
            with self._lock:
                if writer in self._conn_writers:
                    self._conn_writers.remove(writer)
            try:
                writer.close()
            except Exception:
                logger.debug(
                    "hottier.peer connection close failed", exc_info=True
                )

    # ------------------------------------------------------------- handlers

    def _handle_request(
        self, header: Dict[str, Any], payload: bytes
    ) -> Tuple[Dict[str, Any], bytes]:
        op = header.get("op")
        base: Dict[str, Any] = {"v": wire.PROTOCOL_VERSION}
        start = time.monotonic()
        # Adopt the client's trace id off the frame so this server-side
        # wiretap event joins the same merged snapxray trace.
        trace_id = header.get("trace")
        with tracing.adopt_trace(
            trace_id if isinstance(trace_id, str) else None
        ):
            # The server half of the wire addresses its LOCAL store even
            # when this same process registered the host id as remote
            # (the in-process test form) — without the scope, tier calls
            # would route back through the RemotePeer into this very
            # server.
            with tier.serve_local():
                response, resp_payload = self._dispatch(
                    op, base, header, payload
                )
            try:
                # Unknown ops stay out of the wiretap: the telemetry
                # key space is exactly the PROTOCOL.md op inventory
                # (the conformance test holds us to it); a bad_request
                # probe must not mint a new label.
                if op in HOT_TIER_OPS:
                    wiretap.record(
                        "snapwire",
                        op,
                        seconds=time.monotonic() - start,
                        outcome=(
                            "ok"
                            if response.get("ok")
                            else wiretap.outcome_from_wire_error(
                                response.get("error")
                            )
                        ),
                        bytes_in=len(payload),
                        bytes_out=len(resp_payload),
                    )
            except Exception:  # pragma: no cover - defensive
                logger.debug(
                    "hottier.peer: wiretap record failed", exc_info=True
                )
        return response, resp_payload

    def _dispatch(
        self,
        op: Any,
        base: Dict[str, Any],
        header: Dict[str, Any],
        payload: bytes,
    ) -> Tuple[Dict[str, Any], bytes]:
        # Table-driven off the shared registry: the ops this server
        # answers ARE the ops the client may send, by construction —
        # adding one means adding a ``_do_*`` method AND a registry row,
        # and snapcheck's SNAP010 fails the build if either half drifts.
        meta = HOT_TIER_OPS.get(op) if isinstance(op, str) else None
        if meta is None:
            return (
                {
                    **base,
                    "ok": False,
                    "error": {
                        "kind": "bad_request",
                        "message": f"unknown op {op!r}",
                    },
                },
                b"",
            )
        try:
            handler = getattr(self, meta["handler"])
            return handler(header, payload)
        except Exception as e:
            return (
                {**base, "ok": False, "error": wire.error_to_wire(e)},
                b"",
            )

    def _do_put(
        self, header: Dict[str, Any], payload: bytes
    ) -> Tuple[Dict[str, Any], bytes]:
        from .. import codecs
        from ..fingerprint import fingerprint_host

        base: Dict[str, Any] = {"v": wire.PROTOCOL_VERSION}

        def _err(kind: str, message: str) -> Tuple[Dict[str, Any], bytes]:
            return (
                {
                    **base,
                    "ok": False,
                    "error": {"kind": kind, "message": message},
                },
                b"",
            )

        key = str(header.get("key"))
        root = str(header.get("root"))
        tag = str(header.get("tag"))
        size = int(header.get("size") or 0)
        lossy = bool(header.get("lossy"))
        frames = header.get("frames") or []
        basis = header.get("basis")
        base_bytes: Optional[bytes] = None
        if basis:
            try:
                base_obj = tier.get_replica(
                    str(basis.get("key")), self.host_id
                )
            except (KeyError, tier.HostLostError):
                base_obj = None
            if base_obj is None or base_obj.tag != basis.get("tag"):
                return _err(
                    "stale_basis",
                    f"basis {basis.get('key')!r} not held at tag "
                    f"{basis.get('tag')!r}",
                )
            base_bytes = base_obj.data
        out = bytearray(size)
        cursor = 0
        for frame in frames:
            kind, off, length = frame[0], int(frame[1]), int(frame[2])
            if off < 0 or off + length > size:
                return _err("bad_frame", f"frame out of bounds: {frame!r}")
            if kind == "ref":
                if base_bytes is None or off + length > len(base_bytes):
                    return _err(
                        "stale_basis", f"ref frame without basis: {frame!r}"
                    )
                out[off : off + length] = base_bytes[off : off + length]
                continue
            enc_len, codec_name = int(frame[3]), frame[4]
            chunk = payload[cursor : cursor + enc_len]
            cursor += enc_len
            if len(chunk) != enc_len:
                return _err("bad_frame", "payload shorter than frame table")
            try:
                dec = codecs.decode(codec_name, chunk)
            except Exception as e:
                return _err("bad_frame", f"codec decode failed: {e!r}")
            if len(dec) != length:
                return _err(
                    "bad_frame",
                    f"decoded {len(dec)} bytes, frame claims {length}",
                )
            out[off : off + length] = dec
        if cursor != len(payload):
            return _err("bad_frame", "payload longer than frame table")
        data = bytes(out)
        # The ack gate: the reconstructed object must fingerprint back
        # to the pushed content tag (lossy int8 pushes are tagged by
        # their own reconstructed bytes — the client is told which
        # bytes were actually stored, and the drain's strict tag match
        # keeps them out of the durable tier).
        stored_tag = fingerprint_host(data)
        if not lossy and stored_tag != tag:
            return _err(
                "corrupt_push",
                f"reconstructed fingerprint {stored_tag} != pushed "
                f"tag {tag}",
            )
        stored = tier.put_replica(
            key,
            self.host_id,
            data,
            stored_tag,
            root,
            capacity_bytes=self.capacity_bytes,
        )
        return (
            {
                **base,
                "ok": True,
                "stored": stored,
                "stored_tag": stored_tag,
            },
            b"",
        )

    def _do_get(
        self, header: Dict[str, Any], payload: bytes = b""
    ) -> Tuple[Dict[str, Any], bytes]:
        base: Dict[str, Any] = {"v": wire.PROTOCOL_VERSION}
        key = str(header.get("key"))
        try:
            obj = tier.get_replica(key, self.host_id)
        except KeyError:
            return (
                {
                    **base,
                    "ok": False,
                    "error": {"kind": "not_found", "message": key},
                },
                b"",
            )
        return (
            {
                **base,
                "ok": True,
                "tag": obj.tag,
                "root": obj.root,
                "put_t": obj.put_t,
                "drained": obj.drained,
            },
            obj.data,
        )

    def _do_query(
        self, header: Dict[str, Any], payload: bytes = b""
    ) -> Tuple[Dict[str, Any], bytes]:
        base: Dict[str, Any] = {"v": wire.PROTOCOL_VERSION}
        key = str(header.get("key"))
        try:
            obj = tier.get_replica(key, self.host_id)
        except KeyError:
            return {**base, "ok": True, "found": False}, b""
        return (
            {
                **base,
                "ok": True,
                "found": True,
                "tag": obj.tag,
                "nbytes": len(obj.data),
                "put_t": obj.put_t,
                "drained": obj.drained,
            },
            b"",
        )

    def _do_drop_stale(
        self, header: Dict[str, Any], payload: bytes = b""
    ) -> Tuple[Dict[str, Any], bytes]:
        base: Dict[str, Any] = {"v": wire.PROTOCOL_VERSION}
        key = str(header.get("key"))
        keep = set(header.get("keep_tags") or [])
        try:
            obj = tier.get_replica(key, self.host_id)
        except KeyError:
            return {**base, "ok": True, "dropped": False}, b""
        if obj.tag in keep:
            return {**base, "ok": True, "dropped": False}, b""
        tier.drop_replica(key, self.host_id)
        return {**base, "ok": True, "dropped": True}, b""

    def _do_drop(
        self, header: Dict[str, Any], payload: bytes = b""
    ) -> Tuple[Dict[str, Any], bytes]:
        base: Dict[str, Any] = {"v": wire.PROTOCOL_VERSION}
        tier.drop_replica(str(header.get("key")), self.host_id)
        return {**base, "ok": True}, b""

    def _do_mark_drained(
        self, header: Dict[str, Any], payload: bytes = b""
    ) -> Tuple[Dict[str, Any], bytes]:
        base: Dict[str, Any] = {"v": wire.PROTOCOL_VERSION}
        tier.mark_drained(str(header.get("key")), header.get("tag"))
        return {**base, "ok": True}, b""

    def _do_stats(
        self, header: Dict[str, Any], payload: bytes = b""
    ) -> Tuple[Dict[str, Any], bytes]:
        base: Dict[str, Any] = {"v": wire.PROTOCOL_VERSION}
        occ = tier.host_occupancy().get(self.host_id) or {
            "alive": True,
            "used_bytes": 0,
            "capacity_bytes": self.capacity_bytes,
            "objects": 0,
            "undrained_bytes": 0,
        }
        resp = {**base, "ok": True, "occupancy": occ}
        # This peer's own wire view rides the stats op so the ops CLI's
        # fleet-wide wire section can aggregate peers without a new op.
        try:
            block = wiretap.sample_block()
            if block.get("ops"):
                resp["wire"] = block
        except Exception:  # pragma: no cover - defensive
            logger.debug(
                "hottier.peer: wiretap sample failed", exc_info=True
            )
        # The memory plane rides the same op (`ops --mem` fleet table).
        try:
            from ..telemetry import memwatch

            mem = memwatch.sample_block()
            if mem.get("domains"):
                resp["memory"] = mem
        except Exception:  # pragma: no cover - defensive
            logger.debug(
                "hottier.peer: memwatch sample failed", exc_info=True
            )
        return resp, b""

    def _do_ping(
        self, header: Dict[str, Any], payload: bytes = b""
    ) -> Tuple[Dict[str, Any], bytes]:
        base: Dict[str, Any] = {"v": wire.PROTOCOL_VERSION}
        return (
            {
                **base,
                "ok": True,
                "host": self.host_id,
                "generation": self.generation,
            },
            b"",
        )


# ------------------------------------------------- in-process / subprocess


def start_local_peer(
    host_id: int,
    capacity_bytes: Optional[int] = None,
    register: bool = True,
    generation: int = 0,
):
    """Run a peer server on a daemon thread of THIS process (real
    sockets, no spawn cost — the fast-test form). With ``register``
    the matching :class:`~.transport.RemotePeer` is registered so the
    tier routes host ``host_id`` over the wire; returns
    ``(server, peer_or_None)``."""
    server = PeerServer(
        host_id, capacity_bytes=capacity_bytes, generation=generation
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
                logger.debug("hottier.peer local loop cancelled")

        try:
            asyncio.run(_main())
        except Exception:
            logger.warning("hottier.peer local server exited", exc_info=True)

    thread = threading.Thread(
        target=_run, name=f"hottier-peer-{host_id}", daemon=True
    )
    server._thread = thread
    thread.start()
    if not server._ready.wait(timeout=10.0):
        raise RuntimeError("hottier.peer failed to bind in time")
    if server._startup_error is not None:
        raise RuntimeError(
            f"hottier.peer failed to start: {server._startup_error!r}"
        )
    peer = None
    if register:
        from .transport import connect_peer

        peer = connect_peer(
            host_id,
            server.addr,
            capacity_bytes=capacity_bytes,
            generation=generation,
        )
    return server, peer


def spawn_peer(
    host_id: int,
    capacity_bytes: Optional[int] = None,
    register: bool = True,
    timeout_s: float = _SPAWN_TIMEOUT_S,
    generation: int = 0,
    port_file: Optional[str] = None,
):
    """Spawn a REAL peer subprocess (``python -m
    torchsnapshot_tpu_torch.hottier.peer``) on an ephemeral port, discover
    the bound address through ``--port-file``, and (by default)
    register its :class:`~.transport.RemotePeer`. Returns
    ``(process, addr, peer_or_None)`` — killing ``process`` with
    SIGKILL is a real host loss (``tier.kill_host`` does exactly that
    for registered spawned peers).

    ``generation`` stamps the membership incarnation (the repair
    plane respawns a lost host one generation up). With ``port_file``
    the bound address is KEPT at that path after discovery — the hot
    tier's address-book file the supervisor hot-reloads on every
    respawn, so sidecar tooling rediscovers the peer without a process
    restart; without it a temp file is used and removed."""
    keep_port_file = port_file is not None
    if port_file is None:
        fd, port_file = tempfile.mkstemp(
            prefix="hottier-peer-", suffix=".addr"
        )
        os.close(fd)
    if os.path.exists(port_file):
        os.unlink(port_file)  # the peer writes it atomically when bound
    cmd = [
        sys.executable,
        "-m",
        "torchsnapshot_tpu_torch.hottier.peer",
        "--host-id",
        str(host_id),
        "--addr",
        "127.0.0.1:0",
        "--port-file",
        port_file,
        "--generation",
        str(generation),
    ]
    if capacity_bytes is not None:
        cmd += ["--capacity-bytes", str(capacity_bytes)]
    env = dict(os.environ)
    # The peer imports this package: put its parent on the path so the
    # child finds it from any working directory.
    pkg_parent = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (pkg_parent, env.get("PYTHONPATH", "")) if p
    )
    proc = subprocess.Popen(
        cmd,
        env=env,
        stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL,
    )
    deadline = time.monotonic() + timeout_s
    addr: Optional[str] = None
    try:
        while time.monotonic() < deadline:
            if os.path.exists(port_file):
                with open(port_file) as f:
                    addr = f.read().strip()
                if addr:
                    break
            if proc.poll() is not None:
                raise RuntimeError(
                    f"hottier.peer subprocess exited rc={proc.returncode} "
                    f"before binding"
                )
            time.sleep(0.05)
        if not addr:
            raise RuntimeError(
                f"hottier.peer subprocess did not bind within {timeout_s:g}s"
            )
    except BaseException:
        if proc.poll() is None:
            proc.kill()
        raise
    finally:
        if not keep_port_file:
            try:
                os.unlink(port_file)
            except OSError:
                pass
    peer = None
    if register:
        from .transport import connect_peer

        peer = connect_peer(
            host_id,
            addr,
            process=proc,
            capacity_bytes=capacity_bytes,
            generation=generation,
        )
        # The repair plane's respawn reuses the configured port-file so
        # the address book on disk follows the host across generations.
        peer.spawn_port_file = port_file if keep_port_file else None
    return proc, addr, peer


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m torchsnapshot_tpu_torch.hottier.peer",
        description="snapwire peer: one host's hot-tier RAM store "
        "served over TCP.",
    )
    parser.add_argument(
        "--host-id", type=int, required=True, help="virtual host id"
    )
    parser.add_argument(
        "--addr",
        default="127.0.0.1:0",
        help="host:port to bind (port 0 = ephemeral; the bound address "
        "is printed and optionally written to --port-file)",
    )
    parser.add_argument(
        "--capacity-bytes",
        type=int,
        default=None,
        help="RAM store cap (default $TPUSNAPSHOT_HOT_TIER_BYTES or 1 GiB)",
    )
    parser.add_argument(
        "--port-file",
        default=None,
        help="write the bound host:port here once listening (lets "
        "spawning scripts discover an ephemeral port)",
    )
    parser.add_argument(
        "--generation",
        type=int,
        default=0,
        help="membership generation this incarnation serves (snapmend "
        "supervisors bump it per respawn; echoed in every ping)",
    )
    args = parser.parse_args(argv)
    host, _, port = args.addr.rpartition(":")
    server = PeerServer(
        args.host_id,
        host=host or "127.0.0.1",
        port=int(port or 0),
        capacity_bytes=args.capacity_bytes,
        generation=args.generation,
    )

    async def _main() -> None:
        addr = await server.start()
        print(f"hottier.peer host {args.host_id} on {addr}", flush=True)
        if args.port_file:
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
        logger.info("hottier.peer: interrupted; shutting down")
    return 0


if __name__ == "__main__":
    sys.exit(main())
