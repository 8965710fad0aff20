"""Shared wire format: length-prefixed JSON header + raw payload.

One frame both ways, for every TCP service of the package — the hot
tier's snapwire replication transport (:mod:`.hottier.transport` /
:mod:`.hottier.peer`) — byte for byte the JAX package's frames, so a
port client and a JAX peer (or the reverse) speak to each other::

    !I  header length        (JSON, utf-8, <= MAX_HEADER_BYTES)
    !Q  payload length       (raw bytes, <= MAX_PAYLOAD_BYTES)
    header bytes
    payload bytes

Headers are service-defined JSON objects; the framing layer only
requires a dict. Frames are bit-compatible with the pre-extraction
snapserve protocol (the struct layout, limits, and JSON encoding —
``sort_keys``, utf-8 — are unchanged), so mixed-version clients and
servers interoperate.

Error marshalling preserves the io_types failure taxonomy across the
hop: a server-side not-found comes back as ``FileNotFoundError`` and a
range-past-EOF as :class:`InvalidRange` (structurally classified as a
416 by ``io_types.is_range_not_satisfiable_error`` via its class name),
so ``verify()``'s past-end probe and the retry layer's
never-retry-deterministic-failures policy behave identically through a
service and against the backend directly — the bit-exact-fallback
contract depends on that equivalence.
"""

import asyncio
import json
import struct
from typing import Any, Dict, Optional, Tuple

PROTOCOL_VERSION = 1
MAX_HEADER_BYTES = 1 << 20
# Payloads are whole checkpoint objects; the sharded write path caps
# objects at 512 MiB but dense single-device leaves are unbounded —
# allow large frames and let the receiving service's policy bound
# memory.
MAX_PAYLOAD_BYTES = 1 << 40

_HEADER_STRUCT = struct.Struct("!IQ")


class ProtocolError(Exception):
    """Malformed frame — the connection cannot be trusted afterwards."""


class RemoteServerError(Exception):
    """The server reached its backend and the backend failed. Carries
    the remote error's repr; treated like any other storage failure by
    the retry layer above the client plugin."""


class InvalidRange(Exception):
    """Server-side range-not-satisfiable, re-raised client-side. The
    class NAME is the contract: ``io_types.is_range_not_satisfiable_error``
    classifies structurally by ``__name__`` over the MRO."""


async def send_frame(
    writer: asyncio.StreamWriter,
    header: Dict[str, Any],
    payload: bytes = b"",
) -> None:
    raw = json.dumps(header, sort_keys=True).encode("utf-8")
    if len(raw) > MAX_HEADER_BYTES:
        raise ProtocolError(f"header too large: {len(raw)} bytes")
    writer.write(_HEADER_STRUCT.pack(len(raw), len(payload)))
    writer.write(raw)
    if payload:
        writer.write(payload)
    await writer.drain()


def encode_frame(header: Dict[str, Any], payload: bytes = b"") -> bytes:
    """The exact byte sequence :func:`send_frame` would write — for
    callers that need the frame as a buffer (fault injection tears it
    at a byte offset; tests compare framings)."""
    raw = json.dumps(header, sort_keys=True).encode("utf-8")
    if len(raw) > MAX_HEADER_BYTES:
        raise ProtocolError(f"header too large: {len(raw)} bytes")
    return _HEADER_STRUCT.pack(len(raw), len(payload)) + raw + payload


async def recv_frame(
    reader: asyncio.StreamReader,
) -> Tuple[Dict[str, Any], bytes]:
    """Read one frame; raises ``asyncio.IncompleteReadError`` on a
    cleanly closed peer (callers treat that as end-of-stream) and
    :class:`ProtocolError` on garbage."""
    head = await reader.readexactly(_HEADER_STRUCT.size)
    header_len, payload_len = _HEADER_STRUCT.unpack(head)
    if header_len > MAX_HEADER_BYTES:
        raise ProtocolError(f"header length {header_len} exceeds limit")
    if payload_len > MAX_PAYLOAD_BYTES:
        raise ProtocolError(f"payload length {payload_len} exceeds limit")
    raw = await reader.readexactly(header_len)
    try:
        header = json.loads(raw.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ProtocolError(f"unparseable frame header: {e!r}") from e
    if not isinstance(header, dict):
        raise ProtocolError(f"frame header is not an object: {header!r}")
    payload = await reader.readexactly(payload_len) if payload_len else b""
    return header, payload


def error_to_wire(exc: BaseException) -> Dict[str, str]:
    """Classify a server-side failure into the wire taxonomy using the
    same structural classifiers the retry layer uses."""
    from .io_types import is_not_found_error, is_range_not_satisfiable_error

    if is_not_found_error(exc):
        kind = "not_found"
    elif is_range_not_satisfiable_error(exc):
        kind = "range"
    else:
        kind = "backend"
    return {"kind": kind, "message": repr(exc)}


def wire_to_error(
    error: Optional[Dict[str, Any]], path: str
) -> Exception:
    """The client-side exception for a wire error dict."""
    kind = (error or {}).get("kind")
    message = (error or {}).get("message", "")
    if kind == "not_found":
        return FileNotFoundError(path)
    if kind == "range":
        return InvalidRange(f"{path}: {message}")
    if kind == "bad_request":
        return ProtocolError(f"{path}: {message}")
    return RemoteServerError(f"{path}: {message}")
