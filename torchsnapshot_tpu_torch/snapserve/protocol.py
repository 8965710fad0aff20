"""snapserve wire protocol: length-prefixed JSON header + raw payload.

The framing and error marshalling live in the shared
:mod:`torchsnapshot_tpu_torch.wire` module (one implementation for every TCP
service in the tree — this read plane and the hot tier's snapwire
replication transport); this module re-exports it under the historical
names so snapserve code and external callers are unchanged. Frames are
bit-compatible with the pre-extraction protocol.

Request headers: ``{"v": 1, "op": ..., "backend": ..., "path": ...,
"range": [start, end] | null, "trace": {"id", "flow"} | absent}``.
Response headers: ``{"v": 1, "ok": true, ...meta}`` or ``{"v": 1,
"ok": false, "error": {"kind", "message"}}``.

``trace`` is the snapxray causal context: ``id`` is the client's
take/restore trace id (the server's spans adopt it, joining the
client's causal chain in the merged trace) and ``flow`` a per-RPC flow
id (the server emits the matching Perfetto flow step, the client the
start/end — the cross-process arrows). Optional and ignorable: servers
and clients from before the field interoperate unchanged, and a
malformed ``trace`` never fails a read.

Error marshalling preserves the io_types failure taxonomy across the
hop: a server-side not-found comes back as ``FileNotFoundError`` and a
range-past-EOF as :class:`InvalidRange` (structurally classified as a
416 by ``io_types.is_range_not_satisfiable_error`` via its class name),
so ``verify()``'s past-end probe and the retry layer's
never-retry-deterministic-failures policy behave identically through
the service and against the backend directly — the bit-exact-fallback
contract depends on that equivalence.
"""

from ..wire import (  # noqa: F401  (re-exported protocol surface)
    MAX_HEADER_BYTES,
    MAX_PAYLOAD_BYTES,
    PROTOCOL_VERSION,
    InvalidRange,
    ProtocolError,
    RemoteServerError,
    encode_frame,
    error_to_wire,
    recv_frame,
    send_frame,
    wire_to_error,
)

# ---------------------------------------------------- read-plane op registry
#
# The single source of truth for the snapserve protocol: every op kind
# a client may send and the server handler method that answers it.
# Runtime dispatch (server.SnapServer._handle_request) and the static
# protocol checker (analysis/protocol.py, rules SNAP010/SNAP012) both
# read THIS dict, so a kind string cannot drift between client and
# server. The read plane is read-only by construction — every op is a
# pure read, hence idempotent; the client's recovery policy is
# fallback-to-direct-backend rather than retry, recorded per op as
# ``retry``.
READ_PLANE_OPS = {
    "read": {"handler": "_op_read", "retry": "fallback"},
    "stats": {"handler": "_op_stats", "retry": "none"},
    "ping": {"handler": "_op_ping", "retry": "none"},
    # Chunk pushdown: the request payload carries the record layout +
    # slice boxes (pushdown.plan_from_doc), the response the record
    # subset to fetch. Pure compute — no backend touch — and recoverable
    # by local computation (the client holds the same math), hence
    # retry "fallback".
    "plan": {"handler": "_op_plan", "retry": "fallback"},
    # Fleet membership probe: the member's name + generation stamp
    # (snapfleet supervision; a stale generation is refused upstream).
    "membership": {"handler": "_op_membership", "retry": "none"},
}

# Ops safe to re-send after an ambiguous transport failure. All
# read-plane ops qualify (pure reads); the registry exists so the next
# non-idempotent op must make that decision explicitly.
IDEMPOTENT_OPS = frozenset(READ_PLANE_OPS)

__all__ = [
    "MAX_HEADER_BYTES",
    "MAX_PAYLOAD_BYTES",
    "PROTOCOL_VERSION",
    "IDEMPOTENT_OPS",
    "READ_PLANE_OPS",
    "InvalidRange",
    "ProtocolError",
    "RemoteServerError",
    "encode_frame",
    "error_to_wire",
    "recv_frame",
    "send_frame",
    "wire_to_error",
]
