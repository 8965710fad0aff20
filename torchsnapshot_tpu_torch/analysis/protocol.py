"""snapproto: static wire-protocol models for the three TCP stacks.

ROADMAP item 4 wants the snapserve read plane, the snapwire hot-tier
transport, and the snapmend repair plane unified onto one async
data-plane core. Nobody should attempt that refactor blind: the
protocol contracts — which op kinds exist, which side answers them,
which frame fields each side reads and writes, which error kinds
survive marshalling, which waits carry deadlines, which retries are
idempotent — live in the code, and this module extracts them from the
ASTs so the conformance rules (:mod:`.rules_protocol`, SNAP010-SNAP013)
and the generated protocol map (``--inventory`` →
``docs/PROTOCOL.md``) can never drift from it.

Everything here is per-file **facts** (:class:`ModuleFacts`): what a
module sends, handles, reads, writes, declares. Cross-file judgement
(client vs server skew) belongs to the rules; cross-transport
composition (the migration map) to :func:`build_inventory`.

Extraction is deliberately syntactic and over-approximate on the write
side (every dict-literal key in a file counts as "written") and precise
on the read side (only ``.get("k")`` / ``["k"]`` on tracked frame
variables count as "read"), so the only conformance failure that can
fire is a genuine read-without-writer — the direction that breaks at
runtime.
"""

import ast
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from .core import dotted_name

# Function parameters with these names mark the function as a frame
# RESPONDER (it was handed a decoded request); reads through them are
# request-field reads, and its sends are replies (exempt from the
# initiator deadline discipline in SNAP011).
HEADERISH_PARAMS = frozenset({"header", "hdr", "req", "request", "frame"})

# Call results tracked as RESPONSE frames on the initiator side:
# ``resp, _ = self._call(...)`` / ``header, payload = await
# recv_frame(...)`` and friends. Matched on the callee's last dotted
# component; substring match for call/rpc/exchange covers the
# ``_call_once`` family without enumerating it.
_RESPONSE_SOURCE_EXACT = frozenset({"recv_frame"})
_RESPONSE_SOURCE_SUBSTR = ("call", "rpc", "exchange")

# Awaited wire waits, by kind, for SNAP011.
WIRE_WAITS = {
    "open_connection": "dial",
    "send_frame": "send",
    "drain": "send",
    "recv_frame": "recv",
    "readexactly": "recv",
    "readuntil": "recv",
}

# tier-facade / RemotePeer methods that cross the wire, and the op kind
# each one rides — how the snapmend repair plane (which never touches
# frames itself) maps onto the snapwire protocol in the inventory.
FACADE_METHOD_OPS = {
    "probe": "ping",
    "get_replica": "get",
    "put_replica": "put",
    "drop_replica": "drop",
    "mark_drained": "mark_drained",
    "drop_stale_replicas": "drop_stale",
    "live_replicas": "query",
    "host_occupancy": "stats",
}


def _last(name: Optional[str]) -> str:
    return (name or "").rsplit(".", 1)[-1]


def call_last_name(node: ast.Call) -> str:
    return _last(dotted_name(node.func))


def is_protocol_module(tree: ast.AST) -> bool:
    """Does this module participate in a wire protocol? True when it
    imports the framing layer (``wire`` / a ``protocol`` module) or
    calls the frame functions directly."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if _last(alias.name) == "wire":
                    return True
        elif isinstance(node, ast.ImportFrom):
            if _last(node.module) in ("wire", "protocol"):
                return True
            for alias in node.names:
                if alias.name in (
                    "wire",
                    "send_frame",
                    "recv_frame",
                    "encode_frame",
                ):
                    return True
        elif isinstance(node, ast.Call):
            if call_last_name(node) in (
                "send_frame",
                "recv_frame",
                "encode_frame",
            ):
                return True
    return False


def is_framing_module(tree: ast.AST) -> bool:
    """The framing layer itself (defines both ``send_frame`` and
    ``recv_frame`` at module level — ``wire.py``): its raw reads/writes
    ARE the protocol; the conformance rules skip it."""
    defs = {
        n.name
        for n in getattr(tree, "body", [])
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    }
    return "send_frame" in defs and "recv_frame" in defs


def dict_literal_keys(node: ast.Dict) -> List[str]:
    return [
        k.value
        for k in node.keys
        if isinstance(k, ast.Constant) and isinstance(k.value, str)
    ]


def dict_literal_get(node: ast.Dict, key: str) -> Optional[ast.expr]:
    for k, v in zip(node.keys, node.values):
        if isinstance(k, ast.Constant) and k.value == key:
            return v
    return None


def _const_str(node: Optional[ast.expr]) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def walk_shallow(func: ast.AST):
    """Walk a function body without descending into nested function
    definitions (the nested def node itself IS yielded, so call edges
    and name references to it are still seen)."""
    stack = list(ast.iter_child_nodes(func))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
        ):
            stack.extend(ast.iter_child_nodes(node))


@dataclass
class WireSite:
    """One awaited wire wait."""

    kind: str  # dial | send | recv
    name: str  # the callee (recv_frame, drain, ...)
    line: int
    col: int
    bounded: bool  # directly inside an asyncio.wait_for argument


@dataclass
class FuncFacts:
    name: str
    node: Any
    is_async: bool
    params: List[str]
    responder: bool
    wire_sites: List[WireSite] = field(default_factory=list)
    # callee name -> list of (line, bounded) for in-module edges
    calls: Dict[str, List[Tuple[int, bool]]] = field(default_factory=dict)


@dataclass
class ModuleFacts:
    path: str
    tree: Any
    is_protocol: bool = False
    is_framing: bool = False
    # op -> lines where a frame dict literal with that "op" was built
    ops_sent: Dict[str, List[int]] = field(default_factory=dict)
    # op -> (fields of that request frame literal)
    request_fields_by_op: Dict[str, Set[str]] = field(default_factory=dict)
    # op -> line of an ``op == "x"`` dispatch comparison
    ops_handled: Dict[str, int] = field(default_factory=dict)
    # table name -> {op -> meta dict} for module-level ``*_OPS`` dicts
    op_tables: Dict[str, Dict[str, Dict[str, Any]]] = field(
        default_factory=dict
    )
    op_table_lines: Dict[str, int] = field(default_factory=dict)
    idempotent_ops: Optional[Set[str]] = None
    idempotent_ops_line: int = 0
    # every dict-literal key / subscript store / .update kwarg in the
    # file — the over-approximate write set
    fields_written: Set[str] = field(default_factory=set)
    # precise frame reads: [(field, line)]
    request_reads: List[Tuple[str, int]] = field(default_factory=list)
    response_reads: List[Tuple[str, int]] = field(default_factory=list)
    # error taxonomy
    error_kinds_emitted: Dict[str, List[int]] = field(default_factory=dict)
    error_kinds_handled: Dict[str, List[int]] = field(default_factory=dict)
    function_names: Set[str] = field(default_factory=set)
    functions: List[FuncFacts] = field(default_factory=list)
    # facade method -> lines (snapmend's wire surface)
    facade_calls: Dict[str, List[int]] = field(default_factory=dict)
    protocol_version: Optional[int] = None


def _collect_op_tables(facts: ModuleFacts) -> None:
    """Module-level ``FOO_OPS = {...}`` / ``IDEMPOTENT_OPS = ...``
    constants — the declarative registries the runtime dispatch and
    these rules both read."""
    for stmt in facts.tree.body:
        if isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            targets = [stmt.target]
            value = stmt.value
        elif isinstance(stmt, ast.Assign):
            targets = stmt.targets
            value = stmt.value
        else:
            continue
        for target in targets:
            if not isinstance(target, ast.Name):
                continue
            name = target.id
            if not name.isupper() or not name.endswith("OPS"):
                continue
            ops = _resolve_ops_constant(value, facts)
            if ops is None:
                continue
            if name == "IDEMPOTENT_OPS":
                facts.idempotent_ops = set(ops)
                facts.idempotent_ops_line = stmt.lineno
            elif isinstance(ops, dict):
                facts.op_tables[name] = ops
                facts.op_table_lines[name] = stmt.lineno


def _resolve_ops_constant(value: ast.expr, facts: ModuleFacts):
    """A dict op-table ({op: meta}), or a set of op strings, or a
    ``frozenset(EXISTING_TABLE)`` reference. None when unrecognized."""
    if isinstance(value, ast.Dict):
        table: Dict[str, Dict[str, Any]] = {}
        for k, v in zip(value.keys, value.values):
            op = _const_str(k)
            if op is None:
                return None
            meta: Dict[str, Any] = {}
            if isinstance(v, ast.Dict):
                for mk, mv in zip(v.keys, v.values):
                    mkey = _const_str(mk)
                    if mkey is not None and isinstance(mv, ast.Constant):
                        meta[mkey] = mv.value
            table[op] = meta
        return table
    if isinstance(value, (ast.Set, ast.List, ast.Tuple)):
        ops = [_const_str(e) for e in value.elts]
        return None if any(o is None for o in ops) else set(ops)
    if isinstance(value, ast.Call) and call_last_name(value) in (
        "frozenset",
        "set",
    ):
        if len(value.args) != 1:
            return None
        arg = value.args[0]
        if isinstance(arg, ast.Name) and arg.id in facts.op_tables:
            return set(facts.op_tables[arg.id])
        return _resolve_ops_constant(arg, facts)
    return None


def _frame_var_roles(func: ast.AST) -> Tuple[Set[str], Set[str]]:
    """(request_vars, response_vars) for one function: header-ish
    parameters are requests; results of recv/_call-family calls are
    responses."""
    request_vars: Set[str] = set()
    response_vars: Set[str] = set()
    args = getattr(func, "args", None)
    if args is not None:
        for a in list(args.args) + list(args.kwonlyargs):
            if a.arg in HEADERISH_PARAMS:
                request_vars.add(a.arg)
    for node in walk_shallow(func):
        if not isinstance(node, (ast.Assign, ast.AnnAssign)):
            continue
        value = node.value
        if value is None:
            continue
        call = _unwrap_to_call(value)
        if call is None:
            continue
        last = call_last_name(call)
        low = last.lower()
        if last not in _RESPONSE_SOURCE_EXACT and not any(
            s in low for s in _RESPONSE_SOURCE_SUBSTR
        ):
            continue
        targets = (
            node.targets if isinstance(node, ast.Assign) else [node.target]
        )
        for t in targets:
            if isinstance(t, ast.Tuple) and t.elts:
                t = t.elts[0]
            if isinstance(t, ast.Name):
                response_vars.add(t.id)
    return request_vars, response_vars


def _unwrap_to_call(value: ast.expr) -> Optional[ast.Call]:
    """``await wait_for(f(...), t)`` / ``await f(...)`` / ``f(...)``
    → the innermost interesting Call."""
    if isinstance(value, ast.Await):
        value = value.value
    if not isinstance(value, ast.Call):
        return None
    if call_last_name(value) == "wait_for" and value.args:
        inner = value.args[0]
        if isinstance(inner, ast.Call):
            return inner
    return value


def _scan_field_reads(
    func: ast.AST,
    request_vars: Set[str],
    response_vars: Set[str],
    facts: ModuleFacts,
) -> None:
    for node in walk_shallow(func):
        if isinstance(node, ast.Call):
            f = node.func
            if (
                isinstance(f, ast.Attribute)
                and f.attr == "get"
                and isinstance(f.value, ast.Name)
                and node.args
            ):
                key = _const_str(node.args[0])
                if key is not None:
                    if f.value.id in request_vars:
                        facts.request_reads.append((key, node.lineno))
                    elif f.value.id in response_vars:
                        facts.response_reads.append((key, node.lineno))
        elif isinstance(node, ast.Subscript) and isinstance(
            node.ctx, ast.Load
        ):
            if isinstance(node.value, ast.Name):
                key = _const_str(node.slice)
                if key is not None:
                    if node.value.id in request_vars:
                        facts.request_reads.append((key, node.lineno))
                    elif node.value.id in response_vars:
                        facts.response_reads.append((key, node.lineno))


def _scan_wire_sites(func: ast.AST, ff: FuncFacts) -> None:
    bounded_ids: Set[int] = set()
    awaited_ids: Set[int] = set()
    for node in walk_shallow(func):
        if isinstance(node, ast.Call) and call_last_name(node) == "wait_for":
            if node.args:
                for sub in ast.walk(node.args[0]):
                    if isinstance(sub, ast.Call):
                        bounded_ids.add(id(sub))
        if isinstance(node, ast.Await):
            for sub in ast.walk(node.value):
                if isinstance(sub, ast.Call):
                    awaited_ids.add(id(sub))
    for node in walk_shallow(func):
        if not isinstance(node, ast.Call):
            continue
        name = call_last_name(node)
        kind = WIRE_WAITS.get(name)
        if kind is None or id(node) not in awaited_ids:
            continue
        ff.wire_sites.append(
            WireSite(
                kind=kind,
                name=name,
                line=node.lineno,
                col=node.col_offset,
                bounded=id(node) in bounded_ids,
            )
        )
    ff.wire_sites.sort(key=lambda s: (s.line, s.col))


def _scan_calls(
    func: ast.AST, ff: FuncFacts, local_names: Set[str]
) -> None:
    bounded_ids: Set[int] = set()
    for node in walk_shallow(func):
        if isinstance(node, ast.Call) and call_last_name(node) == "wait_for":
            if node.args:
                for sub in ast.walk(node.args[0]):
                    if isinstance(sub, ast.Call):
                        bounded_ids.add(id(sub))
    for node in walk_shallow(func):
        if not isinstance(node, ast.Call):
            continue
        name = call_last_name(node)
        if name in local_names and name != ff.name:
            ff.calls.setdefault(name, []).append(
                (node.lineno, id(node) in bounded_ids)
            )


def extract_module(tree: ast.AST, path: str) -> ModuleFacts:
    """All per-file protocol facts for one module."""
    facts = ModuleFacts(path=path, tree=tree)
    facts.is_protocol = is_protocol_module(tree)
    facts.is_framing = is_framing_module(tree)
    _collect_op_tables(facts)

    for stmt in tree.body:
        if isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                if (
                    isinstance(t, ast.Name)
                    and t.id == "PROTOCOL_VERSION"
                    and isinstance(stmt.value, ast.Constant)
                ):
                    facts.protocol_version = stmt.value.value

    funcs = [
        n
        for n in ast.walk(tree)
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    ]
    facts.function_names = {f.name for f in funcs}

    for node in ast.walk(tree):
        # -- frame sends + the over-approximate write set
        if isinstance(node, ast.Dict):
            keys = dict_literal_keys(node)
            facts.fields_written.update(keys)
            op = _const_str(dict_literal_get(node, "op"))
            if op is not None:
                facts.ops_sent.setdefault(op, []).append(node.lineno)
                facts.request_fields_by_op.setdefault(op, set()).update(keys)
            kind = _const_str(dict_literal_get(node, "kind"))
            if kind is not None:
                facts.error_kinds_emitted.setdefault(kind, []).append(
                    node.lineno
                )
        elif isinstance(node, ast.Subscript) and isinstance(
            node.ctx, ast.Store
        ):
            key = _const_str(node.slice)
            if key is not None:
                facts.fields_written.add(key)
        elif isinstance(node, ast.Call):
            last = call_last_name(node)
            if last == "update":
                for kw in node.keywords:
                    if kw.arg is not None:
                        facts.fields_written.add(kw.arg)
            elif last == "_err" and node.args:
                kind = _const_str(node.args[0])
                if kind is not None:
                    facts.error_kinds_emitted.setdefault(kind, []).append(
                        node.lineno
                    )
            elif last in FACADE_METHOD_OPS:
                facts.facade_calls.setdefault(last, []).append(node.lineno)
        # -- dispatch comparisons and error-kind handling
        elif isinstance(node, ast.Compare) and len(node.ops) == 1:
            _scan_compare(node, facts)
        # -- error taxonomy via plain ``kind = "..."`` assignment
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == "kind":
                    kind = _const_str(node.value)
                    if kind is not None:
                        facts.error_kinds_emitted.setdefault(
                            kind, []
                        ).append(node.lineno)

    for func in funcs:
        request_vars, response_vars = _frame_var_roles(func)
        ff = FuncFacts(
            name=func.name,
            node=func,
            is_async=isinstance(func, ast.AsyncFunctionDef),
            params=[a.arg for a in func.args.args],
            responder=bool(request_vars),
        )
        _scan_wire_sites(func, ff)
        if not ff.responder and ff.wire_sites:
            first_non_dial = next(
                (s for s in ff.wire_sites if s.kind != "dial"), None
            )
            if first_non_dial is not None and first_non_dial.kind == "recv":
                ff.responder = True
        _scan_calls(func, ff, facts.function_names)
        _scan_field_reads(func, request_vars, response_vars, facts)
        facts.functions.append(ff)
    return facts


def _scan_compare(node: ast.Compare, facts: ModuleFacts) -> None:
    left, op, right = node.left, node.ops[0], node.comparators[0]
    left_name = _last(dotted_name(left))
    left_get: Optional[str] = None
    if (
        isinstance(left, ast.Call)
        and isinstance(left.func, ast.Attribute)
        and left.func.attr == "get"
        and left.args
    ):
        left_get = _const_str(left.args[0])
    is_op = left_name == "op" or left_get == "op"
    is_kind = left_name.endswith("kind") or left_get == "kind"
    if not (is_op or is_kind):
        return
    values: List[Tuple[str, int]] = []
    if isinstance(op, (ast.Eq, ast.In)):
        if isinstance(right, ast.Constant) and isinstance(right.value, str):
            values.append((right.value, node.lineno))
        elif isinstance(right, (ast.Tuple, ast.List, ast.Set)):
            for e in right.elts:
                v = _const_str(e)
                if v is not None:
                    values.append((v, node.lineno))
    for value, line in values:
        if is_op:
            facts.ops_handled.setdefault(value, line)
        else:
            facts.error_kinds_handled.setdefault(value, []).append(line)


def merged_op_table(
    facts_list: Sequence[Optional[ModuleFacts]],
) -> Dict[str, Dict[str, Any]]:
    """One op table across a peering (client + server + shared protocol
    module) — whichever file declares the registry, both sides are
    judged against it."""
    merged: Dict[str, Dict[str, Any]] = {}
    for facts in facts_list:
        if facts is None:
            continue
        for table in facts.op_tables.values():
            for op, meta in table.items():
                merged.setdefault(op, dict(meta))
    return merged


def parse_facts(path: str) -> Optional[ModuleFacts]:
    try:
        with open(path, "r", encoding="utf-8") as f:
            source = f.read()
        tree = ast.parse(source, filename=path)
    except (OSError, UnicodeDecodeError, SyntaxError):
        return None
    return extract_module(tree, path)


# ----------------------------------------------------------------- inventory
#
# The registry of the three wire stacks. ``client_files`` are the
# frame-building sides (server.py appears for snapserve because its
# one-shot stats helper is a client); ``facade`` transports ride
# another transport's protocol through method calls instead of frames.

TRANSPORTS: Tuple[Dict[str, Any], ...] = (
    {
        "name": "snapserve",
        "description": (
            "read plane: asyncio caching read service "
            "(client falls back to direct backend reads)"
        ),
        "client_files": ("snapserve/client.py", "snapserve/server.py"),
        "server_file": "snapserve/server.py",
        "shared_files": ("snapserve/protocol.py",),
        "facade": None,
        "telemetry_transport": "snapserve",
    },
    {
        "name": "snapwire",
        "description": (
            "hot-tier replication: sync-RPC client (per-RPC deadline, "
            "decorrelated-jitter retry budget) + asyncio peer server"
        ),
        "client_files": ("hottier/transport.py",),
        "server_file": "hottier/peer.py",
        "shared_files": (),
        "facade": None,
        "telemetry_transport": "snapwire",
    },
    {
        "name": "snapmend",
        "description": (
            "repair plane: no frames of its own — rides the snapwire "
            "peer through the tier facade / RemotePeer methods"
        ),
        "client_files": ("hottier/repair.py",),
        "server_file": "hottier/peer.py",
        "shared_files": ("hottier/transport.py",),
        "facade": FACADE_METHOD_OPS,
        # A facade has no frames of its own: its RPCs surface in the
        # wiretap under the transport whose wire it rides.
        "telemetry_transport": "snapwire",
    },
)


def package_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_inventory(root: Optional[str] = None) -> Dict[str, Any]:
    """The machine-readable protocol map: per-transport op catalogs,
    frame-field contracts, error taxonomies, retry/deadline policy, and
    the cross-transport divergence list — ROADMAP item 4's migration
    map, regenerated from the code on every run."""
    root = root or package_root()
    cache: Dict[str, Optional[ModuleFacts]] = {}

    def facts_for(rel: str) -> Optional[ModuleFacts]:
        if rel not in cache:
            cache[rel] = parse_facts(os.path.join(root, rel))
        return cache[rel]

    wire_facts = facts_for("wire.py")
    transports: List[Dict[str, Any]] = []
    for spec in TRANSPORTS:
        server = facts_for(spec["server_file"])
        clients = [
            (rel, facts_for(rel)) for rel in spec["client_files"]
        ]
        shared = [facts_for(rel) for rel in spec["shared_files"]]
        table = merged_op_table(
            [server] + [f for _, f in clients] + shared
        )
        ops: Dict[str, Any] = {}
        sent_ops: Set[str] = set()
        for rel, cf in clients:
            if cf is None:
                continue
            if spec["facade"]:
                for method, lines in sorted(cf.facade_calls.items()):
                    op = spec["facade"][method]
                    sent_ops.add(op)
                    entry = ops.setdefault(op, {"sent_by": {}})
                    entry["sent_by"].setdefault(rel, []).extend(
                        sorted(lines)
                    )
                    entry.setdefault("via_methods", []).append(method)
            for op, lines in sorted(cf.ops_sent.items()):
                sent_ops.add(op)
                entry = ops.setdefault(op, {"sent_by": {}})
                entry["sent_by"].setdefault(rel, []).extend(sorted(lines))
        handled: Dict[str, Any] = {}
        if server is not None:
            for op, meta in table.items():
                handler = meta.get("handler")
                handled[op] = {
                    "handler": handler,
                    "defined": bool(
                        handler and handler in server.function_names
                    ),
                    "retry": meta.get("retry", "unspecified"),
                }
            for op, line in server.ops_handled.items():
                handled.setdefault(
                    op,
                    {
                        "handler": None,
                        "defined": True,
                        "retry": "unspecified",
                    },
                )
        for op in sorted(set(ops) | set(handled)):
            entry = ops.setdefault(op, {"sent_by": {}})
            h = handled.get(op)
            entry["handler"] = h["handler"] if h else None
            entry["handled"] = bool(h and h["defined"])
            entry["retry"] = h["retry"] if h else "unspecified"
            # snapflight join key: every wiretap sample for this op
            # carries this "{transport}/{op}" label pair; the
            # conformance test pins sample keys == inventory keys.
            entry["telemetry_key"] = (
                f"{spec['telemetry_transport']}/{op}"
            )
            if "via_methods" in entry:
                entry["via_methods"] = sorted(set(entry["via_methods"]))
        idempotent: Optional[List[str]] = None
        for f in [server] + [c for _, c in clients] + shared:
            if f is not None and f.idempotent_ops is not None:
                idempotent = sorted(
                    set(idempotent or []) | f.idempotent_ops
                )
        request_fields: Dict[str, List[str]] = {}
        for _, cf in clients:
            if cf is None:
                continue
            for op, fields in cf.request_fields_by_op.items():
                request_fields[op] = sorted(
                    set(request_fields.get(op, [])) | fields
                )
        response_reads: Set[str] = set()
        for _, cf in clients:
            if cf is None:
                continue
            response_reads.update(k for k, _ in cf.response_reads)
        request_reads: Set[str] = set()
        error_kinds_emitted: Set[str] = set()
        if server is not None:
            request_reads.update(k for k, _ in server.request_reads)
            error_kinds_emitted.update(server.error_kinds_emitted)
        error_kinds_handled: Set[str] = set()
        for _, cf in clients:
            if cf is None:
                continue
            error_kinds_handled.update(cf.error_kinds_handled)
        transports.append(
            {
                "name": spec["name"],
                "description": spec["description"],
                "client_files": list(spec["client_files"]),
                "server_file": spec["server_file"],
                "telemetry_transport": spec["telemetry_transport"],
                "ops": ops,
                "ops_without_handler": sorted(
                    op
                    for op in sent_ops
                    if not ops.get(op, {}).get("handled")
                ),
                "handlers_without_sender": sorted(
                    op for op in handled if op not in sent_ops
                ),
                "idempotent_ops": idempotent,
                "request_fields_by_op": {
                    op: request_fields[op] for op in sorted(request_fields)
                },
                "request_fields_read_by_server": sorted(request_reads),
                "response_fields_read_by_clients": sorted(response_reads),
                "error_kinds_emitted": sorted(error_kinds_emitted),
                "error_kinds_handled_by_clients": sorted(
                    error_kinds_handled
                ),
            }
        )
    # cross-transport divergences: the unification work list
    op_sets = {t["name"]: set(t["ops"]) for t in transports}
    shared_kinds = sorted(
        set.union(*op_sets.values())
        & {
            op
            for op in set.union(*op_sets.values())
            if sum(op in s for s in op_sets.values()) > 1
        }
    )
    retry_styles = {
        t["name"]: sorted(
            {e.get("retry", "unspecified") for e in t["ops"].values()}
        )
        for t in transports
    }
    inventory = {
        "wire": {
            "file": "wire.py",
            "protocol_version": (
                wire_facts.protocol_version if wire_facts else None
            ),
            "error_kinds_marshalled": sorted(
                wire_facts.error_kinds_emitted
            )
            if wire_facts
            else [],
            "error_kinds_unmarshalled": sorted(
                wire_facts.error_kinds_handled
            )
            if wire_facts
            else [],
        },
        "transports": transports,
        "divergences": {
            "op_kinds_shared_across_transports": shared_kinds,
            "retry_styles": retry_styles,
        },
    }
    return inventory


def render_markdown(inventory: Dict[str, Any]) -> str:
    """docs/PROTOCOL.md — deterministic (sorted, no timestamps) so the
    CI freshness gate can diff it byte-for-byte."""
    w = inventory["wire"]
    out: List[str] = []
    out.append("# Wire-protocol inventory (snapproto)")
    out.append("")
    out.append(
        "> Generated by `python -m torchsnapshot_tpu_torch.analysis "
        "--inventory`. Do not edit by hand — CI regenerates this file "
        "and fails on any diff (the protocol map can never go stale "
        "against the code). This document is the migration map for "
        "ROADMAP item 4 (one data plane): every op kind, handler, "
        "frame-field contract, error taxonomy, and retry/deadline "
        "policy the unification must preserve."
    )
    out.append("")
    out.append(
        f"## Shared framing (`{w['file']}`) — protocol version "
        f"{w['protocol_version']}"
    )
    out.append("")
    out.append(
        "Length-prefixed JSON header + raw payload (`!IQ`), one frame "
        "each way. Error kinds marshalled by `error_to_wire`: "
        + ", ".join(f"`{k}`" for k in w["error_kinds_marshalled"])
        + ". Kinds unmarshalled by `wire_to_error`: "
        + ", ".join(f"`{k}`" for k in w["error_kinds_unmarshalled"])
        + " (anything else becomes `RemoteServerError`)."
    )
    for t in inventory["transports"]:
        out.append("")
        out.append(f"## Transport: {t['name']}")
        out.append("")
        out.append(f"{t['description']}.")
        out.append("")
        out.append(
            f"Server: `{t['server_file']}` · clients: "
            + ", ".join(f"`{c}`" for c in t["client_files"])
        )
        out.append("")
        out.append(
            "| op | handler | retry | idempotent | telemetry key "
            "| request fields |"
        )
        out.append("|---|---|---|---|---|---|")
        idem = set(t["idempotent_ops"] or [])
        for op in sorted(t["ops"]):
            e = t["ops"][op]
            handler = e.get("handler") or "—"
            via = (
                " (via " + ", ".join(e["via_methods"]) + ")"
                if e.get("via_methods")
                else ""
            )
            fields = ", ".join(
                t["request_fields_by_op"].get(op, [])
            ) or "—"
            tkey = e.get("telemetry_key") or "—"
            out.append(
                f"| `{op}`{via} | `{handler}` | {e.get('retry')} | "
                f"{'yes' if op in idem else 'no'} | `{tkey}` | {fields} |"
            )
        if t["ops_without_handler"]:
            out.append("")
            out.append(
                "**Ops without a handler:** "
                + ", ".join(f"`{o}`" for o in t["ops_without_handler"])
            )
        if t["handlers_without_sender"]:
            out.append("")
            out.append(
                "**Handlers without a sender:** "
                + ", ".join(f"`{o}`" for o in t["handlers_without_sender"])
            )
        out.append("")
        out.append(
            "Request fields the server reads: "
            + (
                ", ".join(
                    f"`{k}`"
                    for k in t["request_fields_read_by_server"]
                )
                or "—"
            )
        )
        out.append("")
        out.append(
            "Response fields the clients read: "
            + (
                ", ".join(
                    f"`{k}`"
                    for k in t["response_fields_read_by_clients"]
                )
                or "—"
            )
        )
        out.append("")
        out.append(
            "Error kinds emitted by the server: "
            + (
                ", ".join(f"`{k}`" for k in t["error_kinds_emitted"])
                or "—"
            )
            + " · handled by the clients: "
            + (
                ", ".join(
                    f"`{k}`" for k in t["error_kinds_handled_by_clients"]
                )
                or "—"
            )
        )
    d = inventory["divergences"]
    out.append("")
    out.append("## Divergences (the unification work list)")
    out.append("")
    out.append(
        "Op kinds that exist in more than one transport with "
        "independent handlers and schemas: "
        + (
            ", ".join(
                f"`{k}`" for k in d["op_kinds_shared_across_transports"]
            )
            or "none"
        )
        + ". One data plane must reconcile these into a single "
        "dispatch table."
    )
    out.append("")
    out.append("Retry styles per transport:")
    out.append("")
    for name in sorted(d["retry_styles"]):
        out.append(
            f"- **{name}**: " + ", ".join(d["retry_styles"][name])
        )
    out.append("")
    out.append(
        "Conformance is enforced by snapcheck rules SNAP010-SNAP013 "
        "(`docs/ANALYSIS.md`); this inventory and those rules read the "
        "same module-level op registries (`HOT_TIER_OPS`, "
        "`READ_PLANE_OPS`), so drift between dispatch and documentation "
        "is a lint failure before it is a runtime `bad_request`."
    )
    out.append("")
    return "\n".join(out)
