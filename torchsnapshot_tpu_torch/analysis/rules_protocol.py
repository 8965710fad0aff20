"""SNAP010-SNAP013: wire-protocol conformance (snapproto).

Four rules over the protocol models extracted by :mod:`.protocol`,
covering the failure modes a length-prefixed JSON protocol actually has
in this tree:

- **SNAP010 rpc-conformance** — the two halves of a transport drift: a
  client sends an op kind no handler answers (runtime ``bad_request``),
  a handler answers an op nothing sends (dead code the unification
  would faithfully port), or one side reads a frame field the other
  never writes (silent ``None``s).
- **SNAP011 unbounded-wire-wait** — the wire analog of SNAP007: an
  *initiator's* dial/send/recv awaited without an ``asyncio.wait_for``
  deadline hangs forever on a wedged peer. Flow-sensitive over the
  module call graph: a raw-wait helper only reachable through
  ``wait_for(...)`` wrappers is bounded by construction and clean.
- **SNAP012 retry-idempotency** — an op re-sent after an *ambiguous*
  transport failure (the request may have executed) must be declared
  in the module's ``IDEMPOTENT_OPS`` registry; and the retry loop
  itself must jitter (no synchronized retry storms) and carry an
  elapsed budget or attempt bound (no infinite retry against a dead
  peer).
- **SNAP013 ack-ordering** — must-analysis over the CFG of any handler
  that both stores replica bytes and sends a positive ack: on every
  path, fingerprint verification precedes the store and the store
  precedes the ack. The hot tier's ack-at-k durability story is
  exactly this ordering; an ack before the store counts phantom
  replicas toward k.

All four rules skip non-protocol modules (no framing import/use) and
the framing layer itself (``wire.py`` — its raw reads/writes ARE the
protocol). Conformance pairs files by convention: ``client.py`` ↔
``server.py`` (shared ``protocol.py``) and ``transport.py`` ↔
``peer.py`` in the same directory.
"""

import ast
import os
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from .cfg import build_cfg, iter_function_defs, stmt_scan_parts
from .core import Diagnostic, Rule
from .dataflow import ForwardAnalysis
from .protocol import (
    HEADERISH_PARAMS,
    FuncFacts,
    ModuleFacts,
    call_last_name,
    dict_literal_get,
    extract_module,
    merged_op_table,
    parse_facts,
    walk_shallow,
)

# client-side file -> (server-side sibling, shared protocol siblings)
CLIENT_PEERS = {
    "client.py": ("server.py", ("protocol.py",)),
    "transport.py": ("peer.py", ()),
}
# server-side file -> (client-side sibling, shared protocol siblings)
SERVER_PEERS = {
    "server.py": ("client.py", ("protocol.py",)),
    "peer.py": ("transport.py", ()),
}


def _d(rule: Rule, path: str, line: int, col: int, msg: str) -> Diagnostic:
    return Diagnostic(
        rule=rule.name,
        code=rule.code,
        path=path,
        line=line,
        col=col,
        message=msg,
    )


# ------------------------------------------------------------------ SNAP010


class RpcConformanceRule(Rule):
    name = "rpc-conformance"
    code = "SNAP010"
    description = (
        "wire op kinds, handlers, and frame fields stay conformant "
        "across each transport's client/server pair (no unanswered "
        "ops, dead handlers, or field skew)"
    )

    def __init__(self) -> None:
        self._cache: Dict[str, Optional[ModuleFacts]] = {}

    def applies_to(self, path: str) -> bool:
        base = os.path.basename(path)
        return base in CLIENT_PEERS or base in SERVER_PEERS

    def _sibling(self, path: str, name: str) -> Optional[ModuleFacts]:
        sib = os.path.join(
            os.path.dirname(os.path.abspath(path)), name
        )
        if sib not in self._cache:
            self._cache[sib] = (
                parse_facts(sib) if os.path.exists(sib) else None
            )
        return self._cache[sib]

    def check(
        self, tree: ast.AST, lines: Sequence[str], path: str
    ) -> List[Diagnostic]:
        facts = extract_module(tree, path)
        if not facts.is_protocol or facts.is_framing:
            return []
        base = os.path.basename(path)
        if base in CLIENT_PEERS:
            peer_name, shared_names = CLIENT_PEERS[base]
            server_side = False
        else:
            peer_name, shared_names = SERVER_PEERS[base]
            server_side = True
        peer = self._sibling(path, peer_name)
        shared = [
            s
            for n in shared_names
            if (s := self._sibling(path, n)) is not None
        ]
        if peer is None:
            # No peer on disk (a lone module using wire for something
            # else): nothing to be conformant WITH.
            return []
        if server_side:
            return self._check_server(facts, peer, shared, peer_name)
        return self._check_client(facts, peer, shared, peer_name)

    # ---- client side: everything sent must be answered; everything
    # read out of a response must be written by the server.
    def _check_client(
        self,
        facts: ModuleFacts,
        server: ModuleFacts,
        shared: List[ModuleFacts],
        server_name: str,
    ) -> List[Diagnostic]:
        diags: List[Diagnostic] = []
        table = merged_op_table([facts, server] + shared)
        handled = set(server.ops_handled)
        for op, meta in table.items():
            h = meta.get("handler")
            if h is None or h in server.function_names:
                handled.add(op)
        for op in sorted(facts.ops_sent):
            if op not in handled:
                diags.append(
                    _d(
                        self,
                        facts.path,
                        facts.ops_sent[op][0],
                        0,
                        f"client sends op '{op}' but {server_name} has "
                        f"no handler for it (no registry row or "
                        f"dispatch arm answers it) — the peer can only "
                        f"answer bad_request",
                    )
                )
        writes = set(server.fields_written)
        for s in shared:
            writes |= s.fields_written
        for field, line in sorted(set(facts.response_reads)):
            if field not in writes:
                diags.append(
                    _d(
                        self,
                        facts.path,
                        line,
                        0,
                        f"response field '{field}' is read but no "
                        f"{server_name} response ever writes it — this "
                        f"read is always None",
                    )
                )
        return diags

    # ---- server side: everything handled must be sent by someone;
    # every request field read must be written by a client; registry
    # handlers must exist. The server's own one-shot client helpers
    # (stats fetchers) are checked like a client too.
    def _check_server(
        self,
        facts: ModuleFacts,
        client: ModuleFacts,
        shared: List[ModuleFacts],
        client_name: str,
    ) -> List[Diagnostic]:
        diags: List[Diagnostic] = []
        table = merged_op_table([facts, client] + shared)
        table_local_lines: Dict[str, int] = {}
        for tname, tops in facts.op_tables.items():
            for op in tops:
                table_local_lines.setdefault(
                    op, facts.op_table_lines[tname]
                )
        handled = set(facts.ops_handled)
        for op, meta in table.items():
            h = meta.get("handler")
            if h is not None and h not in facts.function_names:
                diags.append(
                    _d(
                        self,
                        facts.path,
                        table_local_lines.get(op, 1),
                        0,
                        f"op registry declares handler '{h}' for op "
                        f"'{op}' but this module does not define it",
                    )
                )
            else:
                handled.add(op)
        sent = set(facts.ops_sent) | set(client.ops_sent)
        for op in sorted(facts.ops_handled):
            if op not in sent:
                diags.append(
                    _d(
                        self,
                        facts.path,
                        facts.ops_handled[op],
                        0,
                        f"dead handler: op '{op}' is answered but no "
                        f"{client_name} code sends it",
                    )
                )
            if table and op not in table:
                diags.append(
                    _d(
                        self,
                        facts.path,
                        facts.ops_handled[op],
                        0,
                        f"op '{op}' is dispatched by comparison but "
                        f"missing from the op registry — registry and "
                        f"dispatch have drifted",
                    )
                )
        for op in sorted(table):
            if op not in sent and op not in facts.ops_handled:
                diags.append(
                    _d(
                        self,
                        facts.path,
                        table_local_lines.get(op, 1),
                        0,
                        f"dead registry op: '{op}' has a handler row "
                        f"but no {client_name} code sends it",
                    )
                )
        writes = set(facts.fields_written) | set(client.fields_written)
        for s in shared:
            writes |= s.fields_written
        for field, line in sorted(set(facts.request_reads)):
            if field not in writes:
                diags.append(
                    _d(
                        self,
                        facts.path,
                        line,
                        0,
                        f"request field '{field}' is read from the "
                        f"frame but no client request ever writes it — "
                        f"this read is always None",
                    )
                )
        # The server's own sends (one-shot helpers) and response reads.
        for op in sorted(facts.ops_sent):
            if op not in handled:
                diags.append(
                    _d(
                        self,
                        facts.path,
                        facts.ops_sent[op][0],
                        0,
                        f"op '{op}' is sent but no handler in this "
                        f"module answers it",
                    )
                )
        for field, line in sorted(set(facts.response_reads)):
            if field not in writes:
                diags.append(
                    _d(
                        self,
                        facts.path,
                        line,
                        0,
                        f"response field '{field}' is read but never "
                        f"written by any response in this module",
                    )
                )
        return diags


# ------------------------------------------------------------------ SNAP011


class UnboundedWireWaitRule(Rule):
    name = "unbounded-wire-wait"
    code = "SNAP011"
    description = (
        "initiator-side wire waits (dial/send/recv) carry an "
        "asyncio.wait_for deadline on every reachable path — a wedged "
        "peer must never hang a caller forever"
    )

    def check(
        self, tree: ast.AST, lines: Sequence[str], path: str
    ) -> List[Diagnostic]:
        facts = extract_module(tree, path)
        if not facts.is_protocol or facts.is_framing:
            return []
        by_name: Dict[str, List[FuncFacts]] = {}
        for ff in facts.functions:
            by_name.setdefault(ff.name, []).append(ff)
        # in-degree + unbounded-call edges over the module call graph
        incoming: Dict[str, int] = {n: 0 for n in by_name}
        unbounded_edges: Dict[str, Set[str]] = {n: set() for n in by_name}
        for ff in facts.functions:
            for callee, sites in ff.calls.items():
                if callee not in by_name:
                    continue
                incoming[callee] += len(sites)
                if any(not bounded for _, bounded in sites):
                    unbounded_edges[ff.name].add(callee)
        # A function is "deadline-free reachable" when some entry point
        # reaches it without passing through a wait_for wrapper: roots
        # (never called in-module — public API, callbacks) plus the
        # closure over unbounded call edges. A helper whose every
        # in-module call sits inside wait_for(...) is bounded by its
        # callers and its raw waits are fine.
        reachable = {n for n, deg in incoming.items() if deg == 0}
        work = list(reachable)
        while work:
            fn = work.pop()
            for callee in unbounded_edges.get(fn, ()):
                if callee not in reachable:
                    reachable.add(callee)
                    work.append(callee)
        diags: List[Diagnostic] = []
        for ff in facts.functions:
            if ff.name not in reachable:
                continue
            first_send = min(
                (
                    (s.line, s.col)
                    for s in ff.wire_sites
                    if s.kind == "send"
                ),
                default=None,
            )
            for site in ff.wire_sites:
                if site.bounded:
                    continue
                if ff.responder:
                    # A responder legitimately blocks waiting for the
                    # NEXT request (recv before any reply is sent), and
                    # its replies ride the connection the client is
                    # actively reading.
                    if site.kind == "send":
                        continue
                    if site.kind == "recv" and (
                        first_send is None
                        or (site.line, site.col) < first_send
                    ):
                        continue
                role = "responder" if ff.responder else "initiator"
                diags.append(
                    _d(
                        self,
                        facts.path,
                        site.line,
                        site.col,
                        f"unbounded wire wait: '{site.name}' is awaited "
                        f"in {role} '{ff.name}' without an "
                        f"asyncio.wait_for deadline — a wedged peer "
                        f"hangs this path forever",
                    )
                )
        return diags


# ------------------------------------------------------------------ SNAP012

_JITTER_CALLS = frozenset(
    {"uniform", "random", "expovariate", "betavariate", "choice"}
)
_BUDGET_WORDS = ("budget", "deadline", "attempt", "tries", "retries")
_SLEEP_NAMES = frozenset({"sleep"})


def _identifiers(node: ast.AST) -> Set[str]:
    out: Set[str] = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name):
            out.add(sub.id)
        elif isinstance(sub, ast.Attribute):
            out.add(sub.attr)
    return out


def _is_retry_loop(loop: ast.AST) -> Tuple[bool, Optional[int]]:
    """(is retry loop, first sleep line). A retry loop re-attempts a
    failed body: a ``try`` whose handler sleeps, or a try-return with a
    sleep anywhere in the loop. Periodic tick loops (sleep outside any
    handler, no try-return) are not retries."""
    sleep_lines = [
        n.lineno
        for n in ast.walk(loop)
        if isinstance(n, ast.Call) and call_last_name(n) in _SLEEP_NAMES
    ]
    if not sleep_lines:
        return False, None
    for t in ast.walk(loop):
        if not isinstance(t, ast.Try):
            continue
        for handler in t.handlers:
            for h_stmt in handler.body:
                for sub in ast.walk(h_stmt):
                    if (
                        isinstance(sub, ast.Call)
                        and call_last_name(sub) in _SLEEP_NAMES
                    ):
                        return True, sub.lineno
        if any(
            isinstance(sub, ast.Return)
            for stmt in t.body
            for sub in ast.walk(stmt)
        ):
            return True, min(sleep_lines)
    return False, None


class RetryIdempotencyRule(Rule):
    name = "retry-idempotency"
    code = "SNAP012"
    description = (
        "ops re-sent after ambiguous transport failures are declared "
        "in IDEMPOTENT_OPS, and retry loops carry jitter and an "
        "elapsed budget/attempt bound"
    )

    def check(
        self, tree: ast.AST, lines: Sequence[str], path: str
    ) -> List[Diagnostic]:
        facts = extract_module(tree, path)
        if not facts.is_protocol or facts.is_framing:
            return []
        diags: List[Diagnostic] = []
        for func in iter_function_defs(tree):
            for node in walk_shallow(func):
                if not isinstance(node, (ast.While, ast.For)):
                    continue
                retry, sleep_line = _is_retry_loop(node)
                if not retry:
                    continue
                diags.extend(
                    self._check_loop(facts, func, node, sleep_line)
                )
        return diags

    def _check_loop(
        self,
        facts: ModuleFacts,
        func: ast.AST,
        loop: ast.AST,
        sleep_line: Optional[int],
    ) -> List[Diagnostic]:
        diags: List[Diagnostic] = []
        subtree = list(ast.walk(loop))
        has_jitter = any(
            isinstance(n, ast.Call)
            and call_last_name(n) in _JITTER_CALLS
            for n in subtree
        ) or any(
            "jitter" in ident.lower()
            for n in subtree
            for ident in _identifiers(n)
        )
        if not has_jitter:
            diags.append(
                _d(
                    self,
                    facts.path,
                    sleep_line or loop.lineno,
                    0,
                    "retry loop backs off without jitter — "
                    "fleet-synchronized retries stampede a recovering "
                    "peer; use decorrelated jitter "
                    "(rng.uniform(floor, prev*3))",
                )
            )
        bounded = isinstance(loop, ast.For) and (
            isinstance(loop.iter, ast.Call)
            and call_last_name(loop.iter) == "range"
        )
        if not bounded:
            bounded = any(
                isinstance(n, ast.Compare)
                and any(
                    any(w in ident.lower() for w in _BUDGET_WORDS)
                    for ident in _identifiers(n)
                )
                for n in subtree
            )
        if not bounded:
            diags.append(
                _d(
                    self,
                    facts.path,
                    loop.lineno,
                    0,
                    "retry loop has no elapsed budget or attempt bound "
                    "— an unreachable peer is retried forever instead "
                    "of surfacing host loss",
                )
            )
        diags.extend(self._check_idempotency(facts, func, loop))
        return diags

    def _check_idempotency(
        self, facts: ModuleFacts, func: ast.AST, loop: ast.AST
    ) -> List[Diagnostic]:
        # (op, line) pairs retried by this loop: frames built inline in
        # the loop, plus — when the loop lives in a wrapper taking the
        # frame as a parameter (``_call(header, ...)``) — every
        # in-module call site's op, resolved through local dict
        # assignments. ``best_effort=True`` call sites opt out of the
        # retry loop at runtime and are skipped.
        retried: List[Tuple[str, int]] = []
        for n in ast.walk(loop):
            if isinstance(n, ast.Dict):
                op = dict_literal_get(n, "op")
                if isinstance(op, ast.Constant) and isinstance(
                    op.value, str
                ):
                    retried.append((op.value, n.lineno))
        param_names = {
            a.arg
            for a in list(func.args.args) + list(func.args.kwonlyargs)
        }
        if param_names & HEADERISH_PARAMS:
            retried.extend(self._wrapper_call_sites(facts, func.name))
        diags: List[Diagnostic] = []
        for op, line in sorted(set(retried)):
            if facts.idempotent_ops is None:
                diags.append(
                    _d(
                        self,
                        facts.path,
                        line,
                        0,
                        f"op '{op}' is retried after ambiguous "
                        f"transport failures but this module declares "
                        f"no IDEMPOTENT_OPS registry",
                    )
                )
            elif op not in facts.idempotent_ops:
                diags.append(
                    _d(
                        self,
                        facts.path,
                        line,
                        0,
                        f"op '{op}' is retried after ambiguous "
                        f"transport failures but is not declared in "
                        f"IDEMPOTENT_OPS — a duplicate execution on "
                        f"the peer is unaccounted for",
                    )
                )
        return diags

    def _wrapper_call_sites(
        self, facts: ModuleFacts, wrapper: str
    ) -> List[Tuple[str, int]]:
        out: List[Tuple[str, int]] = []
        for ff in facts.functions:
            if ff.name == wrapper:
                continue
            caller = ff.node
            # local ``name = {...}`` frame literals, for call sites
            # passing the frame by name
            local_dicts: Dict[str, ast.Dict] = {}
            for n in walk_shallow(caller):
                if isinstance(n, (ast.Assign, ast.AnnAssign)):
                    value = n.value
                    targets = (
                        n.targets
                        if isinstance(n, ast.Assign)
                        else [n.target]
                    )
                    if isinstance(value, ast.Dict):
                        for t in targets:
                            if isinstance(t, ast.Name):
                                local_dicts[t.id] = value
            for n in walk_shallow(caller):
                if (
                    not isinstance(n, ast.Call)
                    or call_last_name(n) != wrapper
                ):
                    continue
                if any(
                    kw.arg == "best_effort"
                    and isinstance(kw.value, ast.Constant)
                    and bool(kw.value.value)
                    for kw in n.keywords
                ):
                    continue
                frame: Optional[ast.Dict] = None
                for arg in n.args:
                    if isinstance(arg, ast.Dict):
                        frame = arg
                        break
                    if (
                        isinstance(arg, ast.Name)
                        and arg.id in local_dicts
                    ):
                        frame = local_dicts[arg.id]
                        break
                if frame is None:
                    continue
                op = dict_literal_get(frame, "op")
                if isinstance(op, ast.Constant) and isinstance(
                    op.value, str
                ):
                    out.append((op.value, n.lineno))
        return out


# ------------------------------------------------------------------ SNAP013

_STORE_CALLS = frozenset(
    {"put_replica", "store", "store_replica", "write_replica"}
)


def _scan_events(parts: List[ast.AST]) -> Tuple[bool, bool, bool]:
    """(verify, store, ack) events in one CFG node's scan parts."""
    verify = store = ack = False
    for part in parts:
        for n in ast.walk(part):
            if isinstance(n, ast.Call):
                last = call_last_name(n)
                low = last.lower()
                if "fingerprint" in low or "verify" in low:
                    verify = True
                if last in _STORE_CALLS:
                    store = True
                if last == "send_frame" and any(
                    _is_ok_true_dict(a) for a in n.args
                ):
                    ack = True
            elif isinstance(n, ast.Return) and n.value is not None:
                value = n.value
                if isinstance(value, ast.Tuple) and value.elts:
                    value = value.elts[0]
                if _is_ok_true_dict(value):
                    ack = True
    return verify, store, ack


def _is_ok_true_dict(node: ast.AST) -> bool:
    if not isinstance(node, ast.Dict):
        return False
    ok = dict_literal_get(node, "ok")
    return isinstance(ok, ast.Constant) and ok.value is True


class AckOrderingRule(Rule):
    name = "ack-ordering"
    code = "SNAP013"
    description = (
        "push handlers verify the fingerprint before storing and store "
        "before sending a positive ack — ack-at-k must never count a "
        "corrupt or unstored replica"
    )

    def check(
        self, tree: ast.AST, lines: Sequence[str], path: str
    ) -> List[Diagnostic]:
        facts = extract_module(tree, path)
        if not facts.is_protocol or facts.is_framing:
            return []
        diags: List[Diagnostic] = []
        for func in iter_function_defs(tree):
            any_verify = any_store = any_ack = False
            for n in walk_shallow(func):
                v, s, a = _scan_events([n])
                # walk_shallow yields every node, so scanning each node
                # as its own "part" double-counts nothing we key on —
                # the three flags are idempotent.
                any_verify |= v
                any_store |= s
                any_ack |= a
            if not (any_store and any_ack):
                continue
            diags.extend(self._check_func(facts, func, any_verify))
        return diags

    def _check_func(
        self, facts: ModuleFacts, func: ast.AST, has_verify: bool
    ) -> List[Diagnostic]:
        cfg = build_cfg(func)

        def transfer(node: Any, state: Any) -> Any:
            if state is None:
                return None
            verify, store, _ = _scan_events(stmt_scan_parts(node.stmt))
            if not (verify or store):
                return state
            s = set(state)
            if verify:
                s.add("verified")
            if store:
                s.add("stored")
            return frozenset(s)

        def join(a: Any, b: Any) -> Any:
            if a is None:
                return b
            if b is None:
                return a
            return a & b  # must-analysis: true on EVERY path

        ins = ForwardAnalysis(
            transfer, join, None, frozenset()
        ).run(cfg)
        diags: List[Diagnostic] = []
        flagged_no_verify = False
        for node in cfg.nodes:
            if node.is_marker:
                continue
            state = ins[node.index]
            if state is None:  # unreachable
                continue
            _, store, ack = _scan_events(stmt_scan_parts(node.stmt))
            line = getattr(node.stmt, "lineno", func.lineno)
            if store:
                if has_verify and "verified" not in state:
                    diags.append(
                        _d(
                            self,
                            facts.path,
                            line,
                            0,
                            f"'{func.name}' stores replica bytes "
                            f"before fingerprint verification on some "
                            f"path — a corrupt push can be stored and "
                            f"acked",
                        )
                    )
                elif not has_verify and not flagged_no_verify:
                    flagged_no_verify = True
                    diags.append(
                        _d(
                            self,
                            facts.path,
                            line,
                            0,
                            f"'{func.name}' stores pushed bytes and "
                            f"acks without any fingerprint "
                            f"verification — corrupt pushes are "
                            f"indistinguishable from good ones",
                        )
                    )
            if ack and "stored" not in state:
                diags.append(
                    _d(
                        self,
                        facts.path,
                        line,
                        0,
                        f"'{func.name}' sends a positive ack "
                        f"(ok=true) before the store completes — "
                        f"ack-at-k would count a phantom replica",
                    )
                )
        return diags
