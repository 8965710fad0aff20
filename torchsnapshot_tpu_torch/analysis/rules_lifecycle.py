"""SNAP006 ``resource-lifecycle``: acquire/release pairing on all paths.

The bug class the last several review rounds kept paying for by hand: a
resource obligation silently dropped on one control-flow path — a
staging-pool lease whose scheduler-budget re-credit must fire *exactly
once*, a hot-tier write-through begun but neither noted nor aborted when
the durable write throws, a tracing span entered and never exited. Each
is an acquire/release pair, and each bug is visible *inside one
function* once exception edges are explicit (the Infer biabduction
observation, scaled down to a checklist of this repo's own protocols).

The rule is a **may-analysis over obligation statuses** on the
statement-level CFG (``cfg.py`` + ``dataflow.py``): per acquire site,
track {held, released, escaped} along every path (exception edges
propagate pre-statement state), then report

- **leak** — a path reaches function exit (normal or exceptional) with
  the obligation still held;
- **double release** — a path reaches a release site with the
  obligation already released (bound-variable protocols only — counter
  protocols like the scheduler budget legitimately hold many credits);
- **overwrite** — a path rebinds the obligation variable while held.

Ownership transfer is respected: storing the handle into an attribute /
container, passing it (or its bound release method) to another call,
returning it, or closing over it in a nested function all mark the
obligation ESCAPED — another owner is now responsible, and the
intraprocedural analysis stops (conservative, never a false leak).

The **protocol table** is declarative (:data:`PROTOCOLS`): new
subsystems register their pairs instead of growing the rule. Three
protocol shapes:

- ``bound`` — ``v = recv.acquire(...)`` binds a handle; discharge is a
  release-method call on ``v``.
- ``paired`` — acquire and release are calls on the *same receiver*
  (``budget.charge`` / ``budget.release``); referencing the bound
  release method (``budget.release`` handed to a callback) is an escape.
- ``cm`` — the acquire is a context manager whose enter/exit IS the
  pair (``tracing.span``, ``consume_section``); calling it as a bare
  expression statement discards the manager unentered — the span
  silently never opens or closes.
"""

import ast
import re
from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from .cfg import CFG, build_cfg, iter_function_defs, stmt_scan_parts
from .core import Diagnostic, Rule, dotted_name
from .dataflow import ForwardAnalysis

# Obligation statuses (may-set members).
_VIRGIN = "V"    # path has not executed the acquire
_HELD = "H"
_RELEASED = "R"
_ESCAPED = "E"

State = FrozenSet[str]


@dataclass(frozen=True)
class ResourceProtocol:
    """One registered acquire/release pair. ``kind`` is ``bound`` /
    ``paired`` / ``cm`` (see module docstring)."""

    name: str
    kind: str
    acquire_methods: Tuple[str, ...] = ()
    receiver_pat: Optional[str] = None  # regex searched on receiver name
    acquire_funcs: Tuple[str, ...] = ()  # dotted-name suffixes for cm kind
    release_methods: Tuple[str, ...] = ()
    hint: str = ""

    def receiver_matches(self, receiver: Optional[str]) -> bool:
        if self.receiver_pat is None:
            return True
        if receiver is None:
            return False
        return re.search(self.receiver_pat, receiver.lower()) is not None


PROTOCOLS: Tuple[ResourceProtocol, ...] = (
    ResourceProtocol(
        name="staging-lease",
        kind="bound",
        acquire_methods=("acquire",),
        receiver_pat=r"pool",
        release_methods=("release",),
        hint=(
            "a StagingLease carries the scheduler budget re-credit and "
            "must return to the pool exactly once; release in "
            "try/finally or hand the lease to a longer-lived owner"
        ),
    ),
    ResourceProtocol(
        name="scheduler-budget",
        kind="paired",
        acquire_methods=("charge",),
        receiver_pat=r"budget|_cell",
        release_methods=("release",),
        hint=(
            "a charged budget hold must be re-credited (release) or "
            "handed off (e.g. consumer.set_cost_releaser(budget.release)) "
            "on every path, or the pipeline budget shrinks forever"
        ),
    ),
    ResourceProtocol(
        name="hottier-write-through",
        kind="paired",
        acquire_methods=("begin_write_through",),
        receiver_pat=None,
        release_methods=("note_write_through", "abort_write_through"),
        hint=(
            "begin_write_through quiesces the drain pipeline and keeps "
            "the obligation pending; every path must retire it via "
            "note_write_through (success) or re-arm via "
            "abort_write_through (failure), or .tierdown lies clean "
            "over hot-only bytes"
        ),
    ),
    ResourceProtocol(
        name="lock",
        kind="paired",
        acquire_methods=("acquire",),
        receiver_pat=r"lock$|_lock\b|mutex|(^|[._])cond\b",
        release_methods=("release",),
        hint=(
            "an explicitly acquired lock must be released on every "
            "path (prefer `with lock:`)"
        ),
    ),
    ResourceProtocol(
        name="tracing-span",
        kind="cm",
        acquire_funcs=(
            "tracing.span",
            "tracing.trace_scope",
            "tracing.adopt_trace",
            "trace_scope",
            "adopt_trace",
        ),
        hint=(
            "tracing.span/trace_scope/adopt_trace are context managers; "
            "called bare, the generator is never entered and the span "
            "never opens or closes — use `with`"
        ),
    ),
    ResourceProtocol(
        name="consume-section",
        kind="cm",
        acquire_funcs=(
            "consume_section",
            "_cprof.consume_section",
            "consume_profile.consume_section",
            "_cprof.substep",
            "consume_profile.substep",
        ),
        hint=(
            "consume_section/substep are context managers marking the "
            "consume-wall attribution scope; a bare call never "
            "enters/exits and the sub-step accounting silently drops — "
            "use `with`"
        ),
    ),
)


def _unwrap_await(node: ast.AST) -> ast.AST:
    return node.value if isinstance(node, ast.Await) else node


def _as_call(node: ast.AST) -> Optional[ast.Call]:
    node = _unwrap_await(node)
    return node if isinstance(node, ast.Call) else None


def _method_call(
    call: ast.Call,
) -> Optional[Tuple[Optional[str], str]]:
    """(receiver dotted name or None, method name) for ``recv.m(...)``."""
    if isinstance(call.func, ast.Attribute):
        return dotted_name(call.func.value), call.func.attr
    return None


@dataclass
class _Obligation:
    protocol: ResourceProtocol
    site: ast.AST            # node carrying line/col for reports
    acquire_node_idx: int    # CFG node index of the acquiring statement
    var: Optional[str]       # bound kind: tracked local name
    receiver: Optional[str]  # paired kind: receiver dotted name


@dataclass
class _StmtEffect:
    releases: bool = False
    escapes: bool = False
    rebinds: bool = False
    reacquires: bool = False


class _UseScanner(ast.NodeVisitor):
    """Classify how a statement uses a tracked bound variable ``var``."""

    def __init__(self, var: str, release_methods: Tuple[str, ...]):
        self.var = var
        self.release_methods = release_methods
        self.effect = _StmtEffect()

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._nested_def(node)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self._nested_def(node)

    def visit_Lambda(self, node: ast.Lambda) -> None:
        self._nested_def(node)

    def _nested_def(self, node: ast.AST) -> None:
        # Closing over the handle hands it to code running later (an
        # executor callback, a done-callback): escaped.
        for inner in ast.walk(node):
            if isinstance(inner, ast.Name) and inner.id == self.var:
                self.effect.escapes = True
                return

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        if (
            isinstance(func, ast.Attribute)
            and isinstance(func.value, ast.Name)
            and func.value.id == self.var
        ):
            if func.attr in self.release_methods:
                self.effect.releases = True
            # Receiver position is not an escape; still scan arguments.
            for arg in node.args:
                self.visit(arg)
            for kw in node.keywords:
                self.visit(kw.value)
            return
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if isinstance(node.value, ast.Name) and node.value.id == self.var:
            # Attribute read (lease.buffer) — neutral. A bound-method
            # reference to a release method that is NOT called is a
            # handoff (functools.partial(lease.release) etc.): treat any
            # non-call attribute access of a release method as escape.
            if node.attr in self.release_methods and isinstance(
                node.ctx, ast.Load
            ):
                self.effect.escapes = True
            return
        self.generic_visit(node)

    def visit_Name(self, node: ast.Name) -> None:
        if node.id != self.var:
            return
        if isinstance(node.ctx, ast.Store):
            self.effect.rebinds = True
        else:
            # A bare use of the handle itself — argument, return value,
            # container element, alias: ownership may transfer.
            self.effect.escapes = True


def _iter_part_nodes(stmt: ast.AST):
    """Walk only the scan-relevant parts of a CFG node's statement (the
    header expressions for compound statements — see stmt_scan_parts)."""
    for part in stmt_scan_parts(stmt):
        yield from ast.walk(part)


def _paired_effect(
    stmt: ast.AST, obligation: _Obligation
) -> _StmtEffect:
    """Effect of one statement on a paired-receiver obligation."""
    proto = obligation.protocol
    recv = obligation.receiver
    eff = _StmtEffect()
    for node in _iter_part_nodes(stmt):
        if isinstance(node, ast.Call):
            mc = _method_call(node)
            if mc is not None and mc[0] == recv:
                if mc[1] in proto.release_methods:
                    eff.releases = True
                continue
            # The receiver itself passed whole as an argument.
            for arg in list(node.args) + [k.value for k in node.keywords]:
                if dotted_name(arg) == recv:
                    eff.escapes = True
        elif isinstance(node, ast.Attribute):
            if (
                node.attr in proto.release_methods
                and dotted_name(node.value) == recv
            ):
                # `recv.release` referenced without a call: bound-method
                # handoff — scan the parent Call case above first, but a
                # non-call reference lands here via generic walk. The
                # Call branch `continue`s past its own func, so any
                # release-method Attribute seen in the walk that is not
                # a call func is conservative-escape; ones that ARE call
                # funcs were already counted as releases (harmless).
                eff.escapes = True
        elif isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
        ):
            root = recv.split(".", 1)[0] if recv else None
            for inner in ast.walk(node):
                if isinstance(inner, ast.Name) and inner.id == root:
                    eff.escapes = True
                    break
    return eff


class LifecycleRule(Rule):
    name = "resource-lifecycle"
    code = "SNAP006"
    description = (
        "Acquire/release obligations (staging-pool leases, scheduler "
        "budget holds, hot-tier write-throughs, locks, tracing spans) "
        "must be discharged exactly once on every control-flow path, "
        "including exception edges."
    )

    def __init__(
        self, protocols: Sequence[ResourceProtocol] = PROTOCOLS
    ) -> None:
        self.protocols = tuple(protocols)

    # ---------------------------------------------------------------- check
    def check(
        self, tree: ast.AST, lines: Sequence[str], path: str
    ) -> List[Diagnostic]:
        diags: List[Diagnostic] = []
        with_contexts = self._with_context_calls(tree)
        for func in iter_function_defs(tree):
            diags.extend(
                self._check_function(func, path, with_contexts)
            )
        diags.extend(self._check_cm_protocols(tree, path, with_contexts))
        return diags

    def _with_context_calls(self, tree: ast.AST) -> Set[int]:
        """ids of Call nodes appearing as a ``with`` context expression
        (possibly under ``await``) — those discharge via __exit__."""
        out: Set[int] = set()
        for node in ast.walk(tree):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    call = _as_call(item.context_expr)
                    if call is not None:
                        out.add(id(call))
        return out

    # ----------------------------------------------------- cm protocols
    def _check_cm_protocols(
        self, tree: ast.AST, path: str, with_contexts: Set[int]
    ) -> List[Diagnostic]:
        diags: List[Diagnostic] = []
        cm_protos = [p for p in self.protocols if p.kind == "cm"]
        if not cm_protos:
            return diags
        for node in ast.walk(tree):
            if not isinstance(node, ast.Expr):
                continue
            call = _as_call(node.value)
            if call is None or id(call) in with_contexts:
                continue
            name = dotted_name(call.func)
            if name is None:
                continue
            for proto in cm_protos:
                if any(
                    name == f or name.endswith("." + f)
                    for f in proto.acquire_funcs
                ):
                    diags.append(
                        self.diag(
                            path,
                            node,
                            f"[{proto.name}] '{name}(...)' is a context "
                            f"manager called as a bare statement — the "
                            f"enter/exit pair never runs; {proto.hint}.",
                        )
                    )
                    break
        return diags

    # ------------------------------------------------- flow protocols
    def _acquire_in_stmt(
        self, stmt: ast.AST, with_contexts: Set[int]
    ) -> List[Tuple[ResourceProtocol, Optional[str], Optional[str], ast.AST]]:
        """Acquire sites in one statement:
        (protocol, bound var or None, receiver or None, report node)."""
        found: List[
            Tuple[ResourceProtocol, Optional[str], Optional[str], ast.AST]
        ] = []
        # Clean bound form: `v = [await] recv.acquire(...)`.
        bound_call: Optional[ast.Call] = None
        bound_var: Optional[str] = None
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and (
            isinstance(stmt.targets[0], ast.Name)
        ):
            bound_call = _as_call(stmt.value)
            bound_var = stmt.targets[0].id
        for node in _iter_part_nodes(stmt):
            if not isinstance(node, ast.Call) or id(node) in with_contexts:
                continue
            mc = _method_call(node)
            if mc is None:
                continue
            recv, method = mc
            for proto in self.protocols:
                if proto.kind == "cm":
                    continue
                if method not in proto.acquire_methods:
                    continue
                if not proto.receiver_matches(recv):
                    continue
                if proto.kind == "bound":
                    if node is bound_call and bound_var is not None:
                        found.append((proto, bound_var, recv, node))
                    # Acquire whose handle is stored elsewhere
                    # (attribute target, container, argument): another
                    # owner tracks it — conservative skip, except the
                    # outright discard.
                    elif (
                        isinstance(stmt, ast.Expr)
                        and _unwrap_await(stmt.value) is node
                    ):
                        found.append((proto, None, recv, node))
                else:  # paired
                    found.append((proto, None, recv, node))
                break
        return found

    def _check_function(
        self,
        func: ast.AST,
        path: str,
        with_contexts: Set[int],
    ) -> List[Diagnostic]:
        diags: List[Diagnostic] = []
        cfg = build_cfg(func)
        # Map CFG node -> acquire sites it contains.
        obligations: List[_Obligation] = []
        for n in cfg.nodes:
            if n.is_marker or not isinstance(n.stmt, ast.stmt):
                continue
            if isinstance(
                n.stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                continue
            for proto, var, recv, site in self._acquire_in_stmt(
                n.stmt, with_contexts
            ):
                if proto.kind == "bound" and var is None:
                    diags.append(
                        self.diag(
                            path,
                            site,
                            f"[{proto.name}] acquire result discarded — "
                            f"the obligation can never be discharged; "
                            f"{proto.hint}.",
                        )
                    )
                    continue
                obligations.append(
                    _Obligation(
                        protocol=proto,
                        site=site,
                        acquire_node_idx=n.index,
                        var=var,
                        receiver=recv,
                    )
                )
        for ob in obligations:
            diags.extend(self._analyze_obligation(cfg, ob, path))
        return diags

    def _analyze_obligation(
        self, cfg: CFG, ob: _Obligation, path: str
    ) -> List[Diagnostic]:
        proto = ob.protocol
        effects: Dict[int, _StmtEffect] = {}

        def effect_of(idx: int) -> _StmtEffect:
            eff = effects.get(idx)
            if eff is None:
                node = cfg.nodes[idx]
                if node.is_marker or not isinstance(node.stmt, ast.AST):
                    eff = _StmtEffect()
                elif isinstance(
                    node.stmt,
                    (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda),
                ):
                    eff = _StmtEffect()
                    scan = (
                        _UseScanner(ob.var, proto.release_methods)
                        if ob.var is not None
                        else None
                    )
                    if scan is not None:
                        scan._nested_def(node.stmt)
                        eff = scan.effect
                    elif ob.receiver is not None:
                        eff = _paired_effect(node.stmt, ob)
                elif ob.var is not None:
                    scan = _UseScanner(ob.var, proto.release_methods)
                    for part in stmt_scan_parts(node.stmt):
                        scan.visit(part)
                    eff = scan.effect
                else:
                    eff = _paired_effect(node.stmt, ob)
                effects[idx] = eff
            return eff

        acquire_idx = ob.acquire_node_idx

        def transfer(node, state: State) -> State:
            idx = node.index
            if idx == acquire_idx:
                # This site's acquire fires (re-entry through a loop
                # replaces the previous obligation).
                return frozenset({_HELD})
            eff = effect_of(idx)
            out: Set[str] = set()
            for s in state:
                if s == _HELD:
                    if eff.releases:
                        s = _RELEASED
                    if eff.escapes:
                        s = _ESCAPED
                    elif s == _HELD and eff.rebinds:
                        s = _ESCAPED  # rebind handled by report pass
                elif s == _RELEASED and eff.escapes:
                    s = _ESCAPED
                out.add(s)
            return frozenset(out)

        def exc_transfer(node, state: State) -> State:
            # The acquire itself raising creates no obligation (pre
            # state flows); a release/escape is assumed to stick even
            # when its statement raises — otherwise every try/finally
            # release would "leak on the release's own exception edge".
            if node.index == acquire_idx:
                return state
            return transfer(node, state)

        analysis = ForwardAnalysis(
            transfer=transfer,
            join=lambda a, b: a | b,
            bottom=frozenset(),
            entry_state=frozenset({_VIRGIN}),
            exc_transfer=exc_transfer,
        )
        ins = analysis.run(cfg)

        diags: List[Diagnostic] = []
        what = (
            f"'{ob.var}'"
            if ob.var is not None
            else f"'{ob.receiver}.{proto.acquire_methods[0]}(...)' hold"
        )
        exc_leak = _HELD in ins[cfg.raise_exit]
        norm_leak = _HELD in ins[cfg.exit]
        if exc_leak or norm_leak:
            where = (
                "an exception path"
                if exc_leak and not norm_leak
                else "a normal path"
                if norm_leak and not exc_leak
                else "both normal and exception paths"
            )
            diags.append(
                self.diag(
                    path,
                    ob.site,
                    f"[{proto.name}] {what} can leak on {where} — no "
                    f"release reaches function exit; {proto.hint}.",
                )
            )
        if proto.kind == "bound":
            for n in cfg.nodes:
                if n.is_marker or not isinstance(n.stmt, ast.AST):
                    continue
                if n.index == acquire_idx:
                    # Re-acquire through a loop is this site replacing
                    # itself: only flag when a HELD state could reach it
                    # other than the virgin entry — i.e. a leak-by-
                    # overwrite.
                    if _HELD in ins[n.index]:
                        diags.append(
                            self.diag(
                                path,
                                ob.site,
                                f"[{proto.name}] {what} can be "
                                f"re-acquired while a previous "
                                f"obligation is still held (a path "
                                f"skips the release); {proto.hint}.",
                            )
                        )
                    continue
                eff = effect_of(n.index)
                if eff.releases and _RELEASED in ins[n.index]:
                    diags.append(
                        self.diag(
                            path,
                            n.stmt,
                            f"[{proto.name}] {what} can be released "
                            f"twice — a path reaches this release "
                            f"already released; {proto.hint}.",
                        )
                    )
                if (
                    eff.rebinds
                    and not eff.releases
                    and not eff.escapes
                    and _HELD in ins[n.index]
                ):
                    diags.append(
                        self.diag(
                            path,
                            n.stmt,
                            f"[{proto.name}] {what} is rebound while "
                            f"the obligation is still held — the "
                            f"handle (and its exactly-once release) "
                            f"is dropped; {proto.hint}.",
                        )
                    )
        return diags
