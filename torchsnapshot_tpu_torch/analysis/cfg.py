"""Statement-level control-flow graphs for snapcheck's flow-sensitive rules.

One :class:`CFG` per function body. Nodes are *simple statements* (plus
the headers of compound statements and synthetic markers: ENTRY, EXIT,
RAISE_EXIT, except-dispatch, finally-entry, loop-exit); edges are either
**normal** (the statement completed) or **exception** (the statement
raised mid-flight). The distinction matters to the dataflow engine
(``dataflow.py``): along a normal edge the statement's effect has
happened, along an exception edge it may not have — so exception edges
propagate the *pre*-statement state.

Precision decisions, chosen for the rules this core serves (resource
lifecycle, reachability) rather than generality:

- ``try/finally`` bodies are routed *through* the shared ``finally``
  block, not duplicated per continuation. The finally exit then fans out
  to every continuation that entered it (fall-through, re-raise,
  return/break/continue targets). This conflates "which exit" across
  paths — a may-analysis over the result sees a superset of real paths,
  which keeps leak detection sound (a real leaked path is always
  present) at the cost of occasional conservatism. A return threading
  *nested* try/finally regions runs only the innermost finally before
  fanning out — same superset argument.
- Every statement that can plausibly raise gets an exception edge to the
  innermost handler (or the function's RAISE_EXIT). ``pass``, ``break``,
  ``continue`` and bare name/constant expression statements are treated
  as no-raise.
- ``while True:`` (any constant-true test) has no condition-false exit;
  only ``break`` reaches the code after the loop. Other loop headers
  may exit normally.
- ``with`` bodies get exception edges like any other region; the context
  manager's ``__exit__`` is assumed not to suppress exceptions (the
  codebase convention — ``contextlib.suppress`` would be a lint finding
  of its own).

The builder is deliberately intraprocedural: calls are opaque
(may-raise), matching the Infer/RacerD observation that most lifecycle
bugs are visible inside one function once exception edges are explicit.
"""

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple, Union

# Synthetic node markers.
ENTRY = "<entry>"
EXIT = "<exit>"
RAISE_EXIT = "<raise-exit>"

# Statements that cannot raise once reached (no expression evaluation
# that could call user code).
_NO_RAISE_STMTS = (ast.Pass, ast.Break, ast.Continue, ast.Global,
                   ast.Nonlocal)


@dataclass
class Node:
    """One CFG node: a simple statement, a compound-statement header,
    an except-handler entry, or a synthetic marker string."""

    index: int
    stmt: Union[ast.AST, str]
    succ: Set[int] = field(default_factory=set)      # normal edges
    exc_succ: Set[int] = field(default_factory=set)  # exception edges

    @property
    def is_marker(self) -> bool:
        return isinstance(self.stmt, str)


class CFG:
    def __init__(self) -> None:
        self.nodes: List[Node] = []
        self.entry = self._new(ENTRY)
        self.exit = self._new(EXIT)
        self.raise_exit = self._new(RAISE_EXIT)

    def _new(self, stmt: Union[ast.AST, str]) -> int:
        node = Node(index=len(self.nodes), stmt=stmt)
        self.nodes.append(node)
        return node.index

    def preds(self) -> Dict[int, Set[int]]:
        out: Dict[int, Set[int]] = {n.index: set() for n in self.nodes}
        for n in self.nodes:
            for s in n.succ | n.exc_succ:
                out[s].add(n.index)
        return out


class _FinallyFrame:
    """One active ``finally`` region during construction. Continuations
    that route through it (return / break / continue / fall-through /
    re-raise) register their eventual targets; the builder wires the
    finally's exit frontier to all of them once the body is built."""

    def __init__(self) -> None:
        self.entry: Optional[int] = None
        self.targets: Set[int] = set()

    def entry_node(self, cfg: CFG) -> int:
        if self.entry is None:
            self.entry = cfg._new("<finally>")
        return self.entry


def _is_constant_true(test: ast.expr) -> bool:
    return isinstance(test, ast.Constant) and bool(test.value)


class _Builder:
    def __init__(self, cfg: CFG):
        self.cfg = cfg
        # Innermost landing node for an in-flight exception.
        self.exc_targets: List[int] = [cfg.raise_exit]
        # (target node, finally-stack depth at loop entry)
        self.break_targets: List[Tuple[int, int]] = []
        self.continue_targets: List[Tuple[int, int]] = []
        self.finally_stack: List[_FinallyFrame] = []

    # ------------------------------------------------------------ helpers
    def _may_raise(self, stmt: ast.stmt) -> bool:
        if isinstance(stmt, _NO_RAISE_STMTS):
            return False
        if isinstance(stmt, ast.Expr) and isinstance(
            stmt.value, (ast.Constant, ast.Name)
        ):
            return False
        return True

    def _add_stmt_node(self, stmt: ast.stmt, frontier: Set[int]) -> Set[int]:
        idx = self.cfg._new(stmt)
        for f in frontier:
            self.cfg.nodes[f].succ.add(idx)
        if self._may_raise(stmt):
            self.cfg.nodes[idx].exc_succ.add(self.exc_targets[-1])
        return {idx}

    def _route_jump(
        self, frontier: Set[int], target: int, depth: int
    ) -> None:
        """Route a non-local continuation (return/break/continue) from
        ``frontier`` to ``target``. Finally regions entered since
        ``depth`` must run first: the jump enters the innermost such
        finally, whose exit later fans out to the registered target."""
        if len(self.finally_stack) > depth:
            frame = self.finally_stack[-1]
            frame.targets.add(target)
            entry = frame.entry_node(self.cfg)
            for f in frontier:
                self.cfg.nodes[f].succ.add(entry)
        else:
            for f in frontier:
                self.cfg.nodes[f].succ.add(target)

    # -------------------------------------------------------------- build
    def build_stmts(
        self, stmts: Sequence[ast.stmt], frontier: Set[int]
    ) -> Set[int]:
        for stmt in stmts:
            if not frontier:
                break  # unreachable code after return/raise/...
            frontier = self.build_stmt(stmt, frontier)
        return frontier

    def build_stmt(self, stmt: ast.stmt, frontier: Set[int]) -> Set[int]:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            # Nested definitions are opaque statements here; their own
            # bodies get their own CFGs via build_cfg.
            idx = self.cfg._new(stmt)
            for f in frontier:
                self.cfg.nodes[f].succ.add(idx)
            return {idx}
        if isinstance(stmt, ast.Return):
            frontier = self._add_stmt_node(stmt, frontier)
            self._route_jump(frontier, self.cfg.exit, 0)
            return set()
        if isinstance(stmt, ast.Raise):
            frontier = self._add_stmt_node(stmt, frontier)
            # A raise flows only along the exception edge, which
            # _add_stmt_node already wired to the innermost handler.
            for f in frontier:
                self.cfg.nodes[f].succ.clear()
                self.cfg.nodes[f].exc_succ.add(self.exc_targets[-1])
            return set()
        if isinstance(stmt, ast.Break):
            frontier = self._add_stmt_node(stmt, frontier)
            if self.break_targets:
                target, depth = self.break_targets[-1]
                self._route_jump(frontier, target, depth)
            return set()
        if isinstance(stmt, ast.Continue):
            frontier = self._add_stmt_node(stmt, frontier)
            if self.continue_targets:
                target, depth = self.continue_targets[-1]
                self._route_jump(frontier, target, depth)
            return set()
        if isinstance(stmt, ast.If):
            header = self._add_stmt_node(stmt, frontier)
            then_out = self.build_stmts(stmt.body, set(header))
            else_out = self.build_stmts(stmt.orelse, set(header))
            return then_out | else_out
        if isinstance(stmt, (ast.While, ast.For, ast.AsyncFor)):
            return self._build_loop(stmt, frontier)
        if isinstance(stmt, ast.Try) or (
            hasattr(ast, "TryStar") and isinstance(stmt, ast.TryStar)
        ):
            return self._build_try(stmt, frontier)
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            header = self._add_stmt_node(stmt, frontier)
            return self.build_stmts(stmt.body, set(header))
        if hasattr(ast, "Match") and isinstance(stmt, ast.Match):
            header = self._add_stmt_node(stmt, frontier)
            out: Set[int] = set()
            for case in stmt.cases:
                out |= self.build_stmts(case.body, set(header))
            # A subject matching no case falls through.
            return out | set(header)
        # Simple statement.
        return self._add_stmt_node(stmt, frontier)

    def _build_loop(self, stmt: ast.stmt, frontier: Set[int]) -> Set[int]:
        header = self._add_stmt_node(stmt, frontier)
        header_idx = next(iter(header))
        join = self.cfg._new("<loop-exit>")
        depth = len(self.finally_stack)
        self.break_targets.append((join, depth))
        self.continue_targets.append((header_idx, depth))
        body_out = self.build_stmts(stmt.body, set(header))
        for b in body_out:
            self.cfg.nodes[b].succ.add(header_idx)
        self.break_targets.pop()
        self.continue_targets.pop()
        # Normal loop exit: condition false / iterator exhausted. A
        # constant-true while has no such exit — only break reaches join.
        infinite = isinstance(stmt, ast.While) and _is_constant_true(
            stmt.test
        )
        if not infinite:
            after = (
                self.build_stmts(stmt.orelse, set(header))
                if stmt.orelse
                else set(header)
            )
            for a in after:
                self.cfg.nodes[a].succ.add(join)
        return {join}

    def _build_try(self, stmt: ast.Try, frontier: Set[int]) -> Set[int]:
        frame: Optional[_FinallyFrame] = None
        if stmt.finalbody:
            frame = _FinallyFrame()
            self.finally_stack.append(frame)

        # Handler dispatch node: where in-flight exceptions from the try
        # body land before a handler (or the finally, or propagation).
        dispatch = self.cfg._new("<except-dispatch>")
        self.exc_targets.append(dispatch)
        body_out = self.build_stmts(stmt.body, frontier)
        self.exc_targets.pop()

        # Exceptions raised in handler/else bodies must still run an
        # enclosing finally before propagating outward.
        if frame is not None:
            frame.targets.add(self.exc_targets[-1])
            self.exc_targets.append(frame.entry_node(self.cfg))

        else_out = self.build_stmts(stmt.orelse, body_out)

        handler_outs: Set[int] = set()
        handled_all = False
        for handler in stmt.handlers:
            h_entry = self.cfg._new(handler)
            self.cfg.nodes[dispatch].succ.add(h_entry)
            handler_outs |= self.build_stmts(handler.body, {h_entry})
            # `except Exception` counts as handling everything for path
            # purposes: what escapes it (KeyboardInterrupt, SystemExit,
            # faultline's SimulatedCrash) is tearing the process down
            # anyway. A handler that re-raises still produces the
            # exceptional path via its `raise` statement's edge.
            if handler.type is None or (
                isinstance(handler.type, ast.Name)
                and handler.type.id in ("BaseException", "Exception")
            ):
                handled_all = True

        if frame is not None:
            self.exc_targets.pop()

        # An exception matching no handler propagates outward (through
        # the finally when there is one).
        if not handled_all:
            if frame is not None:
                self.cfg.nodes[dispatch].succ.add(
                    frame.entry_node(self.cfg)
                )
            else:
                self.cfg.nodes[dispatch].succ.add(self.exc_targets[-1])

        fall_through = else_out | handler_outs

        if frame is None:
            return fall_through

        self.finally_stack.pop()
        entry = frame.entry_node(self.cfg)
        for f in fall_through:
            self.cfg.nodes[f].succ.add(entry)
        fin_out = self.build_stmts(stmt.finalbody, {entry})
        # Fan out: fall-through continues; routed continuations reach
        # their targets (return/break/continue/outer handler).
        for t in frame.targets:
            for f in fin_out:
                self.cfg.nodes[f].succ.add(t)
        return fin_out


def build_cfg(
    func: Union[ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda]
) -> CFG:
    """A statement-level CFG for one function body. Nested function
    bodies are opaque single nodes (build their own CFGs separately)."""
    cfg = CFG()
    builder = _Builder(cfg)
    body: Sequence[ast.stmt]
    if isinstance(func, ast.Lambda):
        expr = ast.Expr(value=func.body)
        ast.copy_location(expr, func.body)
        body = [expr]
    else:
        body = func.body
    out = builder.build_stmts(body, {cfg.entry})
    for f in out:
        cfg.nodes[f].succ.add(cfg.exit)
    return cfg


def iter_function_defs(tree: ast.AST):
    """Every function/async-function definition in the tree, including
    nested ones."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def stmt_scan_parts(stmt: Union[ast.AST, str]) -> List[ast.AST]:
    """The sub-ASTs a per-node scan should walk for one CFG node.

    Compound-statement headers carry the whole compound AST node (the
    builder wires their bodies through separate nodes), so scanning the
    node must cover only the *header* expressions — the test of an
    ``if``/``while``, the iterable and target of a ``for``, the context
    expressions of a ``with`` — or body statements would be scanned
    twice (once via the header node, once via their own nodes)."""
    if isinstance(stmt, str):
        return []
    if isinstance(stmt, (ast.If, ast.While)):
        return [stmt.test]
    if isinstance(stmt, (ast.For, ast.AsyncFor)):
        return [stmt.iter, stmt.target]
    if isinstance(stmt, (ast.With, ast.AsyncWith)):
        parts: List[ast.AST] = []
        for item in stmt.items:
            parts.append(item.context_expr)
            if item.optional_vars is not None:
                parts.append(item.optional_vars)
        return parts
    if hasattr(ast, "Match") and isinstance(stmt, ast.Match):
        return [stmt.subject]
    if isinstance(stmt, ast.Try) or (
        hasattr(ast, "TryStar") and isinstance(stmt, ast.TryStar)
    ):
        return []
    if isinstance(stmt, ast.ExceptHandler):
        return []
    if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
        return [stmt]
    return [stmt]
