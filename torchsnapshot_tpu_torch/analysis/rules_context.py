"""SNAP008 ``context-propagation``: contextvars don't cross thread hops alone.

The bug class snapxray fixed by hand in three places: a ``contextvars``
value (the ambient trace id, the consume-profile scope, the read-plane
restore accumulator) is stamped in the submitting thread, but a callable
handed to an executor / ``Thread(target=...)`` / done-callback runs with
a *fresh* context — the read inside the callback silently returns the
default, and a whole take's drain spans attribute to no trace, or one
restore's fallbacks get charged to another.

The rule: a function **submitted to another thread** (``submit``,
``run_in_executor``, ``Thread(target=...)``, ``add_done_callback``,
``asyncio.to_thread``, ``call_soon_threadsafe``) whose body **reads a
registered context API** without an enclosing **adoption** is flagged
at the read. Registered readers and adopters are declarative
(:data:`CONTEXT_READERS`, :data:`ADOPTERS`) so new subsystems register
their contextvars instead of growing the rule:

- readers — ``tracing.current_trace_id``/``current_trace_id``,
  ``tracing.span``/``tracing.instant`` (they attribute to the ambient
  trace), ``consume_profile.current``/``_cprof.current``, plus
  ``.get()`` on any module-level ``contextvars.ContextVar`` binding in
  the same file (catches ``_SCOPE.get()`` style accumulators).
- adopters — a ``with tracing.adopt_trace(...)`` /
  ``consume_section()`` block around the read, or running the callable
  under a captured ``contextvars.copy_context()``.

The safe pattern the codebase uses everywhere else — capture the value
*outside* the callback (``tid = current_trace_id()``) and close over
it — never fires: only reads *inside* the submitted callable count.

Intra-file, one level deep by design: a submitted callable's direct
body is checked, not its callees (cross-function propagation would need
the tracked value analysis SNAP006 owns). Callables the resolver cannot
see (``ctx.run`` bound methods, imported functions) are skipped,
conservative in the quiet direction.
"""

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .core import Diagnostic, Rule, dotted_name

# Dotted-name suffixes whose *call* reads a registered contextvar.
CONTEXT_READERS: Tuple[Tuple[str, str], ...] = (
    ("current_trace_id", "the ambient trace id"),
    ("tracing.current_trace_id", "the ambient trace id"),
    ("tracing.span", "the ambient trace id (span attribution)"),
    ("tracing.instant", "the ambient trace id (instant attribution)"),
    ("tracing.flow_start", "the ambient trace id (flow attribution)"),
    ("_cprof.current", "the consume-profile scope"),
    ("consume_profile.current", "the consume-profile scope"),
)

# Call names that, used as a `with` context around the read (or wrapping
# the submission), re-establish the context in the target thread.
ADOPTERS: Tuple[str, ...] = (
    "adopt_trace",
    "tracing.adopt_trace",
    "trace_scope",
    "tracing.trace_scope",
    "consume_section",
    "_cprof.consume_section",
    "consume_profile.consume_section",
)

# Submission shapes: method/function name -> index of the callable
# argument (None = keyword `target=`).
_SUBMITTERS: Dict[str, Optional[int]] = {
    "submit": 0,
    "run_in_executor": 1,
    "add_done_callback": 0,
    "to_thread": 0,
    "call_soon_threadsafe": 0,
    "Thread": None,
    "Timer": None,
}


def _matches_suffix(name: Optional[str], suffixes: Sequence[str]) -> bool:
    if name is None:
        return False
    return any(
        name == s or name.endswith("." + s) for s in suffixes
    )


def _contextvar_names(tree: ast.AST) -> Set[str]:
    """Module-level names bound to ``contextvars.ContextVar(...)`` (or a
    bare imported ``ContextVar``)."""
    out: Set[str] = set()
    for node in ast.iter_child_nodes(tree):
        targets: List[ast.expr] = []
        value: Optional[ast.expr] = None
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        if value is None or not isinstance(value, ast.Call):
            continue
        name = dotted_name(value.func)
        if name is None or not (
            name == "ContextVar" or name.endswith(".ContextVar")
        ):
            continue
        for t in targets:
            if isinstance(t, ast.Name):
                out.add(t.id)
    return out


class _CallableResolver:
    """Map a submitted callee expression to candidate FunctionDef/Lambda
    bodies, intra-file."""

    def __init__(self, tree: ast.AST):
        # name -> defs (module-level and nested); (class, name) -> defs
        self.by_name: Dict[str, List[ast.AST]] = {}
        self.by_method: Dict[Tuple[str, str], List[ast.AST]] = {}

        def walk(node: ast.AST, cls: Optional[str]) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    walk(child, child.name)
                elif isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    self.by_name.setdefault(child.name, []).append(child)
                    if cls is not None:
                        self.by_method.setdefault(
                            (cls, child.name), []
                        ).append(child)
                    walk(child, cls)
                else:
                    walk(child, cls)

        walk(tree, None)

    def resolve(
        self, callee: ast.expr, cls: Optional[str]
    ) -> List[ast.AST]:
        # functools.partial(f, ...) -> f
        if isinstance(callee, ast.Call):
            name = dotted_name(callee.func)
            if _matches_suffix(name, ("partial",)) and callee.args:
                return self.resolve(callee.args[0], cls)
            return []
        if isinstance(callee, ast.Lambda):
            return [callee]
        if isinstance(callee, ast.Name):
            return self.by_name.get(callee.id, [])
        if isinstance(callee, ast.Attribute) and isinstance(
            callee.value, ast.Name
        ) and callee.value.id in ("self", "cls") and cls is not None:
            return self.by_method.get((cls, callee.attr), [])
        return []


def _reads_in_body(
    body_root: ast.AST, cv_names: Set[str]
) -> List[Tuple[ast.AST, str]]:
    """(node, what) for every un-adopted registered context read inside
    one callable body. Reads lexically inside a `with <adopter>:` block
    or inside a *nested* def (its own submission is its own problem)
    are skipped."""
    found: List[Tuple[ast.AST, str]] = []

    def scan(node: ast.AST, adopted: bool) -> None:
        for child in ast.iter_child_nodes(node):
            # Defs nested inside the submitted callable run only when
            # *they* are invoked — if they too cross a thread hop,
            # their own submission site gets its own check.
            if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            ):
                continue
            child_adopted = adopted
            if isinstance(child, (ast.With, ast.AsyncWith)):
                for item in child.items:
                    expr = item.context_expr
                    if isinstance(expr, ast.Call) and _matches_suffix(
                        dotted_name(expr.func), ADOPTERS
                    ):
                        child_adopted = True
            if not adopted and isinstance(child, ast.Call):
                name = dotted_name(child.func)
                for suffix, what in CONTEXT_READERS:
                    if name is not None and (
                        name == suffix or name.endswith("." + suffix)
                    ):
                        found.append((child, what))
                        break
                else:
                    if (
                        isinstance(child.func, ast.Attribute)
                        and child.func.attr == "get"
                        and isinstance(child.func.value, ast.Name)
                        and child.func.value.id in cv_names
                    ):
                        found.append(
                            (
                                child,
                                f"contextvar "
                                f"'{child.func.value.id}'",
                            )
                        )
            scan(child, child_adopted)

    scan(body_root, False)
    return found


class ContextPropagationRule(Rule):
    name = "context-propagation"
    code = "SNAP008"
    description = (
        "A callable submitted to an executor/thread/done-callback that "
        "reads a registered contextvar (trace id, consume-profile "
        "scope, restore accumulators) must adopt it explicitly "
        "(adopt_trace / consume_section / copy_context) — a fresh "
        "thread context reads the default."
    )

    def check(
        self, tree: ast.AST, lines: Sequence[str], path: str
    ) -> List[Diagnostic]:
        cv_names = _contextvar_names(tree)
        resolver = _CallableResolver(tree)
        diags: List[Diagnostic] = []
        reported: Set[Tuple[int, int]] = set()

        def handle_submission(
            call: ast.Call, cls: Optional[str]
        ) -> None:
            func = call.func
            name = (
                func.attr
                if isinstance(func, ast.Attribute)
                else func.id
                if isinstance(func, ast.Name)
                else None
            )
            if name not in _SUBMITTERS:
                return
            arg_idx = _SUBMITTERS[name]
            callee: Optional[ast.expr] = None
            if arg_idx is None:
                for kw in call.keywords:
                    if kw.arg == "target":
                        callee = kw.value
                        break
            elif len(call.args) > arg_idx:
                callee = call.args[arg_idx]
            if callee is None:
                return
            # Submitting ctx.run / copy_context().run re-establishes
            # the whole context; nothing to check.
            if isinstance(callee, ast.Attribute) and callee.attr == "run":
                return
            for target in resolver.resolve(callee, cls):
                target_name = getattr(target, "name", "<lambda>")
                for node, what in _reads_in_body(target, cv_names):
                    key = (
                        getattr(node, "lineno", 0),
                        getattr(node, "col_offset", 0),
                    )
                    if key in reported:
                        continue
                    reported.add(key)
                    diags.append(
                        self.diag(
                            path,
                            node,
                            f"'{target_name}' is handed to "
                            f"'{name}' (line {call.lineno}) but reads "
                            f"{what} without adoption — the executor "
                            f"thread's fresh context returns the "
                            f"default; wrap the read in adopt_trace/"
                            f"consume_section or submit via "
                            f"contextvars.copy_context().run.",
                        )
                    )

        def walk(node: ast.AST, cls: Optional[str]) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    walk(child, child.name)
                    continue
                if isinstance(child, ast.Call):
                    handle_submission(child, cls)
                walk(child, cls)

        walk(tree, None)
        return diags
