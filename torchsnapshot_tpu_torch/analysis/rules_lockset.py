"""SNAP005 ``lockset``: shared mutable state must be mutated under its lock.

The scheduler's budget cell is charged from the event loop and released
from executor threads; the coordinator singleton is resolved from
arbitrary caller threads; tracing spans append from every worker. The
codebase's convention for such state is explicit: the owning object (or
module) holds a ``threading.Lock``/``Condition``, and every mutation
happens inside ``with <lock>:``. This rule enforces the convention where
it is declared:

- **Class-scoped**: in a class that assigns a lock to an attribute
  (``self._lock = threading.Lock()``), any method (other than
  ``__init__``) that mutates ``self.<attr>`` — assignment, augmented
  assignment, ``self.x[k] = v``, ``del``, or a mutating container method
  (``append``/``pop``/``update``/…) — outside a ``with self.<lock>:``
  block is flagged. A class with no lock attribute is presumed
  single-threaded (thread-confined) and is not checked.
- **Module-scoped**: if the module binds a lock at top level
  (``_lock = threading.Lock()``), a function that declares ``global X``
  and assigns ``X`` outside ``with <that lock>:`` is flagged.
- **Executor callbacks**: a nested function handed to
  ``run_in_executor``/``executor.submit`` that mutates ``self.<attr>``
  or a ``nonlocal``/``global`` name without any lock-looking ``with``
  guard is flagged — thread-pool callbacks race the event-loop thread
  by construction.

Scoped by default to the concurrency-bearing modules: ``scheduler.py``,
``coord.py``, ``manager.py``, ``tracing.py``.
"""

import ast
import os
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .core import Diagnostic, Rule, dotted_name

# Entries are file basenames, or slashed suffixes ("telemetry/metrics.py")
# for generically-named files that must only match inside their package —
# a bare "metrics.py" would drag every fixture or example of that name
# into the concurrency lint.
_DEFAULT_MODULES = (
    "scheduler.py",
    "coord.py",
    "manager.py",
    "tracing.py",
    # snapstats: the metrics registry is mutated from the event loop,
    # executor threads, and async-take drains at once; the flight
    # recorder's phase map is written from the background drain while
    # the foreground reads summaries. Analyzed, not skipped.
    "telemetry/metrics.py",
    "telemetry/report.py",
    "telemetry/export.py",
    # snapserve: the content cache is hit from every handler task and
    # read by stats RPCs; the service's stats/backend/memo dicts are
    # shared between the server loop and stats callers; the client
    # plugin's pools/down-latch are touched from per-operation event
    # loops on different threads. Analyzed, not skipped.
    "snapserve/cache.py",
    "snapserve/server.py",
    "snapserve/client.py",
)

_LOCK_FACTORIES = {
    "Lock",
    "RLock",
    "Condition",
    "Semaphore",
    "BoundedSemaphore",
}

_MUTATING_METHODS = {
    "append",
    "appendleft",
    "add",
    "clear",
    "discard",
    "extend",
    "insert",
    "pop",
    "popleft",
    "popitem",
    "remove",
    "setdefault",
    "update",
}


def _is_lock_factory(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    name = dotted_name(node.func)
    if name is None:
        return False
    return name.split(".")[-1] in _LOCK_FACTORIES


def _self_attr(node: ast.AST) -> Optional[str]:
    """``self.x`` -> "x"."""
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _mutated_self_attr(node: ast.AST) -> Optional[Tuple[str, ast.AST]]:
    """The self attribute a statement/expression mutates, if any."""
    targets: List[ast.AST] = []
    if isinstance(node, ast.Assign):
        targets = node.targets
    elif isinstance(node, ast.AugAssign):
        targets = [node.target]
    elif isinstance(node, ast.AnnAssign):
        # A bare annotation (`self.x: int`, no value) declares, not
        # mutates.
        if node.value is None:
            return None
        targets = [node.target]
    elif isinstance(node, ast.Delete):
        targets = node.targets
    elif isinstance(node, ast.Call):
        if (
            isinstance(node.func, ast.Attribute)
            and node.func.attr in _MUTATING_METHODS
        ):
            attr = _self_attr(node.func.value)
            if attr is not None:
                return attr, node
        return None
    for t in targets:
        attr = _self_attr(t)
        if attr is not None:
            return attr, node
        if isinstance(t, ast.Subscript):
            attr = _self_attr(t.value)
            if attr is not None:
                return attr, node
    return None


def _assigned_names(node: ast.AST) -> List[str]:
    """Plain names a statement assigns (Assign/AugAssign/AnnAssign)."""
    if isinstance(node, ast.Assign):
        targets = node.targets
    elif isinstance(node, ast.AugAssign):
        targets = [node.target]
    elif isinstance(node, ast.AnnAssign) and node.value is not None:
        targets = [node.target]
    else:
        return []
    return [t.id for t in targets if isinstance(t, ast.Name)]


class _LockScopeVisitor(ast.NodeVisitor):
    """Shared lock-depth tracking for every lockset sub-check.

    Walks one function body, counting nesting inside ``with`` blocks
    whose context ``is_lock_ctx`` recognizes as a lock; every node
    reached at depth zero is handed to ``on_unlocked`` to decide whether
    it is a violating mutation.
    """

    def __init__(self, is_lock_ctx, on_unlocked) -> None:
        self._is_lock_ctx = is_lock_ctx
        self._on_unlocked = on_unlocked
        self._lock_depth = 0

    def visit_With(self, node: ast.With) -> None:
        self._visit_with(node)

    def visit_AsyncWith(self, node: ast.AsyncWith) -> None:
        self._visit_with(node)

    def _visit_with(self, node) -> None:
        locked = any(
            self._is_lock_ctx(item.context_expr) for item in node.items
        )
        if locked:
            self._lock_depth += 1
        self.generic_visit(node)
        if locked:
            self._lock_depth -= 1

    def generic_visit(self, node: ast.AST) -> None:
        if self._lock_depth == 0:
            self._on_unlocked(node)
        super().generic_visit(node)


class LocksetRule(Rule):
    name = "lockset"
    code = "SNAP005"
    description = (
        "Attribute of a lock-owning object (or module global guarded "
        "elsewhere by a lock) mutated outside 'with <lock>:', or "
        "mutated from a thread-pool callback without a lock."
    )

    def __init__(
        self, modules: Tuple[str, ...] = _DEFAULT_MODULES
    ) -> None:
        self._modules = modules

    def applies_to(self, path: str) -> bool:
        norm = path.replace(os.sep, "/")
        for module in self._modules:
            if "/" in module:
                if norm == module or norm.endswith("/" + module):
                    return True
            elif os.path.basename(path) == module:
                return True
        return False

    def check(
        self, tree: ast.AST, lines: Sequence[str], path: str
    ) -> List[Diagnostic]:
        diags: List[Diagnostic] = []
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                diags.extend(self._check_class(node, path))
        diags.extend(self._check_module_globals(tree, path))
        diags.extend(self._check_executor_callbacks(tree, path))
        return diags

    # ---------------------------------------------------------- class scope

    def _check_class(
        self, cls: ast.ClassDef, path: str
    ) -> List[Diagnostic]:
        lock_attrs: Set[str] = set()
        for node in ast.walk(cls):
            if isinstance(node, ast.Assign) and _is_lock_factory(node.value):
                for t in node.targets:
                    attr = _self_attr(t)
                    if attr is not None:
                        lock_attrs.add(attr)
        if not lock_attrs:
            return []
        diags: List[Diagnostic] = []
        for item in cls.body:
            if not isinstance(
                item, (ast.FunctionDef, ast.AsyncFunctionDef)
            ):
                continue
            if item.name in ("__init__", "__new__", "__del__"):
                continue
            diags.extend(
                self._check_method(item, lock_attrs, cls.name, path)
            )
        return diags

    def _check_method(
        self,
        fn: ast.AST,
        lock_attrs: Set[str],
        cls_name: str,
        path: str,
    ) -> List[Diagnostic]:
        diags: List[Diagnostic] = []

        def on_unlocked(node: ast.AST) -> None:
            found = _mutated_self_attr(node)
            if found is not None and found[0] not in lock_attrs:
                attr, where = found
                diags.append(
                    self.diag(
                        path,
                        where,
                        f"'{cls_name}.{fn.name}' mutates "
                        f"'self.{attr}' outside 'with self."
                        f"{sorted(lock_attrs)[0]}:' — the class "
                        f"declares lock-guarded state; guard "
                        f"the mutation or mark it thread-"
                        f"confined with a suppression.",
                    )
                )

        _LockScopeVisitor(
            lambda ctx: _self_attr(ctx) in lock_attrs, on_unlocked
        ).visit(fn)
        return diags

    # --------------------------------------------------------- module scope

    def _check_module_globals(
        self, tree: ast.AST, path: str
    ) -> List[Diagnostic]:
        module_locks: Set[str] = set()
        for node in tree.body if isinstance(tree, ast.Module) else []:
            if isinstance(node, ast.Assign) and _is_lock_factory(node.value):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        module_locks.add(t.id)
        if not module_locks:
            return []
        diags: List[Diagnostic] = []
        for node in ast.walk(tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            declared_global: Set[str] = set()
            for sub in ast.walk(node):
                if isinstance(sub, ast.Global):
                    declared_global.update(sub.names)
            if not declared_global:
                continue

            def on_unlocked(anode: ast.AST, fn=node) -> None:
                for name in _assigned_names(anode):
                    if name in declared_global:
                        diags.append(
                            self.diag(
                                path,
                                anode,
                                f"global '{name}' assigned "
                                f"outside 'with "
                                f"{sorted(module_locks)[0]}:' "
                                f"in '{fn.name}' — the "
                                f"module declares a lock for "
                                f"its globals.",
                            )
                        )

            _LockScopeVisitor(
                lambda ctx: isinstance(ctx, ast.Name)
                and ctx.id in module_locks,
                on_unlocked,
            ).visit(node)
        return diags

    # ---------------------------------------------------- executor callbacks

    def _check_executor_callbacks(
        self, tree: ast.AST, path: str
    ) -> List[Diagnostic]:
        diags: List[Diagnostic] = []
        # A callback nested several functions deep is reachable from
        # every enclosing function's walk; report it once.
        checked: Set[int] = set()
        for node in ast.walk(tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            nested: Dict[str, ast.AST] = {
                item.name: item
                for item in ast.walk(node)
                if isinstance(
                    item, (ast.FunctionDef, ast.AsyncFunctionDef)
                )
                and item is not node
            }
            if not nested:
                continue
            submitted: Set[str] = set()
            for call in ast.walk(node):
                if not isinstance(call, ast.Call):
                    continue
                fname = dotted_name(call.func)
                if fname is None:
                    continue
                leaf = fname.split(".")[-1]
                if leaf == "run_in_executor" and len(call.args) >= 2:
                    arg = call.args[1]
                elif leaf == "submit" and call.args:
                    arg = call.args[0]
                else:
                    continue
                if isinstance(arg, ast.Name) and arg.id in nested:
                    submitted.add(arg.id)
            for name in sorted(submitted):
                fn_node = nested[name]
                if id(fn_node) in checked:
                    continue
                checked.add(id(fn_node))
                diags.extend(self._check_callback(fn_node, name, path))
        return diags

    def _check_callback(
        self, fn: ast.AST, name: str, path: str
    ) -> List[Diagnostic]:
        shared: Set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, (ast.Nonlocal, ast.Global)):
                shared.update(node.names)
        diags: List[Diagnostic] = []

        def is_lock_ctx(ctx: ast.AST) -> bool:
            # In a detached callback the guard may be any lock the
            # closure can see; accept any lock-looking context.
            dn = dotted_name(ctx) or ""
            return "lock" in dn.lower() or "cond" in dn.lower()

        def on_unlocked(node: ast.AST) -> None:
            found = _mutated_self_attr(node)
            if found is not None:
                attr, where = found
                diags.append(
                    self.diag(
                        path,
                        where,
                        f"'{name}' runs in a thread-pool and "
                        f"mutates 'self.{attr}' without a "
                        f"lock; it races the event-loop "
                        f"thread.",
                    )
                )
                return
            for shared_name in _assigned_names(node):
                if shared_name in shared:
                    diags.append(
                        self.diag(
                            path,
                            node,
                            f"'{name}' runs in a thread-"
                            f"pool and assigns shared "
                            f"'{shared_name}' (nonlocal/global) "
                            f"without a lock.",
                        )
                    )

        _LockScopeVisitor(is_lock_ctx, on_unlocked).visit(fn)
        return diags
