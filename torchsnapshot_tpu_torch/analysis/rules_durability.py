"""SNAP002 ``durability-order``: data must be durable before it is published.

The snapshot commit protocol is metadata-last: payload objects are written
first, then the manifest/marker publishes them. The same discipline
applies one level down, inside a single storage object: the
write-temp-then-rename pattern (``open(tmp) … write … os.replace(tmp,
final)``) only provides crash atomicity when the temp file's *data* is
durable before the rename publishes the final name. POSIX allows a crash
shortly after an un-fsynced rename to leave the final name pointing at a
zero-length or partially-written file — a torn object that the metadata
(written later, possibly on another host) will happily reference.

The check is per-function and order-based: if a function writes through a
file handle opened in that function and later calls
``os.replace``/``os.rename`` with no ``os.fsync`` between the last write
and the rename, the rename is flagged. (A correct sequence is
``f.flush(); os.fsync(f.fileno())`` before the rename — flush pushes
Python's userspace buffer, fsync pushes the kernel's.)

Append-only logs get the same discipline (the telemetry-ledger append
path motivated this arm): a write through a handle opened in append
mode (``"a"``/``"ab"``) IS its own publish — the record becomes visible
to every reader the moment it lands, and callers treat the function's
return as success. If no ``os.fsync`` follows the last append-mode
write in the function, a crash after "success" silently loses the
record (the append must land before any success log/marker). Flagged on
the write; genuinely ephemeral appends (best-effort telemetry export)
carry a justified suppression instead.
"""

import ast
from typing import List, Optional, Sequence

from .core import Diagnostic, Rule, dotted_name


def _open_mode(call: ast.Call) -> Optional[str]:
    """The literal mode string of an ``open()``-style call, if static."""
    mode_node: Optional[ast.AST] = None
    if len(call.args) >= 2:
        mode_node = call.args[1]
    for kw in call.keywords:
        if kw.arg == "mode":
            mode_node = kw.value
    if isinstance(mode_node, ast.Constant) and isinstance(
        mode_node.value, str
    ):
        return mode_node.value
    return None


def _opened_handles(fn: ast.AST) -> tuple:
    """``(handles, append_handles)``: names bound via ``with open(...)
    as f`` / ``os.fdopen(...) as f`` or ``f = open(...)`` within this
    function (not nested functions); ``append_handles`` is the subset
    whose literal mode contains ``"a"`` (append-only logs)."""
    handles = set()
    append_handles = set()

    def note(name: str, call: ast.AST) -> None:
        handles.add(name)
        mode = _open_mode(call) if isinstance(call, ast.Call) else None
        if mode is not None and "a" in mode:
            append_handles.add(name)

    for node in _walk_function(fn):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                if (
                    item.optional_vars is not None
                    and isinstance(item.optional_vars, ast.Name)
                    and _is_open_call(item.context_expr)
                ):
                    note(item.optional_vars.id, item.context_expr)
        elif isinstance(node, ast.Assign):
            if _is_open_call(node.value):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        note(t.id, node.value)
    return handles, append_handles


def _is_open_call(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    name = dotted_name(node.func)
    return name in ("open", "os.fdopen", "io.open", "builtins.open")


def _walk_function(fn: ast.AST):
    """Walk a function body without descending into nested functions."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
        ):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


class DurabilityOrderRule(Rule):
    name = "durability-order"
    code = "SNAP002"
    description = (
        "os.replace/os.rename publishing file data that was never "
        "fsync'd: a crash after the rename can leave the published name "
        "pointing at torn or empty data that later metadata references."
    )

    def check(
        self, tree: ast.AST, lines: Sequence[str], path: str
    ) -> List[Diagnostic]:
        # Local names bound to os.fsync by `from os import fsync [as f]`,
        # so the bare-call spelling is recognized as a sync too.
        fsync_names = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module == "os":
                for alias in node.names:
                    if alias.name == "fsync":
                        fsync_names.add(alias.asname or alias.name)
        diags: List[Diagnostic] = []
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                diags.extend(
                    self._check_function(node, path, fsync_names)
                )
        return diags

    def _check_function(
        self, fn: ast.AST, path: str, fsync_names: set
    ) -> List[Diagnostic]:
        handles, append_handles = _opened_handles(fn)
        if not handles:
            return []
        write_lines: List[int] = []
        append_writes: List[ast.Call] = []
        fsync_lines: List[int] = []
        renames: List[ast.Call] = []
        for node in _walk_function(fn):
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func)
            if (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in ("write", "writelines")
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id in handles
            ):
                write_lines.append(node.lineno)
                if node.func.value.id in append_handles:
                    append_writes.append(node)
            elif name is not None and (
                name.endswith(".fsync") or name in fsync_names
            ):
                fsync_lines.append(node.lineno)
            elif name in ("os.replace", "os.rename"):
                renames.append(node)
        diags: List[Diagnostic] = []
        if append_writes:
            # Append arm: the write IS the publish for an append-only
            # log; the last append must be fsync'd before the function
            # can signal success.
            last_append = max(w.lineno for w in append_writes)
            if not any(f >= last_append for f in fsync_lines):
                node = max(append_writes, key=lambda w: w.lineno)
                diags.append(
                    self.diag(
                        path,
                        node,
                        "append-mode write is never os.fsync'd before "
                        "the function returns: the appended record is "
                        "the publish itself, and a crash after callers "
                        "observed success can silently lose it (fsync "
                        "the handle after the last append, or suppress "
                        "with a justification if the log is genuinely "
                        "ephemeral).",
                    )
                )
        if not renames or not write_lines:
            return diags
        for rename in renames:
            prior_writes = [w for w in write_lines if w < rename.lineno]
            if not prior_writes:
                continue
            last_write = max(prior_writes)
            synced = any(
                last_write <= f < rename.lineno for f in fsync_lines
            )
            if not synced:
                target = dotted_name(rename.func)
                diags.append(
                    self.diag(
                        path,
                        rename,
                        f"'{target}' publishes file data written at line "
                        f"{last_write} without an os.fsync in between; a "
                        f"crash after the rename can publish a torn "
                        f"object (add f.flush(); os.fsync(f.fileno()) "
                        f"before renaming).",
                    )
                )
        return diags
