"""SNAP007 ``event-loop-blocking``: blocking calls reachable from async code.

SNAP001 flags a handful of known device-sync calls *directly* inside an
``async def``. This rule generalizes both axes, the way the snaptier
round-3 ``begin_write_through`` stall taught us to: the registry covers
the whole family of blocking operations (the storage plugins' ``*_sync``
helpers, lock ``.acquire()`` without a timeout, subprocess waits,
``Future.result()``, ``Thread.join()``, ``Event``/``Condition`` waits,
``time.sleep``, ``block_until_ready`` and PyTorch's host syncs:
``torch.cuda.synchronize()``, ``Event``/``Stream.synchronize()``,
``Tensor.item/.cpu/.numpy/.tolist``), and reachability is
**transitive**: a synchronous helper *called directly* from an ``async
def`` body runs on the event loop, so a blocking call anywhere down that
intra-module call chain stalls every in-flight request — snapserve's
whole fan-out, or the drain runtime's scheduler loop.

The escape hatch is structural, not annotated: routing through
``loop.run_in_executor(...)`` / ``asyncio.to_thread(...)`` /
``executor.submit(...)`` passes the helper as an *argument*, not a
direct call, so executor-routed helpers never enter the call graph —
exactly the codebase convention (``fs.py`` wraps ``_write_sync`` et al).
``await``-ed calls are exempt (``await lock.acquire()`` is an asyncio
primitive, not a thread lock).

Approximations, documented because they shape findings:

- The call graph is intra-module (``f()`` to a module function, a
  nested function in scope, or ``self.m()``/``cls.m()`` to a method of
  the same class). Cross-module reachability is out of scope.
- A helper called from both async and sync contexts is flagged — if the
  blocking is deliberate on the sync path, suppress with the invariant
  written down or split the helper.
- Registry entries SNAP001 already reports inside async bodies
  (``time.sleep``, ``block_until_ready``, the torch syncs) are skipped
  in the direct-in-async arm to avoid duplicate findings; they still
  fire through the transitive arm.
"""

import ast
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .core import Diagnostic, Rule, dotted_name, import_aliases, imported_names
from .rules_async import torch_sync_name, torch_sync_what

# Receiver-name heuristics (matched on the lowered dotted receiver).
_LOCKISH = re.compile(r"lock|mutex|(^|[._])cond\b|semaphore")
_PROCISH = re.compile(r"proc|popen|server|child")
_EVENTISH = re.compile(r"event|(^|[._])cond\b|barrier")
_FUTUREISH = re.compile(r"fut|promise")
_THREADISH = re.compile(r"thread|worker|drainer")

_SUBPROCESS_FUNCS = {
    "subprocess.run",
    "subprocess.call",
    "subprocess.check_call",
    "subprocess.check_output",
    "os.waitpid",
    "os.wait",
}

@dataclass(frozen=True)
class BlockingCall:
    """One classified blocking call site."""

    node: ast.Call
    what: str
    snap001_overlap: bool = False


def _has_timeout_arg(call: ast.Call) -> bool:
    if any(kw.arg in ("timeout", "block") for kw in call.keywords):
        return True
    return bool(call.args)


class _Registry:
    """The declarative blocking-call registry, bound to one file's
    import aliases."""

    def __init__(self, tree: ast.AST):
        self.time_aliases = import_aliases(tree, "time")
        self.subprocess_aliases = import_aliases(tree, "subprocess")
        self.os_aliases = import_aliases(tree, "os")
        self.bare_sleep = {
            n for n in imported_names(tree, "time") if n == "sleep"
        }
        self.torch_aliases = import_aliases(tree, "torch")
        self.bare_synchronize = {
            n for n in imported_names(tree, "torch") if n == "synchronize"
        }

    def classify(
        self, call: ast.Call, awaited: bool
    ) -> Optional[BlockingCall]:
        if awaited:
            return None
        func = call.func
        name = dotted_name(func) or ""
        lowered = name.lower()
        torch_sync = torch_sync_name(
            func, self.torch_aliases, self.bare_synchronize
        )
        if torch_sync is not None:
            return BlockingCall(
                call,
                f"'{torch_sync}()' {torch_sync_what(torch_sync)}",
                snap001_overlap=True,
            )
        if isinstance(func, ast.Attribute):
            attr = func.attr
            recv = dotted_name(func.value)
            recv_l = (recv or "").lower()
            if attr == "block_until_ready":
                return BlockingCall(
                    call,
                    "'block_until_ready()' blocks on a device transfer",
                    snap001_overlap=True,
                )
            if attr.endswith("_sync"):
                return BlockingCall(
                    call,
                    f"'{attr}()' is a blocking storage/IO helper (the "
                    f"`*_sync` convention means: executor-only)",
                )
            if (
                attr == "acquire"
                and recv is not None
                and _LOCKISH.search(recv_l)
                and not _has_timeout_arg(call)
            ):
                return BlockingCall(
                    call,
                    f"'{recv}.acquire()' blocks indefinitely on a "
                    f"thread lock (no timeout)",
                )
            if attr == "communicate" and recv is not None:
                return BlockingCall(
                    call, f"'{recv}.communicate()' waits on a subprocess"
                )
            if (
                attr == "wait"
                and recv is not None
                and not _has_timeout_arg(call)
                and (_PROCISH.search(recv_l) or _EVENTISH.search(recv_l))
            ):
                return BlockingCall(
                    call,
                    f"'{recv}.wait()' blocks with no timeout",
                )
            if (
                attr == "result"
                and recv is not None
                and _FUTUREISH.search(recv_l)
                and not _has_timeout_arg(call)
            ):
                return BlockingCall(
                    call,
                    f"'{recv}.result()' blocks on a future with no "
                    f"timeout",
                )
            if (
                attr == "join"
                and recv is not None
                and _THREADISH.search(recv_l)
                and not _has_timeout_arg(call)
            ):
                return BlockingCall(
                    call,
                    f"'{recv}.join()' blocks on a thread with no "
                    f"timeout",
                )
        else:
            attr = ""
        root, _, rest = name.partition(".")
        if name.endswith("_sync") and isinstance(func, ast.Name):
            return BlockingCall(
                call,
                f"'{name}()' is a blocking helper (the `*_sync` "
                f"convention means: executor-only)",
            )
        if (root in self.time_aliases and rest == "sleep") or (
            name in self.bare_sleep
        ):
            return BlockingCall(
                call,
                "'time.sleep()' blocks the event loop (use 'await "
                "asyncio.sleep()')",
                snap001_overlap=True,
            )
        if name in _SUBPROCESS_FUNCS or (
            root in self.subprocess_aliases
            and rest in ("run", "call", "check_call", "check_output")
        ):
            return BlockingCall(
                call, f"'{name}()' waits on a subprocess"
            )
        return None


def _awaited_call_ids(tree: ast.AST) -> Set[int]:
    return {
        id(node.value)
        for node in ast.walk(tree)
        if isinstance(node, ast.Await)
        and isinstance(node.value, ast.Call)
    }


class _FuncInfo:
    def __init__(
        self,
        node: ast.AST,
        qual: str,
        cls: Optional[str],
        is_async: bool,
    ):
        self.node = node
        self.qual = qual
        self.cls = cls
        self.is_async = is_async
        # Direct callees: (name, via_self) pairs.
        self.calls: List[Tuple[str, bool]] = []
        self.blocking: List[BlockingCall] = []


def _collect_functions(
    tree: ast.AST, registry: _Registry, awaited: Set[int]
) -> List[_FuncInfo]:
    """Every function def with its direct-call edges and blocking sites.
    Statements of nested defs belong to the nested def, not the parent."""
    infos: List[_FuncInfo] = []

    def walk_body(
        node: ast.AST,
        owner: Optional[_FuncInfo],
        cls: Optional[str],
        in_class_body: bool = False,
    ) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                walk_body(child, None, child.name, in_class_body=True)
                continue
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{cls}.{child.name}" if cls else child.name
                info = _FuncInfo(
                    child,
                    qual,
                    # Only a *direct* method is addressed via self.m();
                    # a function nested inside a method is called by
                    # bare name, so it resolves like a module function.
                    cls if in_class_body else None,
                    isinstance(child, ast.AsyncFunctionDef),
                )
                infos.append(info)
                walk_body(child, info, cls, in_class_body=False)
                continue
            if owner is not None and isinstance(child, ast.Call):
                bc = registry.classify(child, id(child) in awaited)
                if bc is not None:
                    owner.blocking.append(bc)
                else:
                    func = child.func
                    if isinstance(func, ast.Name):
                        owner.calls.append((func.id, False))
                    elif isinstance(func, ast.Attribute) and isinstance(
                        func.value, ast.Name
                    ) and func.value.id in ("self", "cls"):
                        owner.calls.append((func.attr, True))
            walk_body(child, owner, cls, in_class_body=False)

    walk_body(tree, None, None)
    return infos


class EventLoopBlockingRule(Rule):
    name = "event-loop-blocking"
    code = "SNAP007"
    description = (
        "Blocking calls (sync storage helpers, untimed lock acquires, "
        "subprocess waits, sleeps, torch host syncs) inside async "
        "functions or sync "
        "helpers directly reachable from them stall the event loop; "
        "route them through run_in_executor."
    )

    def check(
        self, tree: ast.AST, lines: Sequence[str], path: str
    ) -> List[Diagnostic]:
        registry = _Registry(tree)
        awaited = _awaited_call_ids(tree)
        infos = _collect_functions(tree, registry, awaited)

        by_key: Dict[Tuple[Optional[str], str], List[_FuncInfo]] = {}
        for info in infos:
            name = info.qual.rsplit(".", 1)[-1]
            by_key.setdefault((info.cls, name), []).append(info)

        # BFS from every async def through direct sync calls; remember
        # the first discovered call path for the report.
        on_loop: Dict[int, Tuple[str, List[str]]] = {}
        work: List[_FuncInfo] = []
        for info in infos:
            if info.is_async:
                on_loop[id(info)] = (info.qual, [info.qual])
                work.append(info)
        while work:
            cur = work.pop(0)
            origin, trail = on_loop[id(cur)]
            for callee_name, via_self in cur.calls:
                key = (cur.cls if via_self else None, callee_name)
                for callee in by_key.get(key, []):
                    if callee.is_async or id(callee) in on_loop:
                        continue
                    on_loop[id(callee)] = (
                        origin, trail + [callee.qual]
                    )
                    work.append(callee)

        diags: List[Diagnostic] = []
        for info in infos:
            if info.is_async:
                for bc in info.blocking:
                    if bc.snap001_overlap:
                        continue  # SNAP001 already reports these here
                    diags.append(
                        self.diag(
                            path,
                            bc.node,
                            f"{bc.what} inside async '{info.qual}' — "
                            f"every in-flight request on the loop "
                            f"stalls behind it; route it through "
                            f"loop.run_in_executor.",
                        )
                    )
            elif id(info) in on_loop:
                origin, trail = on_loop[id(info)]
                chain = " -> ".join(trail)
                for bc in info.blocking:
                    diags.append(
                        self.diag(
                            path,
                            bc.node,
                            f"{bc.what} in '{info.qual}', called on "
                            f"the event loop from async '{origin}' "
                            f"({chain}) — route the helper through "
                            f"loop.run_in_executor or make the chain "
                            f"async.",
                        )
                    )
        return diags
