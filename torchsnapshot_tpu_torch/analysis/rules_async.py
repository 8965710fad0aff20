"""SNAP001 ``blocking-sync``: no blocking device synchronization in async code.

The write pipeline's whole point is that the training step resumes while
staging and storage IO drain in the background (``Snapshot.async_take``,
``scheduler.execute_write_reqs``). A blocking device sync executed on the
event-loop thread — ``x.block_until_ready()``, ``jax.device_get(x)``,
``np.asarray(device_array)`` — stalls *every* in-flight request behind one
transfer and, during an async take, stalls the training step itself.
PyTorch's host syncs are the same hazard: ``torch.cuda.synchronize()``,
``.synchronize()`` on a CUDA ``Event`` or ``Stream``, and a tensor's
``.item()`` / ``.cpu()`` / ``.numpy()`` / ``.tolist()``, each of which
waits for the device's queued work before it returns.

The static approximation: inside the body of an ``async def``, any call to
a known blocking-sync API is flagged. Synchronous helpers are exempt even
when defined inside an async function — the codebase's convention is that
sync helpers run inside a thread executor (``loop.run_in_executor``),
where blocking is exactly what is supposed to happen. ``time.sleep`` in
async code is flagged for the same reason (use ``asyncio.sleep``).

numpy/jax/torch module aliases are resolved from the file's import
statements, so ``import numpy as _np; _np.asarray(...)`` is still caught.
The tensor and stream methods are matched on any receiver, as
``block_until_ready`` is: the analyzer has no types.
"""

import ast
from typing import List, Sequence

from .core import Diagnostic, Rule, dotted_name, import_aliases, imported_names

# Attribute method names that synchronize with the device regardless of
# the receiver's spelling.
_BLOCKING_METHODS = {"block_until_ready"}

# PyTorch's host syncs, by method name on any receiver: each waits for
# the device's queued work before it returns.
TORCH_SYNC_METHODS = {
    "synchronize": "waits for the device's queued work",
    "item": "copies a tensor's value to the host, waiting for the "
    "device's queued work",
    "cpu": "copies a tensor to the host, waiting for the device's "
    "queued work",
    "numpy": "copies a tensor to a host array, waiting for the "
    "device's queued work",
    "tolist": "copies a tensor to a host list, waiting for the "
    "device's queued work",
}


def torch_sync_name(func: ast.expr, torch_aliases: set, bare: set):
    """The printed name of a torch host sync called as ``func``, or None.

    ``torch.cuda.synchronize`` is resolved through the file's ``torch``
    aliases (and ``from torch.cuda import synchronize``); every other
    entry of :data:`TORCH_SYNC_METHODS` is a method on any receiver.
    """
    name = dotted_name(func)
    if name is not None:
        root, _, rest = name.partition(".")
        if root in torch_aliases and rest == "cuda.synchronize":
            return "torch.cuda.synchronize"
        if name in bare:
            return "synchronize"
    if isinstance(func, ast.Attribute) and func.attr in TORCH_SYNC_METHODS:
        recv = dotted_name(func.value)
        return f"{recv}.{func.attr}" if recv else f".{func.attr}"
    return None


def torch_sync_what(printed: str) -> str:
    """Why the torch host sync ``printed`` blocks."""
    return TORCH_SYNC_METHODS[printed.rsplit(".", 1)[-1]]


class BlockingSyncRule(Rule):
    name = "blocking-sync"
    code = "SNAP001"
    description = (
        "Blocking device synchronization (block_until_ready, "
        "jax.device_get, np.asarray, time.sleep, torch.cuda."
        "synchronize, Event/Stream.synchronize, Tensor.item/.cpu/"
        ".numpy/.tolist) inside an async function stalls the event "
        "loop and every in-flight request."
    )

    def check(
        self, tree: ast.AST, lines: Sequence[str], path: str
    ) -> List[Diagnostic]:
        numpy_aliases = import_aliases(tree, "numpy")
        jax_aliases = import_aliases(tree, "jax")
        time_aliases = import_aliases(tree, "time")
        # from jax import device_get / from time import sleep
        bare_device_get = {
            n for n in imported_names(tree, "jax") if n == "device_get"
        }
        bare_sleep = {n for n in imported_names(tree, "time") if n == "sleep"}
        torch_aliases = import_aliases(tree, "torch")
        # from torch.cuda import synchronize
        bare_synchronize = {
            n for n in imported_names(tree, "torch") if n == "synchronize"
        }

        diags: List[Diagnostic] = []
        rule = self

        class Visitor(ast.NodeVisitor):
            def __init__(self) -> None:
                # Innermost function kind: True = async, False = sync.
                self._stack: List[bool] = []

            def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef):
                self._stack.append(True)
                self.generic_visit(node)
                self._stack.pop()

            def visit_FunctionDef(self, node: ast.FunctionDef):
                self._stack.append(False)
                self.generic_visit(node)
                self._stack.pop()

            def visit_Lambda(self, node: ast.Lambda):
                self._stack.append(False)
                self.generic_visit(node)
                self._stack.pop()

            def _in_async(self) -> bool:
                return bool(self._stack) and self._stack[-1]

            def visit_Call(self, node: ast.Call):
                if self._in_async():
                    msg = self._classify(node)
                    if msg is not None:
                        diags.append(rule.diag(path, node, msg))
                self.generic_visit(node)

            def _classify(self, node: ast.Call) -> str:
                func = node.func
                if (
                    isinstance(func, ast.Attribute)
                    and func.attr in _BLOCKING_METHODS
                ):
                    return (
                        f"'{func.attr}()' blocks the event loop on a "
                        f"device transfer; run it in a thread executor "
                        f"(loop.run_in_executor)."
                    )
                torch_sync = torch_sync_name(
                    func, torch_aliases, bare_synchronize
                )
                if torch_sync is not None:
                    return (
                        f"'{torch_sync}()' "
                        f"{torch_sync_what(torch_sync)}, stalling the "
                        f"event loop; run it in a thread executor "
                        f"(loop.run_in_executor)."
                    )
                name = dotted_name(func)
                if name is None:
                    return None
                root, _, rest = name.partition(".")
                if root in jax_aliases and rest == "device_get":
                    return (
                        "'jax.device_get()' blocks the event loop on a "
                        "device→host transfer; stage through a "
                        "BufferStager in a thread executor instead."
                    )
                if name in bare_device_get:
                    return (
                        "'device_get()' blocks the event loop on a "
                        "device→host transfer; stage through a "
                        "BufferStager in a thread executor instead."
                    )
                if root in numpy_aliases and rest in ("asarray", "array"):
                    return (
                        f"'{name}()' forces a synchronous device→host "
                        f"copy when handed a jax.Array, stalling the "
                        f"event loop; move it into a sync helper run via "
                        f"loop.run_in_executor."
                    )
                if (root in time_aliases and rest == "sleep") or (
                    name in bare_sleep
                ):
                    return (
                        "'time.sleep()' blocks the event loop; use "
                        "'await asyncio.sleep()'."
                    )
                return None

        Visitor().visit(tree)
        return diags
