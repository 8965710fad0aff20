"""SNAP003 ``swallowed-exception``: broad catches must not discard failures.

The retry and commit paths classify exceptions to decide whether to retry,
fail, or degrade (``io_types.retry_storage_op``, the sweep age guard, the
commit barrier). A broad handler (``except Exception``, ``except
BaseException``, or a bare ``except``) that silently discards the
exception hides exactly the failures those paths need to see: a storage
5xx that should have been retried, a commit-ordering violation that
should have aborted the take, a corrupted-metadata parse that should have
failed the restore.

A broad handler passes this rule when it does any of:

- re-raise (``raise`` anywhere in the handler body),
- log through a recognized logging facility (``logger.*``, ``logging.*``,
  ``tracing.*``, ``warnings.*``),
- *use* the bound exception value (``except Exception as e`` where ``e``
  is read) — storing/formatting/returning the failure counts as
  propagating it, e.g. ``problems[loc] = f"unreadable: {e!r}"``,
- capture the active exception some other way (``traceback.format_exc``,
  ``traceback.print_exc``, ``sys.exc_info``).

Deliberate best-effort swallows must carry a justification suppression::

    except Exception:  # snapcheck: disable=swallowed-exception -- why
"""

import ast
from typing import List, Sequence

from .core import Diagnostic, Rule

_BROAD = {"Exception", "BaseException"}
_LOG_BASES = {"logger", "logging", "log", "tracing", "warnings"}
_CAPTURE_CALLS = {
    "traceback.format_exc",
    "traceback.print_exc",
    "sys.exc_info",
}


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True  # bare except
    names = []
    if isinstance(t, ast.Name):
        names = [t.id]
    elif isinstance(t, ast.Tuple):
        names = [e.id for e in t.elts if isinstance(e, ast.Name)]
    return any(n in _BROAD for n in names)


def _handles_failure(handler: ast.ExceptHandler) -> bool:
    bound = handler.name
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Call):
            base = node.func
            while isinstance(base, ast.Attribute):
                base = base.value
            if isinstance(base, ast.Name) and base.id in _LOG_BASES:
                return True
            dotted = []
            f = node.func
            while isinstance(f, ast.Attribute):
                dotted.append(f.attr)
                f = f.value
            if isinstance(f, ast.Name):
                dotted.append(f.id)
                if ".".join(reversed(dotted)) in _CAPTURE_CALLS:
                    return True
        if (
            bound
            and isinstance(node, ast.Name)
            and node.id == bound
            and isinstance(node.ctx, ast.Load)
        ):
            return True
    return False


class SwallowedExceptionRule(Rule):
    name = "swallowed-exception"
    code = "SNAP003"
    description = (
        "except Exception/BaseException/bare-except that neither "
        "re-raises, logs, nor uses the exception value — failures in "
        "retry/commit paths vanish silently."
    )

    def check(
        self, tree: ast.AST, lines: Sequence[str], path: str
    ) -> List[Diagnostic]:
        diags: List[Diagnostic] = []
        for node in ast.walk(tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not _is_broad(node):
                continue
            if _handles_failure(node):
                continue
            caught = "bare except"
            if isinstance(node.type, ast.Name):
                caught = f"except {node.type.id}"
            diags.append(
                self.diag(
                    path,
                    node,
                    f"{caught} discards the failure (no raise, no "
                    f"logging, exception value unused); log it, "
                    f"re-raise, or suppress with a justification.",
                )
            )
        return diags
