"""SNAP004 ``nondeterminism``: serialization paths must be reproducible.

Incremental snapshots deduplicate by content fingerprint, and the
manifest's serialized bytes feed checksums and cross-rank comparison.
Both contracts break if serialization is a function of anything beyond
the logical payload: wall-clock time, random state, process-specific
values (``hash()`` of a str depends on PYTHONHASHSEED; ``id()`` on the
allocator), or unordered-collection iteration order.

Scoped to the modules that own serialization (``fingerprint.py``,
``manifest.py``, ``serialization.py`` by default). Flags:

- calls into nondeterministic sources: ``time.*``, ``datetime.now/
  utcnow/today``, the ``random`` module, ``np.random.*``, ``uuid.*``,
  ``secrets.*``, ``os.urandom``, builtin ``hash()`` / ``id()``;
- ``json.dumps`` without ``sort_keys=True`` (or with it explicitly
  False) and ``yaml.dump`` with ``sort_keys=False`` — the manifest
  document must have one canonical byte form;
- iteration over a set (literal, comprehension, or ``set()``/
  ``frozenset()`` call) — set order varies across processes; sort first.
"""

import ast
import os
from typing import List, Optional, Sequence, Tuple

from .core import Diagnostic, Rule, dotted_name, import_aliases

_DEFAULT_MODULES = ("fingerprint.py", "manifest.py", "serialization.py")

_DATETIME_NOW = {"now", "utcnow", "today"}


class DeterminismRule(Rule):
    name = "nondeterminism"
    code = "SNAP004"
    description = (
        "Nondeterministic source (time/random/hash/uuid) or "
        "non-canonical serialization (unsorted dict dump, set "
        "iteration) in a fingerprint/manifest serialization module."
    )

    def __init__(
        self, modules: Tuple[str, ...] = _DEFAULT_MODULES
    ) -> None:
        self._modules = modules

    def applies_to(self, path: str) -> bool:
        return os.path.basename(path) in self._modules

    def check(
        self, tree: ast.AST, lines: Sequence[str], path: str
    ) -> List[Diagnostic]:
        time_aliases = import_aliases(tree, "time")
        datetime_aliases = import_aliases(tree, "datetime")
        random_aliases = import_aliases(tree, "random")
        numpy_aliases = import_aliases(tree, "numpy")
        uuid_aliases = import_aliases(tree, "uuid")
        secrets_aliases = import_aliases(tree, "secrets")
        os_aliases = import_aliases(tree, "os")
        json_aliases = import_aliases(tree, "json") or {"json"}
        yaml_aliases = import_aliases(tree, "yaml") or {"yaml"}

        diags: List[Diagnostic] = []
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                msg = self._classify_call(
                    node,
                    time_aliases,
                    datetime_aliases,
                    random_aliases,
                    numpy_aliases,
                    uuid_aliases,
                    secrets_aliases,
                    os_aliases,
                    json_aliases,
                    yaml_aliases,
                )
                if msg is not None:
                    diags.append(self.diag(path, node, msg))
            elif isinstance(node, (ast.For, ast.AsyncFor)):
                msg = self._classify_iter(node.iter)
                if msg is not None:
                    diags.append(self.diag(path, node, msg))
            elif isinstance(node, ast.comprehension):
                msg = self._classify_iter(node.iter)
                if msg is not None:
                    diags.append(self.diag(path, node.iter, msg))
        return diags

    def _classify_call(
        self,
        node: ast.Call,
        time_aliases,
        datetime_aliases,
        random_aliases,
        numpy_aliases,
        uuid_aliases,
        secrets_aliases,
        os_aliases,
        json_aliases,
        yaml_aliases,
    ) -> Optional[str]:
        name = dotted_name(node.func)
        if name is None:
            return None
        parts = name.split(".")
        root, rest = parts[0], parts[1:]
        if name in ("hash", "id"):
            return (
                f"builtin '{name}()' is process-specific "
                f"(PYTHONHASHSEED / allocator); serialization must not "
                f"depend on it."
            )
        if root in time_aliases and rest:
            return (
                f"'{name}()' reads the clock; serialization output "
                f"must be a pure function of the payload."
            )
        if root in datetime_aliases and rest and rest[-1] in _DATETIME_NOW:
            return f"'{name}()' reads the clock; serialization must be deterministic."
        if root in random_aliases:
            return f"'{name}()' draws random state; serialization must be deterministic."
        if root in numpy_aliases and rest and rest[0] == "random":
            return f"'{name}()' draws random state; serialization must be deterministic."
        if root in uuid_aliases and rest:
            return f"'{name}()' generates a unique value per call; not reproducible."
        if root in secrets_aliases and rest:
            return f"'{name}()' draws entropy; serialization must be deterministic."
        if root in os_aliases and rest == ["urandom"]:
            return f"'{name}()' draws entropy; serialization must be deterministic."
        if root in json_aliases and rest == ["dumps"]:
            if not self._sorts_keys(node):
                return (
                    "json.dumps without sort_keys=True: the serialized "
                    "document's byte form depends on dict construction "
                    "order instead of being canonical."
                )
        if root in yaml_aliases and rest and rest[-1] in ("dump", "safe_dump"):
            if self._explicitly_unsorted(node):
                return (
                    "yaml dump with sort_keys=False: the serialized "
                    "document's byte form depends on dict construction "
                    "order instead of being canonical."
                )
        return None

    @staticmethod
    def _sorts_keys(node: ast.Call) -> bool:
        for kw in node.keywords:
            if kw.arg == "sort_keys":
                return not (
                    isinstance(kw.value, ast.Constant)
                    and kw.value.value is False
                )
        return False

    @staticmethod
    def _explicitly_unsorted(node: ast.Call) -> bool:
        for kw in node.keywords:
            if kw.arg == "sort_keys":
                return (
                    isinstance(kw.value, ast.Constant)
                    and kw.value.value is False
                )
        return False

    @staticmethod
    def _classify_iter(iter_node: ast.AST) -> Optional[str]:
        if isinstance(iter_node, (ast.Set, ast.SetComp)):
            return (
                "iterating a set: element order varies across "
                "processes; iterate sorted(...) instead."
            )
        if isinstance(iter_node, ast.Call):
            name = dotted_name(iter_node.func)
            if name in ("set", "frozenset"):
                return (
                    "iterating a set: element order varies across "
                    "processes; iterate sorted(...) instead."
                )
        return None
