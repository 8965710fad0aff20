"""SNAP009 ``contract-drift``: code and docs publish the same contract.

The repo's operational surface is spread across artifacts that only
humans kept in sync until now: every ``TPUSNAPSHOT_*`` env knob is
supposed to appear in ``docs/api.md``; every metric name in
``telemetry/metrics.py`` in ``docs/OBSERVABILITY.md``; every doctor
rule id in the OBSERVABILITY doctor table; every ledger digest field in
the OBSERVABILITY schema section; every ``FaultSchedule`` rule kind in
``docs/FAULTS.md``. Each PR that added a subsystem also added knobs,
metrics, and rules — and each review round found one the docs missed.

This rule makes the pairing machine-checked. It is *cross-artifact*:
the unit of analysis is still one Python file (so suppressions,
baselining, and fingerprints work unchanged), but the check compares
the file's extracted contract surface against the sibling ``docs/``
tree, located by walking up from the analyzed file (so a fixture tree
with its own ``docs/`` is self-contained, and the real package resolves
to the repo's). A missing doc file is itself a finding at line 1 —
silence would let a renamed doc disable the whole contract.

Contract sources (:data:`CONTRACTS` — declarative, so a new subsystem
registers its pair):

==============================  ============================  =========
File (suffix match)             Extracted                     Doc
==============================  ============================  =========
any ``*.py``                    env knobs read via
                                ``os.environ``/``os.getenv``/
                                ``env_*`` helpers              api.md
``telemetry/metrics.py``        ``tpusnapshot_*`` constants    OBSERVABILITY.md
``telemetry/doctor.py``         rule ids (``Finding(...)``)    OBSERVABILITY.md
``telemetry/ledger.py``         digest fields
                                (``digest_from_report``)       OBSERVABILITY.md
``faultline/schedule.py``       ``FaultRule`` kinds            FAULTS.md
==============================  ============================  =========
"""

import ast
import os
import re
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .core import Diagnostic, Rule, dotted_name

_ENV_READ_FUNCS = {
    "os.getenv",
    "getenv",
    "env_int",
    "env_float",
    "env_str",
    "env_bool",
    "env_flag",
}

_ENV_PREFIX = "TPUSNAPSHOT_"


def _extract_env_knobs(tree: ast.AST) -> List[Tuple[str, ast.AST]]:
    """Env names read through the recognized idioms. Module-level
    ``_X_ENV_VAR = "TPUSNAPSHOT_..."`` constants count as reads — the
    actual ``os.environ`` call usually lives behind a helper."""
    found: List[Tuple[str, ast.AST]] = []
    seen: set = set()

    def record(name: str, node: ast.AST) -> None:
        if name.startswith(_ENV_PREFIX) and name not in seen:
            seen.add(name)
            found.append((name, node))

    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            fname = dotted_name(node.func) or ""
            is_env_call = (
                fname in _ENV_READ_FUNCS
                or any(fname.endswith("." + f) for f in _ENV_READ_FUNCS)
                or (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("get", "setdefault", "pop")
                    and dotted_name(node.func.value) in
                    ("os.environ", "environ")
                )
            )
            if is_env_call:
                for arg in node.args[:1]:
                    if isinstance(arg, ast.Constant) and isinstance(
                        arg.value, str
                    ):
                        record(arg.value, arg)
        elif isinstance(node, ast.Subscript):
            if dotted_name(node.value) in ("os.environ", "environ"):
                sl = node.slice
                if isinstance(sl, ast.Constant) and isinstance(
                    sl.value, str
                ):
                    record(sl.value, node)
        elif isinstance(node, ast.Assign):
            if isinstance(node.value, ast.Constant) and isinstance(
                node.value.value, str
            ) and node.value.value.startswith(_ENV_PREFIX):
                for t in node.targets:
                    if isinstance(t, ast.Name) and (
                        "ENV" in t.id or t.id.isupper()
                    ):
                        record(node.value.value, node.value)
    return found


def _extract_metric_names(tree: ast.AST) -> List[Tuple[str, ast.AST]]:
    found: List[Tuple[str, ast.AST]] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            if node.value.startswith("tpusnapshot_"):
                found.append((node.value, node))
    return found


def _extract_doctor_rule_ids(tree: ast.AST) -> List[Tuple[str, ast.AST]]:
    """First positional argument (or ``rule=`` keyword) of every
    ``Finding(...)`` construction."""
    found: List[Tuple[str, ast.AST]] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fname = dotted_name(node.func)
        if fname is None or not (
            fname == "Finding" or fname.endswith(".Finding")
        ):
            continue
        candidates: List[ast.expr] = []
        if node.args:
            candidates.append(node.args[0])
        candidates.extend(
            kw.value for kw in node.keywords if kw.arg == "rule"
        )
        for c in candidates:
            if isinstance(c, ast.Constant) and isinstance(c.value, str):
                found.append((c.value, c))
    return found


def _extract_ledger_fields(tree: ast.AST) -> List[Tuple[str, ast.AST]]:
    """String keys of the digest dict literals inside
    ``digest_from_report`` (the schema-v1 record surface)."""
    found: List[Tuple[str, ast.AST]] = []
    for node in ast.walk(tree):
        if (
            isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
            and node.name == "digest_from_report"
        ):
            for inner in ast.walk(node):
                if isinstance(inner, ast.Dict):
                    for key in inner.keys:
                        if isinstance(key, ast.Constant) and isinstance(
                            key.value, str
                        ):
                            found.append((key.value, key))
    return found


def _extract_fault_kinds(tree: ast.AST) -> List[Tuple[str, ast.AST]]:
    """``kind="..."`` keyword values of ``FaultRule(...)`` calls."""
    found: List[Tuple[str, ast.AST]] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fname = dotted_name(node.func)
        if fname is None or not (
            fname == "FaultRule" or fname.endswith(".FaultRule")
        ):
            continue
        for kw in node.keywords:
            if kw.arg == "kind" and isinstance(
                kw.value, ast.Constant
            ) and isinstance(kw.value.value, str):
                found.append((kw.value.value, kw.value))
    return found


@dataclass(frozen=True)
class Contract:
    name: str
    file_suffix: Optional[str]  # None = every .py file
    doc: str                    # filename under docs/
    extract: Callable[[ast.AST], List[Tuple[str, ast.AST]]]
    what: str                   # human name of the extracted thing


CONTRACTS: Tuple[Contract, ...] = (
    Contract(
        name="env-knob",
        file_suffix=None,
        doc="api.md",
        extract=_extract_env_knobs,
        what="env knob",
    ),
    Contract(
        name="metric-name",
        file_suffix="telemetry/metrics.py",
        doc="OBSERVABILITY.md",
        extract=_extract_metric_names,
        what="metric",
    ),
    Contract(
        name="doctor-rule-id",
        file_suffix="telemetry/doctor.py",
        doc="OBSERVABILITY.md",
        extract=_extract_doctor_rule_ids,
        what="doctor rule id",
    ),
    Contract(
        name="ledger-field",
        file_suffix="telemetry/ledger.py",
        doc="OBSERVABILITY.md",
        extract=_extract_ledger_fields,
        what="ledger digest field",
    ),
    Contract(
        name="fault-kind",
        file_suffix="faultline/schedule.py",
        doc="FAULTS.md",
        extract=_extract_fault_kinds,
        what="FaultSchedule rule kind",
    ),
)


def _find_docs_dir(path: str) -> Optional[str]:
    """Nearest ancestor ``docs/`` directory containing at least one of
    the contract docs — so a fixture tree carrying its own docs/ is
    self-contained and the real package resolves to the repo's."""
    cur = os.path.dirname(os.path.abspath(path))
    wanted = {c.doc for c in CONTRACTS}
    for _ in range(16):
        candidate = os.path.join(cur, "docs")
        if os.path.isdir(candidate):
            try:
                names = set(os.listdir(candidate))
            except OSError:
                names = set()
            if names & wanted:
                return candidate
        parent = os.path.dirname(cur)
        if parent == cur:
            break
        cur = parent
    return None


class ContractDriftRule(Rule):
    name = "contract-drift"
    code = "SNAP009"
    description = (
        "Cross-artifact consistency: env knobs documented in "
        "docs/api.md, metric names and doctor rule ids and ledger "
        "digest fields in docs/OBSERVABILITY.md, fault-schedule kinds "
        "in docs/FAULTS.md."
    )

    def __init__(self) -> None:
        self._doc_cache: Dict[str, Optional[str]] = {}

    def _doc_text(self, docs_dir: str, doc: str) -> Optional[str]:
        key = os.path.join(docs_dir, doc)
        if key not in self._doc_cache:
            try:
                with open(key, "r", encoding="utf-8") as f:
                    self._doc_cache[key] = f.read()
            except OSError:
                self._doc_cache[key] = None
        return self._doc_cache[key]

    def check(
        self, tree: ast.AST, lines: Sequence[str], path: str
    ) -> List[Diagnostic]:
        norm = os.path.normpath(path).replace(os.sep, "/")
        applicable = [
            c
            for c in CONTRACTS
            if c.file_suffix is None or norm.endswith(c.file_suffix)
        ]
        extracted = [
            (c, c.extract(tree)) for c in applicable
        ]
        if not any(items for _, items in extracted):
            return []
        docs_dir = _find_docs_dir(path)
        diags: List[Diagnostic] = []
        for contract, items in extracted:
            if not items:
                continue
            if docs_dir is None:
                diags.append(
                    Diagnostic(
                        rule=self.name,
                        code=self.code,
                        path=path,
                        line=items[0][1].lineno
                        if hasattr(items[0][1], "lineno")
                        else 1,
                        col=0,
                        message=(
                            f"{contract.what} '{items[0][0]}' has no "
                            f"reachable docs/ tree to check against "
                            f"(expected docs/{contract.doc} in an "
                            f"ancestor directory)."
                        ),
                    )
                )
                continue
            text = self._doc_text(docs_dir, contract.doc)
            if text is None:
                diags.append(
                    Diagnostic(
                        rule=self.name,
                        code=self.code,
                        path=path,
                        line=getattr(items[0][1], "lineno", 1),
                        col=0,
                        message=(
                            f"docs/{contract.doc} is missing but "
                            f"{norm} declares {contract.what}s "
                            f"(e.g. '{items[0][0]}')."
                        ),
                    )
                )
                continue
            for value, node in items:
                if value in text:
                    continue
                diags.append(
                    self.diag(
                        path,
                        node,
                        f"{contract.what} '{value}' is not documented "
                        f"in docs/{contract.doc} — the contract "
                        f"surface must not drift from its doc "
                        f"({contract.name}).",
                    )
                )
        return diags
