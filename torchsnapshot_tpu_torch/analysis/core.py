"""snapcheck core: diagnostics, rule protocol, suppressions, baseline, runner.

The analyzer's own logic is deliberately dependency-free (stdlib ``ast``
and ``tokenize`` only) — no device, no network, no accelerator stack at
analysis time. (Importing it still imports the parent package, so run it
where the repo's dependencies are installed; the CI job and the pytest
gate both are.) Each rule is a small visitor over one file's AST; the
framework owns everything rule-independent:

- **Suppressions** — ``# snapcheck: disable=<rule>[,<rule>...]`` on the
  flagged line (or alone on the line directly above it) silences a single
  finding; ``# snapcheck: disable-file=<rule>`` anywhere in a file silences
  the rule for the whole file; ``all`` matches every rule. Suppressions are
  expected to carry a justification after ``--``, e.g.
  ``# snapcheck: disable=swallowed-exception -- best-effort probe``.
- **Baseline** — a JSON file of fingerprinted pre-existing findings
  (rule + path + source-line hash, so ordinary line drift does not
  invalidate it). Findings present in the baseline are reported separately
  and do not fail the gate; new findings still do.
- **Machine-readable output** — every diagnostic carries rule id, numeric
  code, file, line, column, and message.
"""

import ast
import hashlib
import io
import json
import os
import re
import tokenize
from dataclasses import asdict, dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# The directive may share a comment with other markers
# ("# pragma: no cover; snapcheck: disable=..."), so anchor on a '#'
# anywhere earlier in the line rather than immediately before it. The
# rule list tolerates spaces around commas ("disable=a, b"); a "--"
# always terminates it (justification), even with no space before it.
_SUPPRESS_RE = re.compile(
    r"#.*?\bsnapcheck:\s*disable(?P<scope>-file)?\s*=\s*"
    r"(?P<rules>[A-Za-z0-9_-]+(?:\s*,\s*[A-Za-z0-9_-]+)*)"
)


@dataclass
class Diagnostic:
    """One finding: ``rule`` is the human id ("blocking-sync"), ``code``
    the stable numeric id ("SNAP001")."""

    rule: str
    code: str
    path: str
    line: int
    col: int
    message: str

    def format(self) -> str:
        return (
            f"{self.path}:{self.line}:{self.col}: "
            f"{self.code} [{self.rule}] {self.message}"
        )

    def to_dict(self) -> Dict[str, object]:
        return asdict(self)


class Rule:
    """Base class for snapcheck rules.

    Subclasses set ``name``/``code``/``description`` and implement
    :meth:`check`. ``applies_to`` lets module-scoped rules (determinism,
    lockset) skip files cheaply.
    """

    name: str = ""
    code: str = ""
    description: str = ""

    def applies_to(self, path: str) -> bool:
        return True

    def check(
        self, tree: ast.AST, lines: Sequence[str], path: str
    ) -> List[Diagnostic]:
        raise NotImplementedError

    def diag(
        self, path: str, node: ast.AST, message: str
    ) -> Diagnostic:
        return Diagnostic(
            rule=self.name,
            code=self.code,
            path=path,
            line=getattr(node, "lineno", 1),
            col=getattr(node, "col_offset", 0),
            message=message,
        )


# --------------------------------------------------------------- suppressions


@dataclass
class _Suppressions:
    # line -> set of rule names silenced on that line
    by_line: Dict[int, set] = field(default_factory=dict)
    file_wide: set = field(default_factory=set)

    def matches(self, diag: "Diagnostic") -> bool:
        # Directives may name the rule ("swallowed-exception") or its
        # code ("SNAP003") — diagnostics print the code first, so that
        # is what developers copy out of a CI failure.
        keys = {diag.rule, diag.code, "all"}
        if keys & self.file_wide:
            return True
        rules = self.by_line.get(diag.line)
        return rules is not None and bool(keys & rules)


def _parse_suppressions(
    source: str, lines: Sequence[str]
) -> _Suppressions:
    # Tokenize rather than regex over raw lines: a directive quoted in a
    # docstring or string literal (e.g. documentation of the suppression
    # syntax itself) must not silence anything — only real comments count.
    sup = _Suppressions()
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type != tokenize.COMMENT:
                continue
            m = _SUPPRESS_RE.search(tok.string)
            if m is None:
                continue
            # No rule id contains "--", so a justification glued on
            # without a space ("disable=rule--why") is still cut off
            # rather than silently failing to match any rule.
            rules = {
                s
                for r in m.group("rules").split(",")
                if (s := r.split("--", 1)[0].strip())
            }
            if m.group("scope"):
                sup.file_wide |= rules
                continue
            row, col = tok.start
            target = row
            # A comment-only line suppresses the next line instead.
            if lines[row - 1][:col].strip() == "":
                target = row + 1
            sup.by_line.setdefault(target, set()).update(rules)
    except (tokenize.TokenError, IndentationError):
        # Unterminated constructs etc.: keep the suppressions found so
        # far; the file already parsed with ast, so this is rare.
        pass
    return sup


# ------------------------------------------------------------------ baseline


def fingerprint(diag: Diagnostic, lines: Sequence[str]) -> str:
    """Line-drift-tolerant identity: rule + normalized path + a hash of
    the flagged source line's text (not its number)."""
    text = ""
    if 1 <= diag.line <= len(lines):
        text = lines[diag.line - 1].strip()
    digest = hashlib.sha1(text.encode("utf-8", "replace")).hexdigest()[:12]
    # Normalize the path spelling, not just the separators: the baseline
    # must keep matching when the analyzer is invoked as `pkg/`, `./pkg`,
    # or an absolute path to the same tree.
    norm = os.path.normpath(diag.path)
    if os.path.isabs(norm):
        try:
            rel = os.path.relpath(norm)
            if not rel.startswith(".."):
                norm = rel
        except ValueError:
            pass
    norm = norm.replace(os.sep, "/")
    return f"{diag.rule}::{norm}::{digest}"


def load_baseline(path: str) -> Dict[str, int]:
    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    entries = doc.get("entries", {})
    if not isinstance(entries, dict):
        raise ValueError(f"Malformed baseline file {path!r}: no entries map")
    return {str(k): int(v) for k, v in entries.items()}


def save_baseline(path: str, fingerprints: Iterable[str]) -> None:
    counts: Dict[str, int] = {}
    for fp in fingerprints:
        counts[fp] = counts.get(fp, 0) + 1
    doc = {"version": 1, "entries": dict(sorted(counts.items()))}
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")


# -------------------------------------------------------------------- runner


@dataclass
class FileResult:
    path: str
    diagnostics: List[Diagnostic]
    suppressed: List[Diagnostic]
    fingerprints: Dict[int, str]  # index into diagnostics -> fingerprint
    error: Optional[str] = None


def analyze_source(
    source: str, path: str, rules: Sequence[Rule]
) -> FileResult:
    lines = source.splitlines()
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return FileResult(
            path=path,
            diagnostics=[],
            suppressed=[],
            fingerprints={},
            error=f"syntax error: {e.msg} (line {e.lineno})",
        )
    sup = _parse_suppressions(source, lines)
    kept: List[Diagnostic] = []
    silenced: List[Diagnostic] = []
    for rule in rules:
        if not rule.applies_to(path):
            continue
        for diag in rule.check(tree, lines, path):
            if sup.matches(diag):
                silenced.append(diag)
            else:
                kept.append(diag)
    kept.sort(key=lambda d: (d.line, d.col, d.code))
    fps = {i: fingerprint(d, lines) for i, d in enumerate(kept)}
    return FileResult(
        path=path,
        diagnostics=kept,
        suppressed=silenced,
        fingerprints=fps,
    )


def analyze_file(path: str, rules: Sequence[Rule]) -> FileResult:
    try:
        with open(path, "r", encoding="utf-8") as f:
            source = f.read()
    except (OSError, UnicodeDecodeError) as e:
        # Unreadable files fail the gate as a reported error (like a
        # syntax error) instead of crashing the whole run — they cannot
        # be proven clean.
        return FileResult(
            path=path,
            diagnostics=[],
            suppressed=[],
            fingerprints={},
            error=f"unreadable: {e}",
        )
    return analyze_source(source, path, rules)


def iter_python_files(paths: Sequence[str]) -> List[str]:
    found: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = sorted(
                    d for d in dirnames if d != "__pycache__"
                )
                for name in sorted(filenames):
                    if name.endswith(".py"):
                        found.append(os.path.join(dirpath, name))
        elif p.endswith(".py"):
            found.append(p)
        else:
            raise FileNotFoundError(f"Not a Python file or directory: {p}")
    return found


@dataclass
class RunResult:
    violations: List[Diagnostic]
    baselined: List[Diagnostic]
    suppressed: List[Diagnostic]
    errors: List[Tuple[str, str]]  # (path, message)
    fingerprints: List[str]  # of every violation incl. baselined
    # Baseline entries that matched no current finding (count left
    # over). Stale entries are baseline rot: the finding was fixed (or
    # the code deleted) but the mask lives on, ready to hide the next
    # regression at the same fingerprint.
    stale_baseline: Dict[str, int] = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.violations and not self.errors


def run(
    paths: Sequence[str],
    rules: Sequence[Rule],
    baseline: Optional[Dict[str, int]] = None,
) -> RunResult:
    violations: List[Diagnostic] = []
    baselined: List[Diagnostic] = []
    suppressed: List[Diagnostic] = []
    errors: List[Tuple[str, str]] = []
    all_fps: List[str] = []
    remaining = dict(baseline or {})
    for path in iter_python_files(paths):
        result = analyze_file(path, rules)
        if result.error is not None:
            errors.append((path, result.error))
            continue
        suppressed.extend(result.suppressed)
        for i, diag in enumerate(result.diagnostics):
            fp = result.fingerprints[i]
            all_fps.append(fp)
            if remaining.get(fp, 0) > 0:
                remaining[fp] -= 1
                baselined.append(diag)
            else:
                violations.append(diag)
    return RunResult(
        violations=violations,
        baselined=baselined,
        suppressed=suppressed,
        errors=errors,
        fingerprints=all_fps,
        stale_baseline={
            fp: n for fp, n in sorted(remaining.items()) if n > 0
        },
    )


# ----------------------------------------------------------- shared AST utils


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for Attribute/Name chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def import_aliases(tree: ast.AST, module: str) -> set:
    """Local names bound to ``module`` by import statements.

    ``import numpy as np`` -> {"np"}; ``import numpy`` -> {"numpy"}.
    Submodule imports (``import numpy.random as r``) count when the root
    module matches.
    """
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                root = alias.name.split(".")[0]
                if root == module:
                    names.add(alias.asname or root)
    return names


def imported_names(tree: ast.AST, module: str) -> set:
    """Names bound by ``from <module> import x [as y]``."""
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module:
            if node.module.split(".")[0] == module:
                for alias in node.names:
                    names.add(alias.asname or alias.name)
    return names
