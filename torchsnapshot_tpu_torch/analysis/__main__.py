"""CLI: ``python -m torchsnapshot_tpu_torch.analysis [paths...]``.

Exit status: 0 = clean (no violations beyond suppressions/baseline),
1 = violations, unparseable files, stale baseline entries (with
``--fail-stale-baseline``), or a blown ``--max-suppressions`` gate;
2 = usage error (unknown rule, unreadable baseline, bad ``--changed-only``
ref, nonexistent directory).
"""

import argparse
import json
import os
import subprocess
import sys
from typing import List, Optional, Set

from . import default_rules, select_rules
from .core import iter_python_files, load_baseline, run, save_baseline
from .sarif import to_sarif


def _changed_files(ref: str, paths: List[str]) -> List[str]:
    """Files under ``paths`` that differ from ``ref`` (committed diff +
    working tree + untracked), as git reports them. Raises
    ``RuntimeError`` on git failure (bad ref / not a repo)."""
    def _git(*args: str) -> List[str]:
        proc = subprocess.run(
            ["git", *args],
            capture_output=True,
            text=True,
            timeout=60,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                proc.stderr.strip() or f"git {' '.join(args)} failed"
            )
        return [line for line in proc.stdout.splitlines() if line]

    top = _git("rev-parse", "--show-toplevel")[0]
    # Run every listing from the repo toplevel: `diff --name-only` is
    # root-relative from anywhere, but `ls-files --others` is
    # cwd-relative — from a subdirectory its paths would be joined to
    # the toplevel as if root-relative and silently miss untracked
    # files.
    changed: Set[str] = set(
        _git("-C", top, "diff", "--name-only", ref, "--")
    )
    changed.update(
        _git("-C", top, "ls-files", "--others", "--exclude-standard")
    )
    changed_real = {
        os.path.realpath(os.path.join(top, c)) for c in changed
    }
    return [
        p
        for p in iter_python_files(paths)
        if os.path.realpath(p) in changed_real
    ]


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m torchsnapshot_tpu_torch.analysis",
        description=(
            "snapcheck: checkpoint-safety static analyzer for "
            "torchsnapshot_tpu_torch (see docs/ANALYSIS.md)"
        ),
    )
    parser.add_argument(
        "paths",
        nargs="*",
        default=["torchsnapshot_tpu_torch/"],
        help="Files or directories to analyze (default: torchsnapshot_tpu_torch/)",
    )
    parser.add_argument(
        "--format",
        choices=("text", "json", "sarif"),
        default="text",
        help=(
            "Diagnostic output format (sarif = SARIF 2.1.0 for CI "
            "PR-diff annotation)"
        ),
    )
    parser.add_argument(
        "--rules",
        default=None,
        help="Comma-separated rule names/codes to run (default: all)",
    )
    parser.add_argument(
        "--changed-only",
        default=None,
        metavar="REF",
        help=(
            "Lint only files that differ from the given git ref "
            "(committed diff + working tree + untracked) — the fast "
            "pre-commit path. A clean empty intersection exits 0."
        ),
    )
    parser.add_argument(
        "--baseline",
        default=None,
        metavar="FILE",
        help=(
            "JSON baseline of pre-existing findings; findings in it are "
            "reported as 'baselined' and do not fail the run"
        ),
    )
    parser.add_argument(
        "--fail-stale-baseline",
        action="store_true",
        help=(
            "Exit 1 when --baseline entries no longer match any "
            "finding (stale-baseline rot: a fixed finding's mask would "
            "otherwise silently cover the next regression)"
        ),
    )
    parser.add_argument(
        "--max-suppressions",
        type=int,
        default=None,
        metavar="N",
        help=(
            "Exit 1 when more than N findings are silenced by inline "
            "suppressions — the zero-new-suppressions CI gate pins N "
            "at the audited count, so adding one without review fails"
        ),
    )
    parser.add_argument(
        "--write-baseline",
        default=None,
        metavar="FILE",
        help=(
            "Write every current finding's fingerprint to FILE — "
            "bootstraps --baseline for a codebase with pre-existing "
            "findings. Exits 0 unless a file failed to parse (an "
            "unparseable file cannot be baselined)"
        ),
    )
    parser.add_argument(
        "--list-rules",
        action="store_true",
        help="Print the rule registry and exit",
    )
    parser.add_argument(
        "--inventory",
        action="store_true",
        help=(
            "Emit the wire-protocol inventory (ops, handlers, frame "
            "fields, retry classes, error kinds for every transport) "
            "and exit: markdown by default (docs/PROTOCOL.md is this, "
            "verbatim), JSON with --format json"
        ),
    )
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule in default_rules():
            print(f"{rule.code}  {rule.name}\n    {rule.description}")
        return 0

    if args.inventory:
        from .protocol import build_inventory, render_markdown

        inventory = build_inventory()
        if args.format == "json":
            print(json.dumps(inventory, indent=2, sort_keys=True))
        else:
            print(render_markdown(inventory), end="")
        return 0

    try:
        rules = select_rules(
            args.rules.split(",") if args.rules else None
        )
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    baseline = None
    if args.baseline is not None:
        try:
            baseline = load_baseline(args.baseline)
        except (OSError, ValueError, json.JSONDecodeError) as e:
            print(f"error: cannot read baseline: {e}", file=sys.stderr)
            return 2

    paths = args.paths
    if args.changed_only is not None:
        try:
            paths = _changed_files(args.changed_only, paths)
        except (RuntimeError, FileNotFoundError, OSError) as e:
            print(
                f"error: --changed-only {args.changed_only}: {e}",
                file=sys.stderr,
            )
            return 2
        if not paths:
            print(
                f"snapcheck: no files changed vs {args.changed_only}; "
                f"nothing to analyze"
            )
            return 0

    try:
        result = run(paths, rules, baseline=baseline)
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    if args.write_baseline is not None:
        save_baseline(args.write_baseline, result.fingerprints)
        # Unanalyzable files cannot be baselined (errors always fail a
        # gated run), so a bootstrap over them must say so loudly.
        for path, message in result.errors:
            print(
                f"{path}:1:0: SNAP000 [parse-error] {message} "
                f"(NOT baselined)",
                file=sys.stderr,
            )
        print(
            f"snapcheck: wrote {len(result.fingerprints)} finding(s) to "
            f"baseline {args.write_baseline}"
        )
        return 1 if result.errors else 0

    stale_failed = bool(
        args.fail_stale_baseline and result.stale_baseline
    )
    suppression_gate_failed = (
        args.max_suppressions is not None
        and len(result.suppressed) > args.max_suppressions
    )
    exit_code = (
        0
        if result.ok and not stale_failed and not suppression_gate_failed
        else 1
    )

    if args.format == "sarif":
        print(json.dumps(to_sarif(result, rules), indent=2))
    elif args.format == "json":
        doc = {
            "version": 1,
            "violations": [d.to_dict() for d in result.violations],
            "baselined": [d.to_dict() for d in result.baselined],
            "suppressed": len(result.suppressed),
            "stale_baseline": result.stale_baseline,
            "errors": [
                {"path": p, "message": m} for p, m in result.errors
            ],
            # Must agree with the exit status: a machine consumer
            # keying on `ok` must not read "passed" out of a run whose
            # stale-baseline/suppression gate tripped.
            "ok": exit_code == 0,
        }
        print(json.dumps(doc, indent=2, sort_keys=True))
    else:
        for diag in result.violations:
            print(diag.format())
        for path, message in result.errors:
            print(f"{path}:1:0: SNAP000 [parse-error] {message}")
        summary = (
            f"snapcheck: {len(result.violations)} violation(s), "
            f"{len(result.baselined)} baselined, "
            f"{len(result.suppressed)} suppressed"
        )
        if result.errors:
            summary += f", {len(result.errors)} unparseable file(s)"
        print(summary)

    # The gate diagnostics go to stderr in every format so a SARIF/JSON
    # consumer still sees WHY the exit code is 1.
    if stale_failed:
        for fp, n in result.stale_baseline.items():
            print(
                f"stale baseline entry ({n} unmatched): {fp}",
                file=sys.stderr,
            )
        print(
            f"snapcheck: {len(result.stale_baseline)} stale baseline "
            f"entr{'y' if len(result.stale_baseline) == 1 else 'ies'} — "
            f"regenerate with --write-baseline",
            file=sys.stderr,
        )
    if suppression_gate_failed:
        print(
            f"snapcheck: {len(result.suppressed)} suppressions exceed "
            f"--max-suppressions {args.max_suppressions}; new "
            f"suppressions need review (then bump the audited count)",
            file=sys.stderr,
        )
    return exit_code


if __name__ == "__main__":
    sys.exit(main())
