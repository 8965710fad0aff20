"""SARIF 2.1.0 serialization for snapcheck results.

SARIF (Static Analysis Results Interchange Format) is what CI code-
scanning surfaces ingest to annotate PR diffs inline. The emitter here
is deliberately minimal-but-valid: one run, the rule registry as
``tool.driver.rules``, one ``result`` per finding with a physical
location. Baselined findings are included at level ``note`` with
``baselineState: "unchanged"`` so the annotation layer can show them
dimmed instead of dropping the history; unparseable files become
tool-level ``notifications`` (they fail the gate, so they must not
vanish from the report).
"""

from typing import Any, Dict, List, Sequence

from .core import Diagnostic, Rule, RunResult

_SARIF_SCHEMA = (
    "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/master/"
    "Schemata/sarif-schema-2.1.0.json"
)


def _result(diag: Diagnostic, level: str, baseline_state: str = None
            ) -> Dict[str, Any]:
    out: Dict[str, Any] = {
        "ruleId": diag.code,
        "level": level,
        "message": {"text": f"[{diag.rule}] {diag.message}"},
        "locations": [
            {
                "physicalLocation": {
                    "artifactLocation": {
                        "uri": diag.path.replace("\\", "/"),
                    },
                    "region": {
                        "startLine": max(diag.line, 1),
                        "startColumn": diag.col + 1,
                    },
                }
            }
        ],
    }
    if baseline_state is not None:
        out["baselineState"] = baseline_state
    return out


def to_sarif(result: RunResult, rules: Sequence[Rule]) -> Dict[str, Any]:
    rule_descriptors: List[Dict[str, Any]] = [
        {
            "id": rule.code,
            "name": rule.name,
            "shortDescription": {"text": rule.description},
        }
        for rule in rules
    ]
    results: List[Dict[str, Any]] = []
    for diag in result.violations:
        results.append(_result(diag, "error"))
    for diag in result.baselined:
        results.append(_result(diag, "note", baseline_state="unchanged"))
    notifications: List[Dict[str, Any]] = [
        {
            "level": "error",
            "message": {"text": f"{path}: {message}"},
            "locations": [
                {
                    "physicalLocation": {
                        "artifactLocation": {
                            "uri": path.replace("\\", "/")
                        }
                    }
                }
            ],
        }
        for path, message in result.errors
    ]
    run: Dict[str, Any] = {
        "tool": {
            "driver": {
                "name": "snapcheck",
                "informationUri": (
                    "https://github.com/mary-lau/torchsnapshot"
                ),
                "rules": rule_descriptors,
            }
        },
        "results": results,
    }
    if notifications:
        run["invocations"] = [
            {
                "executionSuccessful": False,
                "toolExecutionNotifications": notifications,
            }
        ]
    return {
        "$schema": _SARIF_SCHEMA,
        "version": "2.1.0",
        "runs": [run],
    }
