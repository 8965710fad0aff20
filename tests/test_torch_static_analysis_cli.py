"""The port's snapcheck CLI (``python -m torchsnapshot_tpu_torch.analysis``):
the cases of ``tests/test_static_analysis.py`` that read its output
formats, rule filters and usage errors. The one run over the whole port
tree is ``test_cli_clean_on_package``; every other case points at the
shared fixture corpus, since what it tests is the CLI. Each call starts a
process that imports the port (and with it PyTorch)."""

import json
import os
import subprocess
import sys

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(TESTS_DIR, "analysis_fixtures")
REPO_ROOT = os.path.dirname(TESTS_DIR)
PACKAGE = os.path.join(REPO_ROOT, "torchsnapshot_tpu_torch")


def run_cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "torchsnapshot_tpu_torch.analysis", *args],
        capture_output=True,
        text=True,
        cwd=REPO_ROOT,
        timeout=120,
    )


def test_cli_clean_on_package():
    proc = run_cli(PACKAGE)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 violation(s)" in proc.stdout


def test_cli_dirty_on_fixture_corpus_json():
    proc = run_cli("--format", "json", FIXTURES)
    assert proc.returncode == 1
    doc = json.loads(proc.stdout)
    assert doc["ok"] is False
    codes = {v["code"] for v in doc["violations"]}
    assert codes == {
        "SNAP001", "SNAP002", "SNAP003", "SNAP004", "SNAP005",
        "SNAP006", "SNAP007", "SNAP008", "SNAP009", "SNAP010",
        "SNAP011", "SNAP012", "SNAP013",
    }
    sample = doc["violations"][0]
    # Machine-readable contract: rule id, stable code, location, message.
    assert set(sample) >= {"rule", "code", "path", "line", "col", "message"}


def test_cli_rule_filter_and_usage_errors():
    only_async = run_cli("--rules", "blocking-sync", FIXTURES)
    assert only_async.returncode == 1
    assert "SNAP001" in only_async.stdout
    assert "SNAP003" not in only_async.stdout
    bad_rule = run_cli("--rules", "no-such-rule", FIXTURES)
    assert bad_rule.returncode == 2
    # A nonexistent directory is a usage error; a nonexistent .py file
    # is reported like any unreadable file and fails the gate.
    missing_dir = run_cli("/no/such/dir")
    assert missing_dir.returncode == 2
    missing_file = run_cli("/no/such/path.py")
    assert missing_file.returncode == 1
    assert "unreadable" in missing_file.stdout


def test_cli_list_rules():
    proc = run_cli("--list-rules")
    assert proc.returncode == 0
    for code in (
        "SNAP001", "SNAP002", "SNAP003", "SNAP004", "SNAP005",
        "SNAP006", "SNAP007", "SNAP008", "SNAP009", "SNAP010",
        "SNAP011", "SNAP012", "SNAP013",
    ):
        assert code in proc.stdout


def test_cli_sarif_output_shape():
    proc = run_cli(
        "--format", "sarif",
        os.path.join(FIXTURES, "bad_lifecycle.py"),
    )
    assert proc.returncode == 1
    doc = json.loads(proc.stdout)
    assert doc["version"] == "2.1.0"
    run0 = doc["runs"][0]
    driver = run0["tool"]["driver"]
    assert driver["name"] == "snapcheck"
    rule_ids = {r["id"] for r in driver["rules"]}
    assert "SNAP006" in rule_ids
    results = run0["results"]
    assert results, "expected findings in SARIF results"
    sample = results[0]
    assert sample["ruleId"].startswith("SNAP")
    assert sample["level"] == "error"
    loc = sample["locations"][0]["physicalLocation"]
    assert loc["artifactLocation"]["uri"].endswith("bad_lifecycle.py")
    assert loc["region"]["startLine"] >= 1


def test_cli_sarif_clean_exits_zero():
    proc = run_cli(
        "--format", "sarif",
        os.path.join(FIXTURES, "good_lifecycle.py"),
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    doc = json.loads(proc.stdout)
    assert doc["runs"][0]["results"] == []
