"""The port's snapcheck CLI and its baselines: written with
``--write-baseline``, matched across path spellings, marked in SARIF, and
gone stale under ``--fail-stale-baseline``. The cases of
``tests/test_static_analysis.py`` on the port's analyzer, pointed at the
shared fixture corpus."""

import json
import os
import subprocess
import sys

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(TESTS_DIR, "analysis_fixtures")
REPO_ROOT = os.path.dirname(TESTS_DIR)


def run_cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "torchsnapshot_tpu_torch.analysis", *args],
        capture_output=True,
        text=True,
        cwd=REPO_ROOT,
        timeout=120,
    )


def test_baseline_matches_across_path_spellings(tmp_path):
    # A baseline written via `pkg/file.py` must keep matching when the
    # gate is later invoked as `./pkg/file.py` or an absolute path —
    # otherwise every baselined finding reappears on a CI that spells
    # the target differently than the bootstrap did.
    baseline = str(tmp_path / "baseline.json")
    rel = os.path.relpath(
        os.path.join(FIXTURES, "bad_swallowed.py"), REPO_ROOT
    )
    wrote = run_cli("--write-baseline", baseline, rel)
    assert wrote.returncode == 0, wrote.stdout + wrote.stderr
    for spelling in (os.path.join(".", rel), os.path.join(REPO_ROOT, rel)):
        gated = run_cli("--baseline", baseline, spelling)
        assert gated.returncode == 0, (
            f"{spelling}: {gated.stdout}{gated.stderr}"
        )



# CLI


def test_cli_baseline_roundtrip(tmp_path):
    bad = os.path.join(FIXTURES, "bad_durability.py")
    baseline = str(tmp_path / "baseline.json")
    wrote = run_cli("--write-baseline", baseline, bad)
    assert wrote.returncode == 0
    gated = run_cli("--baseline", baseline, bad)
    assert gated.returncode == 0
    assert "2 baselined" in gated.stdout


def test_cli_sarif_baselined_findings_marked(tmp_path):
    bad = os.path.join(FIXTURES, "bad_swallowed.py")
    baseline = str(tmp_path / "baseline.json")
    assert run_cli("--write-baseline", baseline, bad).returncode == 0
    proc = run_cli("--format", "sarif", "--baseline", baseline, bad)
    assert proc.returncode == 0
    results = json.loads(proc.stdout)["runs"][0]["results"]
    assert results
    assert all(r["baselineState"] == "unchanged" for r in results)
    assert all(r["level"] == "note" for r in results)


def test_cli_fail_stale_baseline(tmp_path):
    bad = os.path.join(FIXTURES, "bad_swallowed.py")
    clean = os.path.join(FIXTURES, "good_swallowed.py")
    baseline = str(tmp_path / "baseline.json")
    assert run_cli("--write-baseline", baseline, bad).returncode == 0

    # The baseline's findings no longer match anything when run against
    # the clean file: without the flag that is tolerated...
    tolerated = run_cli("--baseline", baseline, clean)
    assert tolerated.returncode == 0
    # ...with the flag it is baseline rot and fails.
    stale = run_cli("--fail-stale-baseline", "--baseline", baseline, clean)
    assert stale.returncode == 1
    assert "stale baseline" in stale.stderr

    # A fully-consumed baseline passes the drift check.
    fresh = run_cli("--fail-stale-baseline", "--baseline", baseline, bad)
    assert fresh.returncode == 0, fresh.stdout + fresh.stderr
