"""The port's snapcheck CLI: ``--changed-only`` over a ``tmp_path`` git
repository, and ``--max-suppressions``. The cases of
``tests/test_static_analysis.py`` on the port's analyzer, pointed at
``tmp_path`` trees."""

import json
import os
import subprocess
import sys

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_ROOT = os.path.dirname(TESTS_DIR)


def run_cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "torchsnapshot_tpu_torch.analysis", *args],
        capture_output=True,
        text=True,
        cwd=REPO_ROOT,
        timeout=120,
    )


def _git(cwd, *args):
    return subprocess.run(
        ["git", *args],
        cwd=cwd,
        capture_output=True,
        text=True,
        timeout=60,
        env={
            **os.environ,
            "GIT_AUTHOR_NAME": "t",
            "GIT_AUTHOR_EMAIL": "t@t",
            "GIT_COMMITTER_NAME": "t",
            "GIT_COMMITTER_EMAIL": "t@t",
        },
    )


def run_cli_in(cwd, *args):
    env = dict(os.environ)
    # The tmp repo is outside the source tree; keep the package
    # importable without an install.
    env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", "torchsnapshot_tpu_torch.analysis", *args],
        capture_output=True,
        text=True,
        cwd=cwd,
        env=env,
        timeout=120,
    )


def test_cli_changed_only(tmp_path):
    repo = tmp_path / "repo"
    repo.mkdir()
    assert _git(repo, "init", "-q").returncode == 0
    committed = repo / "committed.py"
    committed.write_text(
        "def swallow(op):\n"
        "    try:\n"
        "        return op()\n"
        "    except Exception:\n"
        "        return None\n"
    )
    _git(repo, "add", ".")
    assert _git(repo, "commit", "-q", "-m", "seed").returncode == 0

    # Nothing changed vs HEAD: exit 0 even though committed.py is dirty
    # by SNAP003 — the fast pre-commit path only lints the diff.
    clean = run_cli_in(repo, "--changed-only", "HEAD", ".")
    assert clean.returncode == 0, clean.stdout + clean.stderr
    assert "nothing to analyze" in clean.stdout

    # An untracked new file with a finding fails; the committed file's
    # pre-existing finding still does not enter the run.
    newfile = repo / "new.py"
    newfile.write_text(
        "import time\n"
        "async def f():\n"
        "    time.sleep(1)\n"
    )
    dirty = run_cli_in(repo, "--changed-only", "HEAD", ".")
    assert dirty.returncode == 1
    assert "new.py" in dirty.stdout
    assert "committed.py" not in dirty.stdout

    # A bad ref is a usage error.
    bad_ref = run_cli_in(repo, "--changed-only", "no-such-ref", ".")
    assert bad_ref.returncode == 2


def test_cli_changed_only_sees_untracked_files_from_subdir(tmp_path):
    # `git ls-files --others` is cwd-relative; run from a subdirectory
    # the untracked file must still be joined to the repo root
    # correctly, or the pre-commit gate silently passes a violation.
    repo = tmp_path / "repo"
    sub = repo / "sub"
    sub.mkdir(parents=True)
    assert _git(repo, "init", "-q").returncode == 0
    (repo / "seed.py").write_text("X = 1\n")
    _git(repo, "add", ".")
    assert _git(repo, "commit", "-q", "-m", "seed").returncode == 0
    (sub / "new.py").write_text(
        "import time\n"
        "async def f():\n"
        "    time.sleep(1)\n"
    )
    dirty = run_cli_in(sub, "--changed-only", "HEAD", ".")
    assert dirty.returncode == 1, dirty.stdout + dirty.stderr
    assert "new.py" in dirty.stdout


def test_cli_max_suppressions_gate(tmp_path):
    target = tmp_path / "suppressed_only.py"
    target.write_text(
        "def swallow(op):\n"
        "    try:\n"
        "        return op()\n"
        "    except Exception:  # snapcheck: disable=SNAP003 -- probe\n"
        "        return None\n"
    )
    ok = run_cli("--max-suppressions", "1", str(target))
    assert ok.returncode == 0, ok.stdout + ok.stderr
    blown = run_cli("--max-suppressions", "0", str(target))
    assert blown.returncode == 1
    assert "--max-suppressions" in blown.stderr
    # JSON `ok` must agree with the exit status when a gate trips.
    blown_json = run_cli(
        "--format", "json", "--max-suppressions", "0", str(target)
    )
    assert blown_json.returncode == 1
    assert json.loads(blown_json.stdout)["ok"] is False
