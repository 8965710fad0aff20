"""Short runs on the card (each skips on a host without the CUDA devices it
needs).

On the card: ``python3 -m pytest --noconftest perfbench/tests/test_perfbench_card.py -q``.
"""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from perfbench import harness, ranks
from perfbench.tests import toy


@pytest.mark.cuda
def test_short_run_on_the_card_is_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "dlrm.train_resume", "--seed", "6000000001",
         "--seconds", "5", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert {"step_s", "peak_card_GB", "setup_s"} <= set(result["metrics"])


def _run_pids(seed: str):
    """Process ids of perfbench/run.py processes run with ``seed``."""
    found = {}
    for proc in Path("/proc").iterdir():
        if proc.name.isdigit():
            try:
                cmd = (proc / "cmdline").read_bytes().split(b"\0")
            except OSError:
                continue
            if any(c.endswith(b"perfbench/run.py") for c in cmd) and seed.encode() in cmd:
                rank = cmd[cmd.index(b"--rank") + 1].decode() if b"--rank" in cmd else "0"
                found[int(proc.name)] = int(rank)
    return found


@pytest.mark.cuda
def test_a_rank_killed_mid_window_ends_the_run():
    """SIGKILL to rank 2 of a four-card cell in mid-window: rank 0 prints no
    result within 300 s and leaves no process and no store behind."""
    cells = [c for c in toy.RANKED if harness.resolve(toy.SPEC, c)["cell"]["chips"] >= 3]
    if not cells or not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four NVIDIA GPUs")
    seed = "6000000002"
    before = set(Path(ranks.SHM_ROOT).glob("perfbench-*"))
    run = subprocess.Popen(
        [sys.executable, "perfbench/run.py", "--workload", cells[0], "--seed", seed, "--seconds", "51",
         "--trace", "0"], cwd=harness.ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    lines = []
    for line in run.stderr:
        lines.append(line)
        if line.startswith("window starts"):
            break
    else:
        pytest.fail("the window never started:\n" + "".join(lines[-20:]))
    time.sleep(15)
    victim = [pid for pid, rank in _run_pids(seed).items() if rank == 2]
    assert len(victim) == 1, _run_pids(seed)
    killed = time.monotonic()
    os.kill(victim[0], signal.SIGKILL)
    out, err = run.communicate(timeout=330)
    ended = time.monotonic() - killed
    print(f"rank 0 exited {run.returncode} {ended:.1f} s after the kill", file=sys.stderr)
    assert run.returncode != 0 and out.strip() == ""
    assert "no result: rank 2" in err, err[-3000:]
    assert ended < 300
    assert _run_pids(seed) == {} and set(Path(ranks.SHM_ROOT).glob("perfbench-*")) == before
