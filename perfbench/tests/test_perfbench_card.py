"""One short run of a cell on the card (skips on a host without CUDA).

On the card: ``python3 -m pytest --noconftest perfbench/tests/test_perfbench_card.py -q``.
"""

import json
import subprocess
import sys

import pytest
import torch

from perfbench import harness


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
