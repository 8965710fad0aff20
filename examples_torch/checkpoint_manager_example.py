"""Checkpoint lifecycle demo: CheckpointManager over a training loop.

The port of ``examples/checkpoint_manager_example.py``: step-indexed
async saves, retention pruning (``max_to_keep=2``), and crash-resume
from the latest COMMITTED step. Beside the run, ``taken_state/`` keeps a
host copy of the state each save saw.

Run:  PYTHONPATH=. python examples_torch/checkpoint_manager_example.py [--work-dir DIR] [--device cpu]
"""

import argparse
import tempfile
from typing import List

import numpy as np
import torch

from torchsnapshot_tpu_torch import CheckpointManager, StateDict
from torchsnapshot_tpu_torch.utils.test_utils import record_taken_state


def expected_lines(device: str) -> List[str]:
    """The lines this script prints, as its JAX counterpart in ``examples/``
    prints them (on ``device``)."""
    return [
        "committed steps (max_to_keep=2): [10, 20]",
        "resumed from step 20",
        "OK: resumed training continues",
    ]


def train_step(w, lr=0.1):
    # Toy quadratic: minimize ||w - target||^2.
    target = torch.arange(w.shape[0], dtype=w.dtype, device=w.device)
    grad = 2 * (w - target)
    return w - lr * grad


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--work-dir", default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    work_dir = args.work_dir or tempfile.mkdtemp(prefix="tpusnapshot-mgr-")
    base = work_dir + "/run"
    device = torch.device(args.device)
    mgr = CheckpointManager(base, max_to_keep=2)

    state = StateDict(w=torch.zeros(1024, dtype=torch.float32, device=device), step=0)

    pending = None
    for step in range(30):
        state["w"] = train_step(state["w"])
        state["step"] = step
        if step % 10 == 0:
            if pending is not None:
                pending.wait()
            pending = mgr.async_save(step, {"train": state})
            record_taken_state(work_dir, f"{base}/step-{step}", {"train": state})
            print(f"step {step:3d}: async save dispatched")
    if pending is not None:
        pending.wait()

    print(f"committed steps (max_to_keep=2): {mgr.all_steps()}")

    # Simulate a crash + resume in a fresh process: a new manager over
    # the same base path resumes from the latest committed step.
    resumed = StateDict(w=torch.zeros(1024, dtype=torch.float32, device=device), step=-1)
    restored_step = CheckpointManager(base).restore({"train": resumed})
    print(f"resumed from step {restored_step}")

    # Continue training from the restored state; loss keeps decreasing.
    target = np.arange(1024, dtype=np.float32)
    before = float(np.sum((resumed["w"].cpu().numpy() - target) ** 2))
    resumed["w"] = train_step(resumed["w"])
    after = float(np.sum((resumed["w"].cpu().numpy() - target) ** 2))
    assert after < before
    print(f"OK: resumed training continues (loss {before:.3f} -> {after:.3f})")


if __name__ == "__main__":
    main()
