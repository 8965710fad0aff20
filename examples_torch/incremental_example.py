"""Incremental checkpointing: pay for changed bytes only.

The port of ``examples/incremental_example.py``: a LoRA-style fine-tune
(a frozen backbone, a small trainable adapter) checkpointed every
"epoch" through CheckpointManager's incremental mode. The frozen
backbone is fingerprinted on the device at each save (on a card by the
xs128 kernel K4) and never re-transferred or re-written; each step's
snapshot references the first writer's objects, restores bit-exactly,
and retention understands the references. Each save prints the payload
bytes it wrote, the K4 launches it made and the leaves they
fingerprinted. Beside the steps,
``taken_state/`` keeps a host copy of the state each save saw.

Run:  PYTHONPATH=. python examples_torch/incremental_example.py [--work-dir DIR] [--device cpu]
"""

import argparse
import contextlib
import os
import tempfile
import time
from typing import List

import numpy as np
import torch

from torchsnapshot_tpu_torch import CheckpointManager, Snapshot, StateDict
from torchsnapshot_tpu_torch.ops import fingerprint as fops
from torchsnapshot_tpu_torch.utils.test_utils import record_taken_state


def expected_lines(device: str) -> List[str]:
    """The lines this script prints, as its JAX counterpart in ``examples/``
    prints them (on ``device``)."""
    return ["steps on disk: [1, 3, 4]", "OK: bit-exact restore from incremental chain"]


def payload_objects(root: str):
    """(count, bytes) of the payload objects a step wrote."""
    n = nbytes = 0
    for dirpath, _, files in os.walk(root):
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), root)
            if rel != ".snapshot_metadata" and not rel.startswith(
                (".completed", ".steps", ".pruning", "refs")
            ):
                n += 1
                nbytes += os.path.getsize(os.path.join(dirpath, f))
    return n, nbytes


@contextlib.contextmanager
def _work_dir(work_dir):
    """The given directory, kept; else a temporary one."""
    if work_dir is not None:
        os.makedirs(work_dir, exist_ok=True)
        yield work_dir
        return
    with tempfile.TemporaryDirectory() as root:
        yield root


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--work-dir", default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    device = torch.device(args.device)

    rng = np.random.default_rng(0)
    backbone = torch.from_numpy(rng.standard_normal((1024, 1024), dtype=np.float32)).to(device)  # 4 MiB, frozen
    adapter_a = torch.from_numpy(rng.standard_normal((1024, 8), dtype=np.float32)).to(device)
    adapter_b = torch.from_numpy(rng.standard_normal((8, 1024), dtype=np.float32)).to(device)

    with _work_dir(args.work_dir) as root:
        mgr = CheckpointManager(root, max_to_keep=2, incremental=True, full_period=100)
        times = []
        for step in range(1, 5):
            # "training": only the adapter changes
            adapter_a = adapter_a + 0.1
            state = {
                "model": StateDict(backbone=backbone, lora_a=adapter_a, lora_b=adapter_b)
            }
            k4_before = (fops.fingerprint_box_launches, fops.fingerprint_box_segments)
            begin = time.monotonic()
            mgr.save(step, state)
            times.append(time.monotonic() - begin)
            record_taken_state(root, os.path.join(root, f"step-{step}"), state)
            n, nbytes = payload_objects(os.path.join(root, f"step-{step}"))
            print(
                f"step {step}: save {times[-1]:.3f}s, {n} payload object(s) "
                f"written, {nbytes} bytes, "
                f"{fops.fingerprint_box_launches - k4_before[0]} K4 launch(es) over "
                f"{fops.fingerprint_box_segments - k4_before[1]} leaves"
            )

        print(f"steps on disk: {mgr.all_steps()}")
        fresh = {
            "model": StateDict(
                backbone=torch.zeros_like(backbone),
                lora_a=torch.zeros_like(adapter_a),
                lora_b=torch.zeros_like(adapter_b),
            )
        }
        restored_step = mgr.restore(fresh)
        assert restored_step == 4
        assert torch.equal(fresh["model"]["backbone"], backbone)
        assert torch.equal(fresh["model"]["lora_a"], adapter_a)
        latest = Snapshot(os.path.join(root, "step-4"))
        assert latest.verify() == {}
        speedup = times[0] / min(times[1:])
        print(
            f"OK: bit-exact restore from incremental chain; "
            f"full {times[0]:.3f}s vs best incremental "
            f"{min(times[1:]):.3f}s ({speedup:.1f}x)"
        )


if __name__ == "__main__":
    main()
