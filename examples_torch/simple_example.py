"""Checkpoint/resume demo: train, snapshot, perturb, restore, verify.

The port of ``examples/simple_example.py``: an epoch-loop training
program that snapshots its full app state (model parameters, Adam's
state, progress counters, host RNG) every epoch and resumes bit-exactly
from a snapshot. Beside the snapshots, ``taken_state/`` keeps a host copy
of the state each take saw.

Run:  PYTHONPATH=. python examples_torch/simple_example.py [--work-dir DIR] [--device cpu]
"""

import argparse
import tempfile
from typing import List

import numpy as np
import torch

from torchsnapshot_tpu_torch import RNGState, Snapshot, StateDict
from torchsnapshot_tpu_torch.utils.test_utils import check_state_dict_eq, record_taken_state


def expected_lines(device: str) -> List[str]:
    """The lines this script prints, as its JAX counterpart in ``examples/``
    prints them (on ``device``)."""
    return ["OK: bit-exact resume (params, optimizer, progress, host RNG)"]


class TrainState:
    """A Stateful bundling the parameters and the optimizer's state."""

    def __init__(self, params, lr=1e-2):
        self.params = params
        self.opt = torch.optim.Adam(list(_leaves(params)), lr=lr)
        # optax.adam's init: zero moments at step 0, so a fresh state has
        # every leaf a snapshot of a trained one holds.
        for p in _leaves(params):
            self.opt.state[p] = {
                "step": torch.tensor(0.0),
                "exp_avg": torch.zeros_like(p),
                "exp_avg_sq": torch.zeros_like(p),
            }

    def state_dict(self):
        return {"params": self.params, "opt_state": self.opt.state_dict()}

    def load_state_dict(self, sd):
        # The parameters are restored in place (the optimizer holds them).
        with torch.no_grad():
            for p, q in zip(_leaves(self.params), _leaves(sd["params"])):
                if p is not q:
                    p.copy_(q)
        self.opt.load_state_dict(sd["opt_state"])


def _leaves(params):
    return [params[layer][name] for layer in ("linear", "head") for name in ("w", "b")]


def init_params(seed, device):
    g = torch.Generator().manual_seed(seed)
    params = {
        "linear": {"w": torch.randn(32, 16, generator=g) * 0.1, "b": torch.zeros(16)},
        "head": {"w": torch.randn(16, 1, generator=g) * 0.1, "b": torch.zeros(1)},
    }
    return {
        layer: {k: v.to(device).requires_grad_() for k, v in leaves.items()}
        for layer, leaves in params.items()
    }


def loss_fn(params, x, y):
    h = torch.tanh(x @ params["linear"]["w"] + params["linear"]["b"])
    pred = h @ params["head"]["w"] + params["head"]["b"]
    return torch.mean((pred - y) ** 2)


def train_epoch(state, device):
    x = torch.from_numpy(np.random.randn(64, 32).astype(np.float32)).to(device)  # host RNG
    y = torch.from_numpy(np.random.randn(64, 1).astype(np.float32)).to(device)
    state.opt.zero_grad()
    loss_fn(state.params, x, y).backward()
    state.opt.step()
    with torch.no_grad():
        return float(loss_fn(state.params, x, y))


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--work-dir", default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    work_dir = args.work_dir or tempfile.mkdtemp(prefix="tpusnapshot-demo-")
    device = torch.device(args.device)

    state = TrainState(init_params(0, device))
    progress = StateDict(epoch=0)
    app_state = {"train": state, "progress": progress, "rng": RNGState()}

    np.random.seed(0)
    snap_path = None
    for epoch in range(4):
        loss = train_epoch(state, device)
        progress["epoch"] = epoch + 1
        snap_path = f"{work_dir}/epoch-{epoch}"
        Snapshot.take(snap_path, app_state)
        record_taken_state(work_dir, snap_path, app_state)
        print(f"epoch {epoch}: loss={loss:.5f}  -> snapshot {snap_path}")

    # Ground truth: two more epochs from here.
    saved_params = {k: {n: t.detach().cpu().clone() for n, t in v.items()}
                    for k, v in state.params.items()}
    expected_losses = [train_epoch(state, device) for _ in range(2)]

    # Simulate a failure: reinitialize everything differently.
    state2 = TrainState(init_params(999, device))
    progress2 = StateDict(epoch=-1)
    app_state2 = {"train": state2, "progress": progress2, "rng": RNGState()}
    np.random.seed(12345)

    Snapshot(snap_path).restore(app_state2)
    assert progress2["epoch"] == 4, progress2
    assert check_state_dict_eq(
        {k: {n: t.detach().cpu() for n, t in v.items()} for k, v in state2.params.items()},
        saved_params,
        exact=True,
    ), "restored params are not bit-identical"

    # Resume: the two post-restore epochs must reproduce the exact losses
    # (params + optimizer state + host RNG all restored).
    resumed_losses = [train_epoch(state2, device) for _ in range(2)]
    print(f"expected losses: {expected_losses}")
    print(f"resumed  losses: {resumed_losses}")
    assert resumed_losses == expected_losses, "resume is not bit-exact"
    print("OK: bit-exact resume (params, optimizer, progress, host RNG)")


if __name__ == "__main__":
    main()
