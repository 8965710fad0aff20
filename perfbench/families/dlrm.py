"""The port's DLRM as a benchmark job.

Builds ``torchsnapshot_tpu_torch.models.dlrm`` from a configuration file,
hands it the benchmark's seeded weights and batches, and trains it with the
port's ``sgd_momentum_train_step``. The app state checkpointed is
``{"model": DLRMState(params, momentum), "progress": StateDict(step)}``.
"""

from typing import Any, Dict, List, Optional

import torch

from perfbench.reference import dlrm as reference
from torchsnapshot_tpu_torch.models import dlrm
from torchsnapshot_tpu_torch.models.transformer import param_leaves
from torchsnapshot_tpu_torch.state_dict import StateDict

# Distinct batches a run draws; step i trains on batch i % BATCH_POOL.
BATCH_POOL = 512


def _tree(leaves: List[torch.Tensor], names: List[str], dm: Dict[str, Any]) -> Dict[str, Any]:
    it = iter(leaves)
    tables = {name: next(it) for name in names}

    def stack(widths):
        return [{"w": next(it), "b": next(it)} for _ in widths[1:]]

    return {"tables": tables, "bottom_mlp": stack(dm["bottom"]), "top_mlp": stack(dm["top"])}


class Job:
    reference = reference

    def __init__(self, config: Dict[str, Any], weight_seed: int, batch_seed: int, device: str) -> None:
        self.config = config
        self.dims = dm = reference.dims(config)
        self.names = [f"cat_{i}" for i in range(len(dm["rows"]))]
        self.cfg = dlrm.DLRMConfig(
            table_rows=dict(zip(self.names, dm["rows"])),
            embed_dim=dm["emb"],
            dense_in=dm["bottom"][0],
            bag_len=1,
            bottom_mlp=tuple(dm["bottom"][1:]),
            top_mlp=tuple(dm["top"][1:]),
            dtype=torch.float32,
        )
        self.batches = reference.make_batches(dm, batch_seed, BATCH_POOL, device)
        self.params = _tree(reference.make_weights(dm, weight_seed, device), self.names, dm)
        self.momentum = dlrm.init_momentum(self.params)
        self.progress = StateDict(step=0)
        self.app_state = {"model": dlrm.DLRMState(self.params, self.momentum), "progress": self.progress}

    def step(self) -> torch.Tensor:
        """One training step on the next batch; returns the loss (on the device)."""
        i = self.progress["step"] % BATCH_POOL
        ids = self.batches["ids"][i]
        sparse = {name: ids[:, j:j + 1] for j, name in enumerate(self.names)}
        _, _, loss = dlrm.sgd_momentum_train_step(
            self.params, self.momentum, self.batches["dense"][i], sparse, self.batches["labels"][i],
            self.cfg, lr=self.dims["lr"], beta=self.dims["beta"])
        self.progress["step"] += 1
        return loss

    def param_tensors(self) -> List[torch.Tensor]:
        return list(param_leaves(self.params))

    def state_tensors(self) -> List[torch.Tensor]:
        return self.param_tensors() + list(param_leaves(self.momentum))

    def first_grad_norms(self, start: List[torch.Tensor]) -> List[float]:
        """After the first step: each parameter's gradient as the optimizer
        holds it, the momentum (``β·0 + g``), in float64."""
        return [float(m.double().norm()) for m in param_leaves(self.momentum)]

    def flops_per_step(self) -> Optional[float]:
        return None

    def attention_shape(self) -> Optional[tuple]:
        return None

    def reference_inputs(self) -> Any:
        return self.batches
