"""The port's GPT-2-shaped transformer as a benchmark job.

Builds ``torchsnapshot_tpu_torch.models.transformer`` from a configuration
file, hands it the benchmark's seeded weights and batches, and trains it with
the port's ``sgd_train_step``. The app state checkpointed is the one a
training loop hands the manager: ``{"model": TransformerState, "progress":
StateDict(step)}``.
"""

from typing import Any, Dict, List, Optional

import torch

from perfbench import roofline
from perfbench.reference import transformer as reference
from torchsnapshot_tpu_torch.models import transformer as tf
from torchsnapshot_tpu_torch.state_dict import StateDict

# Distinct batches a run draws; step i trains on batch i % BATCH_POOL.
BATCH_POOL = 64


class Job:
    reference = reference

    def __init__(self, config: Dict[str, Any], weight_seed: int, batch_seed: int, device: str) -> None:
        self.config = config
        self.dims = dm = reference.dims(config)
        self.cfg = tf.TransformerConfig(
            vocab_size=dm["vocab"],
            d_model=dm["d"],
            n_heads=dm["heads"],
            n_layers=dm["layers"],
            d_ff=dm["ff"],
            max_seq_len=dm["positions"],
            dtype=torch.float32,
            flash_attention=config["attention"] == "flash",
        )
        if dm["eps"] != 1e-6:
            raise ValueError("the port's LayerNorm adds eps 1e-6 inside the rsqrt")
        self.batches = reference.make_batches(dm, batch_seed, BATCH_POOL, device)
        leaves = reference.make_weights(dm, weight_seed, device)
        self.model = tf.Transformer(self.cfg, reference.as_tree(leaves, dm))
        del leaves
        self.params = self.model.params()
        self.progress = StateDict(step=0)
        self.app_state = {"model": tf.TransformerState(self.model), "progress": self.progress}

    def step(self) -> torch.Tensor:
        """One training step on the next batch; returns the loss (on the device)."""
        i = self.progress["step"]
        _, loss = tf.sgd_train_step(self.params, self.batches[i % BATCH_POOL], self.cfg, lr=self.dims["lr"])
        self.progress["step"] = i + 1
        return loss

    def param_tensors(self) -> List[torch.Tensor]:
        return [t.detach() for t in tf.param_leaves(self.params)]

    def state_tensors(self) -> List[torch.Tensor]:
        """Every tensor the app state checkpoints, in a fixed order."""
        return self.param_tensors()

    def first_grad_norms(self, start: List[torch.Tensor]) -> List[float]:
        """After the first step: each leaf's gradient as SGD applied it,
        ``‖p₁ − p₀‖ / lr`` in float64."""
        lr = self.dims["lr"]
        return [float((p.double() - q.double()).norm()) / lr for p, q in zip(self.param_tensors(), start)]

    def flops_per_step(self) -> Optional[float]:
        dm = self.dims
        return roofline.transformer_step_flops(
            dm["batch"], dm["seq"], dm["d"], dm["ff"], dm["layers"], dm["vocab"], dm["heads"])

    def attention_shape(self) -> Optional[tuple]:
        """(B, H, S, Dh) of every flash launch of a step, or None without them."""
        if not self.cfg.flash_attention:
            return None
        dm = self.dims
        return (dm["batch"], dm["heads"], dm["seq"], dm["d"] // dm["heads"])

    def reference_inputs(self) -> Any:
        return self.batches
