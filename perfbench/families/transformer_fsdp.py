"""The port's GPT-2-shaped transformer as an FSDP job, a rank per card.

Every rank builds ``torchsnapshot_tpu_torch.models.transformer`` from the
configuration file as ``transformer.py`` does (the same widths, the weights
drawn whole from the run's weight seed, the K1-K3 flash kernels, float32
with TF32 off), and ``torch.distributed.fsdp.fully_shard`` shards the root
module over the world: every leaf a DTensor ``Shard(0)``, its rows split as
``torch.chunk`` splits them (the embedding's 50,257 as 12,565 × 3 and
12,562), each rank keeping its own shard.

A step runs the module on this rank's micro-batch (its own batch seed), so
FSDP all-gathers the weights; the next-token loss as the port's ``loss_fn``
computes it; autograd's backward, after which FSDP reduce-scatters the
gradients, their mean over the ranks; then SGD on each local shard. The
loss returned is the global mean, all-reduced. The port's own
``sgd_train_step`` takes its gradients with ``torch.autograd.grad``, which
fills no ``.grad`` and so leaves FSDP nothing to reduce-scatter: the step
here is the loop an FSDP user writes around the port's module.

The app state checkpointed is ``{"model": TransformerState over the sharded
module, "progress": StateDict(step)}``: every rank writes its shard of each
of the 387 leaves as a sharded entry.
"""

import math
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from perfbench import roofline
from perfbench.reference import transformer_fsdp as reference
from torchsnapshot_tpu_torch.models import transformer as tf
from torchsnapshot_tpu_torch.state_dict import StateDict

# Distinct micro-batches a rank draws; step i trains on micro-batch i % BATCH_POOL.
BATCH_POOL = 64


def state_bytes(config: Dict[str, Any]) -> int:
    """Bytes of the whole state (every rank's shards), float32."""
    return 4 * sum(math.prod(s) for s in reference.leaf_shapes(reference.dims(config)))


class Job:
    reference = reference

    def __init__(self, config: Dict[str, Any], weight_seed: int, batch_seed: int, device: str) -> None:
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.fsdp import fully_shard

        self.config = config
        self.dims = dm = reference.dims(config)
        self.world = dist.get_world_size()
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
        model = tf.Transformer(self.cfg, reference.as_tree(reference.make_weights(dm, weight_seed, device), dm))
        self.mesh = init_device_mesh(torch.device(device).type, (self.world,))
        self.model = fully_shard(model, mesh=self.mesh)
        self.progress = StateDict(step=0)
        self.app_state = {"model": tf.TransformerState(self.model), "progress": self.progress}

    def _leaves(self) -> List[Any]:
        return list(tf.param_leaves(self.model.params()))

    def _forward_backward(self, tokens: torch.Tensor) -> torch.Tensor:
        """This rank's loss on ``tokens``; its gradients, reduce-scattered
        by FSDP, left in each leaf's ``.grad``."""
        logits = self.model(tokens)
        logp = torch.log_softmax(logits[:, :-1], dim=-1)
        loss = -logp.gather(-1, tokens[:, 1:, None].long()).mean()
        loss.backward()
        return loss.detach()

    def _update(self) -> None:
        """SGD ``p ← p − lr·g`` on each local shard; the gradients freed."""
        lr = self.dims["lr"]
        with torch.no_grad():
            for p in self._leaves():
                p.to_local().sub_(lr * p.grad.to_local())
                p.grad = None

    def step(self) -> torch.Tensor:
        """One training step on this rank's next micro-batch; returns the
        global loss (on the device)."""
        i = self.progress["step"]
        loss = self._forward_backward(self.batches[i % BATCH_POOL])
        self._update()
        dist.all_reduce(loss)
        self.progress["step"] = i + 1
        return loss / self.world

    def param_tensors(self) -> List[torch.Tensor]:
        """This rank's shard of every leaf."""
        return [p.detach().to_local() for p in self._leaves()]

    def state_tensors(self) -> List[torch.Tensor]:
        """Every tensor this rank's part of the app state checkpoints."""
        return self.param_tensors()

    def _whole_norms(self, start: List[torch.Tensor]) -> List[float]:
        """Per leaf, ‖p − p₀‖ of the whole leaf in float64: the ranks' sums of
        squares, all-reduced."""
        squares = torch.stack([(p.double() - q.double()).square().sum()
                               for p, q in zip(self.param_tensors(), start)])
        dist.all_reduce(squares)
        return squares.sqrt().tolist()

    def first_grad_norms(self, start: List[torch.Tensor]) -> List[float]:
        """After the first step: each leaf's gradient as SGD applied it,
        ``‖p₁ − p₀‖ / lr`` over the whole leaf."""
        lr = self.dims["lr"]
        return [n / lr for n in self._whole_norms(start)]

    def change_norms(self, start: List[torch.Tensor]) -> List[float]:
        return self._whole_norms(start)

    def flops_per_step(self) -> Optional[float]:
        """One rank's micro-batch: ``train_mfu`` is a share of one card."""
        dm = self.dims
        return roofline.transformer_step_flops(
            dm["batch"], dm["seq"], dm["d"], dm["ff"], dm["layers"], dm["vocab"], dm["heads"])

    def attention_shape(self) -> Optional[tuple]:
        if not self.cfg.flash_attention:
            return None
        dm = self.dims
        return (dm["batch"], dm["heads"], dm["seq"], dm["d"] // dm["heads"])

    def reference_inputs(self) -> Any:
        """Every rank's micro-batches as the global batches ``[BATCH_POOL,
        world·B, S]``, rank r's rows at ``[r·B, (r+1)·B)``. A collective."""
        parts = [torch.empty_like(self.batches) for _ in range(self.world)]
        dist.all_gather(parts, self.batches)
        return torch.cat(parts, dim=1)
