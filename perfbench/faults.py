"""Faults planted under the timed path of a job laid out a rank per card
(``perfbench/families/transformer_fsdp.py``), by name. Each patches the
family's ``Job``, the take or ``torch.distributed`` in the process that calls
:func:`plant`; a run plants one in every rank, or in one rank alone. Not part
of a benchmark run: ``perfbench/calibrate.py`` reads them at a cell's size on
the card, ``perfbench/tests/rank_entry.py`` at a toy size on the CPU.

- ``state_unchanged``: the step leaves every shard as it was;
- ``half_batch``: half of each micro-batch left out, the mean taken over
  the rest;
- ``exchange_left_out``: FSDP's reduce-scatter keeps this rank's part of its
  own gradient, so each shard moves by one rank's micro-batch alone;
- ``altered_answer``: the take captures one element of the largest leaf's
  shard off by one;
- ``swapped_pieces``: the take captures that shard's two halves at each
  other's offsets;
- ``control_tf32``: the plain reference in TF32 as the step, on the gathered
  leaves and the global batch; each rank keeps its rows.
"""

from contextlib import contextmanager

import torch
import torch.distributed as dist

from perfbench.families import transformer_fsdp
from perfbench.reference import transformer as tf_ref
from torchsnapshot_tpu_torch import snapshot
from torchsnapshot_tpu_torch.models import transformer

Job = transformer_fsdp.Job


def _unchanged():
    def update(self):
        for p in self._leaves():
            p.grad = None
    Job._update = update


def _half_batch():
    forward_backward = Job._forward_backward
    Job._forward_backward = lambda self, tokens: forward_backward(self, tokens[: tokens.shape[0] // 2])


def _exchange_left_out():
    def own_part(output, input, op=None, group=None, async_op=False):
        output.copy_(input.view(dist.get_world_size(group), -1)[dist.get_rank(group)])

    for name in ("reduce_scatter_tensor", "reduce_scatter_single"):
        if hasattr(dist, name):
            setattr(dist, name, own_part)


def _wrong_capture(wrong):
    from torch.distributed.tensor import DTensor

    take = snapshot.Snapshot.async_take.__func__
    state_dict = transformer.TransformerState.state_dict

    def altered(self):
        tree = state_dict(self)
        target = max(transformer.param_leaves(tree), key=lambda t: t.numel())

        def alter(t):
            if t is not target:
                return t
            return DTensor.from_local(wrong(t.to_local()), t.device_mesh, t.placements,
                                      run_check=False, shape=t.shape, stride=t.stride())
        return transformer.map_leaves(alter, tree)

    def async_take(cls, *args, **kwargs):
        transformer.TransformerState.state_dict = altered
        try:
            return take(cls, *args, **kwargs)
        finally:
            transformer.TransformerState.state_dict = state_dict

    snapshot.Snapshot.async_take = classmethod(async_take)


def _plus_one(t):
    out = t.clone()
    out.view(-1)[0] += 1
    return out


def _swapped(t):
    flat = t.reshape(-1)
    h = flat.numel() // 2
    return torch.cat([flat[h:2 * h], flat[:h], flat[2 * h:]]).view_as(t)


def _control():
    def step(self):
        i = self.progress["step"]
        tokens = self.batches[i % transformer_fsdp.BATCH_POOL]
        parts = [torch.empty_like(tokens) for _ in range(self.world)]
        dist.all_gather(parts, tokens)
        leaves = self._leaves()
        whole = [p.detach().full_tensor() for p in leaves]
        loss = tf_ref.sgd_step(whole, torch.cat(parts), dict(self.dims), tf32=True)
        with torch.no_grad():
            for p, w in zip(leaves, whole):
                p.to_local().copy_(torch.chunk(w, self.world, dim=0)[dist.get_rank()])
        self.progress["step"] = i + 1
        return torch.tensor(loss)
    Job.step = step


FAULTS = {"state_unchanged": _unchanged, "half_batch": _half_batch, "exchange_left_out": _exchange_left_out,
          "altered_answer": lambda: _wrong_capture(_plus_one), "swapped_pieces": lambda: _wrong_capture(_swapped),
          "control_tf32": _control}


def plant(name: str) -> None:
    """Plant the named fault in this process, for good."""
    FAULTS[name]()


@contextmanager
def planted(name: str):
    """The named fault, planted for the block and taken out after it."""
    patched = [(Job, attr) for attr in ("step", "_update", "_forward_backward")]
    patched += [(dist, attr) for attr in ("reduce_scatter_tensor", "reduce_scatter_single") if hasattr(dist, attr)]
    patched += [(snapshot.Snapshot, "async_take"), (transformer.TransformerState, "state_dict")]
    saved = [(owner, attr, owner.__dict__[attr]) for owner, attr in patched]
    plant(name)
    try:
        yield
    finally:
        for owner, attr, value in saved:
            setattr(owner, attr, value)
