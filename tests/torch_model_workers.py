"""Rank functions of the port's DLRM and ResNet multi-rank tests.

Each runs in a process that ``run_multiprocess`` spawned into a gloo
process group and saves its results as ``.npz`` files in an output
directory the test reads. Kept apart from the test files, which import
JAX, so a spawned rank imports only torch, numpy and the port."""

import os

import numpy as np
import torch

from torchsnapshot_tpu_torch import Snapshot
from torchsnapshot_tpu_torch.io_preparer import dtensor_box
from torchsnapshot_tpu_torch.models import dlrm, resnet
from torchsnapshot_tpu_torch.parallel.mesh import make_mesh
from torchsnapshot_tpu_torch.utils.train_state import PytreeStateful


def _boxes(tree):
    """Each leaf's local tensor as numpy, and its box offsets."""
    out = {}
    for i, t in enumerate(dlrm.param_leaves(tree)):
        out[f"leaf{i}"] = t.to_local().detach().numpy()
        out[f"offsets{i}"] = np.array(dtensor_box(t)[0])
    return out


def dlrm_ep(rank, world, cases, jax_snapshot, out_dir):
    """For each ``(name, config kwargs, params, batches)`` case: tables
    and momentum row-sharded over ``{"ep": world}``, one momentum step a
    batch, each step's loss and the final local boxes saved; then a take
    of params and momentum (``<out_dir>/<name>``). Then the JAX package's
    ep snapshot ``jax_snapshot`` (its ``"model"`` holding params and
    momentum of the first case's config) restored into ep DTensors."""
    torch.set_num_threads(1)  # the ranks share the host's cores
    mesh = make_mesh({"ep": world}, "cpu")
    for name, cfg_kwargs, params_np, batches in cases:
        cfg = dlrm.DLRMConfig(**cfg_kwargs)
        full = dlrm.params_from_numpy(params_np, "cpu")
        params = dlrm.shard_params(full, mesh)
        momentum = dlrm.shard_params(dlrm.init_momentum(full), mesh)
        losses = []
        for batch in batches:
            _, _, loss = dlrm.sgd_momentum_train_step(
                params, momentum, *dlrm.batch_from_numpy(batch, "cpu"), cfg, mesh, lr=0.1
            )
            losses.append(float(loss))
        state = dlrm.DLRMState(params, momentum)
        Snapshot.take(os.path.join(out_dir, name), {"model": state}, replicated=["**"])
        np.savez(
            os.path.join(out_dir, f"{name}_{rank}.npz"),
            losses=np.array(losses), **_boxes(state.state_dict()),
        )
    cfg_kwargs, params_np = cases[0][1], cases[0][2]
    template = dlrm.params_from_numpy(params_np, "cpu")
    zeros = dlrm.DLRMState(
        dlrm.shard_params(dlrm.init_momentum(template), mesh),
        dlrm.shard_params(dlrm.init_momentum(template), mesh),
    )
    Snapshot(jax_snapshot).restore({"model": zeros})
    np.savez(os.path.join(out_dir, f"from_jax_{rank}.npz"), **_boxes(zeros.state_dict()))


def resnet_dp(rank, world, cfg_kwargs, params_np, stats_np, images, labels, out_dir):
    """One dp step over ``{"dp": world}`` from the given state on this
    rank's rows of the global batch; saves the loss, the parameters and
    the running statistics (replicated: every rank holds them whole)."""
    torch.set_num_threads(1)
    cfg = resnet.ResNetConfig(**cfg_kwargs)
    mesh = make_mesh({"dp": world}, "cpu")
    params, stats = resnet.replicate_state(
        (resnet.params_from_numpy(params_np, "cpu"), resnet.params_from_numpy(stats_np, "cpu")), mesh
    )
    images = resnet.dp_shard_batch(torch.from_numpy(images), mesh)
    labels = resnet.dp_shard_batch(torch.from_numpy(labels), mesh)
    params, stats, loss = resnet.sgd_train_step(params, stats, images, labels, cfg)
    out = {"loss": loss.numpy(), "rows": np.array(images.to_local().shape[0])}
    for i, t in enumerate(dlrm.param_leaves(params)):
        out[f"param{i}"] = t.to_local().numpy()
    for i, t in enumerate(dlrm.param_leaves(stats)):
        out[f"stat{i}"] = t.to_local().numpy()
    Snapshot.take(
        os.path.join(out_dir, "dp"),
        {"params": PytreeStateful(params), "stats": PytreeStateful(stats)},
        replicated=["**"],
    )
    np.savez(os.path.join(out_dir, f"resnet_{rank}.npz"), **out)
