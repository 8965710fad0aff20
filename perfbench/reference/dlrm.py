"""Plain PyTorch reference of the DLRM training step, and the inputs.

The benchmark makes the weights and the batches here, from the run's seed,
and hands the same tensors to the program and to this reference. The step
is facebookresearch/dlrm's ``dlrm_s_pytorch.py`` model with one id per
feature: the bottom MLP (ReLU between layers, none after the last), one row
of each embedding table, the pairwise dot products of the bottom output and
the 26 embeddings above the diagonal in row-major order, the bottom output
concatenated in front of them, the top MLP, and binary cross entropy on the
logit, averaged over the batch. The optimizer is SGD with momentum, no
dampening: ``m ← β·m + g``, ``p ← p − lr·m``. Nothing of the program or of
JAX is imported.

``tf32=True`` rounds both operands of every matrix product to TF32 (the
control: the step one precision below the float32 the configuration states).
"""

import math
from typing import Any, Dict, List, Optional

import torch

from .tf32 import mm


def dims(config: Dict[str, Any]) -> Dict[str, Any]:
    """The model's sizes from a configuration file."""
    bottom = [int(x) for x in config["arch_mlp_bot"].split("-")]
    top = [int(x) for x in config["arch_mlp_top"].split("-")]
    emb = config["arch_sparse_feature_size"]
    if bottom[-1] != emb:
        raise ValueError(f"the bottom MLP ends at {bottom[-1]}, the tables are {emb} wide")
    tables = len(config["num_embeddings_per_feature"])
    return {
        "rows": list(config["num_embeddings_per_feature"]),
        "emb": emb,
        "bottom": bottom,
        # The top MLP's input: the bottom output and the pairs above the
        # diagonal of the (tables + 1) interacting vectors.
        "top": [emb + (tables + 1) * tables // 2] + top,
        "batch": config["mini_batch_size"],
        "lr": config["learning_rate"],
        "beta": config["momentum"],
    }


def leaf_shapes(dm: Dict[str, Any]) -> List[tuple]:
    """Parameter shapes in the program's tree order: tables, then the bottom
    and top MLPs as (w [in, out], b [out]) pairs."""
    shapes = [(rows, dm["emb"]) for rows in dm["rows"]]
    for stack in (dm["bottom"], dm["top"]):
        for fan_in, fan_out in zip(stack[:-1], stack[1:]):
            shapes += [(fan_in, fan_out), (fan_out,)]
    return shapes


def make_weights(dm: Dict[str, Any], seed: int, device: Any) -> List[torch.Tensor]:
    """Every parameter from one draw of a seeded generator on ``device``:
    tables normal × D^-½, MLP weights normal × fan_in^-½, biases zero."""
    shapes = leaf_shapes(dm)
    sizes = [math.prod(s) for s in shapes]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    leaves = []
    for part, shape in zip(torch.split(flat, sizes), shapes):
        if len(shape) == 1:
            leaves.append(torch.zeros(shape, device=device, dtype=torch.float32))
        else:
            fan = dm["emb"] if len(leaves) < len(dm["rows"]) else shape[0]
            leaves.append((part / math.sqrt(fan)).view(shape))
    del flat
    return leaves


def make_batches(dm: Dict[str, Any], seed: int, count: int, device: Any) -> Dict[str, torch.Tensor]:
    """``count`` batches from a seeded generator on ``device``: dense
    features ``[count, B, 13]`` normal, ids ``[count, B, tables]`` uniform
    over each table's rows, labels ``[count, B]`` 0/1."""
    gen = torch.Generator(device=device).manual_seed(seed)
    b = dm["batch"]
    dense = torch.randn(count, b, dm["bottom"][0], generator=gen, device=device)
    rows = torch.tensor(dm["rows"], device=device, dtype=torch.float64)
    u = torch.rand(count, b, len(dm["rows"]), generator=gen, device=device, dtype=torch.float64)
    ids = torch.minimum((u * rows).long(), (rows - 1).long())
    labels = (torch.rand(count, b, generator=gen, device=device) < 0.5).float()
    return {"dense": dense, "ids": ids, "labels": labels}


def _mlp(x: torch.Tensor, pairs: List[torch.Tensor], tf32: bool) -> torch.Tensor:
    n = len(pairs) // 2
    for i in range(n):
        x = mm(x, pairs[2 * i], tf32) + pairs[2 * i + 1]
        if i < n - 1:
            x = torch.relu(x)
    return x


def loss(leaves: List[torch.Tensor], batch: Dict[str, torch.Tensor], dm: Dict[str, Any], tf32: bool) -> torch.Tensor:
    t = len(dm["rows"])
    n_bottom = 2 * (len(dm["bottom"]) - 1)
    tables, bottom, top = leaves[:t], leaves[t:t + n_bottom], leaves[t + n_bottom:]
    d = _mlp(batch["dense"], bottom, tf32)
    feats = torch.stack([d] + [tables[j][batch["ids"][:, j]] for j in range(t)], dim=1)
    inter = mm(feats, feats.transpose(1, 2), tf32)
    iu, ju = torch.triu_indices(t + 1, t + 1, offset=1, device=feats.device)
    logit = _mlp(torch.cat([d, inter[:, iu, ju]], dim=-1), top, tf32)[:, 0]
    y = batch["labels"]
    return torch.mean(torch.clamp(logit, min=0) - logit * y + torch.log1p(torch.exp(-logit.abs())))


def first_steps(
    config: Dict[str, Any],
    weight_seed: int,
    batches: Dict[str, torch.Tensor],
    steps: int,
    device: Any,
    tf32: bool = False,
    rows: Optional[int] = None,
) -> Dict[str, Any]:
    """The readings of the first ``steps`` momentum steps from the seeded
    weights: each step's loss, each parameter's first gradient norm as the
    optimizer holds it (the momentum after one step, which is the gradient)
    and each parameter's change ``‖p_steps − p₀‖``, norms in float64. ``rows``
    trains on the first rows of each batch only."""
    dm = dims(config)
    params = make_weights(dm, weight_seed, device)
    start = [p.clone() for p in params]
    momentum = [torch.zeros_like(p) for p in params]
    count = batches["dense"].shape[0]
    losses, grad1 = [], []
    for i in range(steps):
        batch = {k: v[i % count] for k, v in batches.items()}
        if rows is not None:
            batch = {k: v[:rows] for k, v in batch.items()}
        live = [p.detach().requires_grad_() for p in params]
        value = loss(live, batch, dm, tf32)
        grads = torch.autograd.grad(value, live)
        losses.append(float(value.detach()))
        with torch.no_grad():
            for p, m, g in zip(params, momentum, grads):
                m.mul_(dm["beta"]).add_(g)
                p.sub_(dm["lr"] * m)
        del live, value, grads
        if i == 0:
            grad1 = [float(m.double().norm()) for m in momentum]
    change = [float((p.double() - q.double()).norm()) for p, q in zip(params, start)]
    return {"losses": losses, "grad1": grad1, "change": change}
