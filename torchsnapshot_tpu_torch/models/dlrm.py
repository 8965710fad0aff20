"""DLRM-style recommendation model, ported from the JAX package.

The expert/embedding-parallel workload of ``torchsnapshot_tpu/models/
dlrm.py``: embedding tables row-sharded over the mesh's ``"ep"`` dim,
dense MLPs replicated, and momentum-SGD state shaped (and sharded) like
the parameters, so a snapshot holds large sharded arrays, replicated
dense weights and sharded optimizer state at once. It is the analog of
the reference's torchrec DLRM with row-wise sharded tables and a fused
optimizer.

The parameter tree is the JAX ``init_params`` pytree, untransposed:
``{"tables": {name: [rows, D]}, "bottom_mlp": [{"w": [in, out], "b"}],
"top_mlp": [...]}``, with ``x @ w + b``. A snapshot of the same arrays
has the same logical paths, dtypes, shapes and bytes in either package.

Bags have a static length L (ids ``[B, L]``): the lookup is one gather
and a mean. Pairwise feature interaction is one batched product
``[B, T+1, D] x [B, D, T+1]`` and its upper triangle in row-major order
(``torch.triu_indices`` gives ``jnp.triu_indices``'s order).

Differences from the JAX package, on purpose:

- ``jnp.take`` clamps an out-of-range id to the last row; torch indexing
  raises. Ids must lie in ``[0, rows)``, as :func:`synthetic_batch`
  draws them; nothing emulates the clamp.
- Over ``ep`` the JAX gather over a row-sharded table is a collective
  XLA inserts. Here each rank gathers the ids that fall in its own box
  of rows (:func:`resharding.shard_box`), zeroes the others, mean-pools
  and sums the pooled vectors over ``ep`` (all-reduce forward, identity
  backward), so every rank gets the global logits and loss, and a
  table's gradient reaches only the local rows.
- Boxes are ``torch.chunk``-style (ceil rows per rank) where JAX refuses
  a row count that ``ep`` does not divide.
- :func:`sgd_momentum_train_step` updates parameters and momentum in
  place, where JAX returns new trees.
"""

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..parallel.collectives import group_of, reduce_from_group
from ..parallel.mesh import Spec, placements_for, shard_pytree
from ..resharding import shard_box
from .transformer import (  # noqa: F401 (param_leaves, params_from_numpy: the carry-over)
    _local,
    _resolve_device,
    copy_into,
    map_leaves,
    param_leaves,
    params_from_numpy,
)


@dataclass(frozen=True)
class DLRMConfig:
    # name -> number of rows; all tables share embed_dim so their pooled
    # vectors can interact.
    table_rows: Dict[str, int] = field(
        default_factory=lambda: {"user": 4096, "item": 8192, "cat": 512}
    )
    embed_dim: int = 32
    dense_in: int = 13  # dense feature count (DLRM convention)
    bag_len: int = 8  # static ids per bag
    bottom_mlp: Tuple[int, ...] = (64, 32)  # last must equal embed_dim
    top_mlp: Tuple[int, ...] = (64, 1)
    dtype: torch.dtype = torch.float32


# Row counts of the 26 categorical features of the Criteo Kaggle display
# advertising dataset, as torchrec's DLRM example lists them for
# --num_embeddings_per_feature.
CRITEO_KAGGLE_ROWS = (
    1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145, 5683, 8351593,
    3194, 27, 14992, 5461306, 10, 5652, 2173, 4, 7046547, 18, 15, 286181, 105,
    142572,
)

# facebookresearch/dlrm bench/dlrm_s_criteo_kaggle.sh:
# --arch-sparse-feature-size=16 --arch-mlp-bot=13-512-256-64-16
# --arch-mlp-top=512-256-1; one id per feature (bag_len 1), so the mean
# pooling equals the reference's sum.
CRITEO_KAGGLE = DLRMConfig(
    table_rows={f"cat_{i}": rows for i, rows in enumerate(CRITEO_KAGGLE_ROWS)},
    embed_dim=16,
    dense_in=13,
    bag_len=1,
    bottom_mlp=(512, 256, 64, 16),
    top_mlp=(512, 256, 1),
)


def init_params(config: DLRMConfig, seed: int, device: Any = None) -> Dict[str, Any]:
    """Tables (normal × D^-½) and MLP stacks (normal × in^-½, zero
    biases) drawn from a seeded ``torch.Generator`` on ``device``, in the
    JAX ``init_params`` layout. The numbers differ from JAX's; feed both
    packages the same arrays via :func:`params_from_numpy` to compare."""
    device = _resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def normal(shape, fan):
        w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return (w / np.sqrt(fan)).to(config.dtype)

    tables = {
        name: normal((rows, config.embed_dim), config.embed_dim)
        for name, rows in config.table_rows.items()
    }

    def mlp(in_dim, dims):
        layers = []
        for out_dim in dims:
            layers.append({
                "w": normal((in_dim, out_dim), in_dim),
                "b": torch.zeros(out_dim, dtype=config.dtype, device=device),
            })
            in_dim = out_dim
        return layers

    return {
        "tables": tables,
        "bottom_mlp": mlp(config.dense_in, config.bottom_mlp),
        "top_mlp": mlp(config.embed_dim + _n_pairs(config), config.top_mlp),
    }


def _n_pairs(config: DLRMConfig) -> int:
    """Pairs of the upper triangle over the T tables and the dense vector."""
    t = len(config.table_rows)
    return (t + 1) * t // 2


def init_momentum(params: Dict[str, Any]) -> Dict[str, Any]:
    """Zeros shaped, placed and sharded like ``params``."""
    return map_leaves(torch.zeros_like, params)


def param_sharding_rules(keys: Tuple[str, ...], leaf: Any) -> Spec:
    """Row-shard embedding tables over ``"ep"``; replicate the dense MLPs
    (the JAX package's rule, and torchrec's row-wise layout)."""
    if keys and keys[0] == "tables":
        return ("ep", None)
    return None


def shard_params(params: Dict[str, Any], mesh: Any) -> Dict[str, Any]:
    """``params`` (or momentum) as DTensors on ``mesh``, which has an
    ``"ep"`` dim; each rank keeps its box of every table."""
    return shard_pytree(params, mesh, param_sharding_rules)


def _run_mlp(layers: List[Dict[str, Any]], x: torch.Tensor) -> torch.Tensor:
    for i, layer in enumerate(layers):
        x = x @ _local(layer["w"]) + _local(layer["b"])
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


def _pooled(table: torch.Tensor, ids: torch.Tensor, rows: int, mesh: Any) -> torch.Tensor:
    """Mean over the bag of each row's table vectors ``[B, D]``. Over
    ``ep``: this rank's share of it (ids outside its box contribute
    zeros), summed over the ranks."""
    group = group_of(mesh, "ep")
    if group is None:
        return table[ids].mean(dim=1)
    offsets, sizes = shard_box(
        [rows, table.shape[1]], list(mesh.shape), mesh.get_coordinate(),
        placements_for(mesh, ("ep", None)),
    )
    if table.shape[0] != sizes[0]:
        raise ValueError(
            f"the local table holds {table.shape[0]} rows; its ep box has {sizes[0]}: "
            f"pass the tables shard_params placed"
        )
    local_ids = ids - offsets[0]
    mine = (local_ids >= 0) & (local_ids < sizes[0])
    if sizes[0] == 0:
        part = table.new_zeros(ids.shape[0], table.shape[1])
    else:
        vecs = table[local_ids.clamp(0, sizes[0] - 1)] * mine[..., None].to(table.dtype)
        part = vecs.mean(dim=1)
    return reduce_from_group(part, group)


def forward(
    params: Dict[str, Any],
    dense: torch.Tensor,  # [B, dense_in] float
    sparse_ids: Dict[str, torch.Tensor],  # name -> [B, L] integer
    config: DLRMConfig,
    mesh: Optional[Any] = None,
) -> torch.Tensor:
    """Click-probability logits ``[B]`` float32, as the JAX ``forward``.

    Under a mesh with an ``"ep"`` dim every rank passes the same global
    batch and gets the global logits; the tables are the DTensors of
    :func:`shard_params` (or their local tensors)."""
    d = _run_mlp(params["bottom_mlp"], dense.to(config.dtype))  # [B, D]
    pooled = [d]
    for name, rows in config.table_rows.items():
        pooled.append(_pooled(_local(params["tables"][name]), sparse_ids[name].long(), rows, mesh))
    feats = torch.stack(pooled, dim=1)  # [B, T+1, D]
    inter = torch.bmm(feats, feats.transpose(1, 2))  # [B, T+1, T+1]
    t = feats.shape[1]
    iu, ju = torch.triu_indices(t, t, offset=1, device=feats.device)
    top_in = torch.cat([d, inter[:, iu, ju].to(config.dtype)], dim=-1)
    return _run_mlp(params["top_mlp"], top_in)[:, 0].float()


def loss_fn(
    params: Dict[str, Any],
    dense: torch.Tensor,
    sparse_ids: Dict[str, torch.Tensor],
    labels: torch.Tensor,  # [B] float 0/1
    config: DLRMConfig,
    mesh: Optional[Any] = None,
) -> torch.Tensor:
    """Binary cross-entropy with logits, in the JAX package's stable
    form ``max(l, 0) − l·y + log1p(exp(−|l|))``, mean over the batch."""
    logits = forward(params, dense, sparse_ids, config, mesh)
    return torch.mean(
        torch.clamp(logits, min=0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))
    )


def loss_and_grads(
    params: Dict[str, Any],
    dense: torch.Tensor,
    sparse_ids: Dict[str, torch.Tensor],
    labels: torch.Tensor,
    config: DLRMConfig,
    mesh: Optional[Any] = None,
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(loss, the gradient of every leaf's local tensor in
    :func:`param_leaves` order), as ``jax.value_and_grad(loss_fn)``
    gives them: a table's gradient is its local box of the global one.
    The leaves need not require grad. No collective is needed after the
    backward: every rank computes the same loss from the same batch."""
    locals_ = [_local(p).detach().requires_grad_() for p in param_leaves(params)]
    it = iter(locals_)
    tree = map_leaves(lambda _: next(it), params)
    with torch.enable_grad():
        loss = loss_fn(tree, dense, sparse_ids, labels, config, mesh)
        grads = torch.autograd.grad(loss, locals_, allow_unused=True)
    # An empty ep box takes no part in the graph; its gradient is empty.
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(locals_, grads)]
    return loss.detach(), grads


def sgd_momentum_train_step(
    params: Dict[str, Any],
    momentum: Dict[str, Any],
    dense: torch.Tensor,
    sparse_ids: Dict[str, torch.Tensor],
    labels: torch.Tensor,
    config: DLRMConfig,
    mesh: Optional[Any] = None,
    lr: float = 1e-2,
    beta: float = 0.9,
) -> Tuple[Dict[str, Any], Dict[str, Any], torch.Tensor]:
    """One SGD + momentum step: ``m ← beta·m + g``, ``p ← p − lr·m``
    (no dampening, unlike ``torch.optim.SGD``), returning ``(params,
    momentum, loss)`` as the JAX step does. The update is in place: the
    returned trees hold the same tensors (a DTensor's local tensor is
    updated)."""
    loss, grads = loss_and_grads(params, dense, sparse_ids, labels, config, mesh)
    with torch.no_grad():
        for p, m, g in zip(param_leaves(params), param_leaves(momentum), grads):
            m_local = _local(m)
            m_local.mul_(beta).add_(g.to(m_local.dtype))
            _local(p).sub_(lr * m_local.to(p.dtype))
    return params, momentum, loss


def synthetic_batch(
    config: DLRMConfig, batch_size: int, seed: int, device: Any = None
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], torch.Tensor]:
    """A random ``(dense, sparse_ids, labels)`` batch with static shapes
    from a seeded ``torch.Generator`` on ``device``: ids uniform in
    ``[0, rows)``, labels 0/1."""
    device = _resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    dense = torch.randn(batch_size, config.dense_in, generator=gen, device=device)
    sparse = {
        name: torch.randint(0, rows, (batch_size, config.bag_len), generator=gen, device=device)
        for name, rows in config.table_rows.items()
    }
    labels = (torch.rand(batch_size, generator=gen, device=device) < 0.5).float()
    return dense, sparse, labels


def numpy_batch(
    config: DLRMConfig, batch_size: int, seed: int
) -> Tuple[np.ndarray, Dict[str, np.ndarray], np.ndarray]:
    """The same kind of batch from ``np.random.default_rng(seed)`` as
    numpy arrays (ids int32, as the JAX batch has them), for feeding both
    packages the same inputs; :func:`batch_from_numpy` moves it over."""
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((batch_size, config.dense_in), dtype=np.float32)
    sparse = {
        name: rng.integers(0, rows, (batch_size, config.bag_len)).astype(np.int32)
        for name, rows in config.table_rows.items()
    }
    labels = (rng.random(batch_size) < 0.5).astype(np.float32)
    return dense, sparse, labels


def batch_from_numpy(batch: Tuple[Any, ...], device: Any = None) -> Tuple[Any, ...]:
    """A :func:`numpy_batch` as tensors on ``device``."""
    return tuple(params_from_numpy(part, device) for part in batch)


class DLRMState:
    """A ``Stateful`` over a DLRM's parameters and momentum: its state
    dict is ``{"params": ..., "momentum": ...}`` in the JAX layout.
    Restore copies into the held tensors (a DTensor's local tensor) in
    place when the restored tensor is not already one of them."""

    def __init__(self, params: Dict[str, Any], momentum: Dict[str, Any]) -> None:
        self.params = params
        self.momentum = momentum

    def state_dict(self) -> Dict[str, Any]:
        return {
            "params": map_leaves(lambda t: t.detach(), self.params),
            "momentum": map_leaves(lambda t: t.detach(), self.momentum),
        }

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        # By key: a snapshot's dicts may list their keys in another order
        # (a JAX take sorts them).
        copy_into(self.params, state_dict["params"], "params")
        copy_into(self.momentum, state_dict["momentum"], "momentum")
