"""Residual CNN, ported from the JAX package: the data-parallel workload.

The "DDP ResNet" configuration of ``torchsnapshot_tpu/models/resnet.py``:
a compact residual CNN whose state holds what the transformer and DLRM
lack, batch-norm running statistics, which must resume bit-exactly with
the parameters.

The trees are the JAX package's: ``params = {"stem", "stages":
[[{"conv1", "conv2", "bn1": {"scale", "bias"}, "bn2", ("proj")}]],
"head": {"w", "b"}}`` and ``stats = {"stages": [[{"bn1": {"mean",
"var"}, "bn2"}]]}``. Convolution weights are stored as JAX's HWIO
``[kh, kw, cin, cout]``, so the on-disk format is shared, and are
permuted to OIHW only at the call; images are NHWC ``[B, H, W, C]`` as
in JAX, and run NCHW inside. Every convolution is stride 1 with JAX's
``"SAME"`` padding.

Batch norm follows JAX, not ``F.batch_norm``: the biased variance
(``jnp.var``), eps 1e-5, and running statistics ``m·running + (1−m)·
batch``. Under a ``"dp"`` mesh JAX's statistics are over the global
batch; here each rank holds its rows of the batch (:func:`dp_shard_batch`)
and the statistics are summed over ``dp`` (the mean first, then the mean
squared deviation, as synchronised batch norm does), the loss is the
global mean, and the gradients are summed over ``dp``.

:func:`sgd_train_step` updates the parameters and the running statistics
in place, where JAX returns new trees.
"""

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..io_preparer import is_dtensor
from ..parallel.collectives import all_reduce_, copy_to_group, group_of, reduce_from_group
from ..parallel.mesh import replicate_pytree, shard_pytree
from .transformer import (  # noqa: F401 (params_from_numpy: the carry-over)
    _local,
    _resolve_device,
    map_leaves,
    param_leaves,
    params_from_numpy,
)


@dataclass(frozen=True)
class ResNetConfig:
    in_channels: int = 3
    widths: Tuple[int, ...] = (16, 32)  # one residual stage per width
    blocks_per_stage: int = 2
    num_classes: int = 10
    image_size: int = 16
    bn_momentum: float = 0.9
    dtype: torch.dtype = torch.float32


# ResNet-18's stage widths and blocks (He et al. 2016, Table 1) on
# CIFAR-10's shapes (32×32×3, 10 classes); stride 1 throughout, as the
# JAX model has no strides.
RESNET18_CIFAR10 = ResNetConfig(
    widths=(64, 128, 256, 512), blocks_per_stage=2, num_classes=10, image_size=32
)


def init_state(
    config: ResNetConfig, seed: int, device: Any = None
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """``(params, batch_stats)`` in the JAX layout: convolutions normal
    × (2 / fan_in)^½ in HWIO, the head normal × cin^-½, BN scale ones and
    bias zeros, running means zeros and variances ones, drawn from a
    seeded ``torch.Generator`` on ``device``."""
    device = _resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def conv(kh, kw, cin, cout):
        w = torch.randn((kh, kw, cin, cout), generator=gen, device=device)
        return (w * np.sqrt(2.0 / (kh * kw * cin))).to(config.dtype)

    def vec(width, value):
        return torch.full((width,), value, dtype=torch.float32, device=device)

    params: Dict[str, Any] = {"stem": conv(3, 3, config.in_channels, config.widths[0])}
    stages, stat_stages = [], []
    cin = config.widths[0]
    for width in config.widths:
        blocks, stat_blocks = [], []
        for _ in range(config.blocks_per_stage):
            block = {
                "conv1": conv(3, 3, cin, width),
                "conv2": conv(3, 3, width, width),
                "bn1": {"scale": vec(width, 1.0), "bias": vec(width, 0.0)},
                "bn2": {"scale": vec(width, 1.0), "bias": vec(width, 0.0)},
            }
            if cin != width:
                block["proj"] = conv(1, 1, cin, width)
            blocks.append(block)
            stat_blocks.append({
                "bn1": {"mean": vec(width, 0.0), "var": vec(width, 1.0)},
                "bn2": {"mean": vec(width, 0.0), "var": vec(width, 1.0)},
            })
            cin = width
        stages.append(blocks)
        stat_stages.append(stat_blocks)
    params["stages"] = stages
    w = torch.randn((cin, config.num_classes), generator=gen, device=device)
    params["head"] = {
        "w": (w / np.sqrt(cin)).to(config.dtype),
        "b": torch.zeros(config.num_classes, dtype=config.dtype, device=device),
    }
    return params, {"stages": stat_stages}


def _conv(x: torch.Tensor, w_hwio: torch.Tensor) -> torch.Tensor:
    """NCHW ``x`` by an HWIO weight, stride 1, JAX's ``"SAME"`` padding."""
    return F.conv2d(x, w_hwio.permute(3, 2, 0, 1), padding="same")


def _summed(x: torch.Tensor, group: Any) -> torch.Tensor:
    """``x`` summed over ``group``, forward and backward: every rank's
    statistics depend on every rank's rows."""
    if group is None:
        return x
    return reduce_from_group(copy_to_group(x, group), group)


def _bn_train(x, bn, running, momentum, group, count):
    """Batch norm in train mode over the ``count`` positions of the
    global batch; returns ``(y, new_running)``."""
    mean = _summed(x.sum(dim=(0, 2, 3)), group) / count
    dev = x - mean[:, None, None]
    var = _summed((dev * dev).sum(dim=(0, 2, 3)), group) / count
    y = dev * torch.rsqrt(var + 1e-5)[:, None, None] * _local(bn["scale"])[:, None, None]
    y = y + _local(bn["bias"])[:, None, None]
    with torch.no_grad():
        new_running = {
            "mean": momentum * _local(running["mean"]) + (1 - momentum) * mean,
            "var": momentum * _local(running["var"]) + (1 - momentum) * var,
        }
    return y, new_running


def _batch(images: Any) -> Tuple[torch.Tensor, Any, int]:
    """(this rank's rows, the dp group or None, the global batch size)."""
    if is_dtensor(images):
        return images.to_local(), group_of(images.device_mesh, "dp"), images.shape[0]
    return images, None, images.shape[0]


def forward_train(
    params: Dict[str, Any],
    stats: Dict[str, Any],
    images: Any,  # [B, H, W, C]; a DTensor of dp_shard_batch under dp
    config: ResNetConfig,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Logits ``[B, num_classes]`` float32 (this rank's rows under dp)
    and the new running statistics (fresh tensors)."""
    local, group, batch = _batch(images)
    count = batch * local.shape[1] * local.shape[2]
    x = _conv(local.to(config.dtype).permute(0, 3, 1, 2), _local(params["stem"]))
    new_stages = []
    for blocks, stat_blocks in zip(params["stages"], stats["stages"]):
        new_blocks = []
        for block, sb in zip(blocks, stat_blocks):
            m = config.bn_momentum
            h, ns1 = _bn_train(_conv(x, _local(block["conv1"])), block["bn1"], sb["bn1"], m, group, count)
            h = torch.relu(h)
            h, ns2 = _bn_train(_conv(h, _local(block["conv2"])), block["bn2"], sb["bn2"], m, group, count)
            shortcut = _conv(x, _local(block["proj"])) if "proj" in block else x
            x = torch.relu(h + shortcut)
            new_blocks.append({"bn1": ns1, "bn2": ns2})
        new_stages.append(new_blocks)
    x = x.mean(dim=(2, 3))  # global average pool
    logits = x @ _local(params["head"]["w"]) + _local(params["head"]["b"])
    return logits.float(), {"stages": new_stages}


def sgd_train_step(
    params: Dict[str, Any],
    stats: Dict[str, Any],
    images: Any,
    labels: Any,  # [B] integer; a DTensor of dp_shard_batch under dp
    config: ResNetConfig,
    lr: float = 1e-2,
) -> Tuple[Dict[str, Any], Dict[str, Any], torch.Tensor]:
    """One SGD step on the mean cross entropy of the global batch;
    returns ``(params, stats, loss)`` as JAX does, with the parameters
    and running statistics updated in place (a DTensor's local tensor).
    Under dp every rank gets the global loss and the summed gradients."""
    locals_ = [_local(p).detach().requires_grad_() for p in param_leaves(params)]
    it = iter(locals_)
    tree = map_leaves(lambda _: next(it), params)
    label_rows, group, batch = _batch(labels)
    with torch.enable_grad():
        logits, new_stats = forward_train(tree, stats, images, config)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, label_rows[:, None].long()).sum()
        loss = (reduce_from_group(nll, group) if group is not None else nll) / batch
        grads = torch.autograd.grad(loss, locals_)
    with torch.no_grad():
        for p, g in zip(locals_, grads):
            if group is not None:
                all_reduce_(g, group)
            p.sub_(lr * g.to(p.dtype))
        for old, new in zip(param_leaves(stats), param_leaves(new_stats)):
            _local(old).copy_(new)
    return params, stats, loss.detach()


def replicate_state(tree: Any, mesh: Any) -> Any:
    """Every tensor of ``tree`` replicated over ``mesh`` as a DTensor
    (the DDP layout: every rank holds the whole model)."""
    return replicate_pytree(tree, mesh)


def dp_shard_batch(batch: torch.Tensor, mesh: Optional[Any]) -> Any:
    """The batch's leading dim sharded over the mesh's ``"dp"`` dim, as a
    DTensor holding this rank's rows; the batch itself without one."""
    if mesh is None or "dp" not in (mesh.mesh_dim_names or ()):
        return batch
    return shard_pytree(batch, mesh, lambda keys, leaf: ("dp",))


def synthetic_batch(
    config: ResNetConfig, batch_size: int, seed: int, device: Any = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Random NHWC images and integer labels from a seeded
    ``torch.Generator`` on ``device``."""
    device = _resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    size = config.image_size
    images = torch.randn(
        (batch_size, size, size, config.in_channels), generator=gen, device=device
    )
    labels = torch.randint(0, config.num_classes, (batch_size,), generator=gen, device=device)
    return images, labels


def numpy_batch(config: ResNetConfig, batch_size: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """The same kind of batch from ``np.random.default_rng(seed)`` (labels
    int32, as the JAX batch has them), for feeding both packages."""
    rng = np.random.default_rng(seed)
    size = config.image_size
    images = rng.standard_normal((batch_size, size, size, config.in_channels), dtype=np.float32)
    labels = rng.integers(0, config.num_classes, batch_size).astype(np.int32)
    return images, labels
