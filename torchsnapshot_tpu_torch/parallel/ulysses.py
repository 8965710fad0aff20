"""Ulysses all-to-all sequence parallelism.

The port of ``torchsnapshot_tpu/parallel/ulysses.py``, the second
long-context strategy beside the ring (``ring_attention.py``): one
all-to-all over the sequence-parallel group re-partitions each rank's
``[B, H, S/n, D]`` slice into ``[B, H/n, S, D]`` (the full sequence for a
subset of heads), each rank runs ordinary attention on it, and a second
all-to-all restores the sequence-sharded layout. Causality is exact by
construction. The local attention is the flash kernels (K1–K3 on the
card) or the einsum reference with kv heads repeated.

Each rank calls :func:`ulysses_attention` with its local slice and the
``"sp"`` process group, as the ring does.
"""

import math
from typing import Optional

import torch
import torch.distributed as dist

from ..ops.attention import flash_attention, resolve_flash_block
from .collectives import all_to_all
from .ring_attention import group_rank_size

_NEG_INF = -1e30


def _reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> torch.Tensor:
    """The einsum attention of the JAX package's ``_reference_attention``:
    f32 scores, the -1e30 mask, softmax cast to q's dtype, then P·V."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() / math.sqrt(q.shape[-1])
    if causal:
        length = q.shape[2]
        mask = torch.ones(length, length, dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


def ulysses_attention(
    q: torch.Tensor,  # [B, H, S/n, D]: this rank's contiguous slice
    k: torch.Tensor,  # [B, Hkv, S/n, D]
    v: torch.Tensor,
    group: Optional[dist.ProcessGroup],
    causal: bool = True,
    attn_impl: str = "flash",
) -> torch.Tensor:
    """This rank's slice of exact attention, by head/sequence all-to-all
    re-partitioning (DeepSpeed-Ulysses). ``attn_impl``: ``"flash"`` (the
    flash kernels on the full sequence) or ``"einsum"`` (the dense
    reference). The head counts on this rank (after any tensor-parallel
    split) must divide by the group's size."""
    if attn_impl not in ("einsum", "flash"):
        raise ValueError(f"unknown attn_impl: {attn_impl!r}")
    _, n = group_rank_size(group)
    h, hkv = q.shape[1], k.shape[1]
    if h % n or hkv % n:
        raise ValueError(
            f"ulysses needs heads divisible by the sp axis: H={h}, Hkv={hkv} "
            f"on this rank (after any head sharding), sp={n}. Use ring "
            f"attention for head counts the mesh axis does not divide."
        )
    if attn_impl == "flash":
        resolve_flash_block(n * q.shape[2])
    if n > 1:
        # Split the heads n ways, concatenate the sequence:
        # [B, H/n, S, D], the full sequence for a subset of heads.
        q, k, v = (all_to_all(x, group, split_dim=1, concat_dim=2) for x in (q, k, v))
    if attn_impl == "flash":
        out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=causal)
    else:
        group_size = q.shape[1] // k.shape[1]
        if group_size > 1:
            k = k.repeat_interleave(group_size, dim=1)
            v = v.repeat_interleave(group_size, dim=1)
        out = _reference_attention(q, k, v, causal)
    if n > 1:
        # The inverse re-partition: split the sequence, regather the heads.
        out = all_to_all(out, group, split_dim=2, concat_dim=1)
    return out
