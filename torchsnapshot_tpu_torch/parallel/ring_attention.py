"""Ring attention: exact attention over sequence-sharded Q/K/V.

The port of ``torchsnapshot_tpu/parallel/ring_attention.py``. Each rank
of the sequence-parallel group holds its ``[B, H, S/n, D]`` slice of Q,
K and V, attends its Q to the K/V slice it holds, and passes that slice
to the next rank of the ring (:func:`collectives.rotate`); after n steps
every query has seen every key. The online-softmax merge of the chunks'
``(o, m, l)`` triples makes the streamed result exact.

Where JAX runs one program over the mesh (``shard_map`` with
``lax.ppermute``), each rank here calls :func:`ring_attention` with its
own local slice and the ``"sp"`` process group and gets its local slice
of the output; ``dist.get_rank(group)`` stands for ``axis_index``.
Causality is decided per (query chunk, key chunk) from the static chunk
ids: a future chunk is skipped by a Python branch (JAX: ``lax.cond``),
never launched masked; the diagonal chunk is causal, the past is full.

``chunk_impl="flash"`` runs each chunk through
:func:`~torchsnapshot_tpu_torch.ops.attention.flash_attention_with_lse`
(the CUDA kernels K1–K3 on the card, their plain versions on the host);
its ``(out, lse)`` enters the merge as ``(out, lse, 1)``, so the lse's
cotangent reaches the backward kernels as ``delta' = delta − dlse``.

:func:`ring_attention_zigzag` balances causal work: rank j holds
sub-chunks j and 2n−1−j (:func:`to_zigzag` / :func:`from_zigzag` permute
a global tensor's sequence dim before slicing), so every rank computes
the same number of chunk attentions.
"""

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..ops.attention import flash_attention_with_lse, resolve_flash_block
from .collectives import keep_alive, rotate

_NEG_INF = -1e30

Triple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def group_rank_size(group: Optional[dist.ProcessGroup]) -> Tuple[int, int]:
    """(this rank's index in ``group``, its size); None is a group of one."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def _chunk_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, causal: bool) -> Triple:
    """Block attention of one (q-chunk, k-chunk) pair: (unnormalised out
    ``[B, Hq, Sq, D]`` f32, row max m, row denominator l ``[B, Hq, Sq, 1]``).
    GQA: q-head h attends kv-head h // group, without repeating K/V; the
    causal mask is the chunk's lower triangle."""
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    if hq % hkv:
        raise ValueError(f"query heads ({hq}) must be a multiple of kv heads ({hkv})")
    qg = q.reshape(b, hkv, hq // hkv, sq, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k).float() * scale
    if causal:
        mask = torch.ones(sq, k.shape[2], dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    # A fully masked row has m == -1e30; the guard keeps its exp finite.
    m_safe = torch.clamp(m, min=_NEG_INF / 2)
    p = torch.exp(s - m_safe)
    if causal:
        p = torch.where(mask, p, torch.zeros_like(p))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(b, hq, sq, d), m_safe.reshape(b, hq, sq, 1), l.reshape(b, hq, sq, 1)


def _chunk_triplet(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, chunk_impl: str) -> Triple:
    """(o, m, l) of ``q`` attending to one K/V chunk. A flash chunk's
    (normalised out, lse) is the triple (out, lse, 1): out·e^lse = Σ
    exp(s)·v and 1·e^lse = Σ exp(s)."""
    if chunk_impl == "flash":
        out, lse = flash_attention_with_lse(q.contiguous(), k.contiguous(), v.contiguous(), causal)
        return out.float(), lse, torch.ones_like(lse)
    return _chunk_attn(q, k, v, 1.0 / math.sqrt(q.shape[-1]), causal)


def _merge(acc: Triple, new: Triple) -> Triple:
    """Merge a chunk's (o, m, l) into the running (o, m, l)."""
    o_run, m_run, l_run = acc
    o, m_new, l_new = new
    m = torch.maximum(m_run, m_new)
    alpha = torch.exp(m_run - m)
    beta = torch.exp(m_new - m)
    return o_run * alpha + o * beta, m, l_run * alpha + l_new * beta


def _norm(acc: Triple) -> torch.Tensor:
    """Normalise an online-softmax accumulator; guard all-masked rows."""
    o_run, _, l_run = acc
    return o_run / torch.where(l_run == 0.0, torch.ones_like(l_run), l_run)


def _init(q: torch.Tensor) -> Triple:
    b, h, s, d = q.shape
    return (
        torch.zeros((b, h, s, d), dtype=torch.float32, device=q.device),
        torch.full((b, h, s, 1), _NEG_INF, dtype=torch.float32, device=q.device),
        torch.zeros((b, h, s, 1), dtype=torch.float32, device=q.device),
    )


def _tie_last_hop(out: torch.Tensor, k_cur: torch.Tensor, v_cur: torch.Tensor, n: int) -> torch.Tensor:
    """``out``, tied to the K/V of the last hop. Each hop's output feeds
    the next hop, but the last one's may feed only a chunk this rank
    skips; its backward must still run on this rank, to send the
    cotangent back to the ranks that attended."""
    return keep_alive(out, k_cur, v_cur) if n > 1 else out


def _check_chunk_impl(chunk_impl: str) -> None:
    if chunk_impl not in ("einsum", "flash"):
        raise ValueError(f"unknown chunk_impl: {chunk_impl!r}")


def ring_attention(
    q: torch.Tensor,  # [B, H, S/n, D]: this rank's contiguous slice
    k: torch.Tensor,  # [B, Hkv, S/n, D]
    v: torch.Tensor,
    group: Optional[dist.ProcessGroup],
    causal: bool = True,
    chunk_impl: str = "einsum",
) -> torch.Tensor:
    """This rank's slice of softmax(QKᵀ/√D)·V, where rank i of ``group``
    holds tokens [i·S/n, (i+1)·S/n) of Q, K and V; K/V rotate around the
    ring. Differentiable through both chunk implementations. Every rank
    of the group calls it, forward and backward."""
    _check_chunk_impl(chunk_impl)
    me, n = group_rank_size(group)
    if chunk_impl == "flash":
        resolve_flash_block(q.shape[2])
    acc = _init(q)
    k_cur, v_cur = k, v
    for i in range(n):
        # After i rotations this rank holds the chunk of rank (me − i) mod n.
        src = (me - i) % n
        if not causal or src < me:
            acc = _merge(acc, _chunk_triplet(q, k_cur, v_cur, False, chunk_impl))
        elif src == me:
            acc = _merge(acc, _chunk_triplet(q, k_cur, v_cur, True, chunk_impl))
        # Rotate only between chunk computations (the last hop would be
        # discarded).
        if i < n - 1:
            k_cur, v_cur = rotate(k_cur, v_cur, group=group)
    return _tie_last_hop(_norm(acc).to(q.dtype), k_cur, v_cur, n)


def zigzag_indices(s: int, n: int) -> torch.Tensor:
    """Token permutation for the balanced causal layout: rank j holds
    sub-chunks j and 2n−1−j of size s/(2n). ``x[..., idx, :]`` is ``x`` in
    zigzag order."""
    if s % (2 * n):
        raise ValueError(f"sequence length {s} must be divisible by 2*n={2 * n}")
    c = s // (2 * n)
    order = []
    for j in range(n):
        order.extend(range(j * c, (j + 1) * c))
        order.extend(range((2 * n - 1 - j) * c, (2 * n - j) * c))
    return torch.tensor(order, dtype=torch.long)


def to_zigzag(x: torch.Tensor, n: int, seq_axis: int = 2) -> torch.Tensor:
    """A global tensor permuted into zigzag order along ``seq_axis`` (2 for
    [B, H, S, D]; 1 for [B, S] tokens or [B, S, V] logits), for ``n``
    ranks. Slice it with :func:`seq_slice` afterwards."""
    idx = zigzag_indices(x.shape[seq_axis], n).to(x.device)
    return x.index_select(seq_axis, idx)


def from_zigzag(x: torch.Tensor, n: int, seq_axis: int = 2) -> torch.Tensor:
    """Invert :func:`to_zigzag`."""
    inv = torch.argsort(zigzag_indices(x.shape[seq_axis], n)).to(x.device)
    return x.index_select(seq_axis, inv)


def seq_slice(x: torch.Tensor, group: Optional[dist.ProcessGroup], seq_axis: int = 2) -> torch.Tensor:
    """This rank's contiguous part of a global tensor's sequence dim, as
    JAX's ``shard_seq`` places it; the length must divide evenly."""
    me, n = group_rank_size(group)
    s = x.shape[seq_axis]
    if s % n:
        raise ValueError(f"sequence length {s} must be divisible by sp={n}")
    return x.narrow(seq_axis, me * (s // n), s // n)


def ring_attention_zigzag(
    q: torch.Tensor,  # [B, H, S/n, D]: this rank's slice in ZIGZAG order
    k: torch.Tensor,
    v: torch.Tensor,
    group: Optional[dist.ProcessGroup],
    chunk_impl: str = "einsum",
) -> torch.Tensor:
    """Causal ring attention over zigzag-ordered slices (balanced work).

    Rank j's slice holds the original sub-chunks j and 2n−1−j; causality
    holds w.r.t. the original token order through those global sub-chunk
    ids. Input and output are in zigzag order."""
    _check_chunk_impl(chunk_impl)
    me, n = group_rank_size(group)
    if q.shape[2] % 2:
        raise ValueError(
            f"sequence length {n * q.shape[2]} must be divisible by 2*sp={2 * n}"
        )
    c = q.shape[2] // 2  # sub-chunk length
    if chunk_impl == "flash":
        resolve_flash_block(c)
    q_halves = (q[:, :, :c], q[:, :, c:])
    q_ids = (me, 2 * n - 1 - me)
    accs = [_init(q_halves[0]), _init(q_halves[1])]
    k_cur, v_cur = k, v
    for i in range(n):
        src = (me - i) % n
        for half, k_id in ((0, src), (1, 2 * n - 1 - src)):
            k_sub = k_cur[:, :, half * c:(half + 1) * c]
            v_sub = v_cur[:, :, half * c:(half + 1) * c]
            for j in (0, 1):
                if k_id <= q_ids[j]:  # a future sub-chunk is skipped
                    new = _chunk_triplet(q_halves[j], k_sub, v_sub, k_id == q_ids[j], chunk_impl)
                    accs[j] = _merge(accs[j], new)
        if i < n - 1:
            k_cur, v_cur = rotate(k_cur, v_cur, group=group)
    out = torch.cat([_norm(accs[0]), _norm(accs[1])], dim=2).to(q.dtype)
    return _tie_last_hop(out, k_cur, v_cur, n)
