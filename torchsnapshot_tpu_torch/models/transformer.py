"""The flagship decoder-only transformer, ported from the JAX package.

The GPT-2 shape of ``torchsnapshot_tpu/models/transformer.py``: a learned
positional table, pre-LayerNorm blocks (population variance, eps 1e-6
inside the rsqrt, no bias), a tanh-approximated GELU MLP, grouped-query
attention, no biases, and an LM head tied to the embedding.

The parameter layout is the JAX package's, untransposed: weights are
``[in, out]`` and used as ``x @ W``, the embedding is ``[V, D]``. The
nested tree ``{"embed", "pos_embed", "final_ln", "layers": [{"attn":
{wq, wk, wv, wo}, "mlp": {w1, w2}, "ln1", "ln2"}]}`` is the JAX
``init_params`` pytree, so ``TransformerState`` gives a snapshot the same
logical paths, dtypes, shapes and payload bytes as a JAX take of the same
parameters, and one snapshot loads into either package.

``flash_attention=True`` runs attention through the CUDA flash kernels
(``ops/attention.py``), forward and backward. On a DeviceMesh with
``dp``, ``sp`` and ``tp`` dims (any of them), every rank of the
``torch.distributed`` job calls :func:`forward`, :func:`loss_fn` and
:func:`sgd_train_step` with the parameters that :func:`shard_params`
placed (the Megatron layout over ``tp``) and the global token batch; each
works on this rank's rows (``dp``) and columns (``sp``) of it, with the
explicit collectives of ``parallel/collectives.py`` where GSPMD inserts
its own. ``ring_attention`` picks the sequence-parallel attention over
``sp``: the contiguous or zigzag ring (``parallel/ring_attention.py``) or
Ulysses (``parallel/ulysses.py``), each with ``ring_chunk_impl`` einsum
or flash chunks. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""

from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..io_preparer import is_dtensor
from ..ops.attention import flash_attention, resolve_flash_block
from ..parallel.collectives import (
    all_reduce_,
    chunk_sizes,
    copy_to_group,
    gather_from_group,
    group_of,
    reduce_from_group,
)
from ..parallel.mesh import Spec, shard_pytree
from ..parallel.ring_attention import (
    ring_attention,
    ring_attention_zigzag,
    zigzag_indices,
)
from ..parallel.ulysses import ulysses_attention


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 256
    d_model: int = 128
    n_heads: int = 4
    # Key/value heads (grouped-query attention); None = n_heads.
    n_kv_heads: Any = None
    n_layers: int = 2
    d_ff: int = 512
    max_seq_len: int = 128
    # Parameter dtype of the weight matrices, embedding and positions.
    dtype: torch.dtype = torch.float32
    # Attention through the CUDA flash kernel instead of the einsum path
    # (one process, no mesh).
    flash_attention: bool = False
    # Sequence-parallel attention over the mesh's "sp" dim, as the JAX
    # package's: False (off), True or "contiguous" (rank j holds tokens
    # [j·S/n, (j+1)·S/n)), "zigzag" (rank j holds sub-chunks j and
    # 2n−1−j; loss_fn permutes the tokens, and forward takes and returns
    # them in zigzag order) or "ulysses" (all-to-all to full-sequence
    # attention on a subset of heads; the heads on a rank must divide by
    # sp).
    ring_attention: Any = False
    # Local attention of the sequence-parallel modes: "einsum" or "flash"
    # (the flash kernels). For the rings it is the chunk attention, and
    # resolve_flash_block applies to the chunk length (S / sp, halved
    # again under zigzag); for Ulysses to the full sequence length.
    ring_chunk_impl: str = "einsum"


def _n_kv_heads(config: TransformerConfig) -> int:
    n_kv = config.n_kv_heads
    if n_kv is None:
        return config.n_heads
    if n_kv <= 0 or config.n_heads % n_kv:
        raise ValueError(
            f"n_heads ({config.n_heads}) must be a positive multiple of "
            f"n_kv_heads ({n_kv})"
        )
    return n_kv


def _ring_mode(config: TransformerConfig) -> Optional[str]:
    """config.ring_attention as None | "contiguous" | "zigzag" | "ulysses"."""
    r = config.ring_attention
    if r is False or r is None:
        return None
    if r is True or r == "contiguous":
        return "contiguous"
    if r in ("zigzag", "ulysses"):
        return r
    raise ValueError(f"unknown ring_attention mode: {r!r}")


def _resolve_device(device: Any) -> torch.device:
    """``None`` means the card; only an explicit device (``"cpu"`` in the
    tests) runs elsewhere."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "torchsnapshot_tpu_torch runs on CUDA by default and no CUDA "
                "device is available; pass device='cpu' to run on the host."
            )
        return torch.device("cuda")
    return torch.device(device)


def init_params(
    config: TransformerConfig, seed: int, device: Any = None
) -> Dict[str, Any]:
    """A parameter tree drawn from a seeded ``torch.Generator`` (normal ×
    d_model^-½ for matrices, ones for the norm scales), as the JAX
    ``init_params`` draws from ``jax.random``. The numbers differ from
    JAX's; feed both packages the same arrays via :func:`params_from_numpy`
    to compare them."""
    device = _resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    scale = 1.0 / np.sqrt(config.d_model)
    kv_dim = (config.d_model // config.n_heads) * _n_kv_heads(config)

    def dense(*shape):
        w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return (w * scale).to(config.dtype)

    def ones():
        return torch.ones(config.d_model, dtype=torch.float32, device=device)

    d, f = config.d_model, config.d_ff
    layers = [
        {
            "attn": {
                "wq": dense(d, d),
                "wk": dense(d, kv_dim),
                "wv": dense(d, kv_dim),
                "wo": dense(d, d),
            },
            "mlp": {"w1": dense(d, f), "w2": dense(f, d)},
            "ln1": ones(),
            "ln2": ones(),
        }
        for _ in range(config.n_layers)
    ]
    return {
        "embed": dense(config.vocab_size, d),
        "pos_embed": dense(config.max_seq_len, d),
        "final_ln": ones(),
        "layers": layers,
    }


def params_from_numpy(tree: Any, device: Any = None) -> Any:
    """The JAX ``init_params`` pytree, as numpy arrays, as a port
    parameter tree on ``device``. Layouts are kept (nothing transposed)."""
    device = _resolve_device(device)
    if isinstance(tree, dict):
        return {key: params_from_numpy(val, device) for key, val in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(val, device) for val in tree]
    arr = np.array(tree, copy=True, order="C")
    if arr.dtype.name == "bfloat16":
        # numpy holds bfloat16 only through ml_dtypes: carry the bits.
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the promoted dtype, as jnp.einsum promotes mixed
    operands (bf16 × f32 → f32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt))


def _layer_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + 1e-6) * scale


def _einsum_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_offset: int, dtype: torch.dtype
) -> torch.Tensor:
    """Causal attention of ``[B, H, Sq, Dh]`` queries at global positions
    ``q_offset + i`` over ``[B, Hkv, Sk, Dh]`` keys at positions ``j``:
    the full score matrix, the -1e30 mask, an f32 softmax cast to
    ``dtype``, kv heads repeated for GQA (the JAX einsum path)."""
    group = q.shape[1] // k.shape[1]
    if group > 1:
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
    sq, sk = q.shape[2], k.shape[2]
    rows = torch.arange(sq, device=q.device)[:, None] + q_offset
    mask = rows >= torch.arange(sk, device=q.device)[None, :]
    scores = _matmul(q, k.transpose(-1, -2)) / np.sqrt(q.shape[-1])
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores.float(), dim=-1).to(dtype)
    return _matmul(probs, v)


def _check_mode(config: TransformerConfig, mesh: Optional[Any]) -> Optional[str]:
    mode = _ring_mode(config)
    if mode is not None:
        if config.flash_attention:
            raise ValueError("flash_attention and ring_attention are mutually exclusive")
        if mesh is None or "sp" not in (mesh.mesh_dim_names or ()):
            raise ValueError('ring_attention requires a mesh with an "sp" axis')
    if config.flash_attention and mesh is not None:
        raise ValueError(
            "flash_attention currently supports single-device (per-host) "
            "execution only; drop the mesh or use the einsum path."
        )
    return mode


def forward(
    params: Dict[str, Any],
    tokens: torch.Tensor,  # [B, S] integer
    config: TransformerConfig,
    mesh: Optional[Any] = None,
) -> torch.Tensor:
    """Logits float32, as the JAX ``forward`` computes them.

    Without a mesh: ``[B, S, V]`` for the ``[B, S]`` tokens. Under a mesh,
    every rank passes the global ``[B, S]`` tokens (in zigzag order under
    ``ring_attention="zigzag"``, as JAX's forward takes them) and gets
    **this rank's block** ``[B/dp, S/sp, V]`` of the global logits: its
    ``dp`` rows and its ``sp`` columns, in zigzag order under zigzag."""
    mode = _check_mode(config, mesh)
    if mesh is not None:
        return _mesh_forward(params, tokens, config, mesh, mode)
    _, seq_len = tokens.shape
    head_dim = config.d_model // config.n_heads
    n_kv = _n_kv_heads(config)
    h = (params["embed"][tokens] + params["pos_embed"][:seq_len]).to(config.dtype)
    if config.flash_attention:
        resolve_flash_block(seq_len)

    for layer in params["layers"]:
        x = _layer_norm(h, layer["ln1"])
        q = _matmul(x, layer["attn"]["wq"])
        k = _matmul(x, layer["attn"]["wk"])
        v = _matmul(x, layer["attn"]["wv"])
        # [B, S, H*Dh] -> [B, H, S, Dh]
        q = q.unflatten(-1, (config.n_heads, head_dim)).transpose(1, 2)
        k = k.unflatten(-1, (n_kv, head_dim)).transpose(1, 2)
        v = v.unflatten(-1, (n_kv, head_dim)).transpose(1, 2)
        if config.flash_attention:
            attn = flash_attention(
                q.contiguous(), k.contiguous(), v.contiguous(), causal=True
            )
        else:
            attn = _einsum_attention(q, k, v, 0, config.dtype)
        attn = attn.transpose(1, 2).flatten(2)
        h = h + _matmul(attn, layer["attn"]["wo"])

        x = _layer_norm(h, layer["ln2"])
        ff = F.gelu(_matmul(x, layer["mlp"]["w1"]), approximate="tanh")
        h = h + _matmul(ff, layer["mlp"]["w2"])

    h = _layer_norm(h, params["final_ln"])
    logits = _matmul(h, params["embed"].transpose(0, 1))  # tied head
    return logits.float()


def _dim(mesh: Any, name: str) -> Tuple[int, int]:
    """(this rank's coordinate, size) on mesh dim ``name``; (0, 1) when
    the mesh has no such dim."""
    names = mesh.mesh_dim_names or ()
    if name not in names:
        return 0, 1
    i = names.index(name)
    return mesh.get_coordinate()[i], mesh.size(i)


def _local_block(x: torch.Tensor, mesh: Any) -> torch.Tensor:
    """This rank's ``dp`` rows and ``sp`` columns of a ``[B, S, ...]``
    tensor: contiguous blocks, as ``P("dp", "sp")`` places them."""
    (dp_i, dp), (sp_i, sp) = _dim(mesh, "dp"), _dim(mesh, "sp")
    b, s = x.shape[:2]
    if b % dp:
        raise ValueError(f"batch {b} must be divisible by dp={dp}")
    if s % sp:
        raise ValueError(f"sequence length {s} must be divisible by sp={sp}")
    return x.narrow(0, dp_i * (b // dp), b // dp).narrow(1, sp_i * (s // sp), s // sp)


def _local(p: Any) -> torch.Tensor:
    """A leaf's local tensor: a DTensor's (differentiably), or the tensor."""
    return p.to_local() if is_dtensor(p) else p


def _tp_local(p: Any, dim: int, mesh: Any) -> torch.Tensor:
    """The local tensor of a weight matrix or the embedding, which over
    ``tp`` > 1 must be sharded on ``dim`` as :func:`shard_params` does."""
    from torch.distributed.tensor import Shard

    if _dim(mesh, "tp")[1] > 1 and not (
        is_dtensor(p) and p.placements[mesh.mesh_dim_names.index("tp")] == Shard(dim)
    ):
        raise ValueError(
            "under a mesh with tp > 1 the weight matrices and the embedding "
            "must be the DTensors of shard_params"
        )
    return _local(p)


def _mesh_forward(
    params: Dict[str, Any],
    tokens: torch.Tensor,
    config: TransformerConfig,
    mesh: Any,
    mode: Optional[str],
) -> torch.Tensor:
    """The forward on this rank's block, with the collectives GSPMD
    inserts for the JAX package: q/k/v/w1 column-parallel and wo/w2
    row-parallel over ``tp`` (Megatron's pair), the embedding
    vocab-parallel (a masked lookup, then an all-reduce) and the tied head
    over the local vocab shard, all-gathered. Heads ride ``tp`` only when
    it divides both head counts, as in JAX; otherwise q/k/v are gathered
    over ``tp``, every rank attends with all heads, and each keeps its
    columns of the result before ``wo``."""
    seq_len = tokens.shape[1]
    tp_i, tp = _dim(mesh, "tp")
    sp_i, sp = _dim(mesh, "sp")
    tp_group, sp_group = group_of(mesh, "tp"), group_of(mesh, "sp")
    head_dim = config.d_model // config.n_heads
    n_kv = _n_kv_heads(config)
    heads_split = config.n_heads % tp == 0 and n_kv % tp == 0
    n_q_att, n_kv_att = (config.n_heads // tp, n_kv // tp) if heads_split else (config.n_heads, n_kv)

    def to_tp(x):
        return copy_to_group(x, tp_group) if tp_group is not None else x

    def from_tp(x):
        return reduce_from_group(x, tp_group) if tp_group is not None else x

    def full_heads(x, width):
        if heads_split or tp_group is None:
            return x
        return gather_from_group(x, tp_group, -1, width, reduce_grad=True)

    # Positions: each slot's ORIGINAL position (zigzag tokens arrive
    # permuted); this rank's columns of them.
    positions = (
        zigzag_indices(seq_len, sp) if mode == "zigzag" else torch.arange(seq_len)
    ).to(tokens.device)
    positions = positions.narrow(0, sp_i * (seq_len // sp), seq_len // sp)
    tok = _local_block(tokens, mesh)

    embed = _tp_local(params["embed"], 0, mesh)
    vocab_offset = sum(chunk_sizes(config.vocab_size, tp)[:tp_i])
    rows = tok.long() - vocab_offset
    mine = (rows >= 0) & (rows < embed.shape[0])
    emb = embed[rows.clamp(0, max(embed.shape[0] - 1, 0))] * mine[..., None].to(embed.dtype)
    h = (from_tp(emb) + _local(params["pos_embed"])[positions]).to(config.dtype)

    d_model, kv_dim = config.d_model, head_dim * n_kv
    col_offset = sum(chunk_sizes(d_model, tp)[:tp_i])
    for layer in params["layers"]:
        attn_p, mlp_p = layer["attn"], layer["mlp"]
        x = to_tp(_layer_norm(h, _local(layer["ln1"])))
        q = full_heads(_matmul(x, _tp_local(attn_p["wq"], 1, mesh)), d_model)
        k = full_heads(_matmul(x, _tp_local(attn_p["wk"], 1, mesh)), kv_dim)
        v = full_heads(_matmul(x, _tp_local(attn_p["wv"], 1, mesh)), kv_dim)
        q = q.unflatten(-1, (n_q_att, head_dim)).transpose(1, 2).contiguous()
        k = k.unflatten(-1, (n_kv_att, head_dim)).transpose(1, 2).contiguous()
        v = v.unflatten(-1, (n_kv_att, head_dim)).transpose(1, 2).contiguous()
        if mode == "zigzag":
            attn = ring_attention_zigzag(q, k, v, sp_group, chunk_impl=config.ring_chunk_impl)
        elif mode == "contiguous":
            attn = ring_attention(q, k, v, sp_group, causal=True, chunk_impl=config.ring_chunk_impl)
        elif mode == "ulysses":
            attn = ulysses_attention(q, k, v, sp_group, causal=True, attn_impl=config.ring_chunk_impl)
        else:
            if sp_group is not None:
                # The einsum path on sequence-sharded activations: each
                # rank attends to the whole sequence's K/V.
                k = gather_from_group(k, sp_group, 2, seq_len, reduce_grad=True)
                v = gather_from_group(v, sp_group, 2, seq_len, reduce_grad=True)
            attn = _einsum_attention(q, k, v, sp_i * (seq_len // sp), config.dtype)
        attn = attn.transpose(1, 2).flatten(2)
        if not heads_split and tp_group is not None:
            attn = attn.narrow(-1, col_offset, chunk_sizes(d_model, tp)[tp_i])
        h = h + from_tp(_matmul(attn, _tp_local(attn_p["wo"], 0, mesh)))

        x = to_tp(_layer_norm(h, _local(layer["ln2"])))
        ff = F.gelu(_matmul(x, _tp_local(mlp_p["w1"], 1, mesh)), approximate="tanh")
        h = h + from_tp(_matmul(ff, _tp_local(mlp_p["w2"], 0, mesh)))

    h = to_tp(_layer_norm(h, _local(params["final_ln"])))
    logits = _matmul(h, embed.transpose(0, 1)).float()  # tied head, local vocab
    if tp_group is not None:
        # Every tp rank computes the loss on the same full logits: each
        # keeps its own vocab columns of the cotangent.
        logits = gather_from_group(logits, tp_group, -1, config.vocab_size, reduce_grad=False)
    return logits


def param_sharding_rules(keys: Tuple[str, ...], leaf: Any) -> Spec:
    """tp-shard the big matrices; replicate norms and positions.

    Column-parallel (wq/wk/wv/w1) shard the output dim, row-parallel
    (wo/w2) the input dim — the Megatron layout — and the embedding its
    vocab dim, as the JAX package's ``param_sharding_rules``."""
    name = keys[-1]
    if name in ("wq", "wk", "wv", "w1"):
        return (None, "tp")
    if name in ("wo", "w2", "embed"):
        return ("tp", None)
    return None


def shard_params(params: Dict[str, Any], mesh: Any) -> Dict[str, Any]:
    """The parameter tree as DTensors on ``mesh`` (which has a ``"tp"``
    dim) per :func:`param_sharding_rules`; each rank keeps its box."""
    return shard_pytree(params, mesh, param_sharding_rules)


def param_leaves(params: Any) -> Iterator[torch.Tensor]:
    """The tensors of a parameter tree, in the tree's own order (dict
    keys as given, list items in order)."""
    if isinstance(params, dict):
        for val in params.values():
            yield from param_leaves(val)
    elif isinstance(params, (list, tuple)):
        for val in params:
            yield from param_leaves(val)
    else:
        yield params


def map_leaves(fn, tree: Any) -> Any:
    """``tree`` with ``fn`` applied to every leaf (dicts keep their key
    order; lists and tuples come back as lists)."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_leaves(fn, v) for v in tree]
    return fn(tree)


def copy_into(held: Any, restored: Any, path: str) -> None:
    """Copy each tensor of ``restored`` into the matching tensor of
    ``held`` (a DTensor's local tensor), matched by key, in place; a
    tensor that already is the held one is skipped. Raises on a shape,
    dtype or length that does not fit."""
    if isinstance(held, dict):
        for key in held:
            copy_into(held[key], restored[key], f"{path}/{key}")
    elif isinstance(held, (list, tuple)):
        if len(held) != len(restored):
            raise ValueError(f"{path}: {len(restored)} layers restored into a model of {len(held)}")
        for i, (h, r) in enumerate(zip(held, restored)):
            copy_into(h, r, f"{path}/{i}")
    else:
        dst, src = _local(held), _local(restored)
        if src.data_ptr() == dst.data_ptr():
            return
        if src.shape != dst.shape or src.dtype != dst.dtype:
            raise ValueError(
                f"{path}: restored {src.dtype}{list(src.shape)} "
                f"does not fit parameter {dst.dtype}{list(dst.shape)}"
            )
        with torch.no_grad():
            dst.copy_(src)


def loss_fn(
    params: Dict[str, Any],
    tokens: torch.Tensor,
    config: TransformerConfig,
    mesh: Optional[Any] = None,
) -> torch.Tensor:
    """Next-token cross entropy, the mean over ``B × (S−1)`` positions:
    ``log_softmax`` of the f32 logits, the targets gathered, as the JAX
    ``loss_fn`` computes it. ``tokens`` are the global batch in original
    order.

    Under a mesh every rank passes the same global tokens. Under zigzag
    the tokens, their next-token targets and the validity mask are
    permuted together here, once a step; each rank sums the NLL of its
    block of positions, and the sum is all-reduced over ``sp`` and ``dp``,
    so every rank returns the global loss."""
    if mesh is None:
        logits = forward(params, tokens, config, mesh)
        logp = torch.log_softmax(logits[:, :-1], dim=-1)
        nll = -logp.gather(-1, tokens[:, 1:, None].long())
        return nll.mean()
    b, s = tokens.shape
    # The final position has no target (the rolled-in first token).
    targets = tokens.roll(-1, dims=1)
    valid = (torch.arange(s, device=tokens.device) < s - 1).expand(b, s)
    if _check_mode(config, mesh) == "zigzag":
        idx = zigzag_indices(s, _dim(mesh, "sp")[1]).to(tokens.device)
        tokens, targets, valid = tokens[:, idx], targets[:, idx], valid[:, idx]
    logits = forward(params, tokens, config, mesh)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, _local_block(targets, mesh)[..., None].long())[..., 0]
    total = (nll * _local_block(valid, mesh)).sum()
    for name in ("sp", "dp"):
        group = group_of(mesh, name)
        if group is not None:
            total = reduce_from_group(total, group)
    return total / (b * (s - 1))


def loss_and_grads(
    params: Dict[str, Any],
    tokens: torch.Tensor,
    config: TransformerConfig,
    mesh: Optional[Any] = None,
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(loss, the gradient of every leaf in :func:`param_leaves` order),
    as ``jax.value_and_grad(loss_fn)`` gives them: a DTensor leaf's
    gradient is its local part of the global gradient.

    Under a mesh each rank's autograd gives the gradient of its own
    rows and columns of tokens; the gradients are summed over ``sp`` and
    ``dp``, over which every leaf is replicated. Over ``tp`` nothing is
    summed: Megatron's pair already makes a replicated leaf's gradient
    whole on each tp rank, and a sharded leaf's is its own. Every leaf
    must require grad."""
    leaves: List[torch.Tensor] = list(param_leaves(params))
    loss = loss_fn(params, tokens, config, mesh)
    grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        grads = [_local(g) for g in grads]
        for name in ("sp", "dp"):
            group = group_of(mesh, name)
            if group is not None:
                for g in grads:
                    all_reduce_(g, group)
    return loss.detach(), grads


def sgd_train_step(
    params: Dict[str, Any],
    tokens: torch.Tensor,
    config: TransformerConfig,
    mesh: Optional[Any] = None,
    lr: float = 1e-2,
) -> Tuple[Dict[str, Any], torch.Tensor]:
    """One SGD step: ``p ← p − lr·g`` for every parameter, returning
    ``(params, loss)`` as the JAX ``sgd_train_step`` does.

    Unlike JAX, which returns a new tree, the update is **in place**: the
    returned tree holds the same tensors as ``params`` (a DTensor's local
    tensor is updated), so the step needs no second copy of the weights
    on the card. Gradients come from :func:`loss_and_grads` (no ``.grad``
    fields are left behind) and are freed as the step returns."""
    loss, grads = loss_and_grads(params, tokens, config, mesh)
    with torch.no_grad():
        for p, g in zip(param_leaves(params), grads):
            _local(p).sub_(lr * g.to(p.dtype))
    return params, loss


class Transformer(nn.Module):
    """The model as an ``nn.Module`` holding the parameter tree.

    Parameters are registered under the tree's own names (``layers.3.
    attn.wq``) and require grad; :meth:`params` returns the nested tree of
    those same tensors, which :func:`forward`, :func:`sgd_train_step` and
    :class:`TransformerState` use. Run inference under ``torch.no_grad()``.
    """

    def __init__(self, config: TransformerConfig, params: Dict[str, Any]) -> None:
        super().__init__()
        self.config = config
        self.embed = nn.Parameter(params["embed"])
        self.pos_embed = nn.Parameter(params["pos_embed"])
        self.final_ln = nn.Parameter(params["final_ln"])
        self.layers = nn.ModuleList()
        for layer in params["layers"]:
            block = nn.Module()
            # An OrderedDict keeps the JAX key order (a plain dict would be
            # sorted by ParameterDict), so manifests list keys alike.
            block.attn = nn.ParameterDict(OrderedDict(
                (n, nn.Parameter(t)) for n, t in layer["attn"].items()
            ))
            block.mlp = nn.ParameterDict(OrderedDict(
                (n, nn.Parameter(t)) for n, t in layer["mlp"].items()
            ))
            block.ln1 = nn.Parameter(layer["ln1"])
            block.ln2 = nn.Parameter(layer["ln2"])
            self.layers.append(block)

    @classmethod
    def init(cls, config: TransformerConfig, seed: int, device: Any = None) -> "Transformer":
        return cls(config, init_params(config, seed, device))

    def params(self) -> Dict[str, Any]:
        return {
            "embed": self.embed,
            "pos_embed": self.pos_embed,
            "final_ln": self.final_ln,
            "layers": [
                {
                    "attn": dict(block.attn.items()),
                    "mlp": dict(block.mlp.items()),
                    "ln1": block.ln1,
                    "ln2": block.ln2,
                }
                for block in self.layers
            ],
        }

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward(self.params(), tokens, self.config)


class TransformerState:
    """A ``Stateful`` over a :class:`Transformer`: its state dict is the
    JAX-shaped parameter tree. Restore copies into the parameters in
    place when the restored tensor is not already one of them."""

    def __init__(self, model: Transformer) -> None:
        self.model = model

    def state_dict(self) -> Dict[str, Any]:
        return map_leaves(lambda t: t.detach(), self.model.params())

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        copy_into(self.model.params(), state_dict, "model")
