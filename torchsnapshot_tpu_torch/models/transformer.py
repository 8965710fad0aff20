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

The single-device forward, the next-token loss and the SGD training
step are ported, and :func:`shard_params` places a parameter tree on a
``"tp"`` DeviceMesh dim in the JAX package's tensor-parallel layout for
checkpointing; the ring, Ulysses and mesh-sharded (sequence- and
tensor-parallel) forwards raise. ``flash_attention=True`` runs attention through the CUDA
flash kernels (``ops/attention.py``), forward and backward. Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import flash_attention, resolve_flash_block
from ..parallel.mesh import Spec, shard_pytree


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
    # Attention through the CUDA flash kernel instead of the einsum path.
    flash_attention: bool = False
    # Sequence parallelism (ring / Ulysses) is not ported yet.
    ring_attention: Any = False

    def __post_init__(self) -> None:
        if self.ring_attention not in (False, None):
            raise NotImplementedError(
                f"ring_attention={self.ring_attention!r} is not yet ported "
                f"to torchsnapshot_tpu_torch (slice S6)"
            )


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


def forward(
    params: Dict[str, Any],
    tokens: torch.Tensor,  # [B, S] integer
    config: TransformerConfig,
    mesh: Optional[Any] = None,
) -> torch.Tensor:
    """Logits ``[B, S, V]`` float32, as the JAX ``forward`` computes them."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh-sharded forward is not yet ported to torchsnapshot_tpu_torch"
        )
    _, seq_len = tokens.shape
    head_dim = config.d_model // config.n_heads
    n_kv = _n_kv_heads(config)
    h = (params["embed"][tokens] + params["pos_embed"][:seq_len]).to(config.dtype)
    if config.flash_attention:
        resolve_flash_block(seq_len)
    else:
        mask = torch.ones(seq_len, seq_len, dtype=torch.bool, device=tokens.device).tril()

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
            if n_kv != config.n_heads:
                group = config.n_heads // n_kv
                k = k.repeat_interleave(group, dim=1)
                v = v.repeat_interleave(group, dim=1)
            scores = _matmul(q, k.transpose(-1, -2)) / np.sqrt(head_dim)
            scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
            probs = torch.softmax(scores.float(), dim=-1).to(config.dtype)
            attn = _matmul(probs, v)
        attn = attn.transpose(1, 2).flatten(2)
        h = h + _matmul(attn, layer["attn"]["wo"])

        x = _layer_norm(h, layer["ln2"])
        ff = F.gelu(_matmul(x, layer["mlp"]["w1"]), approximate="tanh")
        h = h + _matmul(ff, layer["mlp"]["w2"])

    h = _layer_norm(h, params["final_ln"])
    logits = _matmul(h, params["embed"].transpose(0, 1))  # tied head
    return logits.float()


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


def loss_fn(
    params: Dict[str, Any],
    tokens: torch.Tensor,
    config: TransformerConfig,
    mesh: Optional[Any] = None,
) -> torch.Tensor:
    """Next-token cross entropy, the mean over ``B × (S−1)`` positions:
    ``log_softmax`` of the f32 logits, the targets gathered, as the JAX
    ``loss_fn`` computes it off the ring path."""
    logits = forward(params, tokens, config, mesh)
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    nll = -logp.gather(-1, tokens[:, 1:, None].long())
    return nll.mean()


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
    returned tree holds the same tensors as ``params``, so the step needs
    no second copy of the weights on the card. Gradients come from
    ``torch.autograd.grad`` (no ``.grad`` fields are left behind) and are
    freed as the step returns. Every leaf must require grad."""
    leaves: List[torch.Tensor] = list(param_leaves(params))
    loss = loss_fn(params, tokens, config, mesh)
    grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        for p, g in zip(leaves, grads):
            p.sub_(lr * g.to(p.dtype))
    return params, loss.detach()


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
        def detach(tree):
            if isinstance(tree, dict):
                return {k: detach(v) for k, v in tree.items()}
            if isinstance(tree, list):
                return [detach(v) for v in tree]
            return tree.detach()

        return detach(self.model.params())

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        def assign(params, restored, path):
            if isinstance(params, dict):
                for key in params:
                    assign(params[key], restored[key], f"{path}/{key}")
            elif isinstance(params, list):
                if len(params) != len(restored):
                    raise ValueError(
                        f"{path}: {len(restored)} layers restored into a "
                        f"model of {len(params)}"
                    )
                for i, p in enumerate(params):
                    assign(p, restored[i], f"{path}/{i}")
            elif restored.data_ptr() != params.data_ptr():
                if restored.shape != params.shape or restored.dtype != params.dtype:
                    raise ValueError(
                        f"{path}: restored {restored.dtype}{list(restored.shape)} "
                        f"does not fit parameter {params.dtype}{list(params.shape)}"
                    )
                with torch.no_grad():
                    params.copy_(restored)

        assign(self.model.params(), state_dict, "model")
