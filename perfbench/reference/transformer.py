"""Plain PyTorch reference of the GPT-2-shaped training step, and the inputs.

The benchmark makes the weights and the token batches here, from the run's
seed, and hands the same tensors to the program and to this reference. The
reference recomputes the program's first SGD steps from those inputs with
nothing but ``torch`` operations: a learned positional table, pre-LayerNorm
blocks (population variance, eps inside the rsqrt, a scale and no bias), the
tanh GELU MLP, causal softmax attention written out as two products, no
biases, and an LM head tied to the embedding. Gradients come from autograd,
one block of batch rows at a time so that the full-size step fits beside its
activations. Nothing of the program or of JAX is imported.

``tf32=True`` rounds both operands of every matrix product to TF32 (10
mantissa bits, round to nearest) and accumulates in float32, as the tensor
cores do with TF32 on: that is the control, the step computed in the
precision just below the float32 the configuration states.
"""

import math
from typing import Any, Dict, List, Optional

import torch

from .tf32 import mm

# The gradient of a step is the mean of the per-row-block gradients; one row
# of 1024 tokens at GPT-2 XL's widths keeps the activations near 20 GB.
ROWS_PER_BLOCK = 1


def dims(config: Dict[str, Any]) -> Dict[str, Any]:
    """The model's sizes from a configuration file (Hugging Face GPT-2 keys)."""
    d = config["n_embd"]
    return {
        "vocab": config["vocab_size"],
        "d": d,
        "heads": config["n_head"],
        "layers": config["n_layer"],
        "ff": config["n_inner"] or 4 * d,
        "positions": config["n_positions"],
        "eps": config["layer_norm_epsilon"],
        "batch": config["batch_size"],
        "seq": config["seq_len"],
        "lr": config["learning_rate"],
    }


def leaf_shapes(dm: Dict[str, Any]) -> List[tuple]:
    """Shapes of the parameter leaves in the program's tree order."""
    d, f = dm["d"], dm["ff"]
    shapes = [(dm["vocab"], d), (dm["positions"], d), (d,)]
    for _ in range(dm["layers"]):
        shapes += [(d, d), (d, d), (d, d), (d, d), (d, f), (f, d), (d,), (d,)]
    return shapes


def make_weights(dm: Dict[str, Any], seed: int, device: Any) -> List[torch.Tensor]:
    """Every leaf from one draw of a seeded generator on ``device``: weight
    matrices normal × d^-½, norm scales ones, float32."""
    shapes = leaf_shapes(dm)
    sizes = [math.prod(s) for s in shapes]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    scale = 1.0 / math.sqrt(dm["d"])
    leaves = []
    for part, shape in zip(torch.split(flat, sizes), shapes):
        if len(shape) == 1:
            leaves.append(torch.ones(shape, device=device, dtype=torch.float32))
        else:
            leaves.append((part * scale).view(shape))
    del flat
    return leaves


def as_tree(leaves: List[torch.Tensor], dm: Dict[str, Any]) -> Dict[str, Any]:
    """The leaves as the program's nested parameter tree."""
    it = iter(leaves)
    tree = {"embed": next(it), "pos_embed": next(it), "final_ln": next(it), "layers": []}
    for _ in range(dm["layers"]):
        wq, wk, wv, wo, w1, w2, ln1, ln2 = (next(it) for _ in range(8))
        tree["layers"].append({
            "attn": {"wq": wq, "wk": wk, "wv": wv, "wo": wo},
            "mlp": {"w1": w1, "w2": w2},
            "ln1": ln1,
            "ln2": ln2,
        })
    return tree


def make_batches(dm: Dict[str, Any], seed: int, count: int, device: Any) -> torch.Tensor:
    """``count`` token batches ``[count, B, S]`` of uniform ids, from a seeded
    generator on ``device``; step ``i`` trains on batch ``i % count``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(
        0, dm["vocab"], (count, dm["batch"], dm["seq"]), generator=gen, device=device
    )


def _layer_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def loss(tree: Dict[str, Any], tokens: torch.Tensor, dm: Dict[str, Any], tf32: bool) -> torch.Tensor:
    """Mean next-token cross entropy of ``tokens`` ``[b, S]``."""
    b, s = tokens.shape
    h, dh = dm["heads"], dm["d"] // dm["heads"]
    x = tree["embed"][tokens] + tree["pos_embed"][:s]
    causal = torch.ones(s, s, dtype=torch.bool, device=tokens.device).tril()
    for layer in tree["layers"]:
        a = _layer_norm(x, layer["ln1"], dm["eps"])
        q, k, v = (
            mm(a, layer["attn"][w], tf32).view(b, s, h, dh).transpose(1, 2)
            for w in ("wq", "wk", "wv")
        )
        scores = mm(q, k.transpose(-1, -2), tf32) / math.sqrt(dh)
        probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
        att = mm(probs, v, tf32).transpose(1, 2).reshape(b, s, dm["d"])
        x = x + mm(att, layer["attn"]["wo"], tf32)
        a = _layer_norm(x, layer["ln2"], dm["eps"])
        x = x + mm(_gelu_tanh(mm(a, layer["mlp"]["w1"], tf32)), layer["mlp"]["w2"], tf32)
    x = _layer_norm(x, tree["final_ln"], dm["eps"])
    logits = mm(x, tree["embed"].transpose(0, 1), tf32)
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    return -logp.gather(-1, tokens[:, 1:, None]).mean()


def sgd_step(
    leaves: List[torch.Tensor], tokens: torch.Tensor, dm: Dict[str, Any], tf32: bool
) -> float:
    """One SGD step ``p ← p − lr·g`` in place; returns the loss."""
    rows = tokens.shape[0]
    grads: Optional[List[torch.Tensor]] = None
    total = 0.0
    for r0 in range(0, rows, ROWS_PER_BLOCK):
        block = tokens[r0:r0 + ROWS_PER_BLOCK]
        live = [p.detach().requires_grad_() for p in leaves]
        value = loss(as_tree(live, dm), block, dm, tf32)
        part = torch.autograd.grad(value, live)
        weight = block.shape[0] / rows
        total += float(value.detach()) * weight
        if grads is None:
            grads = [g * weight for g in part]
        else:
            for acc, g in zip(grads, part):
                acc.add_(g, alpha=weight)
        del live, value, part
    with torch.no_grad():
        for p, g in zip(leaves, grads):
            p.sub_(dm["lr"] * g)
    return total


def first_steps(
    config: Dict[str, Any],
    weight_seed: int,
    batches: torch.Tensor,
    steps: int,
    device: Any,
    tf32: bool = False,
    rows: Optional[int] = None,
) -> Dict[str, Any]:
    """The readings of the first ``steps`` steps from the seeded weights: each
    step's loss, each leaf's first gradient norm as SGD applies it
    (``‖p₁ − p₀‖ / lr``) and each leaf's change ``‖p_steps − p₀‖``, norms in
    float64. ``rows`` trains on the first rows of each batch only (a fault
    that leaves half the batch out)."""
    dm = dims(config)
    leaves = make_weights(dm, weight_seed, device)
    start = [p.clone() for p in leaves]
    losses, grad1 = [], []
    for i in range(steps):
        tokens = batches[i % batches.shape[0]]
        if rows is not None:
            tokens = tokens[:rows]
        losses.append(sgd_step(leaves, tokens, dm, tf32))
        if i == 0:
            grad1 = [float((p.double() - q.double()).norm()) / dm["lr"] for p, q in zip(leaves, start)]
    change = [float((p.double() - q.double()).norm()) for p, q in zip(leaves, start)]
    return {"losses": losses, "grad1": grad1, "change": change}
