"""Rank functions and cases of the port's sequence-parallel tests.

Each rank function runs in a process that ``run_multiprocess`` spawned
into a gloo process group, runs every case of its file, and saves its
local results as ``.npz`` files in an output directory that the test
reads. Kept apart from the test files, which import JAX, so a spawned
rank imports only torch, numpy and the port."""

import json
import os

import numpy as np
import torch

from torchsnapshot_tpu_torch import Snapshot
from torchsnapshot_tpu_torch.io_preparer import dtensor_box, is_dtensor
from torchsnapshot_tpu_torch.models import transformer as ttf
from torchsnapshot_tpu_torch.parallel import collectives, ring_attention as ring
from torchsnapshot_tpu_torch.parallel.mesh import make_mesh, replicate_pytree
from torchsnapshot_tpu_torch.parallel.ulysses import ulysses_attention
from torchsnapshot_tpu_torch.utils.train_state import PytreeStateful

# Attention cases at sp 2: (name, kind, (B, Hq, Hkv, S, D), causal, impl,
# with gradients). kind: "ring" (contiguous), "zigzag" or "ulysses".
RING_CASES = [
    ("ring_causal_a", "ring", (2, 2, 2, 64, 16), True, "einsum", False),
    ("ring_full_a", "ring", (2, 2, 2, 64, 16), False, "einsum", False),
    ("ring_causal_b", "ring", (1, 4, 4, 128, 32), True, "einsum", False),
    ("ring_full_b", "ring", (1, 4, 4, 128, 32), False, "einsum", False),
    ("ring_grads", "ring", (1, 2, 2, 32, 8), True, "einsum", True),
    ("ring_flash_causal", "ring", (1, 2, 2, 256, 32), True, "flash", False),
    ("ring_flash_full", "ring", (1, 2, 2, 256, 32), False, "flash", False),
    ("ring_flash_grads", "ring", (2, 2, 2, 128, 16), True, "flash", True),
    ("ring_gqa_einsum", "ring", (1, 4, 2, 128, 16), True, "einsum", False),
    ("ring_gqa_flash", "ring", (1, 4, 2, 128, 16), True, "flash", False),
    ("zigzag", "zigzag", (2, 2, 2, 64, 16), True, "einsum", False),
    ("zigzag_grads", "zigzag", (1, 2, 2, 32, 8), True, "einsum", True),
    ("zigzag_flash", "zigzag", (1, 2, 2, 256, 16), True, "flash", True),
    ("zigzag_gqa_einsum", "zigzag", (1, 4, 2, 128, 8), True, "einsum", True),
    ("zigzag_gqa_flash", "zigzag", (1, 4, 2, 128, 8), True, "flash", True),
]

ULYSSES_CASES = [
    ("ulysses_causal_einsum", "ulysses", (2, 8, 8, 64, 16), True, "einsum", False),
    ("ulysses_causal_flash", "ulysses", (2, 8, 8, 64, 16), True, "flash", False),
    ("ulysses_full_einsum", "ulysses", (2, 8, 8, 64, 16), False, "einsum", False),
    ("ulysses_full_flash", "ulysses", (2, 8, 8, 64, 16), False, "flash", False),
    ("ulysses_grads_einsum", "ulysses", (1, 8, 8, 64, 8), True, "einsum", True),
    ("ulysses_grads_flash", "ulysses", (1, 8, 8, 64, 8), True, "flash", True),
    ("ulysses_gqa", "ulysses", (1, 16, 8, 64, 8), True, "flash", False),
]

TINY = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq_len=32)
# Transformer cases at world 4: (name, mesh axes, config, token batch).
# The widths are those of the JAX package's own tests of each mode (depth
# cut to one layer in two cases); "zigzag_odd_heads" has a head count
# that tp does not divide.
MODEL_CASES = [
    ("zigzag_tp", {"dp": 1, "sp": 2, "tp": 2}, dict(TINY, ring_attention="zigzag"), (4, 32)),
    ("zigzag_flash_tp", {"dp": 1, "sp": 2, "tp": 2},
     dict(TINY, n_layers=1, max_seq_len=128, ring_attention="zigzag", ring_chunk_impl="flash"),
     (2, 128)),
    ("zigzag_odd_heads", {"dp": 1, "sp": 2, "tp": 2},
     dict(TINY, d_model=48, n_heads=3, n_layers=1, ring_attention="zigzag"), (4, 32)),
    ("contiguous_dp_sp", {"dp": 2, "sp": 2}, dict(TINY, ring_attention=True), (4, 32)),
]
ULYSSES_MODEL_CASES = [
    ("ulysses_dp_sp", {"dp": 2, "sp": 2},
     dict(vocab_size=64, d_model=64, n_heads=8, n_layers=2, d_ff=64, max_seq_len=32,
          ring_attention="ulysses"), (4, 32)),
    ("ulysses_einsum_tp", {"dp": 1, "sp": 2, "tp": 2},
     dict(vocab_size=64, d_model=64, n_heads=8, n_layers=2, d_ff=64, max_seq_len=32,
          ring_attention="ulysses", ring_chunk_impl="einsum"), (4, 32)),
]
LR = 1e-2


def qkv(case):
    """The case's global q, k, v as float32 numpy arrays, from its name."""
    _, _, (b, hq, hkv, s, d), _, _, _ = case
    rng = np.random.default_rng(sum(map(ord, case[0])))
    return tuple(
        rng.standard_normal((b, h, s, d)).astype(np.float32) for h in (hq, hkv, hkv)
    )


def tokens_for(case):
    _, _, cfg, (b, s) = case
    rng = np.random.default_rng(sum(map(ord, case[0])) + 1)
    return rng.integers(0, cfg["vocab_size"], (b, s)).astype(np.int32)


def _counting_chunks(counts):
    """Count the ring module's chunk attentions in this process."""
    chunk = ring._chunk_triplet

    def counted(*args, **kwargs):
        counts[0] += 1
        return chunk(*args, **kwargs)

    ring._chunk_triplet = counted


def attention_cases(rank, world, cases, out_dir):
    """Each case's local output (and, with gradients, the local gradients
    of sum(out²) over the ranks) on a ``{"sp": world}`` mesh, and the
    number of chunk attentions the ring ran."""
    torch.set_num_threads(1)  # the ranks share the host's cores
    mesh = make_mesh({"sp": world}, "cpu")
    group = mesh.get_group("sp")
    counts = [0]
    _counting_chunks(counts)
    chunks = {}
    for case in cases:
        name, kind, _, causal, impl, grads = case
        q, k, v = (torch.from_numpy(x) for x in qkv(case))
        if kind == "zigzag":
            q, k, v = (ring.to_zigzag(x, world) for x in (q, k, v))
        q, k, v = (ring.seq_slice(x, group).clone().requires_grad_(grads) for x in (q, k, v))
        counts[0] = 0
        if kind == "ring":
            out = ring.ring_attention(q, k, v, group, causal=causal, chunk_impl=impl)
        elif kind == "zigzag":
            out = ring.ring_attention_zigzag(q, k, v, group, chunk_impl=impl)
        else:
            out = ulysses_attention(q, k, v, group, causal=causal, attn_impl=impl)
        chunks[name] = counts[0]
        result = {"out": out.detach().numpy()}
        if grads:
            dq, dk, dv = torch.autograd.grad((out.float() ** 2).sum(), (q, k, v))
            result.update(dq=dq.numpy(), dk=dk.numpy(), dv=dv.numpy())
        np.savez(os.path.join(out_dir, f"{name}_{rank}.npz"), **result)
    with open(os.path.join(out_dir, f"chunks_{rank}.json"), "w") as f:
        json.dump(chunks, f)
    with open(os.path.join(out_dir, f"rejections_{rank}.json"), "w") as f:
        json.dump(rejections(group), f)


def rejections(group):
    """The error each input that the JAX package refuses gets from the
    port: name -> "ValueError: message", or None if it passed."""
    zeros = torch.zeros
    tries = {
        "ring_indivisible": lambda: ring.seq_slice(zeros(1, 1, 61, 8), group),
        "zigzag_indivisible": lambda: ring.to_zigzag(zeros(1, 1, 42, 8), 2),
        "zigzag_odd_slice": lambda: ring.ring_attention_zigzag(*[zeros(1, 1, 21, 8)] * 3, group),
        "flash_chunk_too_small": lambda: ring.ring_attention(
            *[zeros(1, 1, 1, 8)] * 3, group, chunk_impl="flash"),
        "ulysses_heads": lambda: ulysses_attention(*[zeros(1, 3, 32, 8)] * 3, group),
    }
    errors = {}
    for name, attempt in tries.items():
        errors[name] = None
        try:
            attempt()
        except ValueError as e:
            errors[name] = f"ValueError: {e}"
    return errors


# The collectives' inputs at world 2: (name, this rank's x shape, whether
# every rank's downstream weights are alike, as for a replicated value).
# The gathers concatenate 3 + 2 = 5 columns (torch.chunk sizes).
COLLECTIVE_CASES = [
    ("rotate", (3, 4), False),
    ("all_to_all", (4, 3), False),
    ("copy_to_group", (3, 4), False),
    ("reduce_from_group", (3, 4), True),
    ("gather_reduce_grad", None, False),
    ("gather_keep_grad", None, True),
]


def collective_inputs(name, rank, shape):
    """(x, w) of rank ``rank``: x the helper's input, w the weights of the
    rank's loss sum(w · helper(x))."""
    rng = np.random.default_rng([rank, len(name)])
    if shape is None:  # a gather of columns: 3 on rank 0, 2 on rank 1
        shape = (3, (3, 2)[rank])
    x = rng.standard_normal(shape).astype(np.float32)
    out_shape = {"all_to_all": (2, 6)}.get(name, (3, 5) if name.startswith("gather") else shape)
    alike = dict((c[0], c[2]) for c in COLLECTIVE_CASES)[name]
    w_rng = np.random.default_rng([9, len(name)]) if alike else np.random.default_rng([rank, 9, len(name)])
    return x, w_rng.standard_normal(out_shape).astype(np.float32)


def collective_grads(rank, world, out_dir):
    """Each helper's output and the gradient of this rank's input, with
    every rank backpropagating its own loss."""
    torch.set_num_threads(1)  # the ranks share the host's cores
    group = make_mesh({"sp": world}, "cpu").get_group("sp")
    helpers = {
        "rotate": lambda x: collectives.rotate(x, group=group)[0],
        "all_to_all": lambda x: collectives.all_to_all(x, group, split_dim=0, concat_dim=1),
        "copy_to_group": lambda x: collectives.copy_to_group(x, group),
        "reduce_from_group": lambda x: collectives.reduce_from_group(x, group),
        "gather_reduce_grad": lambda x: collectives.gather_from_group(x, group, 1, 5, True),
        "gather_keep_grad": lambda x: collectives.gather_from_group(x, group, 1, 5, False),
    }
    result = {}
    for name, shape, _ in COLLECTIVE_CASES:
        x, w = (torch.from_numpy(a) for a in collective_inputs(name, rank, shape))
        x.requires_grad_()
        y = helpers[name](x)
        (grad,) = torch.autograd.grad((y * w).sum(), x)
        result[f"{name}_y"], result[f"{name}_grad"] = y.detach().numpy(), grad.numpy()
    np.savez(os.path.join(out_dir, f"collectives_{rank}.npz"), **result)


def ring_world(rank, world, out_dir):
    """The ring test file's world-2 ranks: the collectives, then the ring
    cases."""
    collective_grads(rank, world, out_dir)
    attention_cases(rank, world, RING_CASES, out_dir)


def _local_box(t):
    """(local array, offsets of its box in the global tensor)."""
    if is_dtensor(t):
        offsets, _ = dtensor_box(t)
        return t.to_local().detach().numpy(), offsets
    return t.detach().numpy(), [0] * t.dim()


def _model(case, params_np, mesh):
    cfg = ttf.TransformerConfig(**case[2])
    params = ttf.params_from_numpy(params_np, "cpu")
    if "tp" in case[1]:
        params = ttf.shard_params(params, mesh)
    for p in ttf.param_leaves(params):
        p.requires_grad_()
    return cfg, params


def model_cases(rank, world, cases, params_by_case, out_dir, snapshot_dir=None):
    """Each case's local logits, loss, gradients and stepped leaves at
    world 4; after the first case, its stepped state's checkpoint block
    when ``snapshot_dir`` is given."""
    torch.set_num_threads(1)  # the ranks share the host's cores
    for case in cases:
        name, axes = case[0], case[1]
        mesh = make_mesh(axes, "cpu")
        cfg, params = _model(case, params_by_case[name], mesh)
        tokens = torch.from_numpy(tokens_for(case))
        out = {}
        sp = axes.get("sp", 1)
        fwd_tokens = ring.to_zigzag(tokens, sp, seq_axis=1) if cfg.ring_attention == "zigzag" else tokens
        with torch.no_grad():
            out["logits"] = ttf.forward(params, fwd_tokens, cfg, mesh).numpy()
        loss, grads = ttf.loss_and_grads(params, tokens, cfg, mesh)
        out["loss"] = loss.numpy()
        for i, (p, g) in enumerate(zip(ttf.param_leaves(params), grads)):
            out[f"grad{i}"] = g.numpy()
            out[f"offsets{i}"] = np.array(_local_box(p)[1])
        _, out["step_loss"] = ttf.sgd_train_step(params, tokens, cfg, mesh, lr=LR)
        for i, p in enumerate(ttf.param_leaves(params)):
            out[f"leaf{i}"] = _local_box(p)[0]
        np.savez(os.path.join(out_dir, f"{name}_{rank}.npz"), **out)
        if snapshot_dir is not None and case is cases[0]:
            checkpoint_block(rank, mesh, params, snapshot_dir, out_dir)


def _zeroed(tree):
    if isinstance(tree, dict):
        return {k: _zeroed(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeroed(v) for v in tree]
    return torch.zeros(tree.shape, dtype=tree.dtype)


def _bytes_equal(a, b):
    return a.shape == b.shape and a.contiguous().view(torch.uint8).equal(b.contiguous().view(torch.uint8))


def checkpoint_block(rank, mesh, params, snapshot_dir, out_dir):
    """The dry run's checkpoint block on the stepped state: a take with
    ``replicated=["**"]``; a restore into an all-Replicate template on the
    same mesh (each rank's local shards byte-equal to their boxes of it);
    and a restore into the tp-sharded layout on a 2-rank sub-mesh (ranks
    0–1 and 2–3 each form one), byte-equal to its boxes."""
    path = os.path.join(snapshot_dir, "stepped")
    detached = _detach_tree(params)
    Snapshot.take(path, {"model": PytreeStateful(detached)}, replicated=["**"])

    template = replicate_pytree(_zeroed(_full_like(detached)), mesh)
    replicated = PytreeStateful(template)
    Snapshot(path).restore({"model": replicated})
    full = [t.to_local() for t in ttf.param_leaves(replicated.tree)]
    equal = 0
    for mine, whole in zip(ttf.param_leaves(detached), full):
        local, offsets = _local_box(mine)
        box = tuple(slice(o, o + n) for o, n in zip(offsets, local.shape))
        equal += _bytes_equal(torch.from_numpy(local), whole[box])

    halves = [make_mesh({"tp": 2}, "cpu", ranks=r) for r in ([0, 1], [2, 3])]
    half = halves[0] if halves[0] is not None else halves[1]
    whole_tree = _tree_like(detached, full)
    sharded = PytreeStateful(ttf.shard_params(_zeroed(whole_tree), half))
    Snapshot(path).restore({"model": sharded})
    half_equal = 0
    for got, whole in zip(ttf.param_leaves(sharded.tree), full):
        local, offsets = _local_box(got)
        box = tuple(slice(o, o + n) for o, n in zip(offsets, local.shape))
        half_equal += _bytes_equal(torch.from_numpy(local), whole[box])
    n = len(full)
    with open(os.path.join(out_dir, f"checkpoint_{rank}.json"), "w") as f:
        json.dump({"leaves": n, "replicated_equal": equal, "half_mesh_equal": half_equal,
                   "half_mesh_coordinate": list(half.get_coordinate())}, f)


def _detach_tree(tree):
    if isinstance(tree, dict):
        return {k: _detach_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_detach_tree(v) for v in tree]
    return tree.detach()


def _full_like(tree):
    """Plain tensors of the global shapes of a tree of DTensors."""
    if isinstance(tree, dict):
        return {k: _full_like(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_full_like(v) for v in tree]
    return torch.empty(tree.shape, dtype=tree.dtype)


def _tree_like(tree, leaves):
    it = iter(leaves)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return next(it)

    return walk(tree)
