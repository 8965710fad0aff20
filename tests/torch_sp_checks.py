"""The JAX side of the port's sequence-parallel tests.

The cases live in ``torch_sp_workers.py``; the spawned port ranks save
their local results there. This module computes the JAX package's
results for the same cases, on a mesh of the same shape made of the
first devices of the 8-device CPU platform, and holds the ranks' results
against them."""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torch_sp_workers as workers
from torchsnapshot_tpu.models import transformer as jtf
from torchsnapshot_tpu.ops.attention import _reference_attention
from torchsnapshot_tpu.parallel import mesh as jmesh
from torchsnapshot_tpu.parallel.ring_attention import (
    from_zigzag,
    ring_attention,
    ring_attention_zigzag,
    shard_seq,
    to_zigzag,
    zigzag_indices,
)
from torchsnapshot_tpu.parallel.ulysses import ulysses_attention


def jax_mesh(axes):
    n = int(np.prod(list(axes.values())))
    return Mesh(np.array(jax.devices()[:n]).reshape(tuple(axes.values())), tuple(axes))


def to_numpy(tree):
    """A JAX params pytree as numpy arrays, dict key order kept."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_numpy(v) for v in tree]
    return np.asarray(tree)


def paths(tree, prefix=()):
    """The leaf paths of a nested dict/list tree, in the tree's own order
    (the port's ``param_leaves`` order)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from paths(v, prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from paths(v, prefix + (i,))
    else:
        yield prefix


def at(tree, path):
    for key in path:
        tree = tree[key]
    return np.asarray(tree)


def rank_results(out_dir, name, world):
    return [np.load(os.path.join(out_dir, f"{name}_{r}.npz")) for r in range(world)]


def rank_json(out_dir, name, world):
    records = []
    for r in range(world):
        with open(os.path.join(out_dir, f"{name}_{r}.json")) as f:
            records.append(json.load(f))
    return records


# ------------------------------------------------------------ attention


def assemble(parts, key, kind, n):
    """The global [B, H, S, D] array, in original token order, from the
    ranks' sequence slices."""
    whole = np.concatenate([p[key] for p in parts], axis=2)
    if kind == "zigzag":
        whole = whole[:, :, np.argsort(np.asarray(zigzag_indices(whole.shape[2], n)))]
    return whole


@functools.lru_cache(maxsize=None)  # the output and gradient tests share it
def reference_attention(case):
    """(out, (dq, dk, dv) or None) of the JAX package's einsum attention
    (``_reference_attention``, the Pallas kernels' spec, kv heads
    repeated) on the case's global inputs; gradients of sum(out²), as the
    JAX ring tests take them."""
    _, _, (_, hq, hkv, _, _), causal, _, grads = case
    q, k, v = (jnp.asarray(x) for x in workers.qkv(case))

    def fn(q, k, v):
        g = hq // hkv
        return _reference_attention(q, jnp.repeat(k, g, axis=1), jnp.repeat(v, g, axis=1), causal)

    out = np.asarray(fn(q, k, v))
    if not grads:
        return out, None
    loss = lambda q, k, v: jnp.sum(fn(q, k, v).astype(jnp.float32) ** 2)  # noqa: E731
    return out, [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(q, k, v)]


def jax_attention(case, n):
    """The output of the JAX package's own sequence-parallel function for
    the case on an ``{"sp": n}`` mesh, in original token order."""
    _, kind, _, causal, impl, _ = case
    mesh = jax_mesh({"sp": n})
    q, k, v = (jnp.asarray(x) for x in workers.qkv(case))
    if kind == "zigzag":
        qz, kz, vz = (to_zigzag(t, mesh) for t in (q, k, v))
        return np.asarray(from_zigzag(ring_attention_zigzag(qz, kz, vz, mesh, chunk_impl=impl), mesh))
    qs, ks, vs = (shard_seq(t, mesh) for t in (q, k, v))
    if kind == "ring":
        return np.asarray(ring_attention(qs, ks, vs, mesh, causal=causal, chunk_impl=impl))
    return np.asarray(ulysses_attention(qs, ks, vs, mesh, causal=causal, attn_impl=impl))


def jax_refusal(name, n):
    """The ValueError message the JAX package gives the input of the
    port's rejection ``name`` (``torch_sp_workers.rejections``)."""
    mesh = jax_mesh({"sp": n})
    z = lambda *s: jnp.zeros(s, jnp.float32)  # noqa: E731
    tries = {
        "ring_indivisible": lambda: ring_attention(*[z(1, 1, 61, 8)] * 3, mesh),
        "zigzag_indivisible": lambda: to_zigzag(z(1, 1, 42, 8), mesh),
        "zigzag_odd_slice": lambda: ring_attention_zigzag(*[z(1, 1, 42, 8)] * 3, mesh),
        "flash_chunk_too_small": lambda: ring_attention(*[z(1, 1, 2, 8)] * 3, mesh, chunk_impl="flash"),
        "ulysses_heads": lambda: ulysses_attention(*[z(1, 3, 64, 8)] * 3, mesh),
    }
    try:
        tries[name]()
    except ValueError as e:
        return str(e)
    return None


# ---------------------------------------------------------- transformer


def model_params(case):
    """The case's parameters, from the JAX package's init, as numpy."""
    cfg = {k: v for k, v in case[2].items() if k not in ("ring_attention", "ring_chunk_impl")}
    return to_numpy(jtf.init_params(jtf.TransformerConfig(**cfg), jax.random.key(len(case[0]))))


def jax_model(case, params_np, ring_grads=False):
    """The JAX package's results for the case on a mesh of the same
    shape: the loss and the logits of its sequence-parallel path, and
    jax.grad of its loss with the dense einsum attention on that mesh,
    with the SGD step ``p − lr·g`` its ``sgd_train_step`` takes from it.
    (``tests/test_ring_attention.py`` holds its ring step to that dense
    step; the JAX ring's own backward takes ~20 s a case to compile on
    the CPU.)"""
    _, axes, cfg, _ = case
    cfg = jtf.TransformerConfig(**cfg)
    dense = dataclasses.replace(cfg, ring_attention=False, ring_chunk_impl="einsum")
    mesh = jax_mesh(axes)
    params = jax.tree.map(jnp.asarray, params_np)
    params = (jtf.shard_params if "tp" in axes else jmesh.replicate_pytree)(params, mesh)
    tokens = jax.device_put(jnp.asarray(workers.tokens_for(case)), NamedSharding(mesh, P("dp", "sp")))
    loss = jax.jit(lambda p, t: jtf.loss_fn(p, t, cfg, mesh))(params, tokens)
    fwd_tokens = to_zigzag(tokens, mesh, seq_axis=1) if cfg.ring_attention == "zigzag" else tokens
    logits = jax.jit(lambda p, t: jtf.forward(p, t, cfg, mesh))(params, fwd_tokens)
    dense_loss, grads = jax.jit(jax.value_and_grad(lambda p, t: jtf.loss_fn(p, t, dense, mesh)))(params, tokens)
    grads = to_numpy(grads)
    stepped = jax.tree.map(lambda p, g: np.asarray(p) - np.float32(workers.LR) * g, to_numpy(params), grads)
    result = {
        "loss": float(loss),
        "dense_loss": float(dense_loss),
        "grads": grads,
        "stepped": stepped,
        "logits": np.asarray(logits),
    }
    if ring_grads:  # jax.grad through the sequence-parallel path itself
        result["ring_grads"] = to_numpy(jax.jit(jax.grad(lambda p, t: jtf.loss_fn(p, t, cfg, mesh)))(params, tokens))
    return result


def local_box(whole, offsets, local):
    return whole[tuple(slice(o, o + n) for o, n in zip(offsets, local.shape))]


def rank_block(whole, axes, rank):
    """A rank's [B/dp, S/sp, ...] block of a global [B, S, ...] array:
    ranks are numbered row-major over the mesh dims."""
    shape = tuple(axes.values())
    coordinate = dict(zip(axes, np.unravel_index(rank, shape)))
    b, s = whole.shape[:2]
    dp, sp = axes.get("dp", 1), axes.get("sp", 1)
    i, j = coordinate.get("dp", 0), coordinate.get("sp", 0)
    return whole[i * b // dp:(i + 1) * b // dp, j * s // sp:(j + 1) * s // sp]


def check_loss(ranks, jax_result):
    """Every rank returns the global loss (from loss_and_grads and from
    sgd_train_step), JAX's within rtol 1e-5, through its
    sequence-parallel path and its dense one."""
    for key in ("loss", "step_loss"):
        got = [float(r[key]) for r in ranks]
        assert len(set(got)) == 1, (key, got)
        np.testing.assert_allclose(got[0], jax_result["loss"], rtol=1e-5)
        np.testing.assert_allclose(got[0], jax_result["dense_loss"], rtol=1e-5)


def check_grads(ranks, jax_result, params_np, key="grads"):
    """Each rank's gradient of every leaf against its box of jax.grad's
    (``key``: of the dense path, or of the sequence-parallel one), within
    1e-3 of that gradient's largest entry: a missing or doubled sum over
    a mesh dim misses it by far."""
    for rank in ranks:
        for i, path in enumerate(paths(params_np)):
            want = at(jax_result[key], path)
            got = rank[f"grad{i}"]
            box = local_box(want, rank[f"offsets{i}"], got)
            assert got.shape == box.shape, (path, got.shape, box.shape)
            err = np.abs(got - box).max()
            assert err <= 1e-3 * np.abs(want).max(), (path, err, np.abs(want).max())


def check_stepped(ranks, jax_result, params_np):
    """Every leaf after one SGD step, atol 5e-4 / rtol 1e-3 (the JAX
    test's tolerance for the zigzag step against the dense one)."""
    for rank in ranks:
        for i, path in enumerate(paths(params_np)):
            got = rank[f"leaf{i}"]
            want = local_box(at(jax_result["stepped"], path), rank[f"offsets{i}"], got)
            np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-3, err_msg=str(path))


def check_logits(ranks, jax_result, axes):
    """Each rank's logits, its block of JAX's global logits (zigzag order
    under zigzag), atol 2e-4 / rtol 1e-4."""
    for r, rank in enumerate(ranks):
        want = rank_block(jax_result["logits"], axes, r)
        np.testing.assert_allclose(rank["logits"], want, atol=2e-4, rtol=1e-4)
