"""The port's transformer forward against the JAX package's, on the same
parameters (JAX ``init_params`` → numpy → ``params_from_numpy``) and the
same tokens, at a tiny size."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchsnapshot_tpu.models import transformer as jtf
from torchsnapshot_tpu_torch.models import transformer as ttf

TINY = dict(vocab_size=64, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
            d_ff=128, max_seq_len=32)


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_numpy(v) for v in tree]
    return np.asarray(tree)


def _logits(flash, dtype, seed=0):
    jcfg = jtf.TransformerConfig(
        **TINY, flash_attention=flash, dtype=jnp.bfloat16 if dtype == "bf16" else jnp.float32
    )
    tcfg = ttf.TransformerConfig(
        **TINY, flash_attention=flash,
        dtype=torch.bfloat16 if dtype == "bf16" else torch.float32,
    )
    params = jtf.init_params(jcfg, jax.random.key(seed))
    tokens = np.random.default_rng(seed).integers(0, 64, (2, 32)).astype(np.int32)
    expected = np.asarray(jtf.forward(params, jnp.asarray(tokens), jcfg))
    model = ttf.Transformer(tcfg, ttf.params_from_numpy(_to_numpy(params), "cpu"))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens).long())
    assert got.dtype == torch.float32 and got.shape == (2, 32, 64)
    return got.numpy(), expected


@pytest.mark.parametrize("flash", [False, True], ids=["einsum", "flash"])
def test_forward_matches_jax_f32(flash):
    got, expected = _logits(flash, "f32")
    # f32 matmuls reassociate between XLA:CPU and ATen (and the flash
    # kernel's online softmax reassociates the softmax sums).
    np.testing.assert_allclose(got, expected, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("flash", [False, True], ids=["einsum", "flash"])
def test_forward_matches_jax_bf16(flash):
    got, expected = _logits(flash, "bf16", seed=1)
    # bf16 weights promote to f32 against the f32 LayerNorm output in both
    # packages, so only the bf16 softmax probabilities round: an f32
    # softmax differing in its last bits can round a probability to the
    # neighbouring bf16 value (2^-8 relative). Measured max |diff| is
    # ~2e-6 on logits of magnitude ~4.
    np.testing.assert_allclose(got, expected, atol=1e-3, rtol=1e-3)


def _tiny_pair(flash, seed):
    jcfg = jtf.TransformerConfig(**TINY, flash_attention=flash)
    tcfg = ttf.TransformerConfig(**TINY, flash_attention=flash)
    params = jtf.init_params(jcfg, jax.random.key(seed))
    tokens = np.random.default_rng(seed).integers(0, 64, (2, 32)).astype(np.int32)
    model = ttf.Transformer(tcfg, ttf.params_from_numpy(_to_numpy(params), "cpu"))
    return jcfg, tcfg, params, tokens, model


# f32 matmuls reassociate between XLA:CPU and ATen, forward and backward;
# gradients are held relative to each leaf's largest entry.
GRAD_TOL = dict(atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("flash", [False, True], ids=["einsum", "flash"])
def test_loss_and_gradients_match_jax(flash):
    jcfg, tcfg, params, tokens, model = _tiny_pair(flash, seed=2)
    loss, grads = jax.value_and_grad(jtf.loss_fn)(params, jnp.asarray(tokens), jcfg)
    leaves = list(ttf.param_leaves(model.params()))
    got_loss = ttf.loss_fn(model.params(), torch.from_numpy(tokens), tcfg)
    got = torch.autograd.grad(got_loss, leaves)
    np.testing.assert_allclose(float(got_loss.detach()), float(loss), rtol=1e-5)
    expected = jax.tree.leaves(grads)
    # jax.tree.leaves sorts dict keys; the port's tree keeps the JAX
    # init_params order. Compare by path instead of by position.
    by_path = dict(zip(_paths(model.params()), got))
    for path, e in zip(_jax_paths(grads), expected):
        g = by_path[path].numpy()
        e = np.asarray(e)
        scale = float(np.abs(e).max()) or 1.0
        np.testing.assert_allclose(g / scale, e / scale, **GRAD_TOL, err_msg=path)
    assert len(by_path) == len(expected)


def test_sgd_train_step_matches_jax():
    jcfg, tcfg, params, tokens, model = _tiny_pair(True, seed=3)
    new_params, loss = jtf.sgd_train_step(params, jnp.asarray(tokens), jcfg)
    tree = model.params()
    returned, got_loss = ttf.sgd_train_step(tree, torch.from_numpy(tokens), tcfg)
    assert returned is tree and not got_loss.requires_grad
    np.testing.assert_allclose(float(got_loss.detach()), float(loss), rtol=1e-5)
    by_path = dict(zip(_paths(tree), ttf.param_leaves(tree)))
    for path, e in zip(_jax_paths(new_params), jax.tree.leaves(new_params)):
        # The update moves each weight by lr·g; the new weights agree to
        # the f32 tolerance of the forward.
        np.testing.assert_allclose(
            by_path[path].detach().numpy(), np.asarray(e), atol=1e-5, rtol=1e-5,
            err_msg=path,
        )


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}/{i}")
    else:
        yield prefix


def _jax_paths(tree):
    for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]:
        yield "".join(
            f"/{getattr(k, 'key', getattr(k, 'idx', None))}" for k in path
        )


def test_port_init_is_seeded_and_shaped():
    cfg = ttf.TransformerConfig(**TINY)
    a = ttf.init_params(cfg, seed=3, device="cpu")
    b = ttf.init_params(cfg, seed=3, device="cpu")
    assert torch.equal(a["layers"][1]["mlp"]["w2"], b["layers"][1]["mlp"]["w2"])
    assert a["layers"][0]["attn"]["wk"].shape == (64, 32)
    assert a["embed"].shape == (64, 64) and a["final_ln"].dtype == torch.float32


def test_init_params_without_device_needs_cuda():
    # The entry points run on the card unless the caller asks for the CPU.
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without CUDA")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttf.init_params(ttf.TransformerConfig(**TINY), seed=0)


def test_unported_modes_raise():
    """The sequence-parallel modes are ported; what the JAX forward refuses,
    the port refuses with the same errors: a ring mode without an "sp"
    mesh, an unknown mode, and flash attention beside a ring mode."""
    params = ttf.init_params(ttf.TransformerConfig(**TINY), seed=0, device="cpu")
    tokens = torch.zeros(1, 8, dtype=torch.long)
    jparams = jtf.init_params(jtf.TransformerConfig(**TINY), jax.random.key(0))
    for kw, match in (
        (dict(ring_attention="zigzag"), '"sp" axis'),
        (dict(ring_attention="spiral"), "unknown ring_attention mode"),
        (dict(ring_attention=True, flash_attention=True), "mutually exclusive"),
    ):
        with pytest.raises(ValueError, match=match):
            ttf.forward(params, tokens, ttf.TransformerConfig(**TINY, **kw))
        with pytest.raises(ValueError, match=match):
            jtf.forward(jparams, jnp.zeros((1, 8), jnp.int32), jtf.TransformerConfig(**TINY, **kw))
