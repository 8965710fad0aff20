"""The port's ResNet against the JAX package's on the same numpy-seeded
state and batches, at a tiny size: the forward, the batch statistics
and one SGD step (rtol 1e-4: the convolutions reassociate between
XLA:CPU and oneDNN); HWIO weights on disk; dp 2 over gloo with global
batch statistics against JAX on a 2-device dp mesh; and the state, BN
statistics included, crossing both packages bit for bit.

The spawned ranks run ``torch_model_workers.resnet_dp``."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_model_workers as workers
import torchsnapshot_tpu as jsnap
from torchsnapshot_tpu.models import resnet as jr
from torchsnapshot_tpu.utils.train_state import PytreeStateful as JaxPytree
from torchsnapshot_tpu_torch import PytreeStateful, Snapshot
from torchsnapshot_tpu_torch.manifest import ArrayEntry
from torchsnapshot_tpu_torch.models import dlrm as td
from torchsnapshot_tpu_torch.models import resnet as tr
from torchsnapshot_tpu_torch.utils.test_utils import run_multiprocess

SIZES = dict(widths=(8, 16), blocks_per_stage=2, image_size=8)
BATCH = 8
RTOL, ATOL = 1e-4, 1e-6


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_numpy(v) for v in tree]
    return np.asarray(tree)


def _ordered(like, tree):
    """``tree``'s leaves in the key order of ``like``."""
    if isinstance(like, dict):
        return [x for k in like for x in _ordered(like[k], tree[k])]
    if isinstance(like, (list, tuple)):
        return [x for a, b in zip(like, tree) for x in _ordered(a, b)]
    return [np.asarray(tree)]


def _state(seed=0):
    params, stats = jr.init_state(jr.ResNetConfig(**SIZES), jax.random.key(seed))
    return _to_numpy(params), _to_numpy(stats)


def _leaves(tree):
    return [(t.to_local() if hasattr(t, "to_local") else t).detach().numpy() for t in td.param_leaves(tree)]


def test_forward_and_batch_stats_match_jax():
    jcfg, tcfg = jr.ResNetConfig(**SIZES), tr.ResNetConfig(**SIZES)
    params_np, stats_np = _state()
    images, _ = tr.numpy_batch(tcfg, BATCH, seed=1)
    want_logits, want_stats = jr.forward_train(
        jax.tree.map(jnp.asarray, params_np), jax.tree.map(jnp.asarray, stats_np), jnp.asarray(images), jcfg
    )
    logits, new_stats = tr.forward_train(
        tr.params_from_numpy(params_np, "cpu"), tr.params_from_numpy(stats_np, "cpu"),
        torch.from_numpy(images), tcfg,
    )
    assert logits.shape == (BATCH, 10) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits), rtol=RTOL, atol=ATOL)
    for got, want in zip(_leaves(new_stats), _ordered(stats_np, want_stats)):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_sgd_step_matches_jax():
    jcfg, tcfg = jr.ResNetConfig(**SIZES), tr.ResNetConfig(**SIZES)
    params_np, stats_np = _state(seed=2)
    images, labels = tr.numpy_batch(tcfg, BATCH, seed=3)
    jp, js, jloss = jr.sgd_train_step(
        jax.tree.map(jnp.asarray, params_np), jax.tree.map(jnp.asarray, stats_np),
        jnp.asarray(images), jnp.asarray(labels), jcfg,
    )
    params, stats = tr.params_from_numpy(params_np, "cpu"), tr.params_from_numpy(stats_np, "cpu")
    returned, returned_stats, loss = tr.sgd_train_step(
        params, stats, torch.from_numpy(images), torch.from_numpy(labels), tcfg
    )
    assert returned is params and returned_stats is stats and not loss.requires_grad
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
    for got, want in zip(_leaves(params) + _leaves(stats), _ordered(params_np, jp) + _ordered(stats_np, js)):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_running_stats_update():
    """Guards the restore tests from vacuity, as the JAX package's own."""
    tcfg = tr.ResNetConfig(**SIZES)
    params, stats = tr.init_state(tcfg, seed=0, device="cpu")
    before = [t.clone() for t in td.param_leaves(stats)]
    tr.sgd_train_step(params, stats, *tr.synthetic_batch(tcfg, BATCH, seed=1, device="cpu"), tcfg)
    assert all(not torch.equal(a, b) for a, b in zip(before, td.param_leaves(stats)))


def test_conv_weights_are_stored_hwio(tmp_path):
    tcfg = tr.ResNetConfig(**SIZES)
    params, stats = tr.init_state(tcfg, seed=0, device="cpu")
    Snapshot.take(str(tmp_path / "s"), {"params": PytreeStateful(params)})
    manifest = Snapshot(str(tmp_path / "s")).get_manifest()
    shapes = {p.split("/", 1)[1]: e.shape for p, e in manifest.items() if isinstance(e, ArrayEntry)}
    assert shapes["params/stem"] == [3, 3, 3, 8]
    assert shapes["params/stages/0/0/conv1"] == [3, 3, 8, 8]
    assert shapes["params/stages/1/0/proj"] == [1, 1, 8, 16]
    # The JAX package reads them as its own HWIO weights, bit for bit.
    jparams, _ = jr.init_state(jr.ResNetConfig(**SIZES), jax.random.key(9))
    holder = JaxPytree(jparams)
    jsnap.Snapshot(str(tmp_path / "s")).restore({"params": holder})
    got = np.asarray(holder.tree["stages"][1][0]["proj"])
    np.testing.assert_array_equal(got, params["stages"][1][0]["proj"].numpy())


@pytest.fixture(scope="module")
def dp_world(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("resnet_dp"))
    params_np, stats_np = _state(seed=4)
    images, labels = tr.numpy_batch(tr.ResNetConfig(**SIZES), BATCH, seed=5)
    run_multiprocess(workers.resnet_dp, 2, (SIZES, params_np, stats_np, images, labels, out), timeout_s=240)
    ranks = [dict(np.load(os.path.join(out, f"resnet_{r}.npz"))) for r in range(2)]
    return out, params_np, stats_np, images, labels, ranks


def test_dp2_global_batch_stats_match_jax(dp_world):
    """JAX computes the statistics over the global batch of a dp-sharded
    array; the port's ranks each hold half and sum over dp."""
    _, params_np, stats_np, images, labels, ranks = dp_world
    jcfg = jr.ResNetConfig(**SIZES)
    mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))
    jp, js = jr.replicate_state(
        (jax.tree.map(jnp.asarray, params_np), jax.tree.map(jnp.asarray, stats_np)), mesh
    )
    jp, js, jloss = jr.sgd_train_step(
        jp, js, jr.dp_shard_batch(jnp.asarray(images), mesh), jr.dp_shard_batch(jnp.asarray(labels), mesh), jcfg
    )
    want_params, want_stats = _ordered(params_np, jp), _ordered(stats_np, js)
    for r in ranks:
        assert int(r["rows"]) == BATCH // 2
        np.testing.assert_allclose(float(r["loss"]), float(jloss), rtol=RTOL)
        for i, want in enumerate(want_params):
            np.testing.assert_allclose(r[f"param{i}"], want, rtol=RTOL, atol=ATOL)
        for i, want in enumerate(want_stats):
            np.testing.assert_allclose(r[f"stat{i}"], want, rtol=RTOL, atol=ATOL)
    # The ranks hold one state.
    for key in ranks[0]:
        if key != "rows":
            np.testing.assert_array_equal(ranks[0][key], ranks[1][key])


def test_dp2_matches_one_process_and_restores_through_jax(dp_world):
    out, params_np, stats_np, images, labels, ranks = dp_world
    tcfg = tr.ResNetConfig(**SIZES)
    params, stats = tr.params_from_numpy(params_np, "cpu"), tr.params_from_numpy(stats_np, "cpu")
    _, _, loss = tr.sgd_train_step(params, stats, torch.from_numpy(images), torch.from_numpy(labels), tcfg)
    np.testing.assert_allclose(float(ranks[0]["loss"]), float(loss), rtol=RTOL)
    for i, got in enumerate(_leaves(params)):
        np.testing.assert_allclose(ranks[0][f"param{i}"], got, rtol=RTOL, atol=ATOL)
    # The ranks' replicated take restores through JAX bit for bit.
    jparams, jstats = jr.init_state(jr.ResNetConfig(**SIZES), jax.random.key(8))
    holders = {"params": JaxPytree(jparams), "stats": JaxPytree(jstats)}
    jsnap.Snapshot(os.path.join(out, "dp")).restore(holders)
    for i, got in enumerate(_ordered(params_np, holders["params"].tree)):
        np.testing.assert_array_equal(got, ranks[0][f"param{i}"])
    for i, got in enumerate(_ordered(stats_np, holders["stats"].tree)):
        np.testing.assert_array_equal(got, ranks[0][f"stat{i}"])


def test_state_crosses_both_ways_bit_exact(tmp_path):
    tcfg = tr.ResNetConfig(**SIZES)
    params, stats = tr.init_state(tcfg, seed=0, device="cpu")
    tr.sgd_train_step(params, stats, *tr.synthetic_batch(tcfg, BATCH, seed=1, device="cpu"), tcfg)
    Snapshot.take(str(tmp_path / "port"), {"params": PytreeStateful(params), "stats": PytreeStateful(stats)},
                  replicated=["**"])
    jparams, jstats = jr.init_state(jr.ResNetConfig(**SIZES), jax.random.key(3))
    holders = {"params": JaxPytree(jparams), "stats": JaxPytree(jstats)}
    jsnap.Snapshot(str(tmp_path / "port")).restore(holders)
    for got, want in zip(_ordered(_to_numpy(jparams), holders["params"].tree) +
                         _ordered(_to_numpy(jstats), holders["stats"].tree), _leaves(params) + _leaves(stats)):
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))

    jsnap.Snapshot.take(str(tmp_path / "jax"), holders, replicated=["**"])
    fresh_params, fresh_stats = tr.init_state(tcfg, seed=5, device="cpu")
    target = {"params": PytreeStateful(fresh_params), "stats": PytreeStateful(fresh_stats)}
    Snapshot(str(tmp_path / "jax")).restore(target)
    for got, want in zip(_leaves(fresh_params) + _leaves(fresh_stats), _leaves(params) + _leaves(stats)):
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    # The restored state resumes like the original, bit for bit.
    batch = tr.synthetic_batch(tcfg, BATCH, seed=9, device="cpu")
    a = tr.sgd_train_step(params, stats, *batch, tcfg)[2]
    b = tr.sgd_train_step(target["params"].tree, target["stats"].tree, *batch, tcfg)[2]
    assert float(a) == float(b)
