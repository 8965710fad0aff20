"""The port's DLRM against the JAX package's on the same numpy-seeded
parameters and batches, at a tiny size: forward, loss and a 3-step
momentum trajectory at f32 (rtol 1e-5); the interaction order; ep 2 over
gloo against one process and against JAX on a 2-device ``ep`` mesh; the
state crossing both packages bit for bit, sharded and unsharded; an
uneven ep-2 port snapshot restored through JAX; and the chunk take
writing only the chunks a step changed.

The spawned ranks run ``torch_model_workers.dlrm_ep``."""

import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_model_workers as workers
import torchsnapshot_tpu as jsnap
from torchsnapshot_tpu.models import dlrm as jd
from torchsnapshot_tpu.utils.train_state import PytreeStateful as JaxPytree
from torchsnapshot_tpu_torch import Snapshot
from torchsnapshot_tpu_torch.models import dlrm as td
from torchsnapshot_tpu_torch.utils.test_utils import run_multiprocess

SIZES = dict(embed_dim=8, dense_in=4, bag_len=3, bottom_mlp=(16, 8), top_mlp=(16, 1))
ROWS = {"user": 64, "item": 128, "cat": 32}  # divisible by ep 2, as JAX requires
UNEVEN_ROWS = {"user": 65, "item": 127, "cat": 33}
BATCH = 8
# f32 products and sums reassociate between XLA:CPU and ATen.
RTOL, ATOL = 1e-5, 1e-6


def _configs(rows):
    return jd.DLRMConfig(table_rows=rows, **SIZES), td.DLRMConfig(table_rows=rows, **SIZES)


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_numpy(v) for v in tree]
    return np.asarray(tree)


def _jax_batch(batch):
    dense, sparse, labels = batch
    return jnp.asarray(dense), {k: jnp.asarray(v) for k, v in sparse.items()}, jnp.asarray(labels)


def _ordered(like, tree):
    """The leaves of ``tree`` (a JAX tree, whose dicts jax.tree.map may
    have re-ordered) in the key order of ``like``."""
    if isinstance(like, dict):
        return [x for k in like for x in _ordered(like[k], tree[k])]
    if isinstance(like, (list, tuple)):
        return [x for a, b in zip(like, tree) for x in _ordered(a, b)]
    return [np.asarray(tree)]


def _zeros(tree):
    """Zeros like a numpy tree, its dict order kept (jax.tree.map sorts)."""
    if isinstance(tree, dict):
        return {k: _zeros(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeros(v) for v in tree]
    return np.zeros_like(tree)


def _port_leaves(tree):
    return [(t.to_local() if hasattr(t, "to_local") else t).detach().numpy() for t in td.param_leaves(tree)]


def _params(rows, seed=0):
    jcfg, _ = _configs(rows)
    return _to_numpy(jd.init_params(jcfg, jax.random.key(seed)))


def _batches(rows, n, seed=1):
    _, tcfg = _configs(rows)
    return [td.numpy_batch(tcfg, BATCH, seed + i) for i in range(n)]


def test_forward_and_loss_match_jax():
    jcfg, tcfg = _configs(ROWS)
    params_np = _params(ROWS)
    batch = _batches(ROWS, 1)[0]
    params = td.params_from_numpy(params_np, "cpu")
    tb = td.batch_from_numpy(batch, "cpu")
    jp = jax.tree.map(jnp.asarray, params_np)
    want = np.asarray(jd.forward(jp, *_jax_batch(batch)[:2], jcfg))
    got = td.forward(params, *tb[:2], tcfg)
    assert got.dtype == torch.float32 and got.shape == (BATCH,)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        float(td.loss_fn(params, *tb, tcfg)), float(jd.loss_fn(jp, *_jax_batch(batch), jcfg)), rtol=RTOL
    )


def test_three_momentum_steps_match_jax():
    jcfg, tcfg = _configs(ROWS)
    params_np = _params(ROWS, seed=2)
    jp = jax.tree.map(jnp.asarray, params_np)
    jm = jd.init_momentum(jp)
    params = td.params_from_numpy(params_np, "cpu")
    momentum = td.init_momentum(params)
    for batch in _batches(ROWS, 3, seed=5):
        jp, jm, jloss = jd.sgd_momentum_train_step(jp, jm, *_jax_batch(batch), jcfg, lr=0.1)
        returned, _, loss = td.sgd_momentum_train_step(
            params, momentum, *td.batch_from_numpy(batch, "cpu"), tcfg, lr=0.1
        )
        assert returned is params and not loss.requires_grad
        np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
    for got, want in zip(_port_leaves(params) + _port_leaves(momentum),
                         _ordered(params_np, jp) + _ordered(params_np, jm)):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("t", [2, 4, 27])
def test_interaction_pairs_are_in_jax_order(t):
    iu, ju = torch.triu_indices(t, t, offset=1)
    jiu, jju = jnp.triu_indices(t, k=1)
    np.testing.assert_array_equal(iu.numpy(), np.asarray(jiu))
    np.testing.assert_array_equal(ju.numpy(), np.asarray(jju))
    assert len(iu) == t * (t - 1) // 2


def test_interaction_order_reaches_the_top_mlp_as_in_jax():
    """A swapped pair still trains, so the top MLP's input is compared
    directly: the JAX forward with the top MLP cut to an identity of its
    input against the port's."""
    params_np = _params(ROWS, seed=3)
    n_in = SIZES["embed_dim"] + 6  # 3 tables: (3 + 1) · 3 / 2 pairs
    eye = np.eye(n_in, dtype=np.float32)
    jcfg = jd.DLRMConfig(table_rows=ROWS, **dict(SIZES, top_mlp=(n_in,)))
    tcfg = td.DLRMConfig(table_rows=ROWS, **dict(SIZES, top_mlp=(n_in,)))
    batch = _batches(ROWS, 1, seed=9)[0]
    # forward keeps column 0 of the top MLP's output: a one-layer top MLP
    # whose weight is the identity rolled by col reads input column col.
    for col in range(n_in):
        probe = dict(params_np, top_mlp=[{"w": np.roll(eye, -col, axis=1),
                                          "b": np.zeros(n_in, np.float32)}])
        want = np.asarray(jd.forward(jax.tree.map(jnp.asarray, probe), *_jax_batch(batch)[:2], jcfg))
        got = td.forward(td.params_from_numpy(probe, "cpu"), *td.batch_from_numpy(batch, "cpu")[:2], tcfg)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL, err_msg=f"column {col}")


def _with_deadline(step, fn, timeout_s):
    """``fn()`` in a daemon thread; a TimeoutError naming ``step`` if it is
    still running after ``timeout_s`` (the test fails instead of hanging)."""
    done, error = [], []

    def run():
        try:
            done.append(fn())
        except BaseException as e:  # re-raised below, in the caller
            error.append(e)

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    thread.join(timeout_s)
    if thread.is_alive():
        raise TimeoutError(f"{step} still running after {timeout_s}s")
    if error:
        raise error[0]
    return done[0]


@pytest.fixture(scope="module")
def ep_world(tmp_path_factory):
    """One spawned ep-2 world for the file: a 3-step trajectory on the
    divisible tables, one step on the uneven ones (each taken), and the
    JAX package's ep-4 snapshot restored into ep-2 DTensors."""
    out = str(tmp_path_factory.mktemp("dlrm_ep"))
    jcfg, _ = _configs(ROWS)
    params_np = _params(ROWS, seed=4)
    jp = jax.tree.map(jnp.asarray, params_np)
    mesh = Mesh(np.array(jax.devices()[:4]), ("ep",))
    jax_state = {"params": jd.shard_params(jp, mesh), "momentum": jd.shard_params(
        jax.tree.map(lambda x: x + 0.5, jp), mesh)}
    jax_snap = os.path.join(out, "jax_ep4")
    # In this (xdist worker) process, so under a deadline of its own, as
    # the spawned world below runs under run_multiprocess's.
    _with_deadline(
        "the JAX ep-4 take of the ep_world fixture",
        lambda: jsnap.Snapshot.take(jax_snap, {"model": JaxPytree(jax_state)}, replicated=["**"]),
        timeout_s=240,
    )
    cases = [
        ("even", dict(table_rows=ROWS, **SIZES), params_np, _batches(ROWS, 3, seed=11)),
        ("uneven", dict(table_rows=UNEVEN_ROWS, **SIZES), _params(UNEVEN_ROWS, seed=5),
         _batches(UNEVEN_ROWS, 1, seed=21)),
    ]
    run_multiprocess(workers.dlrm_ep, 2, (cases, jax_snap, out), timeout_s=240)
    ranks = {
        name: [dict(np.load(os.path.join(out, f"{name}_{r}.npz"))) for r in range(2)]
        for name in ("even", "uneven", "from_jax")
    }
    return out, cases, jax_state, ranks


def _assemble(ranks, n_leaves, like_shapes):
    """Global arrays from the ranks' local boxes."""
    out = []
    for i in range(n_leaves):
        full = np.zeros(like_shapes[i], ranks[0][f"leaf{i}"].dtype)
        for r in ranks:
            box = tuple(slice(o, o + n) for o, n in zip(r[f"offsets{i}"], r[f"leaf{i}"].shape))
            full[box] = r[f"leaf{i}"]
        out.append(full)
    return out


def _shapes(params_np):
    leaves = [np.asarray(x) for x in _ordered(params_np, params_np)]
    return [x.shape for x in leaves] * 2  # params, then momentum


def test_ep2_matches_one_process_and_jax(ep_world):
    _, cases, _, ranks = ep_world
    _, cfg_kwargs, params_np, batches = cases[0]
    jcfg, tcfg = _configs(ROWS)
    # One process in the port.
    params = td.params_from_numpy(params_np, "cpu")
    momentum = td.init_momentum(params)
    one = [float(td.sgd_momentum_train_step(params, momentum, *td.batch_from_numpy(b, "cpu"),
                                            tcfg, lr=0.1)[2]) for b in batches]
    # JAX on a 2-device ep mesh.
    mesh = Mesh(np.array(jax.devices()[:2]), ("ep",))
    jp = jd.shard_params(jax.tree.map(jnp.asarray, params_np), mesh)
    jm = jd.shard_params(jd.init_momentum(jp), mesh)
    jlosses = []
    for b in batches:
        jp, jm, loss = jd.sgd_momentum_train_step(jp, jm, *_jax_batch(b), jcfg, mesh, lr=0.1)
        jlosses.append(float(loss))
    for r in ranks["even"]:
        np.testing.assert_allclose(r["losses"], one, rtol=1e-5)
        np.testing.assert_allclose(r["losses"], jlosses, rtol=RTOL)
    got = _assemble(ranks["even"], len(_shapes(params_np)), _shapes(params_np))
    # A backward that multiplied the pooled gradient by ep would move the
    # tables twice as far: held to one process and to JAX.
    for g, one_leaf, j in zip(got, _port_leaves(params) + _port_leaves(momentum),
                              _ordered(params_np, jp) + _ordered(params_np, jm)):
        np.testing.assert_allclose(g, one_leaf, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(g, j, rtol=RTOL, atol=ATOL)


def test_ep2_port_snapshot_restores_through_jax_sharded_and_unsharded(ep_world):
    out, cases, _, ranks = ep_world
    params_np = cases[0][2]
    expected = _assemble(ranks["even"], len(_shapes(params_np)), _shapes(params_np))
    jcfg, _ = _configs(ROWS)
    zeros = jax.tree.map(jnp.zeros_like, jax.tree.map(jnp.asarray, params_np))
    for mesh in (None, Mesh(np.array(jax.devices()[:2]), ("ep",)),
                 Mesh(np.array(jax.devices()[:4]), ("ep",))):
        tree = zeros if mesh is None else jd.shard_params(zeros, mesh)
        holder = JaxPytree({"params": tree, "momentum": tree})
        jsnap.Snapshot(os.path.join(out, "even")).restore({"model": holder})
        got = _ordered(params_np, holder.tree["params"]) + _ordered(params_np, holder.tree["momentum"])
        for g, e in zip(got, expected):
            np.testing.assert_array_equal(g.view(np.uint32), e.view(np.uint32))


def test_jax_ep4_snapshot_restores_into_port_ep2(ep_world):
    _, cases, jax_state, ranks = ep_world
    params_np = cases[0][2]
    got = _assemble(ranks["from_jax"], len(_shapes(params_np)), _shapes(params_np))
    want = _ordered(params_np, jax_state["params"]) + _ordered(params_np, jax_state["momentum"])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.view(np.uint32), np.asarray(w).view(np.uint32))


def test_jax_ep_snapshot_restores_unsharded_in_the_port(ep_world):
    out, cases, jax_state, _ = ep_world
    params_np = cases[0][2]
    zeros = td.init_momentum(td.params_from_numpy(params_np, "cpu"))
    state = td.DLRMState(zeros, td.init_momentum(zeros))
    Snapshot(os.path.join(out, "jax_ep4")).restore({"model": state})
    want = _ordered(params_np, jax_state["params"]) + _ordered(params_np, jax_state["momentum"])
    for g, w in zip(_port_leaves(state.params) + _port_leaves(state.momentum), want):
        np.testing.assert_array_equal(g.view(np.uint32), np.asarray(w).view(np.uint32))


def test_uneven_ep2_port_snapshot_restores_through_jax(ep_world):
    """JAX refuses an ep mesh over rows it does not divide; the port's
    boxes are torch.chunk's (65 rows: 33 + 32). The format is pinned by a
    JAX restore into an unsharded template."""
    out, cases, _, ranks = ep_world
    _, cfg_kwargs, params_np, _ = cases[1]
    assert [r["leaf0"].shape[0] for r in ranks["uneven"]] == [33, 32]
    expected = _assemble(ranks["uneven"], len(_shapes(params_np)), _shapes(params_np))
    zeros = _zeros(params_np)
    holder = JaxPytree({"params": zeros, "momentum": zeros})
    jsnap.Snapshot(os.path.join(out, "uneven")).restore({"model": holder})
    got = _ordered(params_np, holder.tree["params"]) + _ordered(params_np, holder.tree["momentum"])
    for g, e in zip(got, expected):
        np.testing.assert_array_equal(np.asarray(g).view(np.uint32), e.view(np.uint32))
    # The one-process port step on the same batch agrees with the ranks.
    _, tcfg = _configs(UNEVEN_ROWS)
    params = td.params_from_numpy(params_np, "cpu")
    loss = td.sgd_momentum_train_step(params, td.init_momentum(params),
                                      *td.batch_from_numpy(cases[1][3][0], "cpu"), tcfg, lr=0.1)[2]
    np.testing.assert_allclose(ranks["uneven"][0]["losses"], [float(loss)], rtol=1e-5)


def test_unsharded_state_crosses_both_ways(tmp_path):
    params_np = _params(ROWS, seed=6)
    params = td.params_from_numpy(params_np, "cpu")
    state = td.DLRMState(params, td.map_leaves(lambda t: -t, params))
    Snapshot.take(str(tmp_path / "port"), {"model": state})
    zeros = _zeros(params_np)
    holder = JaxPytree({"params": zeros, "momentum": zeros})
    jsnap.Snapshot(str(tmp_path / "port")).restore({"model": holder})
    got = _ordered(params_np, holder.tree["params"]) + _ordered(params_np, holder.tree["momentum"])
    for g, w in zip(got, _port_leaves(state.params) + _port_leaves(state.momentum)):
        np.testing.assert_array_equal(np.asarray(g).view(np.uint32), w.view(np.uint32))

    jsnap.Snapshot.take(str(tmp_path / "jax"), {"model": JaxPytree(holder.tree)})
    fresh = td.DLRMState(td.init_momentum(params), td.init_momentum(params))
    Snapshot(str(tmp_path / "jax")).restore({"model": fresh})
    for g, w in zip(_port_leaves(fresh.params) + _port_leaves(fresh.momentum),
                    _port_leaves(state.params) + _port_leaves(state.momentum)):
        np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32))


def test_dlrm_state_restores_in_place(tmp_path):
    _, tcfg = _configs(ROWS)
    params = td.init_params(tcfg, seed=0, device="cpu")
    state = td.DLRMState(params, td.init_momentum(params))
    td.sgd_momentum_train_step(state.params, state.momentum,
                               *td.synthetic_batch(tcfg, BATCH, seed=1, device="cpu"), tcfg)
    Snapshot.take(str(tmp_path / "s"), {"model": state})
    other = td.init_params(tcfg, seed=1, device="cpu")
    target = td.DLRMState(other, td.init_momentum(other))
    held = [t.data_ptr() for t in td.param_leaves(target.state_dict())]
    Snapshot(str(tmp_path / "s")).restore({"model": target})
    assert [t.data_ptr() for t in td.param_leaves(target.state_dict())] == held
    for g, w in zip(_port_leaves(target.params) + _port_leaves(target.momentum),
                    _port_leaves(state.params) + _port_leaves(state.momentum)):
        np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32))


def test_synthetic_batch_ids_stay_in_range():
    _, tcfg = _configs(UNEVEN_ROWS)
    dense, sparse, labels = td.synthetic_batch(tcfg, 64, seed=3, device="cpu")
    assert dense.shape == (64, SIZES["dense_in"]) and labels.shape == (64,)
    for name, rows in UNEVEN_ROWS.items():
        ids = sparse[name]
        assert ids.shape == (64, SIZES["bag_len"]) and int(ids.min()) >= 0 and int(ids.max()) < rows
    assert set(labels.unique().tolist()) <= {0.0, 1.0}


def _changed_chunks(before, after, chunk_bytes):
    n = 0
    for a, b in zip(before, after):
        a, b = a.tobytes(), b.tobytes()
        n += sum(a[i:i + chunk_bytes] != b[i:i + chunk_bytes] for i in range(0, len(a), chunk_bytes))
    return n


def test_chunk_take_writes_only_the_changed_chunks(tmp_path, monkeypatch):
    chunk = 4096
    for var, val in (("TPUSNAPSHOT_CHUNK_BYTES", chunk), ("TPUSNAPSHOT_CHUNK_MIN_BYTES", 0),
                     ("TPUSNAPSHOT_SWEEP_MIN_AGE_S", 0), ("TPUSNAPSHOT_REFS_MIN_AGE_S", 0)):
        monkeypatch.setenv(var, str(val))
    rows = {"user": 2048, "item": 4096, "cat": 32}  # 64 and 128 chunks of 4 KiB
    cfg = td.DLRMConfig(table_rows=rows, **dict(SIZES, bag_len=1))
    params = td.init_params(cfg, seed=0, device="cpu")
    state = td.DLRMState(params, td.init_momentum(params))
    run = tmp_path / "run"
    objects = run / ".chunkstore" / "objects"

    def stored():
        return {p.name for p in objects.rglob("*") if p.is_file()}

    Snapshot.take(str(run / "s1"), {"model": state}, chunks=True)
    first = stored()
    before = [x.copy() for x in _port_leaves(state.params) + _port_leaves(state.momentum)]
    td.sgd_momentum_train_step(state.params, state.momentum,
                               *td.synthetic_batch(cfg, 4, seed=2, device="cpu"), cfg)
    after = _port_leaves(state.params) + _port_leaves(state.momentum)
    Snapshot.take(str(run / "s2"), {"model": state}, chunks=True)
    new = stored() - first
    changed = _changed_chunks(before, after, chunk)
    assert 0 < changed < sum(-(-x.nbytes // chunk) for x in after)
    assert len(new) == changed
    # Both packages restore the chunked take.
    zeros = _zeros(_to_numpy(jd.init_params(
        jd.DLRMConfig(table_rows=rows, **dict(SIZES, bag_len=1)), jax.random.key(0))))
    holder = JaxPytree({"params": zeros, "momentum": zeros})
    jsnap.Snapshot(str(run / "s2")).restore({"model": holder})
    got = _ordered(zeros, holder.tree["params"]) + _ordered(zeros, holder.tree["momentum"])
    for g, w in zip(got, after):
        np.testing.assert_array_equal(np.asarray(g).view(np.uint32), w.view(np.uint32))
