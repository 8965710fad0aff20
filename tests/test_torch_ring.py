"""The port's ring attention (contiguous and zigzag, einsum and flash
chunks, GQA) and the flagship transformer's dp × sp × tp train step,
against the JAX package on a mesh of the same shape; then the multi-chip
dry run's checkpoint block on the stepped state.

Two spawned gloo worlds run every port case (``torch_sp_workers.py``):
world 2 on ``{"sp": 2}`` for the attention cases, world 4 for the
transformer cases and the checkpoint block. Each rank saves its local
results; the tests here compute JAX's on the first 2 or 4 of the 8 CPU
devices (Pallas in interpret mode) and compare, with the tolerance of the
JAX test that each case mirrors (``tests/test_ring_attention.py``)."""

import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_sp_checks as checks
import torch_sp_workers as workers
import torchsnapshot_tpu as jsnap
from torchsnapshot_tpu.manifest import get_available_entries as jax_available
from torchsnapshot_tpu.models import transformer as jtf
from torchsnapshot_tpu.ops.attention import flash_chunk_attention
from torchsnapshot_tpu_torch import Snapshot
from torchsnapshot_tpu_torch.manifest import get_available_entries
from torchsnapshot_tpu_torch.models import transformer as ttf
from torchsnapshot_tpu_torch.ops.attention import flash_attention_with_lse
from torchsnapshot_tpu_torch.utils.test_utils import run_multiprocess
from torchsnapshot_tpu_torch.utils.train_state import PytreeStateful

CASES = {case[0]: case for case in workers.RING_CASES}
MODELS = {case[0]: case for case in workers.MODEL_CASES}
# |port - JAX| <= atol + rtol·|JAX| for the outputs, as the JAX test of
# each kind holds the ring to its reference.
OUT_TOL = {"einsum": (3e-6, 1e-5), "flash": (3e-5, 1e-5)}


JAX_RINGS = ["zigzag", "ring_flash_causal"]
# The case whose stepped state goes through the checkpoint block, and
# whose gradients are also held to jax.grad through the JAX ring.
CKPT = workers.MODEL_CASES[0]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both spawned worlds, run in the background while this process
    computes the JAX package's results that take compiling: (attention
    output dir, model output dir, snapshot dir, params, JAX results)."""
    attention = str(tmp_path_factory.mktemp("ring"))
    models = str(tmp_path_factory.mktemp("models"))
    snaps = str(tmp_path_factory.mktemp("snaps"))
    params = {name: checks.model_params(case) for name, case in MODELS.items()}
    with ThreadPoolExecutor(2 + len(MODELS) + len(JAX_RINGS) + len(CASES)) as pool:
        spawned = [
            pool.submit(run_multiprocess, workers.ring_world, 2, (attention,), timeout_s=150),
            pool.submit(run_multiprocess, workers.model_cases, 4,
                        (workers.MODEL_CASES, params, models, snaps), timeout_s=150),
        ]
        # XLA compiles the JAX side's functions in parallel threads.
        jax_results = {
            name: pool.submit(checks.jax_model, case, params[name], ring_grads=name == CKPT[0])
            for name, case in MODELS.items()
        }
        jax_results.update({name: pool.submit(checks.jax_attention, CASES[name], 2) for name in JAX_RINGS})
        # The einsum references, cached for the tests.
        references = [pool.submit(checks.reference_attention, case) for case in CASES.values()]
        for future in spawned + references:
            future.result()
        jax_results = {name: future.result() for name, future in jax_results.items()}
    return attention, models, snaps, params, jax_results


@pytest.fixture(scope="module")
def attention_runs(runs):
    return runs[0]


@pytest.fixture(scope="module")
def model_runs(runs):
    return runs[1], runs[2], runs[3]


@pytest.fixture(scope="module")
def jax_results(runs):
    return runs[4]


def _expected_collective(name, inputs):
    """(y, grad) of each rank for a helper, from every rank's (x, w): the
    gradient of the sum of the ranks' losses sum(w_r · y_r), w.r.t. x_r;
    where the weights are alike on every rank the helper's output stands
    for one replicated value, whose loss counts once."""
    (x0, w0), (x1, w1) = inputs
    xs, ws = (x0, x1), (w0, w1)
    if name == "rotate":  # y_r = x_{r-1}
        return [(xs[1 - r], ws[1 - r]) for r in range(2)]
    if name == "all_to_all":  # row block j of x_r lands in column block r of y_j
        ys = [np.concatenate([xs[j][2 * r:2 * r + 2] for j in range(2)], axis=1) for r in range(2)]
        grads = [np.concatenate([ws[j][:, 3 * r:3 * r + 3] for j in range(2)], axis=0) for r in range(2)]
        return list(zip(ys, grads))
    if name == "copy_to_group":  # a replicated input of per-rank work
        return [(xs[r], w0 + w1) for r in range(2)]
    if name == "reduce_from_group":
        return [(x0 + x1, ws[r]) for r in range(2)]
    y = np.concatenate(xs, axis=1)
    blocks = (slice(0, 3), slice(3, 5))
    if name == "gather_reduce_grad":
        return [(y, (w0 + w1)[:, blocks[r]]) for r in range(2)]
    return [(y, ws[r][:, blocks[r]]) for r in range(2)]


@pytest.mark.parametrize("name", [c[0] for c in workers.COLLECTIVE_CASES])
def test_collective_values_and_gradients(attention_runs, name):
    """Each differentiable collective at world 2 on gloo: its value, and
    the gradient each rank's input gets when every rank backpropagates
    its own loss, against the sums written out by hand."""
    shape = {c[0]: c[1] for c in workers.COLLECTIVE_CASES}[name]
    inputs = [workers.collective_inputs(name, r, shape) for r in range(2)]
    got = checks.rank_results(attention_runs, "collectives", 2)
    for rank, (y, grad) in enumerate(_expected_collective(name, inputs)):
        np.testing.assert_allclose(got[rank][f"{name}_y"], y, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got[rank][f"{name}_grad"], grad, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", list(CASES))
def test_ring_output_matches_jax(attention_runs, name):
    """The port's ring against the JAX package's einsum attention, the
    spec its ring tests hold the ring to (:32, :94, :263, :579), at their
    tolerances."""
    case = CASES[name]
    want, _ = checks.reference_attention(case)
    got = checks.assemble(checks.rank_results(attention_runs, name, 2), "out", case[1], 2)
    atol, rtol = OUT_TOL[case[4]]
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


@pytest.mark.parametrize("name", JAX_RINGS)
def test_ring_output_matches_jax_ring(attention_runs, jax_results, name):
    """The port's ring against the JAX package's own ring on a 2-device
    mesh (flash chunks: the Pallas kernels in interpret mode)."""
    case = CASES[name]
    want = jax_results[name]
    got = checks.assemble(checks.rank_results(attention_runs, name, 2), "out", case[1], 2)
    atol, rtol = OUT_TOL[case[4]]
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c[5]])
def test_ring_gradients_match_jax(attention_runs, name):
    """dq, dk, dv of sum(out²) against jax.grad of the einsum attention:
    atol 1e-4 for the einsum rings (:68, :132), 2e-4 / rtol 1e-4 where a
    flash or GQA chunk runs (:337, :366, :598)."""
    case = CASES[name]
    _, want = checks.reference_attention(case)
    parts = checks.rank_results(attention_runs, name, 2)
    tol = (1e-4, 0.0) if case[4] == "einsum" and case[2][1] == case[2][2] else (2e-4, 1e-4)
    for key, w in zip(("dq", "dk", "dv"), want):
        got = checks.assemble(parts, key, case[1], 2)
        np.testing.assert_allclose(got, w, atol=tol[0], rtol=tol[1], err_msg=key)


def test_chunks_skip_the_future(attention_runs):
    """The port skips future chunks by a branch, never a masked launch:
    at sp 2 the zigzag ring runs 5 chunk attentions on each rank (rank 0
    holds sub-chunks {0, 3}: 1 + 4; rank 1 holds {1, 2}: 2 + 3); the
    causal contiguous ring 1 on rank 0 and 2 on rank 1; a full one 2."""
    counts = checks.rank_json(attention_runs, "chunks", 2)
    for name, case in CASES.items():
        got = [c[name] for c in counts]
        if case[1] == "zigzag":
            assert got == [5, 5], name
        else:
            assert got == ([1, 2] if case[3] else [2, 2]), name


@pytest.mark.parametrize(
    "name,phrase",
    [
        ("ring_indivisible", "divisible"),
        ("zigzag_indivisible", "divisible"),
        ("zigzag_odd_slice", "divisible"),
        ("flash_chunk_too_small", "power-of-two factor"),
    ],
)
def test_ring_refuses_what_jax_refuses(attention_runs, name, phrase):
    port = checks.rank_json(attention_runs, "rejections", 2)
    want = checks.jax_refusal(name, 2)
    assert want is not None and phrase in want
    for errors in port:
        assert errors[name] is not None and phrase in errors[name], errors[name]
        assert errors[name].startswith("ValueError")


@pytest.mark.parametrize("seq_axis,shape", [(2, (2, 3, 64, 4)), (1, (2, 64)), (1, (2, 64, 5))])
def test_zigzag_helpers_match_jax(seq_axis, shape):
    """zigzag_indices, to_zigzag and from_zigzag permute a global tensor
    as the JAX package's do, along any sequence dim (:94, :541)."""
    from torchsnapshot_tpu.parallel import ring_attention as jring
    from torchsnapshot_tpu_torch.parallel import ring_attention as pring

    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    mesh = checks.jax_mesh({"sp": 4})
    assert pring.zigzag_indices(64, 4).tolist() == np.asarray(jring.zigzag_indices(64, 4)).tolist()
    z = pring.to_zigzag(torch.from_numpy(x), 4, seq_axis=seq_axis)
    np.testing.assert_array_equal(z.numpy(), np.asarray(jring.to_zigzag(jnp.asarray(x), mesh, seq_axis=seq_axis)))
    np.testing.assert_array_equal(pring.from_zigzag(z, 4, seq_axis=seq_axis).numpy(), x)


def test_flash_chunk_vjp_with_lse_cotangent_matches_jax():
    """The chunk primitive differentiates through both outputs: a loss of
    out and lse gives the same gradients as JAX's flash_chunk_attention
    (Pallas, interpret mode), through delta' = delta − dlse."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((2, 2, 64, 16)).astype(np.float32) for _ in range(3))

    def jax_loss(q, k, v):
        out, lse = flash_chunk_attention(q, k, v, True, 32, 32, True)
        return jnp.sum(out.astype(jnp.float32) ** 2) + jnp.sum(jnp.sin(lse))

    want_loss = float(jax_loss(q, k, v))
    want = jax.grad(jax_loss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, lse = flash_attention_with_lse(tq, tk, tv, True)
    loss = (out.float() ** 2).sum() + torch.sin(lse).sum()
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5)
    for g, w in zip(torch.autograd.grad(loss, (tq, tk, tv)), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("name", list(MODELS))
def test_model_loss_matches_jax(model_runs, jax_results, name):
    checks.check_loss(checks.rank_results(model_runs[0], name, 4), jax_results[name])


@pytest.mark.parametrize("name", list(MODELS))
def test_model_gradients_match_jax(model_runs, jax_results, name):
    out, _, params = model_runs
    checks.check_grads(checks.rank_results(out, name, 4), jax_results[name], params[name])


def test_model_gradients_match_jax_ring_backward(model_runs, jax_results):
    """The zigzag case's gradients against jax.grad through the JAX
    package's zigzag ring itself (its backward compiles for ~20 s on the
    CPU, so one case)."""
    out, _, params = model_runs
    checks.check_grads(checks.rank_results(out, CKPT[0], 4), jax_results[CKPT[0]],
                       params[CKPT[0]], key="ring_grads")


@pytest.mark.parametrize("name", list(MODELS))
def test_model_sgd_step_matches_jax(model_runs, jax_results, name):
    out, _, params = model_runs
    checks.check_stepped(checks.rank_results(out, name, 4), jax_results[name], params[name])


@pytest.mark.parametrize("name", list(MODELS))
def test_model_logits_match_jax(model_runs, jax_results, name):
    checks.check_logits(checks.rank_results(model_runs[0], name, 4), jax_results[name], MODELS[name][1])


# ------------------------------------------------- the checkpoint block


def _port_state(path):
    """The snapshot's state restored by the port at world 1, as numpy."""
    zeros = jax.tree.map(np.zeros_like, checks.model_params(CKPT))
    holder = PytreeStateful(ttf.params_from_numpy(zeros, "cpu"))
    Snapshot(path).restore({"model": holder})
    return checks.to_numpy(holder.tree)


def test_checkpoint_restores_on_the_mesh_and_a_half_mesh(model_runs):
    """On every rank of the (1, 2, 2) mesh, each local shard of the
    stepped state equals its box of the all-Replicate restore, and the
    restore into the tp-sharded layout on a 2-rank sub-mesh equals its
    boxes too, byte for byte."""
    out, _, _ = model_runs
    records = checks.rank_json(out, "checkpoint", 4)
    for r, record in enumerate(records):
        assert record["replicated_equal"] == record["leaves"], (r, record)
        assert record["half_mesh_equal"] == record["leaves"], (r, record)
    assert [rec["half_mesh_coordinate"] for rec in records] == [[0], [1], [0], [1]]


def test_checkpoint_stepped_state_matches_jax_step(model_runs, jax_results):
    state = _port_state(os.path.join(model_runs[1], "stepped"))
    want = jax_results[CKPT[0]]["stepped"]
    for path in checks.paths(state):
        np.testing.assert_allclose(checks.at(state, path), checks.at(want, path),
                                   atol=5e-4, rtol=1e-3, err_msg=str(path))


def _jax_take(path, state):
    mesh = checks.jax_mesh(CKPT[1])
    tree = jtf.shard_params(jax.tree.map(jnp.asarray, state), mesh)
    jsnap.Snapshot.take(path, {"model": _JaxState(tree)}, replicated=["**"])


class _JaxState:
    def __init__(self, tree):
        self.tree = tree

    def state_dict(self):
        return self.tree

    def load_state_dict(self, sd):
        self.tree = sd


def _payload_files(root):
    return sorted(
        os.path.relpath(os.path.join(d, f), root)
        for d, _, fs in os.walk(root) for f in fs
        if not os.path.relpath(os.path.join(d, f), root).startswith(".")
    )


def test_checkpoint_manifest_matches_jax_take(model_runs, tmp_path):
    """A JAX take of the same state on a (1, 2, 2) mesh with the same
    globs writes the same objects with the same bytes, and its manifest
    describes them entry for entry as the port's world-4 take does."""
    _, snaps, _ = model_runs
    port_path, jax_path = os.path.join(snaps, "stepped"), str(tmp_path / "jax")
    _jax_take(jax_path, _port_state(port_path))
    assert _payload_files(port_path) == _payload_files(jax_path)
    for name in _payload_files(port_path):
        with open(os.path.join(port_path, name), "rb") as a, open(os.path.join(jax_path, name), "rb") as b:
            assert a.read() == b.read(), name
    pman = get_available_entries(Snapshot(port_path).get_manifest(), 0)
    jman = jax_available(jsnap.Snapshot(jax_path).get_manifest(), 0)
    assert sorted(pman) == sorted(jman)
    for key, entry in pman.items():
        jentry = jman[key]
        assert type(entry).__name__ == type(jentry).__name__, key
        for field in ("dtype", "shape", "location", "replicated", "checksum"):
            assert getattr(entry, field, None) == getattr(jentry, field, None), (key, field)
        assert sorted(
            (s.offsets, s.sizes, s.array.location, s.array.checksum) for s in getattr(entry, "shards", [])
        ) == sorted(
            (s.offsets, s.sizes, s.array.location, s.array.checksum) for s in getattr(jentry, "shards", [])
        ), key


def test_checkpoint_crosses_packages_bit_exact(model_runs, tmp_path):
    """The port's world-4 snapshot restores through the JAX package onto
    the (1, 2, 2) mesh, and a JAX take restores through the port, bit for
    bit."""
    _, snaps, _ = model_runs
    port_path = os.path.join(snaps, "stepped")
    state = _port_state(port_path)
    mesh = checks.jax_mesh(CKPT[1])
    holder = _JaxState(jtf.shard_params(jax.tree.map(jnp.zeros_like, state), mesh))
    jsnap.Snapshot(port_path).restore({"model": holder})
    for path in checks.paths(state):
        assert checks.at(holder.tree, path).tobytes() == checks.at(state, path).tobytes(), path

    jax_path = str(tmp_path / "jax")
    _jax_take(jax_path, state)
    back = _port_state(jax_path)
    for path in checks.paths(state):
        assert checks.at(back, path).tobytes() == checks.at(state, path).tobytes(), path
