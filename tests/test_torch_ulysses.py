"""The port's Ulysses attention (einsum and flash, GQA) and the flagship
transformer's Ulysses train step, against the JAX package on a mesh of
the same shape.

Two spawned gloo worlds run every port case (``torch_sp_workers.py``):
world 2 on ``{"sp": 2}`` for the attention cases, world 4 for the
transformer on ``{"dp": 2, "sp": 2}`` and ``{"dp": 1, "sp": 2, "tp": 2}``.
The tests compute JAX's results on the first 2 or 4 of the 8 CPU devices
and compare, with the tolerance of the JAX test that each case mirrors
(``tests/test_ulysses.py``)."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import torch_sp_checks as checks
import torch_sp_workers as workers
from torchsnapshot_tpu_torch.utils.test_utils import run_multiprocess

CASES = {case[0]: case for case in workers.ULYSSES_CASES}
MODELS = {case[0]: case for case in workers.ULYSSES_MODEL_CASES}
JAX_ULYSSES = ["ulysses_causal_flash", "ulysses_full_einsum"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both spawned worlds, run in the background while this process
    computes the JAX package's results that take compiling: (attention
    output dir, model output dir, params, JAX results)."""
    attention = str(tmp_path_factory.mktemp("ulysses"))
    models = str(tmp_path_factory.mktemp("models"))
    params = {name: checks.model_params(case) for name, case in MODELS.items()}
    with ThreadPoolExecutor(2 + len(MODELS) + len(JAX_ULYSSES) + len(CASES)) as pool:
        spawned = [
            pool.submit(run_multiprocess, workers.attention_cases, 2,
                        (workers.ULYSSES_CASES, attention), timeout_s=150),
            pool.submit(run_multiprocess, workers.model_cases, 4,
                        (workers.ULYSSES_MODEL_CASES, params, models), timeout_s=150),
        ]
        # XLA compiles the JAX side's functions in parallel threads.
        jax_results = {name: pool.submit(checks.jax_model, case, params[name])
                       for name, case in MODELS.items()}
        jax_results.update({name: pool.submit(checks.jax_attention, CASES[name], 2)
                            for name in JAX_ULYSSES})
        # The einsum references, cached for the tests.
        references = [pool.submit(checks.reference_attention, case) for case in CASES.values()]
        for future in spawned + references:
            future.result()
        jax_results = {name: future.result() for name, future in jax_results.items()}
    return attention, models, params, jax_results


@pytest.mark.parametrize("name", list(CASES))
def test_ulysses_output_matches_jax(runs, name):
    """Against the JAX package's einsum attention (kv heads repeated), the
    spec its Ulysses tests hold it to (:39, :97), atol 3e-5 / rtol 1e-5."""
    case = CASES[name]
    want, _ = checks.reference_attention(case)
    got = checks.assemble(checks.rank_results(runs[0], name, 2), "out", case[1], 2)
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=1e-5)


@pytest.mark.parametrize("name", JAX_ULYSSES)
def test_ulysses_output_matches_jax_ulysses(runs, name):
    """Against the JAX package's own ``ulysses_attention`` on a 2-device
    mesh (flash: the Pallas kernels in interpret mode)."""
    case = CASES[name]
    got = checks.assemble(checks.rank_results(runs[0], name, 2), "out", case[1], 2)
    np.testing.assert_allclose(got, runs[3][name], atol=3e-5, rtol=1e-5)


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c[5]])
def test_ulysses_gradients_match_jax(runs, name):
    """dq, dk, dv of sum(out²) against jax.grad of the einsum attention,
    atol 2e-4 / rtol 1e-4 (:74)."""
    case = CASES[name]
    _, want = checks.reference_attention(case)
    parts = checks.rank_results(runs[0], name, 2)
    for key, w in zip(("dq", "dk", "dv"), want):
        got = checks.assemble(parts, key, case[1], 2)
        np.testing.assert_allclose(got, w, atol=2e-4, rtol=1e-4, err_msg=key)


def test_ulysses_refuses_heads_the_axis_does_not_divide(runs):
    """3 heads over sp 2: both packages raise a ValueError that says the
    heads must be divisible (:115)."""
    want = checks.jax_refusal("ulysses_heads", 2)
    assert want is not None and "divisible" in want
    for errors in checks.rank_json(runs[0], "rejections", 2):
        got = errors["ulysses_heads"]
        assert got is not None and got.startswith("ValueError") and "divisible" in got, got


def test_ulysses_runs_no_ring_chunks(runs):
    assert all(set(c.values()) == {0} for c in checks.rank_json(runs[0], "chunks", 2))


@pytest.mark.parametrize("name", list(MODELS))
def test_model_loss_matches_jax(runs, name):
    checks.check_loss(checks.rank_results(runs[1], name, 4), runs[3][name])


@pytest.mark.parametrize("name", list(MODELS))
def test_model_gradients_match_jax(runs, name):
    checks.check_grads(checks.rank_results(runs[1], name, 4), runs[3][name], runs[2][name])


@pytest.mark.parametrize("name", list(MODELS))
def test_model_sgd_step_matches_jax(runs, name):
    checks.check_stepped(checks.rank_results(runs[1], name, 4), runs[3][name], runs[2][name])


@pytest.mark.parametrize("name", list(MODELS))
def test_model_logits_match_jax(runs, name):
    checks.check_logits(checks.rank_results(runs[1], name, 4), runs[3][name], MODELS[name][1])
