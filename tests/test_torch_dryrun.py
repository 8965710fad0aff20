"""The port's dry-run entry points on the CPU: ``entry()``'s forward against the
JAX package's ``__graft_entry__.entry()`` on the same parameters, and
``dryrun_multichip`` over spawned gloo worlds of 2 and 4 ranks."""

import json
import math
import os

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from torchsnapshot_tpu_torch import dryrun
from torchsnapshot_tpu_torch.models import transformer as ttf


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_numpy(v) for v in tree]
    return np.asarray(tree)


def test_entry_runs_on_the_cpu_and_matches_the_jax_entry():
    fn, (params, tokens) = dryrun.entry(device="cpu")
    logits = fn(params, tokens)
    assert logits.shape == (2, 16, 64) and logits.dtype == torch.float32
    assert bool(torch.isfinite(logits).all())
    jfn, (jparams, jtokens) = graft.entry()
    want = np.asarray(jfn(jparams, jtokens))
    got = fn(ttf.params_from_numpy(_to_numpy(jparams), "cpu"), torch.from_numpy(np.array(jtokens)))
    # f32 products reassociate between XLA:CPU and ATen.
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_entry_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.entry()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.dryrun_multichip(2)


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_over_gloo(tmp_path, n):
    dryrun.dryrun_multichip(n, device="cpu", record_dir=str(tmp_path), timeout_s=240)
    records = [json.load(open(os.path.join(tmp_path, f"dryrun_{r}.json"))) for r in range(n)]
    tp = {2: 2, 4: 4}[n]
    for r in records:
        assert r["axes"] == {"dp": 1, "sp": 1, "tp": tp}
        assert r["ring_impl"] == "flash"
        assert all(math.isfinite(r[k]) for k in ("loss", "ulysses_loss", "dlrm_loss"))
        assert r["incremental_refs"] > 0
        # 2 layers' weights, embed, pos_embed, final_ln; 5 DLRM leaves x 2.
        assert r["replicated_leaves"] == r["split_leaves"] == 19
        assert r["dlrm_leaves"] == 10
    assert [("half_leaves" in r) for r in records] == [r < n // 2 for r in range(n)]
    # Every rank computes the global losses.
    assert len({(r["loss"], r["ulysses_loss"], r["dlrm_loss"]) for r in records}) == 1
