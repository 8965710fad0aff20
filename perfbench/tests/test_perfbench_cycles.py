"""Each one-card cell's mix driven through a whole run at a toy size on the
CPU, with ``memory://`` storage, untraced and traced (the cells of more than
one chip: ``test_perfbench_ranks.py``)."""

import math
import tempfile
import time

import pytest
import torch

from perfbench import checks, harness
from perfbench.tests import toy


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
@pytest.mark.parametrize("cell", toy.ONE_CARD)
def test_cell_runs_and_is_correct(cell, trace, tmp_path):
    result = toy.run(cell, tmp_path, trace=trace)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "checks"
    for entry in result["checks"].values():
        assert entry["value"] <= entry["limit"]
    if not trace:
        assert set(result["metrics"]) == {"step_s", "setup_s"}  # no card: no peak_card_GB
        assert all(m["value"] > 0 for m in result["metrics"].values())
    else:
        # Host-clock and program metrics are found on the CPU too; device
        # ones are not, and are left out rather than reported as 0.
        per_layer = harness.resolve(toy.SPEC, cell)["per_layer"]
        expected = {m["name"] for m in per_layer if m["source"] != "device_trace"}
        assert expected and expected <= set(result["metrics"])
        assert "attn_roofline" not in result["metrics"] and "d2h_GBps" not in result["metrics"]
        assert all(math.isfinite(m["value"]) for m in result["metrics"].values())


def test_digest_sees_value_and_place():
    """The exact comparisons' digest changes with an altered word, with
    pieces of a leaf at each other's offsets (across and within chunks) and
    with transposed rows, and not with a copy."""
    x = torch.randn(1000)
    base = checks.digests([x], chunk=64)[0]
    assert checks.digests([x.clone()], chunk=64) == [base]
    across = x.clone()
    across[0:64], across[64:128] = x[64:128], x[0:64]
    within = x.clone()
    within[3], within[5] = x[5], x[3]
    word = x.clone()
    word.view(torch.int32)[7] += 1
    for wrong in (across, within, word):
        assert checks.digests([wrong], chunk=64)[0] != base
    m = torch.randn(30, 30)
    assert checks.digests([m])[0] != checks.digests([m.t().contiguous()])[0]
    # The same sum of words in another order: a plain sum would not see it.
    assert x.view(torch.int32).sum() == across.view(torch.int32).sum()


MIXES = {
    "incremental": ("memory", {"max_to_keep": 2, "incremental": True}),
    "chunks": ("memory", {"max_to_keep": 1, "chunks": True}),
    "fs": ("fs", {"max_to_keep": 1}),
}


@pytest.mark.parametrize("mix", sorted(MIXES))
@pytest.mark.parametrize("cell", ["gpt2xl.train_async", "dlrm.train_resume"])
def test_mix_keywords_reach_the_manager(cell, mix, monkeypatch, tmp_path):
    """A mix's storage and the manager's and the call's keyword arguments
    come from its data file alone: a mix with ``incremental``, ``chunks`` or
    ``fs`` set runs correct with no code of the harness changed."""
    from torchsnapshot_tpu_torch import manager as mgr

    seen = []
    init = mgr.CheckpointManager.__init__

    def recording(self, base_path, **kwargs):
        seen.append((base_path, kwargs))
        init(self, base_path, **kwargs)

    monkeypatch.setattr(mgr.CheckpointManager, "__init__", recording)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))  # the run's TMPDIR
    storage, kwargs = MIXES[mix]
    r = toy.resolved(cell)
    r["traffic"] = dict(r["traffic"], storage=storage, manager=kwargs)
    result = harness.run_cell(r, 4_000_000_007, 0.5, False, "cpu", time.monotonic(), out_dir=tmp_path)
    assert result["correct"], result["checks"]
    assert seen == [(seen[0][0], kwargs)]
    assert seen[0][0].startswith("memory://" if storage == "memory" else str(tmp_path))
    assert not any(p.name.startswith("perfbench-") for p in tmp_path.iterdir())  # the fs store is removed

