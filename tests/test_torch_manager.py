"""The port's CheckpointManager and Snapshot.delete on CPU tensors: step
markers, retention, pruning with tombstones, reconcile, and run
directories crossing between the port's manager and the JAX package's in
both directions."""

import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jsnap
from torchsnapshot_tpu_torch import (
    CheckpointManager,
    FnStateful,
    PytreeStateful,
    Snapshot,
    StateDict,
)


def _state(v):
    return {"s": StateDict(w=torch.full((8,), float(v)))}


def _target():
    return {"s": StateDict(w=torch.zeros(8))}


def _files(path):
    return [os.path.join(dp, f) for dp, _, fs in os.walk(path) for f in fs]


@pytest.fixture
def no_age_guard(monkeypatch):
    monkeypatch.setenv("TPUSNAPSHOT_SWEEP_MIN_AGE_S", "0")


def test_dry_run_manager_block(tmp_path):
    """The JAX package's dry-run lifecycle block, on the port."""
    params = {"layers": [{"w": torch.randn(4, 3), "b": torch.randn(3)}], "step": 7}
    mgr = CheckpointManager(str(tmp_path / "run"), max_to_keep=1)
    mgr.save(1, {"m": PytreeStateful(params)})
    mgr.async_save(2, {"m": PytreeStateful(params)}).wait()
    assert mgr.all_steps() == [2]
    holder = PytreeStateful(
        {"layers": [{"w": torch.zeros(4, 3), "b": torch.zeros(3)}], "step": 0}
    )
    assert mgr.restore({"m": holder}) == 2
    got = holder.tree["layers"][0]
    assert torch.equal(got["w"], params["layers"][0]["w"])
    assert torch.equal(got["b"], params["layers"][0]["b"])
    assert holder.tree["step"] == 7


def test_save_restore_latest_and_explicit(tmp_path, no_age_guard):
    mgr = CheckpointManager(str(tmp_path / "run"))
    for step in (0, 100, 200):
        mgr.save(step, _state(step))
    assert mgr.all_steps() == [0, 100, 200] and mgr.latest_step() == 200
    for step, expected in ((None, 200), (100, 100)):
        target = _target()
        assert mgr.restore(target, step=step) == expected
        assert torch.equal(target["s"]["w"], torch.full((8,), float(expected)))


@pytest.mark.parametrize(
    "max_to_keep,keep_period,kept", [(2, None, [4, 5]), (1, 2, [0, 2, 4, 5])]
)
def test_retention_and_keep_period(tmp_path, no_age_guard, max_to_keep, keep_period, kept):
    base = tmp_path / "run"
    mgr = CheckpointManager(str(base), max_to_keep=max_to_keep, keep_period=keep_period)
    for step in range(6):
        mgr.save(step, _state(step))
    assert mgr.all_steps() == kept
    for step in set(range(6)) - set(kept):
        assert _files(base / f"step-{step}") == [], step
    assert not _files(base / ".pruning")


def test_uncommitted_step_is_invisible(tmp_path):
    base = tmp_path / "run"
    mgr = CheckpointManager(str(base))
    mgr.save(10, _state(10))
    # A take that crashed: payloads, no metadata, no marker.
    Snapshot.take(str(base / "step-20"), _state(20))
    os.remove(base / "step-20" / ".snapshot_metadata")
    assert mgr.latest_step() == 10
    target = _target()
    assert mgr.restore(target) == 10


def test_restore_with_no_steps_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="No committed checkpoints"):
        CheckpointManager(str(tmp_path / "none")).restore(_target())


def test_interrupted_prune_is_retried_by_the_next_prune(tmp_path, no_age_guard):
    base = tmp_path / "run"
    mgr = CheckpointManager(str(base), max_to_keep=2)
    mgr.save(0, _state(0))
    mgr.save(1, _state(1))
    # A prune of step 0 killed after its marker went: tombstone, payloads.
    os.remove(base / ".steps" / "0")
    (base / ".pruning").mkdir()
    (base / ".pruning" / "0").write_bytes(b"1")
    assert mgr.all_steps() == [1]
    mgr.save(2, _state(2))
    assert _files(base / "step-0") == [] and not (base / ".pruning" / "0").exists()
    assert mgr.all_steps() == [1, 2]


def test_tombstone_survives_an_age_guarded_sweep(tmp_path):
    base = tmp_path / "run"
    mgr = CheckpointManager(str(base), max_to_keep=2)
    mgr.save(0, _state(0))
    mgr.save(1, _state(1))
    os.remove(base / ".steps" / "0")
    os.remove(base / "step-0" / ".snapshot_metadata")
    (base / ".pruning").mkdir()
    (base / ".pruning" / "0").write_bytes(b"1")
    mgr.save(2, _state(2))  # the young payloads are spared
    payloads = _files(base / "step-0")
    assert payloads and (base / ".pruning" / "0").exists()
    old = time.time() - 7200
    for p in payloads:
        os.utime(p, (old, old))
    mgr.save(3, _state(3))
    assert _files(base / "step-0") == [] and not (base / ".pruning" / "0").exists()


def _orphan_step(base, step, value):
    """A committed async save whose wait() never ran: no step marker."""
    Snapshot.async_take(f"{base}/step-{step}", _state(value)).wait()


def test_reconcile_adopts_an_orphaned_async_save(tmp_path, no_age_guard):
    base = str(tmp_path / "run")
    CheckpointManager(base, max_to_keep=2).save(1, _state(1))
    CheckpointManager(base).save(2, _state(2))
    _orphan_step(base, 3, 3.0)
    fresh = CheckpointManager(base, max_to_keep=2)
    assert fresh.latest_step() == 2
    assert fresh.reconcile() == [3]
    assert fresh.all_steps() == [2, 3]  # adoption re-ran retention
    target = _target()
    assert fresh.restore(target) == 3
    assert torch.equal(target["s"]["w"], torch.full((8,), 3.0))
    assert fresh.reconcile() == []


def test_reconcile_sweep_mode_and_its_age_guard(tmp_path, monkeypatch):
    base = str(tmp_path / "run")
    CheckpointManager(base).save(1, _state(1))
    _orphan_step(base, 2, 2.0)
    monkeypatch.setenv("TPUSNAPSHOT_SWEEP_MIN_AGE_S", "3600")
    assert CheckpointManager(base).reconcile(adopt=False) == []  # young: spared
    monkeypatch.setenv("TPUSNAPSHOT_SWEEP_MIN_AGE_S", "0")
    assert CheckpointManager(base, reconcile_on_init=None).reconcile(adopt=False) == [2]
    assert not (tmp_path / "run" / "step-2" / ".snapshot_metadata").exists()
    assert CheckpointManager(base).all_steps() == [1]


def test_unported_options_raise(tmp_path):
    """The deduplication options are ported; what still raises is a
    misuse of them. Reconcile sweeps a run's chunk store."""
    for kwargs in ({"incremental": True}, {"chunks": True}, {"codec": "zlib"}):
        CheckpointManager(str(tmp_path / "run"), **kwargs)
    with pytest.raises(ValueError, match="requires incremental"):
        CheckpointManager(str(tmp_path / "run"), full_period=2)
    with pytest.raises(ValueError, match="full_period"):
        CheckpointManager(str(tmp_path / "run"), incremental=True, full_period=0)
    with pytest.raises(ValueError, match="Unknown codec"):
        CheckpointManager(str(tmp_path / "run"), chunks=True, codec="lz77").save(1, _state(1))
    stray = tmp_path / "run" / ".chunkstore" / "objects" / "ff" / ("xs128:" + "f" * 32 + "-4-raw")
    stray.parent.mkdir(parents=True)
    stray.write_bytes(b"1")
    CheckpointManager(str(tmp_path / "run")).reconcile()
    assert stray.exists()  # younger than the sweep's age guard


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_run_directories_cross_packages(tmp_path, no_age_guard, writer):
    """A run written by one package's manager restores through the
    other's, and the reader's manager goes on saving into it, pruning
    the writer's steps."""
    base = str(tmp_path / "run")
    values = {s: np.random.default_rng(s).standard_normal((5, 3)).astype(np.float32)
              for s in (1, 2)}
    if writer == "jax":
        mgr = jsnap.CheckpointManager(base, max_to_keep=2)
        mgr.save(1, {"s": jsnap.StateDict(w=jnp.asarray(values[1]))})
        mgr.async_save(2, {"s": jsnap.StateDict(w=jnp.asarray(values[2]))}).wait()
        reader = CheckpointManager(base, max_to_keep=2)
        target = {"s": StateDict(w=torch.zeros(5, 3))}
        assert reader.all_steps() == [1, 2] and reader.restore(target) == 2
        reader.save(3, {"s": StateDict(w=torch.ones(5, 3))})
    else:
        mgr = CheckpointManager(base, max_to_keep=2)
        mgr.save(1, {"s": StateDict(w=torch.from_numpy(values[1]))})
        mgr.async_save(2, {"s": StateDict(w=torch.from_numpy(values[2]))}).wait()
        reader = jsnap.CheckpointManager(base, max_to_keep=2)
        target = {"s": jsnap.StateDict(w=np.zeros((5, 3), np.float32))}
        assert reader.all_steps() == [1, 2] and reader.restore(target) == 2
        reader.save(3, {"s": jsnap.StateDict(w=np.ones((5, 3), np.float32))})
    assert np.asarray(target["s"]["w"]).tobytes() == values[2].tobytes()
    assert reader.all_steps() == [2, 3]
    assert _files(os.path.join(base, "step-1")) == []


def test_delete_honours_a_jax_incremental_back_link(tmp_path, no_age_guard):
    base_path, child_path = str(tmp_path / "base"), str(tmp_path / "child")
    w = jnp.arange(32.0)
    jsnap.Snapshot.take(base_path, {"s": jsnap.StateDict(w=w)}, fingerprint=True)
    jsnap.Snapshot.take(child_path, {"s": jsnap.StateDict(w=w)}, base=base_path)
    assert Snapshot(base_path).is_referenced()
    with pytest.raises(RuntimeError, match="still referenced"):
        Snapshot(base_path).delete()
    # Deleting the child removes its back-link; then the base goes too.
    Snapshot(child_path).delete()
    assert not Snapshot(base_path).is_referenced()
    Snapshot(base_path).delete(sweep=True)
    assert _files(base_path) == [] and _files(child_path) == []


def test_delete_refuses_while_a_referencer_is_unreadable(tmp_path, no_age_guard, monkeypatch):
    """A committed JAX incremental child whose metadata is cut in half,
    with a back-link older than TPUSNAPSHOT_REFS_MIN_AGE_S: only a child
    that is not found counts as uncommitted, so the base stays referenced
    and delete refuses."""
    base_path, child_path = str(tmp_path / "base"), str(tmp_path / "child")
    w = jnp.arange(32.0)
    jsnap.Snapshot.take(base_path, {"s": jsnap.StateDict(w=w)}, fingerprint=True)
    jsnap.Snapshot.take(child_path, {"s": jsnap.StateDict(w=w)}, base=base_path)
    metadata = os.path.join(child_path, ".snapshot_metadata")
    with open(metadata, "rb") as f:
        doc = f.read()
    with open(metadata, "wb") as f:
        f.write(doc[: len(doc) // 2])
    monkeypatch.setenv("TPUSNAPSHOT_REFS_MIN_AGE_S", "60")
    old = time.time() - 7200
    for d, _, fs in os.walk(base_path):
        for name in fs:
            os.utime(os.path.join(d, name), (old, old))
    assert Snapshot(base_path).is_referenced()
    with pytest.raises(RuntimeError, match="still referenced"):
        Snapshot(base_path).delete()
    assert _files(base_path)


def test_fn_stateful_round_trips(tmp_path):
    box = {"v": torch.arange(6.0)}
    app = {"f": FnStateful(lambda: {"v": box["v"]}, lambda sd: box.update(v=sd["v"]))}
    Snapshot.take(str(tmp_path / "snap"), app)
    box["v"] = torch.zeros(6)
    Snapshot(str(tmp_path / "snap")).restore(app)
    assert torch.equal(box["v"], torch.arange(6.0))
