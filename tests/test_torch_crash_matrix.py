"""The port's crash-consistency matrix, after ``tests/test_crash_matrix.py``:
replay the save→commit→prune cycle of the port's CheckpointManager
crashing at storage-op boundaries and assert the restore-or-detect
invariant (docs/FAULTS.md) with the port's faultline.

Fast tier (tier-1): a stride sample of crash points on fs and memory,
the five prune-phase crashes, the async-wait transient and crash orphan,
and the two reconcile cases. The full enumeration of every boundary is
``slow``, as in the JAX file.

Across the packages, on fs: after a crash at each stride point of the
port's cycle, the JAX package's recovery (``check_recovery_invariant``
with a JAX restore probe, its reconcile and re-drive, and
``assert_reclaimed``) accepts the base; and after a crash at each stride
point of the JAX package's cycle, the port's does.
"""

import os
import uuid

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jsnap
from torchsnapshot_tpu import faultline as jfl
from torchsnapshot_tpu_torch import CheckpointManager, Snapshot, StateDict
from torchsnapshot_tpu_torch import faultline as fl
from torchsnapshot_tpu_torch.manager import _PRUNING_PREFIX, _STEP_PREFIX

pytestmark = pytest.mark.faultline


def _state(v):
    return {"s": StateDict(w=torch.full((4,), float(v)))}


def _target():
    return {"s": StateDict(w=torch.zeros(4))}


def _probe(base):
    def probe(step):
        target = _target()
        got = CheckpointManager(base).restore(target, step=step)
        assert got == step
        assert torch.equal(target["s"]["w"], torch.full((4,), float(step)))

    return probe


def _jax_state(v):
    return {"s": jsnap.StateDict(w=jnp.full((4,), float(v)))}


def _jax_probe(base):
    def probe(step):
        target = {"s": jsnap.StateDict(w=jnp.zeros((4,)))}
        got = jsnap.CheckpointManager(base).restore(target, step=step)
        assert got == step
        np.testing.assert_array_equal(np.asarray(target["s"]["w"]), float(step))

    return probe


def _prepare_fs(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("crash") / "run")
    mgr = CheckpointManager(base, max_to_keep=1)
    mgr.save(0, _state(0))
    mgr.save(1, _state(1))
    return base


def _prepare_memory(_tmp_path_factory):
    base = f"memory://crashmx-torch-{uuid.uuid4().hex[:10]}/run"
    mgr = CheckpointManager(base, max_to_keep=1)
    mgr.save(0, _state(0))
    mgr.save(1, _state(1))
    return base


def _faulted(base):
    # One full lifecycle op: take step 2, commit its marker, prune step 1.
    CheckpointManager(base, max_to_keep=1).save(2, _state(2))


def _check(base, outcome):
    # (a)/(b): every visible marker restores clean; reconcile adopts
    # committed-unmarked work (also verified restorable).
    res = fl.check_recovery_invariant(base, _probe(base))
    outcome.marked_steps = res.marked_steps
    outcome.adopted_steps = res.adopted_steps
    # Recovery re-drive: the next save→prune cycle must succeed and
    # re-drive any interrupted prune; reconcile then reclaims crashed
    # uncommitted takes; nothing may leak.
    mgr = CheckpointManager(base, max_to_keep=1, reconcile_on_init="adopt")
    mgr.save(3, _state(3))
    mgr.reconcile(adopt=True)
    assert mgr.latest_step() == 3
    _probe(base)(3)
    fl.assert_reclaimed(base, [3])


_PREPARES = {"fs": _prepare_fs, "memory": _prepare_memory}


def _stride_points(total):
    # ~6 points spread over the op stream, always including the first
    # and last boundaries (commit edges live there).
    stride = max(1, total // 5)
    return sorted(set(range(1, total + 1, stride)) | {1, total})


@pytest.mark.parametrize("backend", ["fs", "memory"])
def test_crash_matrix_fast_subset(backend, tmp_path_factory, monkeypatch):
    """Stride-sampled crash points across the whole cycle (tier-1)."""
    monkeypatch.setenv("TPUSNAPSHOT_SWEEP_MIN_AGE_S", "0")
    prepare = _PREPARES[backend]
    base = prepare(tmp_path_factory)
    total = fl.count_storage_ops(lambda: _faulted(base))
    assert total > 0
    points = _stride_points(total)
    report = fl.enumerate_crash_points(
        lambda: prepare(tmp_path_factory), _faulted, _check, points, total_ops=total
    )
    assert report.total_ops == total
    assert set(report.outcomes) == set(points)


@pytest.mark.slow
@pytest.mark.parametrize("backend", ["fs", "memory"])
def test_crash_matrix_full_enumeration(backend, tmp_path_factory, monkeypatch):
    """EVERY storage-op boundary of the save→commit→prune cycle,
    including fs.py's write→fsync→rename→dir-fsync sub-steps."""
    monkeypatch.setenv("TPUSNAPSHOT_SWEEP_MIN_AGE_S", "0")
    prepare = _PREPARES[backend]
    report = fl.enumerate_crash_points(
        lambda: prepare(tmp_path_factory), _faulted, _check
    )
    assert len(report.outcomes) == report.total_ops
    assert all(o.crashed for o in report.outcomes.values())
    kinds = {
        (2 in o.marked_steps, 2 in o.adopted_steps)
        for o in report.outcomes.values()
    }
    assert (True, False) in kinds  # crashed after the marker commit
    assert (False, False) in kinds or (False, True) in kinds  # before


# ------------------------------------------------------ across the packages


def _jax_check(base, outcome):
    """The JAX package's recovery over a base the port crashed in."""
    res = jfl.check_recovery_invariant(base, _jax_probe(base))
    outcome.marked_steps = res.marked_steps
    outcome.adopted_steps = res.adopted_steps
    mgr = jsnap.CheckpointManager(base, max_to_keep=1, reconcile_on_init="adopt")
    mgr.save(3, _jax_state(3))
    mgr.reconcile(adopt=True)
    assert mgr.latest_step() == 3
    _jax_probe(base)(3)
    jfl.assert_reclaimed(base, [3])


def _jax_prepare(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("crash_jax") / "run")
    mgr = jsnap.CheckpointManager(base, max_to_keep=1)
    mgr.save(0, _jax_state(0))
    mgr.save(1, _jax_state(1))
    return base


def _jax_faulted(base):
    jsnap.CheckpointManager(base, max_to_keep=1).save(2, _jax_state(2))


def test_port_crash_points_recovered_by_jax(tmp_path_factory, monkeypatch):
    monkeypatch.setenv("TPUSNAPSHOT_SWEEP_MIN_AGE_S", "0")
    base = _prepare_fs(tmp_path_factory)
    total = fl.count_storage_ops(lambda: _faulted(base))
    points = _stride_points(total)
    report = fl.enumerate_crash_points(
        lambda: _prepare_fs(tmp_path_factory), _faulted, _jax_check, points,
        total_ops=total,
    )
    assert all(o.crashed for o in report.outcomes.values())
    assert set(report.outcomes) == set(points)


def test_jax_crash_points_recovered_by_port(tmp_path_factory, monkeypatch):
    monkeypatch.setenv("TPUSNAPSHOT_SWEEP_MIN_AGE_S", "0")
    base = _jax_prepare(tmp_path_factory)
    total = jfl.count_storage_ops(lambda: _jax_faulted(base))
    points = _stride_points(total)
    report = jfl.enumerate_crash_points(
        lambda: _jax_prepare(tmp_path_factory), _jax_faulted, _check, points,
        total_ops=total,
    )
    assert all(o.crashed for o in report.outcomes.values())
    assert set(report.outcomes) == set(points)


# ----------------------------------------------------- interrupted _prune


def _prune_crash_scenario(tmp_path, monkeypatch, crash_rule):
    """Build 2 committed steps, crash mid-prune of step 0 per
    ``crash_rule``, and return the base path. max_to_keep=1 makes
    save(1) prune step 0."""
    monkeypatch.setenv("TPUSNAPSHOT_SWEEP_MIN_AGE_S", "0")
    base = str(tmp_path / "run")
    CheckpointManager(base).save(0, _state(0))
    sched = fl.FaultSchedule()
    crash_rule(sched)
    with fl.inject(sched) as ctl:
        with pytest.raises(fl.SimulatedCrash):
            CheckpointManager(base, max_to_keep=1).save(1, _state(1))
    assert ctl.fault_counts().get("crash", 0) >= 1
    return base


def _assert_prune_redriven(base):
    """The crashed prune's step is fully reclaimed by the NEXT cycle and
    live steps survive with their values."""
    mgr = CheckpointManager(base)
    assert 1 in mgr.all_steps()
    _probe(base)(1)
    mgr2 = CheckpointManager(base, max_to_keep=1, reconcile_on_init="adopt")
    mgr2.save(2, _state(2))
    mgr2.reconcile(adopt=True)
    assert mgr2.all_steps() == [2]
    _probe(base)(2)
    fl.assert_reclaimed(base, [2])


def test_prune_crash_before_tombstone_write(tmp_path, monkeypatch):
    base = _prune_crash_scenario(
        tmp_path, monkeypatch,
        lambda s: s.crash_on(op="write", path=f"{_PRUNING_PREFIX}0"),
    )
    assert CheckpointManager(base).all_steps() == [0, 1]
    _probe(base)(0)
    _assert_prune_redriven(base)


def test_prune_crash_between_tombstone_and_marker_delete(tmp_path, monkeypatch):
    base = _prune_crash_scenario(
        tmp_path, monkeypatch,
        lambda s: s.crash_on(op="delete", path=f"{_STEP_PREFIX}0"),
    )
    # Tombstone written, marker still visible: the step must STILL be
    # fully restorable (payload deletion is ordered after marker delete).
    assert CheckpointManager(base).all_steps() == [0, 1]
    _probe(base)(0)
    _assert_prune_redriven(base)


def test_prune_crash_between_marker_delete_and_payload_delete(tmp_path, monkeypatch):
    base = _prune_crash_scenario(
        tmp_path, monkeypatch,
        lambda s: s.crash_on(op="delete", path=".snapshot_metadata"),
    )
    # Marker gone: step 0 is invisible even though its payloads survive,
    # and reconcile must NOT resurrect a condemned (tombstoned) step.
    mgr = CheckpointManager(base)
    assert mgr.all_steps() == [1]
    assert mgr.reconcile(adopt=True) == []
    assert mgr.all_steps() == [1]
    _assert_prune_redriven(base)


def test_prune_crash_mid_payload_deletes(tmp_path, monkeypatch):
    base = _prune_crash_scenario(
        tmp_path, monkeypatch,
        lambda s: s.crash_on(op="delete", path="0/*"),
    )
    assert CheckpointManager(base).all_steps() == [1]
    _assert_prune_redriven(base)


def test_prune_crash_before_tombstone_delete(tmp_path, monkeypatch):
    base = _prune_crash_scenario(
        tmp_path, monkeypatch,
        lambda s: s.crash_on(op="delete", path=f"{_PRUNING_PREFIX}0"),
    )
    assert CheckpointManager(base).all_steps() == [1]
    _assert_prune_redriven(base)


# ----------------------------------------- async finalize retriability


def test_async_wait_retries_transient_marker_failure(tmp_path, monkeypatch):
    """A transient marker-write failure during _finalize must leave the
    step finalizable on the next wait(), not silently skipped."""
    monkeypatch.setenv("TPUSNAPSHOT_SWEEP_MIN_AGE_S", "0")
    monkeypatch.setenv("TPUSNAPSHOT_STORAGE_RETRIES", "0")
    base = str(tmp_path / "run")
    mgr = CheckpointManager(base, max_to_keep=2)
    sched = fl.FaultSchedule().transient(op="write", path=f"{_STEP_PREFIX}7", times=1)
    with fl.inject(sched) as ctl:
        handle = mgr.async_save(7, _state(7))
        with pytest.raises(fl.InjectedTransientError):
            handle.wait()
        assert mgr.latest_step() is None  # committed, but no marker yet
        snap = handle.wait()  # idempotent drain; _finalize retries
    assert ctl.fault_counts() == {"transient": 1}
    assert mgr.latest_step() == 7
    _probe(base)(7)
    assert snap.path.endswith("step-7")


def test_async_wait_crash_orphan_adopted_by_reconcile(tmp_path, monkeypatch):
    """Process death between the background commit and wait(): the step
    is committed-but-unmarked, and reconcile(adopt=True) recovers it."""
    monkeypatch.setenv("TPUSNAPSHOT_SWEEP_MIN_AGE_S", "0")
    base = str(tmp_path / "run")
    mgr = CheckpointManager(base, max_to_keep=2)
    sched = fl.FaultSchedule().crash_on(op="write", path=f"{_STEP_PREFIX}3")
    with fl.inject(sched):
        handle = mgr.async_save(3, _state(3))
        with pytest.raises(fl.SimulatedCrash):
            handle.wait()
    mgr2 = CheckpointManager(base)
    assert mgr2.all_steps() == []
    assert mgr2.reconcile(adopt=True) == [3]
    assert mgr2.all_steps() == [3]
    _probe(base)(3)


# ------------------------------------------------- uncommitted-take debris


@pytest.mark.parametrize("backend", ["fs", "memory"])
def test_reconcile_reclaims_crashed_uncommitted_take(backend, tmp_path, monkeypatch):
    """A take that crashes before its commit point leaves payloads no
    marker/metadata/tombstone will ever name; reconcile sweeps them."""
    monkeypatch.setenv("TPUSNAPSHOT_SWEEP_MIN_AGE_S", "0")
    if backend == "fs":
        base = str(tmp_path / "run")
    else:
        base = f"memory://uncmt-torch-{uuid.uuid4().hex[:10]}/run"
    mgr = CheckpointManager(base, max_to_keep=2)
    mgr.save(0, _state(0))
    sched = fl.FaultSchedule().crash_on(op="write", path=".snapshot_metadata")
    with fl.inject(sched):
        with pytest.raises(fl.SimulatedCrash):
            CheckpointManager(base, max_to_keep=2).save(1, _state(1))
    mgr2 = CheckpointManager(base)
    assert mgr2.all_steps() == [0]  # detectably incomplete: unresolvable
    handled = mgr2.reconcile(adopt=True)
    assert 1 in handled  # reclaimed, not adopted (no commit point)
    assert mgr2.all_steps() == [0]
    fl.assert_reclaimed(base, [0])


def test_reconcile_age_guard_spares_young_uncommitted_take(tmp_path, monkeypatch):
    """The sweep age guard must protect an in-flight take: young
    uncommitted objects survive reconcile."""
    monkeypatch.setenv("TPUSNAPSHOT_SWEEP_MIN_AGE_S", "3600")
    base = str(tmp_path / "run")
    mgr = CheckpointManager(base, max_to_keep=2)
    mgr.save(0, _state(0))
    sched = fl.FaultSchedule().crash_on(op="write", path=".snapshot_metadata")
    with fl.inject(sched):
        with pytest.raises(fl.SimulatedCrash):
            CheckpointManager(base, max_to_keep=2).save(1, _state(1))
    mgr2 = CheckpointManager(base)
    handled = mgr2.reconcile(adopt=True)
    assert 1 not in handled
    leftovers = [
        os.path.join(dp, f)
        for dp, _, fs in os.walk(os.path.join(base, "step-1"))
        for f in fs
    ]
    assert leftovers  # spared — it might be someone's in-progress take


# ------------------------- Queue 3 faults 8 and 9, in both packages


def _pkg(name):
    if name == "port":
        return CheckpointManager, fl, lambda a: {"s": StateDict(w=torch.from_numpy(a.copy()))}
    return jsnap.CheckpointManager, jfl, lambda a: {"s": jsnap.StateDict(w=jnp.asarray(a))}


@pytest.mark.parametrize("package", ["port", "jax"])
def test_fault8_torn_chunk_object_is_trusted_by_the_next_take(package, tmp_path, monkeypatch):
    """Reproduces ROADMAP Queue 3 fault 8 (open, in both packages): a
    failed chunk take leaves a torn chunk object at its content key; the
    next take finds the key in its listing, writes nothing, and its
    marked step references the torn bytes, which only ``verify``
    catches."""
    for k, v in dict(TPUSNAPSHOT_SWEEP_MIN_AGE_S="0", TPUSNAPSHOT_REFS_MIN_AGE_S="0",
                     TPUSNAPSHOT_STORAGE_RETRIES="0", TPUSNAPSHOT_CHUNK_BYTES="4096",
                     TPUSNAPSHOT_CHUNK_MIN_BYTES="0").items():
        monkeypatch.setenv(k, v)
    manager, faultline, state = _pkg(package)
    base = str(tmp_path / "run")
    arr = np.random.RandomState(0).randn(64, 64).astype(np.float32)
    manager(base, max_to_keep=1, chunks=True).save(0, state(arr))
    arr[:8] += 1.0
    sched = faultline.FaultSchedule().torn_write(
        path="objects/*", keep_bytes=7, then="permanent", times=None
    )
    with faultline.inject(sched) as ctl:
        with pytest.raises(faultline.InjectedPermanentError):
            manager(base, max_to_keep=1, chunks=True).save(1, state(arr))
    assert ctl.fault_counts() == {"torn": 1}
    manager(base, max_to_keep=1, chunks=True).save(2, state(arr))
    assert manager(base).all_steps() == [2]
    problems = Snapshot(os.path.join(base, "step-2")).verify()
    assert len(problems) == 1
    assert "decoded 7 bytes, expected 4096" in next(iter(problems.values()))


@pytest.mark.parametrize("package", ["port", "jax"])
def test_fault9_reconcile_adopts_a_torn_metadata_object(package, tmp_path, monkeypatch):
    """Reproduces ROADMAP Queue 3 fault 9 (open, in both packages): a
    save whose ``.snapshot_metadata`` write tore (``then="permanent"``)
    leaves a truncated commit object; ``reconcile(adopt=True)`` takes its
    presence for a commit and marks a step that cannot be read."""
    monkeypatch.setenv("TPUSNAPSHOT_SWEEP_MIN_AGE_S", "0")
    monkeypatch.setenv("TPUSNAPSHOT_STORAGE_RETRIES", "0")
    manager, faultline, state = _pkg(package)
    base = str(tmp_path / "run")
    arr = np.zeros(4, np.float32)
    manager(base, max_to_keep=1).save(0, state(arr))
    sched = faultline.FaultSchedule().torn_write(
        path=".snapshot_metadata", keep_bytes=7, then="permanent", times=None
    )
    with faultline.inject(sched):
        with pytest.raises(faultline.InjectedPermanentError):
            manager(base, max_to_keep=1).save(1, state(arr + 1))
    assert manager(base).all_steps() == [0]
    assert manager(base).reconcile(adopt=True) == [1]
    assert manager(base).all_steps() == [0, 1]  # a marker naming a torn commit
    with pytest.raises(Exception):
        Snapshot(os.path.join(base, "step-1")).get_manifest()
