"""Live progress records of the port against the JAX package's: the
same pulses give records of the same schema and values (times, host and
pid aside), a take's statusfile ends in the same phases, the storage
records of an async take are gone once it commits, and each manager's
reconcile sweeps the other package's orphaned records."""

import asyncio
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jsnap
from torchsnapshot_tpu.telemetry import progress as jax_progress
from torchsnapshot_tpu_torch import CheckpointManager, Snapshot, StateDict
from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin
from torchsnapshot_tpu_torch.telemetry import progress

_LIVE = ("heartbeat_at", "started_at", "host", "pid", "retries")


def _pulse(mod, statusfile_dir, storage=None):
    pub = mod.ProgressPublisher(
        kind="async_take", path="/ckpt/step-3", rank=1, world_size=4,
        statusfile_dir=statusfile_dir, interval_s=0.0,
    )
    if storage is not None:
        pub.attach_storage(storage, "a" * 32)
    pub.set_phase("capture")
    pub.add_bytes_total(1000)
    pub.set_phase("write")
    for op, n in (("stage", 0), ("write", 400), ("stage", 0), ("write", 600)):
        pub.pipeline_update(op, n)
    asyncio.run(pub.async_tick(force=True))
    record = pub.record()
    pub.finish()
    return record, pub.record()


def test_same_pulses_give_the_same_record(tmp_path):
    got, got_done = _pulse(progress, str(tmp_path / "port"))
    want, want_done = _pulse(jax_progress, str(tmp_path / "jax"))
    assert sorted(got) == sorted(want)
    strip = lambda r: {k: v for k, v in r.items() if k not in _LIVE}  # noqa: E731
    assert strip(got) == strip(want)
    assert strip(got_done) == strip(want_done)
    assert (got["phase"], got["bytes_done"], got["bytes_total"]) == ("write", 1000, 1000)
    assert got["ops"] == {"stage": 2, "write": 2} and got_done["phase"] == progress.DONE_PHASE
    # Each package parses the other's statusfiles.
    assert progress.collect_statusfiles(str(tmp_path / "jax"))[1]["phase"] == "done"
    assert jax_progress.collect_statusfiles(str(tmp_path / "port"))[1]["phase"] == "done"
    assert progress.progress_path("t", 3) == jax_progress.progress_path("t", 3) == ".progress/t/3"
    assert progress.statusfile_name(2) == jax_progress.statusfile_name(2)


def test_storage_records_parse_both_ways(tmp_path):
    for mod, other in ((progress, jax_progress), (jax_progress, progress)):
        root = str(tmp_path / mod.__name__.split(".")[0])
        storage = FSStoragePlugin(root)
        try:
            _pulse(mod, None, storage)
        finally:
            storage.close()
        with open(os.path.join(root, ".progress", "a" * 32, "1"), "rb") as f:
            data = f.read()
        assert other.parse_record(data)["bytes_done"] == 1000
    assert progress.parse_record(b"{torn") is None


@pytest.mark.parametrize("kind", ["take", "async_take"])
def test_a_take_publishes_and_cleans_up_as_in_jax(tmp_path, monkeypatch, kind):
    phases = {}
    for pkg in ("port", "jax"):
        status = str(tmp_path / f"status_{pkg}")
        monkeypatch.setenv("TPUSNAPSHOT_PROGRESS_DIR", status)
        path = str(tmp_path / pkg / "snap")
        w = np.arange(256, dtype=np.float32)
        if pkg == "port":
            state, snap = {"m": StateDict(w=torch.from_numpy(w))}, Snapshot
        else:
            state, snap = {"m": jsnap.StateDict(w=jnp.asarray(w))}, jsnap.Snapshot
        if kind == "take":
            snap.take(path, state)
        else:
            snap.async_take(path, state).wait()
        record = progress.collect_statusfiles(status)[0]
        phases[pkg] = (record["kind"], record["phase"], record["bytes_total"], record["ops"])
        # A committed take leaves no storage progress record.
        assert not any(
            files for d, _, files in os.walk(os.path.join(path, ".progress"))
        )
    assert phases["port"] == phases["jax"]
    assert phases["port"][:3] == (kind, "done", 1024)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_manager_reconcile_sweeps_either_packages_orphaned_records(tmp_path, monkeypatch, writer):
    monkeypatch.setenv("TPUSNAPSHOT_SWEEP_MIN_AGE_S", "0")
    base = str(tmp_path / "run")
    w = np.arange(64, dtype=np.float32)
    CheckpointManager(base).save(1, {"m": StateDict(w=torch.from_numpy(w))})
    # An orphaned record of a crashed async drain, under a committed step.
    mod = progress if writer == "port" else jax_progress
    storage = FSStoragePlugin(os.path.join(base, "step-1"))
    try:
        _pulse(mod, None, storage)
    finally:
        storage.close()
    record = os.path.join(base, "step-1", ".progress", "a" * 32, "1")
    for reconcile in (
        lambda: CheckpointManager(base).reconcile(),
        lambda: jsnap.CheckpointManager(base).reconcile(),
    ):
        assert os.path.exists(record)
        reconcile()
        assert not os.path.exists(record)
        storage = FSStoragePlugin(os.path.join(base, "step-1"))
        try:
            _pulse(mod, None, storage)
        finally:
            storage.close()
    # The committed step and its ledger survive both sweeps.
    assert CheckpointManager(base).all_steps() == [1]
    assert os.path.exists(os.path.join(base, ".telemetry", "ledger.jsonl"))
