"""Crash-matrix coverage for the port's chunk-store GC, after
``tests/test_chunkstore_gc.py``: a crash at any storage-op boundary
across ``delete`` → ref-doc removal (the refcount decrement) → chunk
free → ``reconcile_store()`` must never free a chunk a committed manifest
references, and the re-drive must reclaim every unreferenced chunk.

Fast tier-1 subset: every 4th crash point on fs and memory, each
recovered by the port and, on fs, also by the JAX package. The full
enumerations are ``slow``, as in the JAX file. The JAX file's two
fault-free cases run on the port in ``tests/test_torch_chunkstore.py``;
here they run across the packages (the JAX package deletes and
reconciles a run the port took)."""

import asyncio
import glob
import os
import uuid

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jsnap
from torchsnapshot_tpu import chunkstore as jchunkstore
from torchsnapshot_tpu_torch import Snapshot, StateDict, chunkstore
from torchsnapshot_tpu_torch.faultline import (
    FaultSchedule,
    SimulatedCrash,
    count_storage_ops,
    inject,
)
from torchsnapshot_tpu_torch.storage_plugin import url_to_storage_plugin

pytestmark = pytest.mark.faultline

_STRIDE = 4  # fast-tier subsample of the crash points


@pytest.fixture(autouse=True)
def _gc_env(monkeypatch):
    monkeypatch.setenv("TPUSNAPSHOT_SWEEP_MIN_AGE_S", "0")
    monkeypatch.setenv("TPUSNAPSHOT_REFS_MIN_AGE_S", "0")
    monkeypatch.setenv("TPUSNAPSHOT_CHUNK_BYTES", "4096")
    monkeypatch.setenv("TPUSNAPSHOT_CHUNK_MIN_BYTES", "0")


def _expected_states():
    """Three takes: step-2 shares most chunks with step-1 (one dirty
    chunk), step-3 shares with step-2 — the sharing pattern that makes
    premature freeing visible."""
    rng = np.random.RandomState(7)
    cur = rng.randn(256, 32).astype(np.float32)
    states = {}
    for step in (1, 2, 3):
        states[step] = cur.copy()
        nxt = cur.copy()
        nxt[(step * 32) : (step * 32) + 32] += 1.0
        cur = nxt
    return states


def _build_run(root: str) -> dict:
    states = _expected_states()
    for step, arr in states.items():
        Snapshot.take(
            f"{root}/step-{step}",
            {"m": StateDict(emb=torch.from_numpy(arr.copy()))},
            chunks=True,
        )
    return states


class _Port:
    """The port's side of the checks."""

    snapshot = Snapshot
    chunkstore = chunkstore

    @staticmethod
    def restore(snap, arr):
        t = {"m": StateDict(emb=torch.zeros(arr.shape))}
        snap.restore(t)
        return t["m"]["emb"].numpy()


class _Jax:
    """The JAX package's side of the same checks."""

    snapshot = jsnap.Snapshot
    chunkstore = jchunkstore

    @staticmethod
    def restore(snap, arr):
        t = {"m": jsnap.StateDict(emb=jnp.zeros(arr.shape, jnp.float32))}
        snap.restore(t)
        return np.asarray(t["m"]["emb"])


def _assert_invariant(pkg, root: str, states: dict, deleted_step: int) -> None:
    """Restore-or-detect over the chunk plane: every still-committed
    step verifies clean and restores bit-exact."""
    for step, arr in states.items():
        if step == deleted_step:
            continue
        snap = pkg.snapshot(f"{root}/step-{step}")
        snap.get_manifest()  # the crash never touched steps 2 and 3
        problems = snap.verify()
        assert not problems, (
            f"crash freed chunk(s) a committed manifest references "
            f"(step {step}): {problems}"
        )
        assert np.array_equal(pkg.restore(snap, arr), arr), step


def _assert_leak_free(pkg, root: str) -> None:
    """After reconcile, the store holds exactly the chunks live
    committed manifests reference (plus their ref docs)."""
    live_keys, live_refs = set(), set()
    for step in range(1, 4):
        url = f"{root}/step-{step}"
        try:
            manifest = pkg.snapshot(url).get_manifest()
        except Exception:
            continue  # deleted
        keys = pkg.chunkstore.chunk_keys_of(manifest)
        if keys:
            live_keys |= keys
            live_refs.add(pkg.chunkstore.ref_doc_name(url))
    storage = url_to_storage_plugin(f"{root}/.chunkstore")
    try:
        objs = asyncio.run(storage.list_prefix("")) or []
    finally:
        storage.close()
    on_disk_keys = {
        o.rsplit("/", 1)[-1] for o in objs if o.startswith(chunkstore.OBJECTS_PREFIX)
    }
    on_disk_refs = {
        o.rsplit("/", 1)[-1] for o in objs if o.startswith(chunkstore.REFS_PREFIX)
    }
    intents = [o for o in objs if o.startswith(chunkstore.INTENTS_PREFIX)]
    assert on_disk_keys == live_keys, (
        f"leaked={sorted(on_disk_keys - live_keys)} "
        f"missing={sorted(live_keys - on_disk_keys)}"
    )
    assert on_disk_refs == live_refs
    assert not intents


def _scenario(root: str) -> None:
    Snapshot(f"{root}/step-1").delete()
    chunkstore.reconcile_store(root)


def _run_matrix(make_root, points=None, recoverers=(_Port,)):
    root = make_root()
    _build_run(root)
    total = count_storage_ops(lambda: _scenario(root))
    assert total > 0
    if points is None:
        points = range(1, total + 1)
    for k in points:
        for pkg in recoverers:
            root = make_root()
            states = _build_run(root)
            with inject(FaultSchedule().crash_at(k)):
                try:
                    _scenario(root)
                except SimulatedCrash:
                    pass
            _assert_invariant(pkg, root, states, deleted_step=1)
            # Recovery: finish the interrupted delete (the snapshot may be
            # half-deleted), then reconcile reclaims every leak.
            try:
                pkg.snapshot(f"{root}/step-1").delete(sweep=True, force=True)
            except Exception:
                pass  # already fully deleted / uncommitted
            pkg.chunkstore.reconcile_store(root)
            _assert_invariant(pkg, root, states, deleted_step=1)
            _assert_leak_free(pkg, root)
    return total


def _fs_root_factory(tmp_path):
    counter = [0]

    def _make():
        counter[0] += 1
        d = tmp_path / f"run{counter[0]}"
        d.mkdir()
        return str(d)

    return _make


def _memory_root_factory():
    def _make():
        return f"memory://gcmx-torch-{uuid.uuid4().hex[:10]}/run"

    return _make


def _stride(make):
    root = make()
    _build_run(root)
    total = count_storage_ops(lambda: _scenario(root))
    return range(1, total + 1, _STRIDE)


class TestGCCrashMatrixFast:
    def test_fs_stride(self, tmp_path):
        make = _fs_root_factory(tmp_path)
        _run_matrix(make, points=_stride(make), recoverers=(_Port, _Jax))

    def test_memory_stride(self):
        make = _memory_root_factory()
        _run_matrix(make, points=_stride(make))


@pytest.mark.slow
class TestGCCrashMatrixFull:
    def test_fs_full_enumeration(self, tmp_path):
        _run_matrix(_fs_root_factory(tmp_path))

    def test_memory_full_enumeration(self):
        _run_matrix(_memory_root_factory())


class TestGCWithoutFaultsAcrossPackages:
    def test_jax_delete_of_port_steps_empties_store(self, tmp_path):
        root = str(tmp_path)
        _build_run(root)
        for step in (1, 2, 3):
            jsnap.Snapshot(f"{root}/step-{step}").delete()
        assert not glob.glob(f"{root}/.chunkstore/objects/*/*")
        assert not glob.glob(f"{root}/.chunkstore/refs/*")

    @pytest.mark.parametrize("reconciler", ["port", "jax"])
    def test_interrupted_delete_redriven_by_reconcile(self, tmp_path, reconciler):
        """The worst half-done delete of a port run (metadata and ref doc
        gone, chunks still there): either package's reconcile reclaims
        exactly the chunks no live step references."""
        root = str(tmp_path)
        states = _build_run(root)
        url = f"{root}/step-1"
        keys1 = chunkstore.chunk_keys_of(Snapshot(url).get_manifest())
        os.remove(f"{root}/step-1/.snapshot_metadata")
        os.remove(f"{root}/.chunkstore/refs/{chunkstore.ref_doc_name(url)}")
        pkg = _Port if reconciler == "port" else _Jax
        pkg.chunkstore.reconcile_store(root)
        _assert_invariant(pkg, root, states, deleted_step=1)
        remaining = {
            p.rsplit("/", 1)[-1] for p in glob.glob(f"{root}/.chunkstore/objects/*/*")
        }
        live = chunkstore.chunk_keys_of(
            Snapshot(f"{root}/step-2").get_manifest()
        ) | chunkstore.chunk_keys_of(Snapshot(f"{root}/step-3").get_manifest())
        assert remaining == live
        assert not (keys1 - live) & remaining
