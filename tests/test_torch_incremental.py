"""Incremental (deduplicated) takes of the port: the cases of
tests/test_incremental.py whose features the port has (not copy_to,
verify, diff, paths= or the inspect CLI), on CPU tensors, and chains
crossing between the port and the JAX package in both directions."""

import json
import logging
import os
import shutil

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jsnap
from torchsnapshot_tpu_torch import CheckpointManager, RNGState, Snapshot, StateDict
from torchsnapshot_tpu_torch import io_preparer
from torchsnapshot_tpu_torch import snapshot as snapshot_mod
from torchsnapshot_tpu_torch.utils.test_utils import run_thread_ranks


def _count_payload_files(root):
    """Stored objects under a snapshot dir, without metadata and markers."""
    n = 0
    for dirpath, _, files in os.walk(root):
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), root)
            if rel == ".snapshot_metadata" or rel.startswith((".completed", ".report", ".telemetry", "refs")):
                continue
            n += 1
    return n


def _w(seed=0, n=1024):
    return np.random.RandomState(seed).randn(n).astype(np.float32)


def _state(seed=0, n=1024):
    rng = np.random.RandomState(seed)
    return StateDict(
        w=torch.from_numpy(rng.randn(n).astype(np.float32)),
        b=rng.randn(32).astype(np.float32),  # a numpy leaf
        step=7,
    )


def _fresh():
    return {"model": StateDict(w=torch.zeros(1024), b=np.zeros(32, np.float32), step=0)}


def _path(tmp_path, name):
    return str(tmp_path / name)


def test_unchanged_take_writes_no_array_objects(tmp_path):
    app = {"model": _state()}
    s1 = Snapshot.take(_path(tmp_path, "s1"), app, fingerprint=True)
    s2 = Snapshot.take(_path(tmp_path, "s2"), app, base=s1)
    assert _count_payload_files(_path(tmp_path, "s2")) == 0
    m = s2.get_manifest()
    assert m["0/model/w"].base is not None and m["0/model/b"].base is not None
    fresh = _fresh()
    Snapshot(_path(tmp_path, "s2")).restore(fresh)
    assert torch.equal(fresh["model"]["w"], app["model"]["w"])
    assert np.array_equal(fresh["model"]["b"], app["model"]["b"])
    assert fresh["model"]["step"] == 7


def test_changed_subset_writes_only_changed(tmp_path):
    app = {"model": _state()}
    s1 = Snapshot.take(_path(tmp_path, "s1"), app, fingerprint=True)
    app["model"]["b"] = app["model"]["b"] + 1.0
    s2 = Snapshot.take(_path(tmp_path, "s2"), app, base=s1)
    m = s2.get_manifest()
    assert m["0/model/w"].base is not None and m["0/model/b"].base is None
    assert _count_payload_files(_path(tmp_path, "s2")) == 1
    fresh = _fresh()
    s2.restore(fresh)
    assert np.array_equal(fresh["model"]["b"], app["model"]["b"])


def test_chain_flattens_to_original_writer(tmp_path):
    app = {"model": _state()}
    s1 = Snapshot.take(_path(tmp_path, "s1"), app, fingerprint=True)
    s2 = Snapshot.take(_path(tmp_path, "s2"), app, base=s1)
    Snapshot.take(_path(tmp_path, "s3"), app, base=s2)
    meta = Snapshot(_path(tmp_path, "s3"))._read_metadata(Snapshot(_path(tmp_path, "s3"))._open_storage())
    assert meta.base_paths[meta.manifest["0/model/w"].base] == "rel:s1"
    Snapshot(_path(tmp_path, "s2")).delete()
    fresh = _fresh()
    Snapshot(_path(tmp_path, "s3")).restore(fresh)
    assert torch.equal(fresh["model"]["w"], app["model"]["w"])


def test_chunked_dense_dedup(tmp_path, monkeypatch):
    monkeypatch.setattr(io_preparer, "MAX_CHUNK_SIZE_BYTES", 1 << 12)
    big = np.arange(4096, dtype=np.float32)  # 16 KiB: 4 chunk objects
    app = {"model": StateDict(big=torch.from_numpy(big.copy()))}
    s1 = Snapshot.take(_path(tmp_path, "s1"), app, fingerprint=True)
    app["model"]["big"][0] += 1.0  # dirty only the first chunk
    s2 = Snapshot.take(_path(tmp_path, "s2"), app, base=s1)
    entry = s2.get_manifest()["0/model/big"]
    writes = [s for s in entry.shards if s.array.base is None]
    assert len(writes) == 1 and writes[0].offsets == [0]
    assert len(entry.shards) == 4
    fresh = {"model": StateDict(big=torch.zeros(4096))}
    Snapshot(_path(tmp_path, "s2")).restore(fresh, verify_device=True)
    assert torch.equal(fresh["model"]["big"], app["model"]["big"])


def test_replicated_striping_dedup_world2(tmp_path):
    base_path, inc_path = _path(tmp_path, "s1"), _path(tmp_path, "s2")

    def app(bar):
        return {"model": StateDict(foo=torch.full((256,), 1.0), bar=torch.full((128,), bar))}

    run_thread_ranks(2, lambda c, r: Snapshot.take(base_path, app(2.0), coord=c, replicated=["**"], fingerprint=True))
    run_thread_ranks(2, lambda c, r: Snapshot.take(inc_path, app(3.0), coord=c, replicated=["**"], base=base_path))

    def restore(coord, rank):
        fresh = {"model": StateDict(foo=torch.zeros(256), bar=torch.zeros(128))}
        Snapshot(inc_path).restore(fresh, coord=coord, verify_device=True)
        assert torch.all(fresh["model"]["foo"] == 1.0) and torch.all(fresh["model"]["bar"] == 3.0)

    run_thread_ranks(2, restore)
    assert _count_payload_files(inc_path) == 1


def test_delete_protection_lifecycle(tmp_path):
    app = {"model": _state()}
    s1 = Snapshot.take(_path(tmp_path, "s1"), app, fingerprint=True)
    Snapshot.take(_path(tmp_path, "s2"), app, base=s1)
    with pytest.raises(RuntimeError, match="referenced by"):
        Snapshot(_path(tmp_path, "s1")).delete()
    Snapshot(_path(tmp_path, "s2")).delete()
    Snapshot(_path(tmp_path, "s1")).delete()
    for root, _, files in os.walk(tmp_path):
        assert not files, (root, files)


def test_delete_force_overrides_protection(tmp_path):
    app = {"model": _state()}
    s1 = Snapshot.take(_path(tmp_path, "s1"), app, fingerprint=True)
    Snapshot.take(_path(tmp_path, "s2"), app, base=s1)
    Snapshot(_path(tmp_path, "s1")).delete(force=True)
    with pytest.raises(Exception):
        Snapshot(_path(tmp_path, "s2")).restore(_fresh())


def test_young_orphan_marker_blocks_delete(tmp_path, monkeypatch):
    Snapshot.take(_path(tmp_path, "s1"), {"model": _state()}, fingerprint=True)
    refs_dir = tmp_path / "s1" / "refs"
    refs_dir.mkdir()
    (refs_dir / "inc_deadbeef_0").write_text(json.dumps({"path": "rel:s_inflight"}))
    with pytest.raises(RuntimeError, match="referenced by"):
        Snapshot(_path(tmp_path, "s1")).delete()
    monkeypatch.setenv("TPUSNAPSHOT_SWEEP_MIN_AGE_S", "0")
    with pytest.raises(RuntimeError, match="referenced by"):
        Snapshot(_path(tmp_path, "s1")).delete()
    monkeypatch.setenv("TPUSNAPSHOT_REFS_MIN_AGE_S", "0")
    Snapshot(_path(tmp_path, "s1")).delete()


def test_base_without_fingerprints_degrades_to_full_write(tmp_path):
    app = {"model": _state()}
    s1 = Snapshot.take(_path(tmp_path, "s1"), app, fingerprint=False)
    s2 = Snapshot.take(_path(tmp_path, "s2"), app, base=s1)
    assert s2.get_manifest()["0/model/w"].base is None
    assert _count_payload_files(_path(tmp_path, "s2")) == 2
    Snapshot.take(_path(tmp_path, "s3"), app, base=s2)
    assert _count_payload_files(_path(tmp_path, "s3")) == 0


def test_async_take_with_base(tmp_path):
    app = {"model": _state()}
    s1 = Snapshot.take(_path(tmp_path, "s1"), app, fingerprint=True)
    app["model"]["b"] = app["model"]["b"] + 5.0
    s2 = Snapshot.async_take(_path(tmp_path, "s2"), app, base=s1).wait()
    assert _count_payload_files(_path(tmp_path, "s2")) == 1
    fresh = _fresh()
    s2.restore(fresh)
    assert np.array_equal(fresh["model"]["b"], app["model"]["b"])


def test_moved_family_rel_refs(tmp_path):
    src = tmp_path / "ckpts"
    src.mkdir()
    app = {"model": _state()}
    s1 = Snapshot.take(str(src / "s1"), app, fingerprint=True)
    Snapshot.take(str(src / "s2"), app, base=s1)
    shutil.move(str(src), str(tmp_path / "archive"))
    fresh = _fresh()
    Snapshot(str(tmp_path / "archive" / "s2")).restore(fresh)
    assert torch.equal(fresh["model"]["w"], app["model"]["w"])


def test_read_object_through_refs(tmp_path):
    app = {"model": _state()}
    s1 = Snapshot.take(_path(tmp_path, "s1"), app, fingerprint=True)
    Snapshot.take(_path(tmp_path, "s2"), app, base=s1)
    assert torch.equal(Snapshot(_path(tmp_path, "s2")).read_object("model/w"), app["model"]["w"])


def test_base_unreadable_raises(tmp_path):
    with pytest.raises(ValueError, match="unreadable"):
        Snapshot.take(_path(tmp_path, "s2"), {"model": _state()}, base=_path(tmp_path, "nonexistent"))


@pytest.mark.parametrize("spelling", ["same", "fs", "dotdot", "slash"])
def test_base_equals_path_raises_however_spelled(tmp_path, spelling):
    path = _path(tmp_path, "s1")
    base = {
        "same": path,
        "fs": "fs://" + path,
        "dotdot": str(tmp_path / "x" / ".." / "s1"),
        "slash": path + "/",
    }[spelling]
    with pytest.raises(ValueError, match="NEW path"):
        Snapshot.take(path, {"model": _state()}, base=base)


def test_fingerprint_env_knob(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUSNAPSHOT_FINGERPRINT", "1")
    s1 = Snapshot.take(_path(tmp_path, "s1"), {"model": _state()})
    assert s1.get_manifest()["0/model/w"].fingerprint.startswith("xs128:")


def test_fingerprints_off_by_default(tmp_path):
    s1 = Snapshot.take(_path(tmp_path, "s1"), {"model": _state()})
    assert s1.get_manifest()["0/model/w"].fingerprint is None


def test_object_entries_not_deduped(tmp_path):
    app = {"model": StateDict(w=torch.arange(16, dtype=torch.float32), cfg={"tags": {"adam", "fp32"}})}
    s1 = Snapshot.take(_path(tmp_path, "s1"), app, fingerprint=True)
    s2 = Snapshot.take(_path(tmp_path, "s2"), app, base=s1)
    m = s2.get_manifest()
    assert m["0/model/w"].base is not None
    assert getattr(m["0/model/cfg/tags"], "base", None) is None
    fresh = {"model": StateDict(w=torch.zeros(16), cfg={"tags": set()})}
    s2.restore(fresh)
    assert fresh["model"]["cfg"]["tags"] == {"adam", "fp32"}


def test_dtype_or_shape_change_degrades_to_full_write(tmp_path):
    app = {"model": StateDict(w=torch.arange(64, dtype=torch.float32))}
    s1 = Snapshot.take(_path(tmp_path, "s1"), app, fingerprint=True)
    app["model"]["w"] = torch.arange(64).to(torch.bfloat16)
    s2 = Snapshot.take(_path(tmp_path, "s2"), app, base=s1)
    assert s2.get_manifest()["0/model/w"].base is None
    app["model"]["w"] = torch.arange(128).to(torch.bfloat16)
    s3 = Snapshot.take(_path(tmp_path, "s3"), app, base=s2)
    assert s3.get_manifest()["0/model/w"].base is None


def test_fingerprint_false_with_base_still_dedups_without_recording(tmp_path):
    app = {"model": _state()}
    s1 = Snapshot.take(_path(tmp_path, "s1"), app, fingerprint=True)
    s2 = Snapshot.take(_path(tmp_path, "s2"), app, base=s1, fingerprint=False)
    m = s2.get_manifest()
    assert m["0/model/w"].base is not None and m["0/model/w"].fingerprint is None
    assert _count_payload_files(_path(tmp_path, "s2")) == 0


def test_decorated_handle_cache_reused_as_base(tmp_path):
    app = {"model": _state()}
    s1 = Snapshot.take(_path(tmp_path, "s1"), app, fingerprint=True)
    s2 = Snapshot(_path(tmp_path, "s2"))
    Snapshot.take(s2.path, app, base=s1)
    s2.restore(_fresh())  # the cache is now the decorated metadata
    assert s2._metadata is not None
    s3 = Snapshot.take(_path(tmp_path, "s3"), app, base=s2)
    meta3 = Snapshot(s3.path)._read_metadata(Snapshot(s3.path)._open_storage())
    for key in ("0/model/w", "0/model/b"):
        e = meta3.manifest[key]
        assert e.location.count("@base") == 1
        assert meta3.base_paths[e.base] == "rel:s1"
    fresh = _fresh()
    s3.restore(fresh)
    assert torch.equal(fresh["model"]["w"], app["model"]["w"])


def test_take_handle_serves_as_base_without_a_metadata_read(tmp_path, monkeypatch):
    from torchsnapshot_tpu_torch import snapshot as snapshot_mod

    app = {"model": _state()}
    s1 = Snapshot.take(_path(tmp_path, "s1"), app, fingerprint=True)

    def refuse(url):
        raise AssertionError(f"read the base metadata at {url}")

    monkeypatch.setattr(snapshot_mod, "_aread_metadata_at", refuse)
    s2 = Snapshot.take(_path(tmp_path, "s2"), app, base=s1)
    assert _count_payload_files(s2.path) == 0


def test_backlink_markers_idempotent_across_takes(tmp_path):
    app = {"model": _state()}
    s1 = Snapshot.take(_path(tmp_path, "s1"), app, fingerprint=True)
    Snapshot.take(_path(tmp_path, "s2"), app, base=s1)
    Snapshot.take(_path(tmp_path, "s3"), app, base=s1)
    assert len(os.listdir(tmp_path / "s1" / "refs")) == 2


def _mgr_state(head):
    return {"model": StateDict(backbone=torch.full((4096,), 7.0), head=torch.full((64,), head))}


def test_manager_incremental_end_to_end(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2, incremental=True)
    for step in range(1, 5):
        mgr.save(step, _mgr_state(float(step)))
    # Step 1 wrote the frozen backbone every later step borrows: deferred.
    assert mgr.all_steps() == [1, 3, 4]
    assert _count_payload_files(str(tmp_path / "step-4")) == 1
    fresh = _mgr_state(0.0)
    assert mgr.restore(fresh) == 4
    assert torch.all(fresh["model"]["head"] == 4.0) and torch.all(fresh["model"]["backbone"] == 7.0)


def test_manager_full_period_unpins_bases(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2, incremental=True, full_period=2)
    for step in range(1, 6):
        mgr.save(step, _mgr_state(float(step)))
    assert mgr.all_steps() == [4, 5]
    assert Snapshot(str(tmp_path / "step-5")).get_manifest()["0/model/backbone"].base is not None
    fresh = _mgr_state(0.0)
    assert mgr.restore(fresh) == 5
    assert torch.all(fresh["model"]["head"] == 5.0)
    with pytest.raises(ValueError, match="requires incremental"):
        CheckpointManager(str(tmp_path), full_period=2)


def test_manager_incremental_world2(tmp_path, caplog):
    root = str(tmp_path)

    def run(coord, rank):
        mgr = CheckpointManager(root, incremental=True, coord=coord)
        for step in (1, 2):
            mgr.save(
                step,
                {"model": StateDict(w=torch.full((256,), float(step)), frozen=torch.full((512,), 3.0))},
                replicated=["**"],
            )

    with caplog.at_level(logging.WARNING):
        run_thread_ranks(2, run)
    assert not [r for r in caplog.records if "but rank 0" in r.message]
    m = Snapshot(f"{root}/step-2").get_manifest()
    assert m["0/model/frozen"].base is not None and m["0/model/w"].base is None


def test_manager_async_incremental(tmp_path):
    mgr = CheckpointManager(str(tmp_path), incremental=True)
    mgr.save(1, _mgr_state(1.0))
    assert mgr.async_save(2, _mgr_state(2.0)).wait() is not None
    assert mgr.all_steps() == [1, 2]
    assert _count_payload_files(str(tmp_path / "step-2")) == 1
    fresh = _mgr_state(0.0)
    assert mgr.restore(fresh) == 2
    assert torch.all(fresh["model"]["head"] == 2.0)


def test_restore_verify_device_passes_and_catches_corruption(tmp_path):
    app = {"model": _state()}
    s1 = Snapshot.take(_path(tmp_path, "s1"), app, fingerprint=True)
    fresh = _fresh()
    s1.restore(fresh, verify_device=True)
    assert torch.equal(fresh["model"]["w"], app["model"]["w"])
    assert snapshot_mod._last_verify_stats == {"verified": 2, "skipped": 0}
    meta = s1._read_metadata(s1._open_storage())
    meta.manifest["0/model/w"].fingerprint = "xs128:" + "f" * 32
    with pytest.raises(RuntimeError, match="model/w"):
        s1.restore(fresh, verify_device=True)


def test_restore_verify_device_skips_unfingerprinted(tmp_path):
    app = {"model": _state()}
    s1 = Snapshot.take(_path(tmp_path, "s1"), app)
    fresh = _fresh()
    s1.restore(fresh, verify_device=True)
    assert torch.equal(fresh["model"]["w"], app["model"]["w"])
    assert snapshot_mod._last_verify_stats == {"verified": 0, "skipped": 2}


def test_incremental_across_compression_change(tmp_path):
    app = {"model": StateDict(w=torch.arange(4096, dtype=torch.float32))}
    s1 = Snapshot.take(_path(tmp_path, "s1"), app, compression="zlib", fingerprint=True)
    s2 = Snapshot.take(_path(tmp_path, "s2"), app, base=s1)
    m2 = s2.get_manifest()
    assert m2["0/model/w"].base is not None and m2["0/model/w"].compression == "zlib"
    fresh = {"model": StateDict(w=torch.zeros(4096))}
    s2.restore(fresh, verify_device=True)
    assert torch.equal(fresh["model"]["w"], app["model"]["w"])
    s3 = Snapshot.take(_path(tmp_path, "s3"), app, base=s2, compression="zlib")
    assert s3.get_manifest()["0/model/w"].base is not None


def test_incremental_bfloat16_leaves(tmp_path):
    app = {"model": StateDict(w=torch.randn(64, 64).to(torch.bfloat16))}
    s1 = Snapshot.take(_path(tmp_path, "s1"), app, fingerprint=True)
    s2 = Snapshot.take(_path(tmp_path, "s2"), app, base=s1)
    assert s2.get_manifest()["0/model/w"].base is not None
    fresh = {"model": StateDict(w=torch.zeros(64, 64, dtype=torch.bfloat16))}
    s2.restore(fresh, verify_device=True)
    assert torch.equal(fresh["model"]["w"].view(torch.int16), app["model"]["w"].view(torch.int16))


def test_rng_state_flows_through_incremental(tmp_path):
    torch.manual_seed(3)
    app = {"rng": RNGState(), "model": _state()}
    s1 = Snapshot.take(_path(tmp_path, "s1"), app, fingerprint=True)
    s2 = Snapshot.take(_path(tmp_path, "s2"), app, base=s1)
    expected = torch.rand(1)
    torch.manual_seed(99)
    s2.restore({"rng": RNGState(), "model": _state(seed=5)})
    assert torch.equal(torch.rand(1), expected)


def test_complex_leaf_degrades_to_unfingerprinted_full_write(tmp_path):
    app = {"model": StateDict(z=torch.ones(8, dtype=torch.complex64), w=torch.ones(8))}
    s1 = Snapshot.take(_path(tmp_path, "s1"), app, fingerprint=True)
    m = s1.get_manifest()
    assert m["0/model/z"].fingerprint is None and m["0/model/w"].fingerprint is not None
    s2 = Snapshot.take(_path(tmp_path, "s2"), app, base=s1)
    assert s2.get_manifest()["0/model/z"].base is None
    assert s2.get_manifest()["0/model/w"].base is not None


# ---- Across packages.


def _jax_app(w, b):
    return {"model": jsnap.StateDict(w=w, b=b, step=7)}


def test_jax_chain_restores_through_port(tmp_path):
    w, b = _w(0), _w(1, 32)
    s1 = jsnap.Snapshot.take(_path(tmp_path, "s1"), _jax_app(w, b), fingerprint=True)
    w2 = w.copy()
    w2[:10] += 1
    s2 = jsnap.Snapshot.take(_path(tmp_path, "s2"), _jax_app(w2, b), base=s1)
    jsnap.Snapshot.take(_path(tmp_path, "s3"), _jax_app(w2, b), base=s2)
    fresh = _fresh()
    Snapshot(_path(tmp_path, "s3")).restore(fresh, verify_device=True)
    assert np.array_equal(fresh["model"]["w"].numpy(), w2)
    assert np.array_equal(fresh["model"]["b"], b)
    # The port dedups against the JAX chain: nothing new to write.
    Snapshot.take(_path(tmp_path, "p4"), fresh, base=_path(tmp_path, "s3"))
    assert _count_payload_files(_path(tmp_path, "p4")) == 0


def test_port_chain_restores_through_jax(tmp_path):
    app = {"model": _state()}
    s1 = Snapshot.take(_path(tmp_path, "s1"), app, fingerprint=True)
    app["model"]["w"][:10] += 1
    s2 = Snapshot.take(_path(tmp_path, "s2"), app, base=s1)
    Snapshot.take(_path(tmp_path, "s3"), app, base=s2)
    target = jsnap.StateDict(w=np.zeros(1024, np.float32), b=np.zeros(32, np.float32), step=0)
    jsnap.Snapshot(_path(tmp_path, "s3")).restore({"model": target}, verify_device=True)
    assert np.array_equal(target["w"], app["model"]["w"].numpy())
    assert jsnap.Snapshot(_path(tmp_path, "s3")).verify() == {}


@pytest.mark.parametrize("direction", ["port-on-jax", "jax-on-port"])
def test_take_on_a_base_of_the_other_package_writes_no_arrays(tmp_path, direction):
    w, b = _w(0), _w(1, 32)
    if direction == "port-on-jax":
        jsnap.Snapshot.take(_path(tmp_path, "s1"), _jax_app(w, b), fingerprint=True)
        Snapshot.take(
            _path(tmp_path, "s2"),
            {"model": StateDict(w=torch.from_numpy(w.copy()), b=b.copy(), step=7)},
            base=_path(tmp_path, "s1"),
        )
        fresh = {"model": jsnap.StateDict(w=np.zeros(1024, np.float32), b=np.zeros(32, np.float32), step=0)}
        jsnap.Snapshot(_path(tmp_path, "s2")).restore(fresh)
        assert np.array_equal(fresh["model"]["w"], w)
    else:
        Snapshot.take(
            _path(tmp_path, "s1"),
            {"model": StateDict(w=torch.from_numpy(w.copy()), b=b.copy(), step=7)},
            fingerprint=True,
        )
        jsnap.Snapshot.take(_path(tmp_path, "s2"), _jax_app(w, b), base=_path(tmp_path, "s1"))
        fresh = _fresh()
        Snapshot(_path(tmp_path, "s2")).restore(fresh)
        assert np.array_equal(fresh["model"]["w"].numpy(), w)
    assert _count_payload_files(_path(tmp_path, "s2")) == 0
    with pytest.raises(RuntimeError, match="referenced by"):
        Snapshot(_path(tmp_path, "s1")).delete()


def test_out_of_range_base_index_degrades_to_a_full_write(tmp_path, caplog):
    app = {"model": _state()}
    s1 = Snapshot.take(_path(tmp_path, "s1"), app, fingerprint=True)
    s2 = Snapshot.take(_path(tmp_path, "s2"), app, base=s1)
    # Corrupt s2's metadata: w borrows from a base index it lacks.
    meta_path = tmp_path / "s2" / ".snapshot_metadata"
    doc = json.loads(meta_path.read_text())
    assert doc["base_paths"] == ["rel:s1"] and doc["manifest"]["0/model/w"]["base"] == 0
    doc["manifest"]["0/model/w"]["base"] = 5
    meta_path.write_text(json.dumps(doc))
    with caplog.at_level(logging.WARNING):
        s3 = Snapshot.take(_path(tmp_path, "s3"), app, base=_path(tmp_path, "s2"))
    m = s3.get_manifest()
    # b flattens to s1 (index 1 of s3's base_paths); w is written.
    assert m["0/model/w"].base is None and m["0/model/b"].base == 1
    assert _count_payload_files(_path(tmp_path, "s3")) == 1
    assert any("writing the leaf in full" in r.message for r in caplog.records)
    fresh = _fresh()
    s3.restore(fresh)
    assert torch.equal(fresh["model"]["w"], app["model"]["w"])
    assert np.array_equal(fresh["model"]["b"], app["model"]["b"])
    # The JAX package aborts the take on the same base.
    with pytest.raises(KeyError):
        jsnap.Snapshot.take(
            _path(tmp_path, "j3"),
            _jax_app(app["model"]["w"].numpy(), app["model"]["b"]),
            base=_path(tmp_path, "s2"),
        )
