"""The port's content-chunk store: the cases of tests/test_chunkstore.py
without telemetry or doctor (verify and copy_to held against the JAX
package on the same snapshots; its snapserve keying cases, served by a
server of either package), the fault-free
cases of tests/test_chunkstore_gc.py, and stores shared between the port
and the JAX package in both directions (equal bytes, equal keys)."""

import glob
import json
import os
import uuid

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torchsnapshot_tpu as jsnap
from torchsnapshot_tpu import chunkstore as jchunkstore
from torchsnapshot_tpu import codecs as jcodecs
from torchsnapshot_tpu_torch import CheckpointManager, Snapshot, StateDict, chunkstore, codecs
from torchsnapshot_tpu_torch import snapshot as snapshot_mod
from torchsnapshot_tpu_torch.manifest import ArrayEntry


@pytest.fixture(autouse=True)
def _chunk_env(monkeypatch):
    # No age guards; 4 KiB chunks so small payloads split; no leaf floor.
    monkeypatch.setenv("TPUSNAPSHOT_SWEEP_MIN_AGE_S", "0")
    monkeypatch.setenv("TPUSNAPSHOT_REFS_MIN_AGE_S", "0")
    monkeypatch.setenv("TPUSNAPSHOT_CHUNK_BYTES", "4096")
    monkeypatch.setenv("TPUSNAPSHOT_CHUNK_MIN_BYTES", "0")


def _arrays(seed=0, emb_rows=256):
    rng = np.random.RandomState(seed)
    return {
        "w": rng.randn(64, 64).astype(np.float32),
        "emb": rng.randn(emb_rows, 32).astype(np.float32),
    }


def _state(seed=0):
    return {"m": StateDict(**{k: torch.from_numpy(v) for k, v in _arrays(seed).items()})}


def _zeros_like(state):
    return {"m": StateDict(**{k: torch.zeros_like(v) for k, v in state["m"].items()})}


def _store_objects(root):
    return sorted(glob.glob(f"{root}/.chunkstore/objects/*/*"))


def _keys(root):
    return {p.rsplit("/", 1)[-1] for p in _store_objects(root)}


def _assert_restores(snapshot, expected):
    t = _zeros_like(expected)
    snapshot.restore(t)
    for k, v in expected["m"].items():
        assert torch.equal(t["m"][k], v), k


def _chunk_records(snapshot):
    return [r for e in snapshot.get_manifest().values() for r in (getattr(e, "chunks", None) or [])]


# ---- Dedup.


def test_unchanged_retake_stores_nothing_new(tmp_path):
    d = str(tmp_path)
    state = _state()
    s1 = Snapshot.take(f"{d}/step-1", state, chunks=True)
    n1 = len(_store_objects(d))
    assert n1 > 0
    s2 = Snapshot.take(f"{d}/step-2", state, chunks=True)
    assert len(_store_objects(d)) == n1
    assert snapshot_mod._last_take_stats["chunks"].chunk_misses == 0
    _assert_restores(s1, state)
    _assert_restores(s2, state)


def test_partially_dirty_leaf_stores_only_touched_chunks(tmp_path):
    d = str(tmp_path)
    state = _state()
    Snapshot.take(f"{d}/step-1", state, chunks=True)
    n1 = len(_store_objects(d))
    state["m"]["emb"][:32] += 1.0  # 32 rows × 32 × 4 B: one 4 KiB chunk
    s2 = Snapshot.take(f"{d}/step-2", state, chunks=True)
    assert len(_store_objects(d)) - n1 == 1
    _assert_restores(s2, state)


def test_identical_leaves_share_chunks_within_one_take(tmp_path):
    d = str(tmp_path)
    a = torch.from_numpy(np.random.RandomState(1).randn(64, 64).astype(np.float32))
    s = Snapshot.take(f"{d}/step-1", {"m": StateDict(x=a, y=a.clone())}, chunks=True)
    assert len(_store_objects(d)) == len({r["k"] for r in _chunk_records(s)}) == 4
    t = {"m": StateDict(x=torch.zeros(64, 64), y=torch.zeros(64, 64))}
    s.restore(t)
    assert torch.equal(t["m"]["x"], a) and torch.equal(t["m"]["y"], a)


def test_memory_backend_round_trip():
    root = f"memory://cstest-{uuid.uuid4().hex[:8]}/run"
    state = _state(3)
    Snapshot.take(f"{root}/step-1", state, chunks=True)
    s2 = Snapshot.take(f"{root}/step-2", state, chunks=True)
    assert snapshot_mod._last_take_stats["chunks"].chunk_misses == 0
    _assert_restores(Snapshot(f"{root}/step-2"), state)
    assert chunkstore.manifest_has_chunks(s2.get_manifest())


@pytest.fixture
def world1():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_dtensor_shards_chunk_and_restore(world1, tmp_path):
    from torch.distributed.tensor import DTensor, Shard

    from torchsnapshot_tpu_torch.parallel.mesh import make_mesh

    d = str(tmp_path)
    mesh = make_mesh({"tp": 1}, "cpu")
    w = torch.arange(4096, dtype=torch.float32).reshape(64, 64)
    state = {"m": StateDict(w=DTensor.from_local(w.clone(), mesh, [Shard(0)], run_check=False))}
    Snapshot.take(f"{d}/step-1", state, chunks=True)
    s2 = Snapshot.take(f"{d}/step-2", state, chunks=True)
    shard = s2.get_manifest()["0/m/w"].shards[0].array
    assert shard.chunks and shard.base is not None
    target = StateDict(w=DTensor.from_local(torch.zeros(64, 64), mesh, [Shard(1)], run_check=False))
    s2.restore({"m": target})
    assert torch.equal(target["w"].to_local(), w)
    # And into a plain tensor, with the JAX package too.
    assert torch.equal(s2.read_object("m/w"), w)
    jt = jsnap.StateDict(w=np.zeros((64, 64), np.float32))
    jsnap.Snapshot(f"{d}/step-2").restore({"m": jt})
    assert np.array_equal(jt["w"], w.numpy())


def test_async_take_chunks(tmp_path):
    d = str(tmp_path)
    state = _state(5)
    Snapshot.async_take(f"{d}/step-1", state, chunks=True).wait()
    n1 = len(_store_objects(d))
    s2 = Snapshot.async_take(f"{d}/step-2", state, chunks=True).wait()
    assert len(_store_objects(d)) == n1
    _assert_restores(s2, state)
    assert not glob.glob(f"{d}/.chunkstore/intents/*")
    # The ref document was written before the async commit.
    assert os.path.exists(f"{d}/.chunkstore/refs/{chunkstore.ref_doc_name(f'{d}/step-2')}")


def test_async_take_cut_holds_while_the_drain_runs(tmp_path):
    d = str(tmp_path)
    state = _state(6)
    want = {k: v.clone() for k, v in state["m"].items()}
    pending = Snapshot.async_take(f"{d}/step-1", state, chunks=True, stage="device")
    for v in state["m"].values():
        v.add_(1.0)
    s = pending.wait()
    t = _zeros_like(state)
    s.restore(t)
    for k, v in want.items():
        assert torch.equal(t["m"][k], v), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16", "int32", "uint8", "bool", "int8", "float64"])
def test_dtype_matrix_round_trip(tmp_path, dtype):
    d = str(tmp_path)
    rng = np.random.RandomState(22)
    if dtype == "bool":
        x = torch.from_numpy(rng.rand(96, 96) > 0.5)
    elif dtype in ("int32", "uint8", "int8"):
        x = torch.from_numpy(rng.randint(0, 100, (96, 96)).astype(dtype))
    else:
        x = torch.from_numpy(rng.randn(96, 96).astype(np.float32)).to(getattr(torch, dtype))
    state = {"m": StateDict(x=x)}
    Snapshot.take(f"{d}/step-1", state, chunks=True)
    n1 = len(_store_objects(d))
    s2 = Snapshot.take(f"{d}/step-2", state, chunks=True)
    assert len(_store_objects(d)) == n1, f"{dtype}: the retake stored chunks again"
    t = {"m": StateDict(x=torch.zeros_like(x))}
    s2.restore(t, verify_device=True)
    assert torch.equal(t["m"]["x"].view(torch.uint8), x.view(torch.uint8))
    # Every chunk verifies against its key (host twin of K5).
    for rec in _chunk_records(s2):
        p = f"{d}/.chunkstore/{chunkstore.chunk_object_path(rec['k'])}"
        chunkstore.decode_and_verify_chunk(rec, dtype, open(p, "rb").read())


def test_rootless_path_degrades_to_plain():
    root = f"memory://bare-{uuid.uuid4().hex[:8]}"
    state = _state(6)
    s = Snapshot.take(root, state, chunks=True)
    _assert_restores(s, state)
    assert not chunkstore.manifest_has_chunks(s.get_manifest())


def test_composes_with_leaf_incremental(tmp_path):
    d = str(tmp_path)
    state = _state(7)
    s1 = Snapshot.take(f"{d}/step-1", state, fingerprint=True)
    state["m"]["emb"][:32] += 1.0
    s2 = Snapshot.take(f"{d}/step-2", state, base=s1, chunks=True)
    manifest = s2.get_manifest()
    assert manifest["0/m/w"].base is not None and not manifest["0/m/w"].chunks
    assert manifest["0/m/emb"].chunks
    _assert_restores(Snapshot(f"{d}/step-2"), state)


def test_chunked_base_falls_through_to_chunk_dedup(tmp_path):
    d = str(tmp_path)
    state = _state(7)
    s1 = Snapshot.take(f"{d}/step-1", state, chunks=True)
    n1 = len(_store_objects(d))
    s2 = Snapshot.take(f"{d}/step-2", state, base=s1, chunks=True)
    assert len(_store_objects(d)) == n1
    assert s2.get_manifest()["0/m/w"].chunks
    _assert_restores(s2, state)


# ---- Codecs.


def test_lossless_codec_round_trip(tmp_path):
    d = str(tmp_path)
    state = _state(8)
    s = Snapshot.take(f"{d}/step-1", state, chunks=True, codec=codecs.best_lossless())
    _assert_restores(s, state)
    recs = _chunk_records(s)
    assert recs and all(r["c"] == codecs.best_lossless() for r in recs)


def test_int8_opt_in_only(tmp_path):
    d = str(tmp_path)
    rng = np.random.RandomState(9)
    state = {
        "m": StateDict(w=torch.from_numpy(rng.randn(64, 64).astype(np.float32))),
        "opt": StateDict(mu=torch.from_numpy(rng.randn(64, 64).astype(np.float32))),
    }
    s = Snapshot.take(f"{d}/step-1", state, chunks=True, codec={"opt/*": "int8", "*": "zlib"})
    t = {"m": StateDict(w=torch.zeros(64, 64)), "opt": StateDict(mu=torch.zeros(64, 64))}
    s.restore(t)
    assert torch.equal(t["m"]["w"], state["m"]["w"])
    err = float((t["opt"]["mu"] - state["opt"]["mu"]).abs().max())
    assert 0 < err <= codecs.quant_error_bound(state["opt"]["mu"].numpy())
    for path, e in s.get_manifest().items():
        for r in getattr(e, "chunks", None) or []:
            assert (r["c"] == "int8") == ("/opt/" in f"/{path}"), path


def test_int8_never_aliases_lossless_chunks(tmp_path):
    d = str(tmp_path)
    a = torch.from_numpy(np.random.RandomState(10).randn(64, 64).astype(np.float32))
    state = {"m": StateDict(w=a), "opt": StateDict(mu=a.clone())}
    s = Snapshot.take(f"{d}/step-1", state, chunks=True, codec={"opt/*": "int8"})
    t = {"m": StateDict(w=torch.zeros(64, 64)), "opt": StateDict(mu=torch.zeros(64, 64))}
    s.restore(t)
    assert torch.equal(t["m"]["w"], a)
    assert not torch.equal(t["opt"]["mu"], a)


def test_verify_device_skips_lossy_entries(tmp_path):
    d = str(tmp_path)
    mu = torch.from_numpy(np.random.RandomState(11).randn(64, 64).astype(np.float32))
    s = Snapshot.take(f"{d}/step-1", {"opt": StateDict(mu=mu)}, chunks=True, codec={"opt/*": "int8"}, fingerprint=True)
    s.restore({"opt": StateDict(mu=torch.zeros(64, 64))}, verify_device=True)


def test_non_finite_leaf_is_stored_unquantized(tmp_path):
    d = str(tmp_path)
    mu = torch.randn(64, 64)
    mu[3, 3] = float("inf")
    s = Snapshot.take(f"{d}/step-1", {"opt": StateDict(mu=mu)}, chunks=True, codec={"opt/*": "int8"})
    assert all(r["c"] is None for r in _chunk_records(s))
    t = {"opt": StateDict(mu=torch.zeros(64, 64))}
    s.restore(t)
    assert torch.equal(t["opt"]["mu"], mu)


def test_bad_codec_spec_leaves_no_store_debris(tmp_path):
    d = str(tmp_path)
    for codec in ("not-a-codec", "int8"):  # unknown; lossy without a glob
        with pytest.raises(ValueError):
            Snapshot.take(f"{d}/step-1", _state(24), chunks=True, codec=codec)
    assert not glob.glob(f"{d}/.chunkstore/intents/*")
    assert not glob.glob(f"{d}/.chunkstore/objects/*/*")


# ---- Integrity.


def test_corrupt_chunk_fails_the_restore_and_leaves_the_template(tmp_path):
    d = str(tmp_path)
    state = _state(12)
    s = Snapshot.take(f"{d}/step-1", state, chunks=True)
    victim = _store_objects(d)[0]
    raw = bytearray(open(victim, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(victim, "wb").write(bytes(raw))
    with pytest.raises(RuntimeError, match="corrupt"):
        _assert_restores(Snapshot(s.path), state)


def test_verify_detects_corrupt_chunk(tmp_path):
    """verify() names the one corrupt chunk object, as the JAX package's
    does on the same snapshot, and the restore fails."""
    d = str(tmp_path)
    state = _state(12)
    s = Snapshot.take(f"{d}/step-1", state, chunks=True)
    assert s.verify() == {}
    victim = _store_objects(d)[0]
    raw = bytearray(open(victim, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(victim, "wb").write(bytes(raw))
    problems = Snapshot(s.path).verify()
    assert problems == jsnap.Snapshot(s.path).verify()
    assert list(problems) == ["@base0/objects/" + victim.rsplit("/objects/", 1)[1]]
    with pytest.raises(RuntimeError):
        _assert_restores(Snapshot(s.path), state)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_copy_to_materializes_self_contained(tmp_path, writer):
    """A port copy of a chunked (zlib-coded) snapshot of either package
    holds plain objects, verifies clean, and restores through both
    packages after the whole source run, store included, is gone."""
    import shutil

    d = str(tmp_path)
    arrays = _arrays(13)
    if writer == "port":
        Snapshot.take(f"{d}/step-1", {"m": StateDict(**{k: torch.from_numpy(v.copy()) for k, v in arrays.items()})},
                      chunks=True, codec="zlib")
    else:
        jsnap.Snapshot.take(f"{d}/step-1", {"m": jsnap.StateDict(**arrays)}, chunks=True, codec="zlib")
    dest = f"{d}/copies/flat"
    c = Snapshot(f"{d}/step-1").copy_to(dest)
    assert not chunkstore.manifest_has_chunks(c.get_manifest())
    assert c.verify() == jsnap.Snapshot(dest).verify() == {}
    shutil.rmtree(f"{d}/.chunkstore")
    shutil.rmtree(f"{d}/step-1")
    _assert_restores(Snapshot(dest), {"m": StateDict(**{k: torch.from_numpy(v) for k, v in arrays.items()})})
    t = jsnap.StateDict(**{k: np.zeros_like(v) for k, v in arrays.items()})
    jsnap.Snapshot(dest).restore({"m": t})
    for k, v in arrays.items():
        assert np.asarray(t[k]).tobytes() == v.tobytes(), k


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_partial_restore_of_a_chunked_snapshot(tmp_path, writer):
    """restore(paths=) reads the selected leaf's chunks through the store
    and leaves the other leaf as it was, as the JAX package does."""
    d = str(tmp_path)
    arrays = _arrays(16)
    if writer == "port":
        Snapshot.take(f"{d}/step-1", {"m": StateDict(**{k: torch.from_numpy(v.copy()) for k, v in arrays.items()})},
                      chunks=True, fingerprint=True)
    else:
        jsnap.Snapshot.take(f"{d}/step-1", {"m": jsnap.StateDict(**arrays)}, chunks=True, fingerprint=True)
    t = {"m": StateDict(**{k: torch.full(v.shape, 2.0) for k, v in arrays.items()})}
    Snapshot(f"{d}/step-1").restore(t, paths=["m/emb"], verify_device=True)
    jt = jsnap.StateDict(**{k: np.full(v.shape, 2.0, np.float32) for k, v in arrays.items()})
    jsnap.Snapshot(f"{d}/step-1").restore({"m": jt}, paths=["m/emb"])
    assert t["m"]["emb"].numpy().tobytes() == np.asarray(jt["emb"]).tobytes() == arrays["emb"].tobytes()
    assert torch.equal(t["m"]["w"], torch.full((64, 64), 2.0)) and (np.asarray(jt["w"]) == 2.0).all()
    assert snapshot_mod._last_verify_stats == {"verified": 1, "skipped": 0}


def test_read_object_on_chunked_entry(tmp_path):
    d = str(tmp_path)
    state = _state(14)
    s = Snapshot.take(f"{d}/step-1", state, chunks=True)
    assert torch.equal(s.read_object("m/emb"), state["m"]["emb"])
    assert np.array_equal(Snapshot(s.path).read_object("m/emb", template=np.zeros((256, 32), np.float32)), state["m"]["emb"].numpy())


# ---- GC.


def test_delete_keeps_shared_frees_exclusive(tmp_path):
    d = str(tmp_path)
    state = _state(15)
    s1 = Snapshot.take(f"{d}/step-1", state, chunks=True)
    state["m"]["emb"][:32] += 1.0
    s2 = Snapshot.take(f"{d}/step-2", state, chunks=True)
    n_all = len(_store_objects(d))
    s1.delete()
    assert len(_store_objects(d)) == n_all - 1
    _assert_restores(Snapshot(s2.path), state)
    s2.delete()
    assert not _store_objects(d)
    assert not glob.glob(f"{d}/.chunkstore/refs/*")


def test_reconcile_reclaims_orphaned_chunks(tmp_path):
    d = str(tmp_path)
    state = _state(16)
    mgr = CheckpointManager(d, chunks=True)
    mgr.save(1, state)
    orphan = f"{d}/.chunkstore/objects/ff/xs128:{'f' * 32}-4096-raw"
    os.makedirs(os.path.dirname(orphan), exist_ok=True)
    open(orphan, "wb").write(b"\0" * 4096)
    stale_ref = f"{d}/.chunkstore/refs/deadbeefdeadbeef"
    open(stale_ref, "w").write(json.dumps({"path": "rel:step-99", "chunks": ["xs128:" + "f" * 32 + "-4096-raw"]}))
    stale_intent = f"{d}/.chunkstore/intents/feedface-r0"
    os.makedirs(os.path.dirname(stale_intent), exist_ok=True)
    open(stale_intent, "w").write("{}")
    mgr.reconcile()
    assert not os.path.exists(orphan) and not os.path.exists(stale_ref) and not os.path.exists(stale_intent)
    _assert_restores(Snapshot(f"{d}/step-1"), state)


def test_young_age_guard_defers_freeing(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUSNAPSHOT_SWEEP_MIN_AGE_S", "3600")
    d = str(tmp_path)
    mgr = CheckpointManager(d, chunks=True)
    mgr.save(1, _state(17))
    orphan = f"{d}/.chunkstore/objects/ff/xs128:{'f' * 32}-4096-raw"
    os.makedirs(os.path.dirname(orphan), exist_ok=True)
    open(orphan, "wb").write(b"\0" * 4096)
    mgr.reconcile()
    assert os.path.exists(orphan)


def test_gc_fails_closed_on_transient_metadata_error(tmp_path, monkeypatch):
    d = str(tmp_path)
    state = _state(25)
    s1 = Snapshot.take(f"{d}/step-1", state, chunks=True)
    s2 = Snapshot.take(f"{d}/step-2", state, chunks=True)
    n_before = len(_store_objects(d))

    async def boom(url):
        raise RuntimeError("injected transient metadata failure")

    monkeypatch.setattr(snapshot_mod, "_aread_metadata_at", boom)
    s1.delete()
    monkeypatch.undo()
    assert len(_store_objects(d)) == n_before
    _assert_restores(Snapshot(s2.path), state)
    chunkstore.reconcile_store(d)
    assert _keys(d) == chunkstore.chunk_keys_of(s2.get_manifest())


def test_retake_ref_overwrite_cannot_unprotect_committed(tmp_path):
    d = str(tmp_path)
    state = _state(26)
    Snapshot.take(f"{d}/step-1", state, chunks=True)
    s_target = Snapshot.take(f"{d}/step-2", state, chunks=True)
    old_keys = chunkstore.chunk_keys_of(s_target.get_manifest())
    ref = f"{d}/.chunkstore/refs/{chunkstore.ref_doc_name(f'{d}/step-2')}"
    open(ref, "w").write(json.dumps({"path": "rel:step-2", "chunks": ["xs128:" + "e" * 32 + "-4096-raw"]}))
    Snapshot(f"{d}/step-1").delete()
    chunkstore.reconcile_store(d)
    assert old_keys <= _keys(d)
    _assert_restores(Snapshot(f"{d}/step-2"), state)


def test_prune_via_manager_gc(tmp_path):
    d = str(tmp_path)
    state = _state(18)
    mgr = CheckpointManager(d, max_to_keep=2, chunks=True)
    for step in range(1, 5):
        state["m"]["emb"][: 32 * step % 224] += 0.5
        mgr.save(step, state)
    assert mgr.all_steps() == [3, 4]
    live = set()
    for step in (3, 4):
        live |= chunkstore.chunk_keys_of(Snapshot(f"{d}/step-{step}").get_manifest())
    assert _keys(d) == live
    _assert_restores(Snapshot(f"{d}/step-4"), state)


def _build_run(root):
    """Three takes, each sharing all but one chunk with the one before."""
    rng = np.random.RandomState(7)
    cur = rng.randn(256, 32).astype(np.float32)
    states = {}
    for step in (1, 2, 3):
        states[step] = cur.copy()
        Snapshot.take(f"{root}/step-{step}", {"m": StateDict(emb=torch.from_numpy(cur.copy()))}, chunks=True)
        cur = cur.copy()
        cur[step * 32 : step * 32 + 32] += 1.0
    return states


def test_delete_all_steps_empties_store(tmp_path):
    root = str(tmp_path)
    _build_run(root)
    for step in (1, 2, 3):
        Snapshot(f"{root}/step-{step}").delete()
    assert not _store_objects(root)
    assert not glob.glob(f"{root}/.chunkstore/refs/*")


def test_interrupted_delete_redriven_by_reconcile(tmp_path):
    root = str(tmp_path)
    states = _build_run(root)
    url = f"{root}/step-1"
    keys1 = chunkstore.chunk_keys_of(Snapshot(url).get_manifest())
    os.remove(f"{url}/.snapshot_metadata")
    os.remove(f"{root}/.chunkstore/refs/{chunkstore.ref_doc_name(url)}")
    chunkstore.reconcile_store(root)
    live = chunkstore.chunk_keys_of(Snapshot(f"{root}/step-2").get_manifest()) | chunkstore.chunk_keys_of(
        Snapshot(f"{root}/step-3").get_manifest()
    )
    assert _keys(root) == live and not (keys1 - live) & _keys(root)
    for step in (2, 3):
        t = {"m": StateDict(emb=torch.zeros(256, 32))}
        Snapshot(f"{root}/step-{step}").restore(t)
        assert np.array_equal(t["m"]["emb"].numpy(), states[step])


# ---- Across packages.


def test_equal_bytes_give_equal_chunk_keys():
    a = np.random.RandomState(30).randn(3000).astype(np.float32)
    elems, n = chunkstore._chunk_grid(a.size, 4, 4096)
    assert (elems, n) == jchunkstore._chunk_grid(a.size, 4, 4096)
    from torchsnapshot_tpu_torch.fingerprint import fingerprint_device_chunked_async, resolve_chunk_fingerprints

    fps = resolve_chunk_fingerprints([fingerprint_device_chunked_async(torch.from_numpy(a), elems * 4)])[0]
    assert [chunkstore.chunk_key(f, 4096, "zlib") for f in fps[:1]] == [
        jchunkstore.chunk_key(jsnap.fingerprint.fingerprint_host_chunked(a, elems * 4)[0], 4096, "zlib")
    ]


@pytest.mark.parametrize("direction", ["port-on-jax", "jax-on-port"])
def test_take_against_a_store_of_the_other_package_stores_no_new_chunk(tmp_path, direction):
    d = str(tmp_path)
    arrays = _arrays(31)
    jstate = {"m": jsnap.StateDict(**arrays)}
    pstate = {"m": StateDict(**{k: torch.from_numpy(v.copy()) for k, v in arrays.items()})}
    if direction == "port-on-jax":
        jsnap.Snapshot.take(f"{d}/step-1", jstate, chunks=True)
        n1 = len(_store_objects(d))
        Snapshot.take(f"{d}/step-2", pstate, chunks=True)
        assert snapshot_mod._last_take_stats["chunks"].chunk_misses == 0
    else:
        Snapshot.take(f"{d}/step-1", pstate, chunks=True)
        n1 = len(_store_objects(d))
        jsnap.Snapshot.take(f"{d}/step-2", jstate, chunks=True)
    assert len(_store_objects(d)) == n1 > 0
    a = {r["k"] for r in _chunk_records(Snapshot(f"{d}/step-1"))}
    b = {r["k"] for r in _chunk_records(Snapshot(f"{d}/step-2"))}
    assert a == b


@pytest.mark.parametrize("direction", ["jax->port", "port->jax"])
@pytest.mark.parametrize("codec", [None, "zlib"])
def test_chunked_snapshots_restore_across_packages(tmp_path, direction, codec):
    d = str(tmp_path)
    arrays = _arrays(32)
    if direction == "jax->port":
        jsnap.Snapshot.take(f"{d}/step-1", {"m": jsnap.StateDict(**arrays)}, chunks=True, codec=codec)
        t = {"m": StateDict(**{k: torch.zeros(v.shape) for k, v in arrays.items()})}
        Snapshot(f"{d}/step-1").restore(t)
        got = {k: v.numpy() for k, v in t["m"].items()}
    else:
        Snapshot.take(
            f"{d}/step-1", {"m": StateDict(**{k: torch.from_numpy(v.copy()) for k, v in arrays.items()})},
            chunks=True, codec=codec,
        )
        t = jsnap.StateDict(**{k: np.zeros_like(v) for k, v in arrays.items()})
        jsnap.Snapshot(f"{d}/step-1").restore({"m": t})
        assert jsnap.Snapshot(f"{d}/step-1").verify() == {}
        got = dict(t.items())
    for k, v in arrays.items():
        assert np.array_equal(got[k], v), k


def test_port_delete_keeps_chunks_a_jax_ref_lists(tmp_path):
    d = str(tmp_path)
    arrays = _arrays(33)
    Snapshot.take(f"{d}/step-1", {"m": StateDict(**{k: torch.from_numpy(v.copy()) for k, v in arrays.items()})}, chunks=True)
    changed = {k: v.copy() for k, v in arrays.items()}
    changed["emb"][:32] += 1.0
    jsnap.Snapshot.take(f"{d}/step-2", {"m": jsnap.StateDict(**changed)}, chunks=True)
    Snapshot(f"{d}/step-1").delete()
    assert _keys(d) == jchunkstore.chunk_keys_of(jsnap.Snapshot(f"{d}/step-2").get_manifest())
    assert jsnap.Snapshot(f"{d}/step-2").verify() == {}
    t = {"m": StateDict(**{k: torch.zeros(v.shape) for k, v in arrays.items()})}
    Snapshot(f"{d}/step-2").restore(t)
    assert np.array_equal(t["m"]["emb"].numpy(), changed["emb"])


def test_int8_frames_cross_packages(tmp_path):
    d = str(tmp_path)
    mu = np.random.RandomState(34).randn(64, 64).astype(np.float32)
    Snapshot.take(f"{d}/step-1", {"opt": StateDict(mu=torch.from_numpy(mu.copy()))}, chunks=True, codec={"opt/*": "int8"})
    t = jsnap.StateDict(mu=np.zeros_like(mu))
    jsnap.Snapshot(f"{d}/step-1").restore({"opt": t})
    assert 0 < np.abs(t["mu"] - mu).max() <= jcodecs.quant_error_bound(mu)
    ours = {"opt": StateDict(mu=torch.zeros(64, 64))}
    Snapshot(f"{d}/step-1").restore(ours)
    assert np.array_equal(ours["opt"]["mu"].numpy(), t["mu"])


def test_chunked_entry_is_array_entry_with_store_base(tmp_path):
    d = str(tmp_path)
    state = _state(35)
    s = Snapshot.take(f"{d}/step-1", state, chunks=True)
    e = s.get_manifest()["0/m/w"]
    assert isinstance(e, ArrayEntry) and e.checksum is None
    md = s._read_metadata(s._open_storage())
    assert md.base_paths[e.base] == "rel:.chunkstore"
    # A whole leaf's chunks stream to its private buffer as they verify.
    _assert_restores(Snapshot(s.path), state)
    streamed = snapshot_mod._last_restore_report["scheduler"]["streamed_bytes"]
    assert streamed == sum(v.numel() * 4 for v in state["m"].values())


# ---- Snapserve keying: chunk objects keyed by their content address.


class TestSnapserveKeying:
    def test_content_address_recognition(self):
        key = chunkstore.chunk_key("xs128:" + "ab" * 16, 4096, "zlib")
        path = chunkstore.chunk_object_path(key)
        assert chunkstore.content_address_of(path) == key
        assert chunkstore.content_address_of(f"@base1/{path}") == key
        assert chunkstore.content_address_of("0/model/w") is None
        assert chunkstore.content_address_of("objects/zz/not-a-key") is None
        for p in (path, f"@base1/{path}", "0/model/w", "objects/zz/not-a-key"):
            assert chunkstore.content_address_of(p) == jchunkstore.content_address_of(p)

    @pytest.mark.parametrize("server_pkg", ["port", "jax"])
    def test_retake_keeps_server_cache_warm(self, tmp_path, server_pkg):
        from torchsnapshot_tpu import snapserve as jsnapserve
        from torchsnapshot_tpu_torch import snapserve

        mod = snapserve if server_pkg == "port" else jsnapserve
        d = str(tmp_path)
        state = _state(21)
        Snapshot.take(f"{d}/step-1", state, chunks=True)
        service = mod.ReadService()
        server = mod.start_local_server(service=service)
        try:
            addr = f"snapserve://{server.addr}"
            _assert_restores(Snapshot(f"{addr}/{d}/step-1"), state)
            backend_before = service.stats()["backend_read_bytes"]
            # The server really served the first restore (a malformed
            # address would fall back to direct reads and prove nothing).
            assert backend_before > 0
            # Retake to a NEW path with the same content: the chunk
            # objects have content-addressed cache keys, so the second
            # restore is served almost entirely from cache.
            Snapshot.take(f"{d}/step-2", state, chunks=True)
            _assert_restores(Snapshot(f"{addr}/{d}/step-2"), state)
            backend_delta = service.stats()["backend_read_bytes"] - backend_before
            logical = sum(v.numel() * v.element_size() for v in state["m"].values())
            # Metadata and manifest fetches only: payload chunks hit.
            assert backend_delta < 0.2 * logical, (backend_delta, logical)
        finally:
            server.stop()
            mod.kill_local_servers()
            # The wire tap is process-wide: a later test's live rules must
            # not read this one's RPCs.
            from torchsnapshot_tpu import wiretap as jwiretap
            from torchsnapshot_tpu_torch import wiretap

            wiretap.reset()
            jwiretap.reset()
