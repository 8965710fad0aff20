"""The port's GCS and S3 plugins against in-memory fake clients (no
network, no SDK), the cases of tests/test_cloud_plugins.py: key layout,
ranged reads (both services' ends are inclusive), BytesIO and bytes
writes, delete, listing, GCS's parallel composite upload and its faults,
and snapshots end to end. Snapshots written by the port to a fake bucket
restore through the JAX package's plugin over the same store, and the
other way round. Also the routing of ``gs://``, ``s3://``, ``snapserve://``
and entry-point plugins."""

import asyncio
import io
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jsnap
from torch_cloud_fakes import FakeGCSClient, FakeNotFound, FakeNoSuchKey, FakeS3Client, route_to_fakes
from torchsnapshot_tpu_torch import Snapshot, StateDict
from torchsnapshot_tpu_torch import storage_plugin as sp_mod
from torchsnapshot_tpu_torch.io_types import IOReq, RetryingStoragePlugin, io_payload, is_not_found_error
from torchsnapshot_tpu_torch.storage_plugins.gcs import GCSStoragePlugin
from torchsnapshot_tpu_torch.storage_plugins.s3 import S3StoragePlugin


def _write(plugin, path, payload=None, buf=None):
    io_req = IOReq(path=path, data=payload) if buf is None else IOReq(path=path, buf=buf)
    asyncio.run(plugin.write(io_req))


def _read(plugin, path, byte_range=None):
    io_req = IOReq(path=path, byte_range=byte_range)
    asyncio.run(plugin.read(io_req))
    return bytes(io_payload(io_req))


def test_gcs_roundtrip_and_key_layout():
    client = FakeGCSClient()
    plugin = GCSStoragePlugin(root="bucket/run/step-5", client=client)
    payload = bytes(range(256))
    _write(plugin, "0/model/w", payload)
    assert client.store["run/step-5/0/model/w"] == payload
    assert _read(plugin, "0/model/w") == payload
    plugin.close()


def test_gcs_ranged_read_end_exclusive_to_inclusive():
    plugin = GCSStoragePlugin(root="b/p", client=FakeGCSClient())
    payload = bytes(range(100))
    _write(plugin, "obj", payload)
    assert _read(plugin, "obj", byte_range=(10, 20)) == payload[10:20]
    assert _read(plugin, "obj", byte_range=(0, 1)) == payload[0:1]
    plugin.close()


def test_gcs_bytesio_write_and_delete():
    client = FakeGCSClient()
    plugin = GCSStoragePlugin(root="b/p", client=client)
    _write(plugin, "x", buf=io.BytesIO(b"hello"))
    assert _read(plugin, "x") == b"hello"
    asyncio.run(plugin.delete("x"))
    assert client.store == {}
    plugin.close()


def test_gcs_root_validation():
    with pytest.raises(ValueError, match="bucket/path"):
        GCSStoragePlugin(root="nobucketpath", client=FakeGCSClient())


def test_s3_roundtrip_and_key_layout():
    client = FakeS3Client()
    plugin = S3StoragePlugin(root="bucket/run/step-5", client=client)
    payload = bytes(range(256))
    _write(plugin, "0/model/w", payload)
    assert client.store[("bucket", "run/step-5/0/model/w")] == payload
    assert _read(plugin, "0/model/w") == payload
    plugin.close()


def test_s3_ranged_read_header_semantics():
    plugin = S3StoragePlugin(root="b/p", client=FakeS3Client())
    payload = bytes(range(100))
    _write(plugin, "obj", payload)
    assert _read(plugin, "obj", byte_range=(10, 20)) == payload[10:20]
    plugin.close()


def test_s3_delete_and_root_validation():
    client = FakeS3Client()
    plugin = S3StoragePlugin(root="b/p", client=client)
    _write(plugin, "x", b"1")
    asyncio.run(plugin.delete("x"))
    assert client.store == {}
    plugin.close()
    with pytest.raises(ValueError, match="bucket/path"):
        S3StoragePlugin(root="nobucket", client=FakeS3Client())


def test_s3_sizes_and_not_found():
    client = FakeS3Client()
    plugin = S3StoragePlugin(root="b/p", client=client)
    _write(plugin, "x", b"12345")
    assert asyncio.run(plugin.object_size_bytes("x")) == 5
    assert asyncio.run(plugin.object_size_bytes("missing")) is None
    assert asyncio.run(plugin.object_age_s("missing")) is None
    with pytest.raises(FakeNoSuchKey) as e:
        _read(plugin, "missing")
    assert is_not_found_error(e.value)
    plugin.close()


def test_s3_without_client_or_sdk_raises_actionably(monkeypatch):
    monkeypatch.setitem(sys.modules, "aiobotocore", None)
    monkeypatch.setitem(sys.modules, "aiobotocore.session", None)
    monkeypatch.setitem(sys.modules, "boto3", None)
    with pytest.raises(RuntimeError, match="aiobotocore or boto3"):
        S3StoragePlugin(root="b/p")


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_snapshot_end_to_end_on_fake_gcs(monkeypatch, writer):
    """A take through one package's GCS plugin restores through both,
    over the same fake bucket, routed by ``gs://``."""
    route_to_fakes(monkeypatch, gcs=FakeGCSClient())
    _end_to_end("gs://bucket/snap", writer)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_snapshot_end_to_end_on_fake_s3(monkeypatch, writer):
    route_to_fakes(monkeypatch, s3=FakeS3Client())
    _end_to_end("s3://bucket/snap", writer)


def _end_to_end(url, writer):
    w = np.random.default_rng(0).standard_normal(4096).astype(np.float32)
    if writer == "port":
        Snapshot.take(url, {"m": StateDict(w=torch.from_numpy(w.copy()), step=3)})
    else:
        jsnap.Snapshot.take(url, {"m": jsnap.StateDict(w=jnp.asarray(w), step=3)})
    target = StateDict(w=torch.zeros(4096), step=0)
    Snapshot(url).restore({"m": target})
    assert target["w"].numpy().tobytes() == w.tobytes() and target["step"] == 3
    jtarget = jsnap.StateDict(w=jnp.zeros(4096, jnp.float32), step=0)
    jsnap.Snapshot(url).restore({"m": jtarget})
    assert np.asarray(jtarget["w"]).tobytes() == w.tobytes()
    assert Snapshot(url).verify() == {}
    assert Snapshot(url).read_object("m/w").numpy().tobytes() == w.tobytes()


def test_gcs_parallel_composite_upload(monkeypatch):
    """A large object uploads as concurrent nonce-named parts and one
    compose; the parts are removed; the object reads back exactly."""
    monkeypatch.setenv("TPUSNAPSHOT_GCS_PARALLEL_UPLOAD_BYTES", str(1 << 10))
    client = FakeGCSClient()
    plugin = GCSStoragePlugin("bucket/prefix", client=client)
    payload = bytes(range(256)) * 64  # 16 KiB: 16 parts of 1 KiB
    asyncio.run(plugin.write(IOReq(path="sharded/big_chunk", data=payload)))
    assert client.store["prefix/sharded/big_chunk"] == payload
    assert [k for k in client.store if ".part" in k] == []
    assert _read(plugin, "sharded/big_chunk") == payload
    assert _read(plugin, "sharded/big_chunk", byte_range=(100, 300)) == payload[100:300]
    assert asyncio.run(plugin.object_size_bytes("sharded/big_chunk")) == len(payload)
    plugin.close()


def test_gcs_small_write_stays_single_object(monkeypatch):
    monkeypatch.setenv("TPUSNAPSHOT_GCS_PARALLEL_UPLOAD_BYTES", str(1 << 20))
    client = FakeGCSClient()
    plugin = GCSStoragePlugin("bucket/prefix", client=client)
    asyncio.run(plugin.write(IOReq(path="small", data=b"abc")))
    assert client.store == {"prefix/small": b"abc"}
    plugin.close()


def test_gcs_compose_respects_32_component_cap(monkeypatch):
    """100 times the threshold still composes in one call: the parts grow
    instead of exceeding GCS's 32 components."""
    monkeypatch.setenv("TPUSNAPSHOT_GCS_PARALLEL_UPLOAD_BYTES", str(64))
    client = FakeGCSClient()
    plugin = GCSStoragePlugin("bucket/p", client=client)
    payload = b"z" * (64 * 100)
    asyncio.run(plugin.write(IOReq(path="huge", data=payload)))
    assert client.store["p/huge"] == payload
    plugin.close()


def test_gcs_list_prefix():
    client = FakeGCSClient()
    plugin = GCSStoragePlugin("bucket/prefix", client=client)
    for key in ("a/b", "a/c", "d"):
        _write(plugin, key, b"x")
    assert sorted(asyncio.run(plugin.list_prefix("a/"))) == ["a/b", "a/c"]
    assert sorted(asyncio.run(plugin.list_prefix(""))) == ["a/b", "a/c", "d"]
    plugin.close()


def test_s3_list_prefix():
    client = FakeS3Client()
    plugin = S3StoragePlugin("bucket/prefix", client=client)
    for key in ("a/b", "a/c", "d"):
        _write(plugin, key, b"x")
    assert sorted(asyncio.run(plugin.list_prefix("a/"))) == ["a/b", "a/c"]
    plugin.close()


def test_gcs_part_upload_failure_cleans_parts_and_surfaces(monkeypatch):
    """A part failing mid-composite surfaces, every uploaded part is
    removed and nothing lands at the destination key."""
    monkeypatch.setenv("TPUSNAPSHOT_GCS_PARALLEL_UPLOAD_BYTES", str(1 << 10))
    client = FakeGCSClient()

    def fail_part3(key):
        if ".part3." in key:
            raise RuntimeError("injected: part 3 upload failed")

    client.hooks["on_upload"] = fail_part3
    plugin = GCSStoragePlugin("bucket/p", client=client)
    with pytest.raises(RuntimeError, match="part 3"):
        asyncio.run(plugin.write(IOReq(path="big", data=bytes(range(256)) * 32)))
    assert [k for k in client.store if ".part" in k] == []
    assert "p/big" not in client.store
    plugin.close()


def test_gcs_compose_failure_cleans_parts_and_surfaces(monkeypatch):
    monkeypatch.setenv("TPUSNAPSHOT_GCS_PARALLEL_UPLOAD_BYTES", str(1 << 10))
    client = FakeGCSClient()

    def fail_compose(key):
        raise RuntimeError("injected: compose failed")

    client.hooks["on_compose"] = fail_compose
    plugin = GCSStoragePlugin("bucket/p", client=client)
    with pytest.raises(RuntimeError, match="compose failed"):
        asyncio.run(plugin.write(IOReq(path="big", data=b"x" * (4 << 10))))
    assert [k for k in client.store if ".part" in k] == []
    assert "p/big" not in client.store
    plugin.close()


def test_gcs_transient_part_failure_retried_whole_object(monkeypatch):
    """The retry layer re-runs the whole composite write after a part's
    transient failure; the second attempt is exact and leaves no part."""
    monkeypatch.setenv("TPUSNAPSHOT_GCS_PARALLEL_UPLOAD_BYTES", str(1 << 10))
    monkeypatch.setenv("TPUSNAPSHOT_STORAGE_RETRIES", "2")
    monkeypatch.setenv("TPUSNAPSHOT_STORAGE_RETRY_CAP_S", "0.01")
    client = FakeGCSClient()
    fails = {"n": 0}

    def fail_once(key):
        if ".part1." in key and fails["n"] == 0:
            fails["n"] += 1
            raise ConnectionError("injected: transient 503")

    client.hooks["on_upload"] = fail_once
    plugin = RetryingStoragePlugin(GCSStoragePlugin("bucket/p", client=client))
    payload = bytes(range(256)) * 16
    asyncio.run(plugin.write(IOReq(path="big", data=payload)))
    assert client.store["p/big"] == payload
    assert [k for k in client.store if ".part" in k] == [] and fails["n"] == 1
    plugin.close()


def test_gcs_composed_size_mismatch_detected(monkeypatch):
    """A composed object whose size is not the payload's (a part
    truncated by an interfering writer) raises at the write."""
    monkeypatch.setenv("TPUSNAPSHOT_GCS_PARALLEL_UPLOAD_BYTES", str(1 << 10))
    client = FakeGCSClient()

    def corrupt_compose(key):
        for k in list(client.store):
            if ".part2." in k:
                client.store[k] = client.store[k][:-7]

    client.hooks["on_compose"] = corrupt_compose
    plugin = GCSStoragePlugin("bucket/p", client=client)
    with pytest.raises(RuntimeError, match="composed object is"):
        asyncio.run(plugin.write(IOReq(path="big", data=b"y" * (4 << 10))))
    assert [k for k in client.store if ".part" in k] == []
    plugin.close()


def test_gcs_crashed_upload_parts_removed_by_sweep(monkeypatch):
    """Parts a crashed process left under the prefix go with
    ``delete(sweep=True)``."""
    client = FakeGCSClient()
    route_to_fakes(monkeypatch, gcs=client)
    Snapshot.take("gs://bucket/snap", {"m": StateDict(w=torch.arange(64.0))})
    client.store["snap/sharded/chunk.part0.deadbeef0123"] = b"orphan"
    client.store["snap/sharded/chunk.part1.deadbeef0123"] = b"orphan"
    Snapshot("gs://bucket/snap").delete(sweep=True)
    assert client.store == {}


def test_gcs_not_found_is_classified_and_sized_as_missing():
    plugin = GCSStoragePlugin("bucket/p", client=FakeGCSClient())
    with pytest.raises(FakeNotFound) as e:
        _read(plugin, "missing")
    assert is_not_found_error(e.value)
    assert asyncio.run(plugin.object_size_bytes("missing")) is None
    assert asyncio.run(plugin.object_age_s("missing")) is None
    plugin.close()


def test_url_dispatch(tmp_path, monkeypatch):
    """gs:// and s3:// open the port's plugins (each behind the retry
    layer); snapserve:// opens the read plane's client over its embedded
    backend URL, as in the JAX package; an unknown protocol is
    unsupported."""
    from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin
    from torchsnapshot_tpu_torch.storage_plugins.memory import MemoryStoragePlugin

    route_to_fakes(monkeypatch, gcs=FakeGCSClient(), s3=FakeS3Client())
    for url, backend in ((str(tmp_path), FSStoragePlugin), (f"fs://{tmp_path}", FSStoragePlugin),
                         ("memory://x", MemoryStoragePlugin), ("gs://b/p", GCSStoragePlugin),
                         ("s3://b/p", S3StoragePlugin)):
        plugin = sp_mod.url_to_storage_plugin(url)
        assert isinstance(plugin, RetryingStoragePlugin) and isinstance(plugin._inner, backend)
        plugin.close()
    from torchsnapshot_tpu.snapserve.client import SnapServePlugin as JaxSnapServePlugin
    from torchsnapshot_tpu_torch.snapserve.client import SnapServePlugin

    plugin = sp_mod.url_to_storage_plugin("snapserve://localhost:1/gs://b/p")
    assert isinstance(plugin, RetryingStoragePlugin) and isinstance(plugin._inner, SnapServePlugin)
    jplugin = JaxSnapServePlugin("localhost:1/gs://b/p")
    assert (plugin._inner._addrs, plugin._inner._backend_url) == (jplugin._addrs, jplugin._backend_url)
    plugin.close()
    jplugin.close()
    with pytest.raises(RuntimeError, match="Unsupported protocol"):
        sp_mod.url_to_storage_plugin("bogus://x")


class _EntryPoints:
    def __init__(self, *eps):
        self._eps = eps

    def select(self, group):
        return list(self._eps) if group == "storage_plugins" else []


def test_entry_point_plugin_resolves(monkeypatch):
    from torchsnapshot_tpu_torch.storage_plugins.memory import MemoryStoragePlugin

    class EP:
        name = "myplug"

        def load(self):
            return lambda path: MemoryStoragePlugin(store={}, prefix=path)

    monkeypatch.setattr(sp_mod.importlib_metadata, "entry_points", lambda: _EntryPoints(EP()))
    plugin = sp_mod.url_to_storage_plugin("myplug://bucket/run")
    assert isinstance(plugin._inner, MemoryStoragePlugin) and plugin._inner.prefix == "bucket/run/"


def test_installed_plugin_load_error_propagates(monkeypatch):
    """An installed entry point whose load raises surfaces that error,
    not "Unsupported protocol"."""

    class BrokenEP:
        name = "myplug"

        def load(self):
            raise ImportError("myplug needs google-cloud-storage")

    monkeypatch.setattr(sp_mod.importlib_metadata, "entry_points", lambda: _EntryPoints(BrokenEP()))
    with pytest.raises(ImportError, match="google-cloud-storage"):
        sp_mod.url_to_storage_plugin("myplug://bucket")
