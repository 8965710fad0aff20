"""The port's memory:// plugin serves ranged reads as views of the stored
object: a read-only ``memoryview`` that shares its memory, keeps the old
bytes alive when the key is overwritten or deleted, and is counted under
``tpusnapshot_storage_read_view_bytes_total``. Restores through those views
(streamed splits, sub-range assembly, chunk-stored objects), ``read_object``
and the verify scrub are bit-exact, and no restored value shares memory
with a stored object.
"""

import asyncio
import json
import uuid

import numpy as np
import pytest
import torch

from torchsnapshot_tpu_torch import Snapshot, StateDict, telemetry, tracing
from torchsnapshot_tpu_torch import io_preparer as iop
from torchsnapshot_tpu_torch import snapshot as psnap
from torchsnapshot_tpu_torch import staging_pool
from torchsnapshot_tpu_torch.io_types import IOReq
from torchsnapshot_tpu_torch.storage_plugin import _MEMORY_STORES
from torchsnapshot_tpu_torch.storage_plugins.memory import MemoryStoragePlugin
from torchsnapshot_tpu_torch.telemetry import metrics as _metric_names

THRESHOLD = 64 << 10


def _counted():
    """Bytes of memory:// ranged reads served as views so far."""
    return telemetry.counter(_metric_names.STORAGE_READ_VIEW_BYTES, backend="memory").value


def _moved(before):
    return _counted() - before


def _read(plugin, path, byte_range=None):
    io_req = IOReq(path=path, byte_range=byte_range)
    asyncio.run(plugin.read(io_req))
    return io_req.data


def _write(plugin, path, payload):
    asyncio.run(plugin.write(IOReq(path=path, data=payload)))


def _extent(buf):
    """(address, nbytes) of a buffer's memory."""
    a = np.frombuffer(buf, dtype=np.uint8)
    return a.ctypes.data, a.nbytes


# ------------------------------------------------------------------ plugin


@pytest.mark.parametrize("start,end", [(100, 3000), (0, 16384), (16000, 16384)])
def test_ranged_read_is_a_read_only_view_inside_the_stored_object(start, end):
    plugin = MemoryStoragePlugin()
    payload = bytes(range(256)) * 64
    _write(plugin, "obj", payload)
    stored = plugin.store["obj"]
    before = _counted()
    got = _read(plugin, "obj", (start, end))
    # Even a range over the whole object is a view, not the object.
    assert isinstance(got, memoryview) and got.readonly
    assert bytes(got) == payload[start:end]
    base, n = _extent(stored)
    addr, m = _extent(got)
    assert (addr, m) == (base + start, end - start) and addr + m <= base + n
    with pytest.raises(TypeError):
        got[0] = 0
    assert _moved(before) == end - start


def test_whole_read_returns_the_stored_object_uncounted():
    plugin = MemoryStoragePlugin()
    _write(plugin, "obj", b"0123456789")
    before = _counted()
    assert _read(plugin, "obj") is plugin.store["obj"]
    assert _moved(before) == 0


def test_ranged_read_past_the_end_is_short_or_empty():
    plugin = MemoryStoragePlugin()
    _write(plugin, "obj", b"0123456789")
    assert bytes(_read(plugin, "obj", (8, 12))) == b"89"
    assert len(_read(plugin, "obj", (10, 11))) == 0


@pytest.mark.parametrize("op", ["overwrite", "delete"])
def test_a_held_view_keeps_the_old_bytes(op):
    plugin = MemoryStoragePlugin()
    _write(plugin, "obj", b"old bytes, all of them")
    view = _read(plugin, "obj", (0, 9))
    if op == "overwrite":
        _write(plugin, "obj", b"NEW BYTES, ALL OF THEM")
        assert bytes(_read(plugin, "obj", (0, 9))) == b"NEW BYTES"
    else:
        asyncio.run(plugin.delete("obj"))
        assert "obj" not in plugin.store
    assert bytes(view) == b"old bytes"


# ----------------------------------------------------------------- restores


def _arr(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


# At 256 KiB chunks and a 64 KiB read threshold: "streamed" is 4 chunks
# of 4 streamed sub-reads, "columns" is cut along dim 1 (each chunk read
# in sub-ranges assembled in a pooled buffer), "ints" two streamed chunks,
# "small" one whole read.
_ARRAYS = {
    "streamed": _arr(1 << 18, seed=1),
    "columns": _arr((256, 1024), seed=2),
    "ints": np.arange(70000, dtype=np.int32),
    "small": _arr((3, 5), seed=3),
}
_RANGED_BYTES = sum(v.nbytes for k, v in _ARRAYS.items() if k != "small")


@pytest.fixture
def memory_root(monkeypatch):
    monkeypatch.setattr(iop, "MAX_CHUNK_SIZE_BYTES", 256 << 10)
    monkeypatch.setenv("TPUSNAPSHOT_PARALLEL_READ_THRESHOLD", str(THRESHOLD))
    monkeypatch.setattr(psnap, "_VERIFY_SCRUB_CHUNK_BYTES", THRESHOLD)
    staging_pool.reset_staging_pool()
    bucket = f"memory-plugin-{uuid.uuid4().hex}"
    yield bucket
    _MEMORY_STORES.pop(bucket, None)
    staging_pool.reset_staging_pool()


def _assert_no_alias(bucket, values):
    stored = [_extent(obj) for obj in _MEMORY_STORES[bucket].values() if len(obj)]
    for name, value in values.items():
        if isinstance(value, torch.Tensor):
            lo, n = value.data_ptr(), value.numel() * value.element_size()
        else:
            lo, n = value.ctypes.data, value.nbytes
        for base, m in stored:
            assert lo + n <= base or base + m <= lo, f"{name} shares memory with a stored object"


@pytest.mark.parametrize("path", ["restore", "chunks", "read_object", "verify"])
def test_restore_from_memory_through_views(memory_root, monkeypatch, path):
    root = f"memory://{memory_root}/run/step-1"
    chunks = path == "chunks"
    if chunks:
        # Content chunks of whole leaves (the store leaves array chunks
        # of a sharded entry as they are).
        monkeypatch.setattr(iop, "MAX_CHUNK_SIZE_BYTES", 64 << 20)
        monkeypatch.setenv("TPUSNAPSHOT_CHUNK_BYTES", str(32 << 10))
        monkeypatch.setenv("TPUSNAPSHOT_CHUNK_MIN_BYTES", "0")
    state = StateDict(**{k: torch.from_numpy(v.copy()) for k, v in _ARRAYS.items()})
    Snapshot.take(root, {"m": state}, chunks=chunks)
    before = _counted()
    if path == "verify":
        assert Snapshot(root).verify() == {}
        # Every object above the scrub chunk streams through ranged reads.
        assert _moved(before) >= _ARRAYS["streamed"].nbytes
        return
    if path == "read_object":
        got = {
            "tensor": Snapshot(root).read_object("m/streamed"),
            "array": Snapshot(root).read_object("m/columns", template=np.zeros_like(_ARRAYS["columns"])),
        }
        assert np.array_equal(got["tensor"].numpy(), _ARRAYS["streamed"])
        assert isinstance(got["array"], np.ndarray) and np.array_equal(got["array"], _ARRAYS["columns"])
        assert _moved(before) == _ARRAYS["streamed"].nbytes + _ARRAYS["columns"].nbytes
        _assert_no_alias(memory_root, got)
        return
    target = StateDict(**{k: torch.zeros_like(torch.from_numpy(v)) for k, v in _ARRAYS.items()})
    Snapshot(root).restore({"m": target})
    for k, v in _ARRAYS.items():
        assert target[k].numpy().tobytes() == v.tobytes(), k
    _assert_no_alias(memory_root, dict(target.items()))
    assert psnap._last_restore_report["scheduler"]["streamed_bytes"] > 0
    # Chunk-stored objects are read whole, never ranged.
    assert _moved(before) == (0 if chunks else _RANGED_BYTES)
    assert staging_pool.get_staging_pool().stats()["in_use_bytes"] == 0


def test_read_spans_say_whether_the_payload_is_a_view(memory_root, tmp_path):
    root = f"memory://{memory_root}/run/step-1"
    arrays = {"streamed": _ARRAYS["streamed"], "small": _ARRAYS["small"]}
    Snapshot.take(root, {"m": StateDict(**{k: torch.from_numpy(v.copy()) for k, v in arrays.items()})})
    target = StateDict(**{k: torch.zeros_like(torch.from_numpy(v)) for k, v in arrays.items()})
    tracing.enable(str(tmp_path / "trace.json"))
    try:
        Snapshot(root).restore({"m": target})
        trace = tracing.flush()
    finally:
        tracing.disable()
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    ends = [e for e in events if e.get("name") == "read" and e.get("ph") == "e"]
    views = [e["args"]["view"] for e in ends]
    # 16 streamed sub-reads of the 1 MiB leaf; the small leaf, the
    # manifest and the telemetry records are whole reads.
    assert views.count(True) == 16 and False in views
