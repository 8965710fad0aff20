"""``Snapshot.verify()`` of the port, the verify cases of
tests/test_integrity.py, held against the JAX package: for the same
snapshot (taken by either package) with the same damage, both packages'
``verify()`` return the same ``{location: problem}`` dict. Covers plain,
replicated-stripe, sharded (mesh-sharded and chunked dense), compressed
and content-chunked snapshots, streamed large objects, length-only
probes and a backend whose ranged reads past the end raise 416."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torchsnapshot_tpu as jsnap
import torchsnapshot_tpu.snapshot as jsnapshot_mod
from torchsnapshot_tpu.io_types import is_range_not_satisfiable_error as jax_is_416
from torchsnapshot_tpu.utils.test_utils import run_thread_ranks as jax_thread_ranks
from torchsnapshot_tpu_torch import Snapshot, StateDict, io_preparer
from torchsnapshot_tpu_torch import snapshot as snapshot_mod
from torchsnapshot_tpu_torch.io_types import RetryingStoragePlugin, is_range_not_satisfiable_error
from torchsnapshot_tpu_torch.manifest import ArrayEntry, SnapshotMetadata
from torchsnapshot_tpu_torch.serialization import StreamingCrc32, compute_checksum
from torchsnapshot_tpu_torch.utils.test_utils import run_thread_ranks

WRITERS = ["port", "jax"]


def _verify_both(path):
    """Both packages' verify() of ``path``, which must be equal."""
    got, ref = Snapshot(path).verify(), jsnap.Snapshot(path).verify()
    assert got == ref
    return got


def _take(writer, path, arrays, **kwargs):
    """Take ``{"s": arrays}`` (numpy arrays and plain values) with
    ``writer``'s package, arrays as its own tensors."""
    if writer == "port":
        conv = {k: torch.from_numpy(v.copy()) if isinstance(v, np.ndarray) else v for k, v in arrays.items()}
        return Snapshot.take(path, {"s": StateDict(**conv)}, **kwargs)
    conv = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in arrays.items()}
    return jsnap.Snapshot.take(path, {"s": jsnap.StateDict(**conv)}, **kwargs)


def _flip(path, index=7):
    data = bytearray(open(path, "rb").read())
    data[index] ^= 0xFF
    open(path, "wb").write(bytes(data))


@pytest.mark.parametrize("writer", WRITERS)
def test_verify_scrubs_payloads(tmp_path, writer):
    """Clean → {}; a flipped byte → a checksum problem; a truncated object
    → a size problem; a removed object → unreadable."""
    path = str(tmp_path / "snap")
    rng = np.random.default_rng(0)
    _take(writer, path, {"a": rng.standard_normal(64).astype(np.float32),
                         "b": np.arange(32, dtype=np.int16), "note": "hello"})
    assert _verify_both(path) == {}
    a_path = os.path.join(path, "0", "s", "a")
    _flip(a_path)
    problems = _verify_both(path)
    assert list(problems) == ["0/s/a"] and "Checksum mismatch" in problems["0/s/a"]
    b_path = os.path.join(path, "0", "s", "b")
    open(b_path, "wb").write(open(b_path, "rb").read()[:10])
    assert "size mismatch" in _verify_both(path)["0/s/b"]
    os.remove(a_path)
    assert "unreadable" in _verify_both(path)["0/s/a"]


@pytest.mark.parametrize("writer", WRITERS)
def test_verify_covers_sharded_and_compressed(tmp_path, writer, monkeypatch):
    """A sharded value (mesh-sharded by JAX; chunked dense by the port:
    512-byte objects) stored compressed: clean, then one shard object
    corrupt, named alone by both packages."""
    arr = np.random.default_rng(1).standard_normal((64, 8)).astype(np.float32)
    path = str(tmp_path / "snap")
    if writer == "jax":
        mesh = Mesh(np.array(jax.devices()), ("x",))
        value = jax.device_put(jnp.asarray(arr), NamedSharding(mesh, P("x", None)))
        jsnap.Snapshot.take(path, {"s": jsnap.StateDict(w=value)}, compression="zlib")
    else:
        monkeypatch.setattr(io_preparer, "MAX_CHUNK_SIZE_BYTES", 512)
        Snapshot.take(path, {"s": StateDict(w=torch.from_numpy(arr))}, compression="zlib")
    assert _verify_both(path) == {}
    shards = sorted(p for d in ("sharded", "chunked") for p in (tmp_path / "snap" / d).rglob("*")
                    if p.is_file())
    assert len(shards) >= 4
    _flip(str(shards[2]), index=3)
    problems = _verify_both(path)
    assert list(problems) == [os.path.relpath(shards[2], path)]


@pytest.mark.parametrize("writer", WRITERS)
def test_verify_uses_owner_checksums_of_a_world_2_replicated_take(tmp_path, writer):
    """Replicated values of a world-2 take: each object is checked once,
    against its owner's checksum."""
    path = str(tmp_path / "snap")
    rng = np.random.default_rng(2)
    arrays = {f"w{i}": rng.standard_normal(32 + i).astype(np.float32) for i in range(4)}
    launch = run_thread_ranks if writer == "port" else jax_thread_ranks
    launch(2, lambda c, r: _take(writer, path, arrays, coord=c, replicated=["**"]))
    assert _verify_both(path) == {}
    for i in range(4):
        _flip(os.path.join(path, "replicated", "s", f"w{i}"), index=i)
    problems = _verify_both(path)
    assert sorted(problems) == [f"replicated/s/w{i}" for i in range(4)]
    assert all("Checksum mismatch" in v for v in problems.values())


def _write_metadata(path, manifest, world_size=1):
    md = SnapshotMetadata(version="0.4.0", world_size=world_size, manifest=manifest)
    (path / ".snapshot_metadata").write_text(md.to_yaml())


def _entry(location, shape, checksum, replicated=False):
    return ArrayEntry(location=location, serializer="raw", dtype="float32", shape=shape,
                      replicated=replicated, checksum=checksum)


def test_verify_uses_owner_checksum_for_replicated_stripes(tmp_path):
    """The non-owner's checksum-less mirror appears first; the owner's
    checksum is the one used."""
    payload = np.arange(16, dtype=np.float32).tobytes()
    path = tmp_path / "snap"
    (path / "replicated" / "s").mkdir(parents=True)
    (path / "replicated" / "s" / "w").write_bytes(payload)
    _write_metadata(path, {
        "0/s/w": _entry("replicated/s/w", [16], None, True),
        "1/s/w": _entry("replicated/s/w", [16], compute_checksum(payload), True),
    }, world_size=2)
    assert _verify_both(str(path)) == {}
    corrupted = bytearray(payload)
    corrupted[5] ^= 0xFF
    (path / "replicated" / "s" / "w").write_bytes(bytes(corrupted))
    assert "Checksum mismatch" in _verify_both(str(path)).get("replicated/s/w", "")


@pytest.fixture
def small_scrub_chunk(monkeypatch):
    monkeypatch.setattr(snapshot_mod, "_VERIFY_SCRUB_CHUNK_BYTES", 64)
    monkeypatch.setattr(jsnapshot_mod, "_VERIFY_SCRUB_CHUNK_BYTES", 64)


@pytest.mark.parametrize("writer", WRITERS)
def test_verify_streams_large_objects(tmp_path, writer, small_scrub_chunk):
    """Above the scrub chunk (64 bytes here) an object streams through a
    running crc32: mid-stream corruption, truncation and trailing bytes
    are caught alike."""
    path = str(tmp_path / "snap")
    _take(writer, path, {"a": np.arange(256, dtype=np.float32)})
    assert _verify_both(path) == {}
    a_path = os.path.join(path, "0", "s", "a")
    payload = open(a_path, "rb").read()
    _flip(a_path, index=200)
    assert "Checksum mismatch" in _verify_both(path)["0/s/a"]
    open(a_path, "wb").write(payload[:300])
    assert "size mismatch" in _verify_both(path)["0/s/a"]
    open(a_path, "wb").write(payload + b"xx")
    assert "size mismatch" in _verify_both(path)["0/s/a"]
    crc = StreamingCrc32()
    for i in range(0, len(payload), 100):
        crc.update(payload[i:i + 100])
    assert crc.tag() == compute_checksum(payload)


def test_verify_length_only_probes_for_unchecksummed_large_objects(tmp_path, small_scrub_chunk):
    """A large object without a crc32 (none, or an unknown algorithm) gets
    the two length probes: the last byte and one past the end."""
    payload = np.arange(256, dtype=np.float32).tobytes()
    path = tmp_path / "snap"
    (path / "0" / "s").mkdir(parents=True)
    obj = path / "0" / "s" / "w"
    obj.write_bytes(payload)
    for tag in (None, "xxh3:abcdef"):
        _write_metadata(path, {"0/s/w": _entry("0/s/w", [256], tag)})
        assert _verify_both(str(path)) == {}
        obj.write_bytes(payload[:-4])
        assert "shorter" in _verify_both(str(path))["0/s/w"]
        obj.write_bytes(payload + b"z")
        assert "longer" in _verify_both(str(path))["0/s/w"]
        obj.write_bytes(payload)


class _Range416(Exception):
    """Shaped like google.api_core's RequestRangeNotSatisfiable: a 416
    ``code`` beside an ``errors`` attribute."""

    def __init__(self):
        super().__init__("416 requested range not satisfiable")
        self.code = 416
        self.errors = ()


class _RangeStrict416Storage:
    """A read-only backend with GCS/S3 range semantics: a ranged read
    starting at or past the end raises 416 (a file returns b"")."""

    max_read_concurrency = 4
    max_write_concurrency = 4

    def __init__(self, base):
        self.base = base
        self.read_attempts = {}

    async def read(self, io_req):
        self.read_attempts[io_req.path] = self.read_attempts.get(io_req.path, 0) + 1
        data = (self.base / io_req.path).read_bytes()
        if io_req.byte_range is not None:
            start, end = io_req.byte_range
            if start >= len(data):
                raise _Range416()
            data = data[start:end]
        io_req.data = data

    async def write(self, io_req):
        raise NotImplementedError

    async def delete(self, path):
        raise NotImplementedError

    async def list_prefix(self, prefix):
        return None

    async def object_age_s(self, path):
        return None

    async def object_size_bytes(self, path):
        return None

    def ensure_durable(self):
        pass

    def close(self):
        pass


def test_verify_past_eof_probe_on_range_erroring_backend(tmp_path, monkeypatch, small_scrub_chunk):
    """On a backend that raises 416 past the end, the probe of a healthy
    object reads as a clean end, a 416 on the last byte as "shorter",
    and no 416 is retried, in both packages."""
    payload = np.arange(256, dtype=np.float32).tobytes()
    base = tmp_path / "snap"
    (base / "0" / "s").mkdir(parents=True)
    obj = base / "0" / "s" / "w"
    obj.write_bytes(payload)
    _write_metadata(base, {"0/s/w": _entry("0/s/w", [256], None)})
    backend = _RangeStrict416Storage(base)
    monkeypatch.setattr(snapshot_mod, "url_to_storage_plugin", lambda url: RetryingStoragePlugin(backend))
    from torchsnapshot_tpu.io_types import RetryingStoragePlugin as JaxRetrying

    monkeypatch.setattr(jsnapshot_mod, "url_to_storage_plugin", lambda url: JaxRetrying(backend))

    def attempts_of(pkg):
        backend.read_attempts.clear()
        problems = pkg(str(base)).verify()
        return problems, backend.read_attempts.get("0/s/w")

    assert attempts_of(Snapshot) == attempts_of(jsnap.Snapshot) == ({}, 2)
    obj.write_bytes(payload[: len(payload) // 2])
    problems, attempts = attempts_of(Snapshot)
    assert "shorter" in problems["0/s/w"] and attempts == 1
    assert attempts_of(jsnap.Snapshot) == (problems, 1)
    obj.write_bytes(payload + b"zz")
    assert "longer" in _verify_both(str(base))["0/s/w"]
    # The streamed scrub: a truncation at a chunk boundary is a 416 on
    # the next chunk, the same "size mismatch" as an empty read.
    _write_metadata(base, {"0/s/w": _entry("0/s/w", [256], compute_checksum(payload))})
    obj.write_bytes(payload[:64])
    assert "size mismatch" in _verify_both(str(base))["0/s/w"]
    obj.write_bytes(payload)
    assert _verify_both(str(base)) == {}


def test_range_not_satisfiable_classifier():
    class RequestRangeNotSatisfiable(Exception):  # google.api_core's name
        code = 416

    class BotoClientError(Exception):
        def __init__(self):
            self.response = {"Error": {"Code": "InvalidRange"},
                             "ResponseMetadata": {"HTTPStatusCode": 416}}

    class GrpcStatusLookalike(Exception):  # a bare overloaded code
        code = 416

    class HttpShapedCode(Exception):  # google.api_core carries .errors
        code = 416
        errors = ()

    GrpcStatusLookalike.__module__ = HttpShapedCode.__module__ = "some.rpc.lib"
    cases = [
        (RequestRangeNotSatisfiable(), True),
        (BotoClientError(), True),
        (RuntimeError("proxy error: 416 Range Not Satisfiable"), False),
        (FileNotFoundError("x"), False),
        (GrpcStatusLookalike(), False),
        (HttpShapedCode(), True),
    ]
    for exc, expected in cases:
        assert is_range_not_satisfiable_error(exc) is expected is jax_is_416(exc), exc


@pytest.fixture
def chunk_env(monkeypatch):
    monkeypatch.setenv("TPUSNAPSHOT_SWEEP_MIN_AGE_S", "0")
    monkeypatch.setenv("TPUSNAPSHOT_REFS_MIN_AGE_S", "0")
    monkeypatch.setenv("TPUSNAPSHOT_CHUNK_BYTES", "4096")
    monkeypatch.setenv("TPUSNAPSHOT_CHUNK_MIN_BYTES", "0")


@pytest.mark.parametrize("codec", [None, "zlib"])
@pytest.mark.parametrize("writer", WRITERS)
def test_verify_scrubs_content_chunks(tmp_path, writer, codec, chunk_env):
    """A chunked snapshot: every chunk object decoded and fingerprinted;
    a flipped byte in one names that chunk alone, and a removed one reads
    as unreadable."""
    path = str(tmp_path / "run" / "step-1")
    arr = np.random.default_rng(3).standard_normal((64, 64)).astype(np.float32)
    _take(writer, path, {"w": arr, "b": np.arange(8, dtype=np.float32)}, chunks=True, codec=codec)
    assert _verify_both(path) == {}
    objects = sorted(p for p in (tmp_path / "run" / ".chunkstore" / "objects").rglob("*") if p.is_file())
    assert len(objects) >= 4
    _flip(str(objects[1]), index=len(objects[1].read_bytes()) // 2)
    problems = _verify_both(path)
    assert len(problems) == 1 and next(iter(problems)).endswith(objects[1].name)
    os.remove(objects[2])
    problems = _verify_both(path)
    assert len(problems) == 2 and any("unreadable" in v for v in problems.values())
