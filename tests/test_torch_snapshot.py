"""The PyTorch port's take/restore, and snapshots crossing between the
port and the JAX package in both directions, bit for bit.

Arrays are made from a seed with numpy and handed to both packages;
payloads are compared as raw bytes (bfloat16 and float8 included)."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torchsnapshot_tpu as jsnap
from torchsnapshot_tpu.models import transformer as jtf
from torchsnapshot_tpu_torch import (
    DictStore,
    FileStore,
    NoOpCoordinator,
    RNGState,
    Snapshot,
    StateDict,
    get_coordinator,
    io_preparer,
)
from torchsnapshot_tpu_torch.manifest import ArrayEntry, ShardedArrayEntry, SnapshotMetadata
from torchsnapshot_tpu_torch.models import transformer as ttf
from torchsnapshot_tpu_torch.scheduler import available_memory_bytes
from torchsnapshot_tpu_torch.serialization import tensor_bytes

DTYPES = [
    "float32", "float64", "float16", "bfloat16", "float8_e4m3fn",
    "float8_e5m2", "int8", "int16", "int32", "int64", "uint8", "bool",
]
_ML_DTYPES = {"bfloat16": np.uint16, "float8_e4m3fn": np.uint8, "float8_e5m2": np.uint8}


def _np_array(name, shape, seed=0):
    rng = np.random.default_rng(seed)
    if name == "bool":
        return rng.integers(0, 2, shape).astype(bool)
    if name.startswith(("int", "uint")):
        info = np.iinfo(name)
        return rng.integers(info.min, info.max, shape, dtype=name, endpoint=True)
    if name in _ML_DTYPES:
        return rng.standard_normal(shape).astype(getattr(ml_dtypes, name))
    return rng.standard_normal(shape).astype(name)


def _to_torch(a):
    """A numpy array (ml_dtypes included) as a CPU tensor of the same bits."""
    name = a.dtype.name
    if name in _ML_DTYPES:
        bits = torch.from_numpy(np.array(a, copy=True).view(_ML_DTYPES[name]))
        return bits.view(getattr(torch, name))
    return torch.from_numpy(np.array(a, copy=True))


def _bytes(x):
    if isinstance(x, torch.Tensor):
        return tensor_bytes(x).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def _to_numpy(tree):
    """A JAX params pytree as numpy arrays, dict key order kept
    (``jax.tree.map`` would sort the keys)."""
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_numpy(v) for v in tree]
    return np.asarray(tree)


class _JaxState:
    def __init__(self, tree):
        self.tree = tree

    def state_dict(self):
        return self.tree

    def load_state_dict(self, sd):
        self.tree = sd


@pytest.mark.parametrize("direction", ["port->port", "port->jax", "jax->port"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_arrays_cross_packages_bit_exact(tmp_path, dtype, direction):
    src = {"w": _np_array(dtype, (7, 5), seed=1), "s": _np_array(dtype, (), seed=2)}
    path = str(tmp_path / "snap")
    if direction.startswith("port"):
        Snapshot.take(path, {"m": StateDict({k: _to_torch(v) for k, v in src.items()})})
    else:
        # 8-byte dtypes go in as numpy arrays: JAX keeps 64-bit values only
        # on the host (x64 is off).
        jsnap.Snapshot.take(
            path,
            {"m": jsnap.StateDict(
                {k: v if v.itemsize == 8 else jnp.asarray(v) for k, v in src.items()}
            )},
        )
    if direction.endswith("jax"):
        target = jsnap.StateDict({k: np.zeros_like(v) for k, v in src.items()})
        jsnap.Snapshot(path).restore({"m": target})
    else:
        target = StateDict({k: torch.zeros_like(_to_torch(v)) for k, v in src.items()})
        Snapshot(path).restore({"m": target})
    for k, v in src.items():
        assert _bytes(target[k]) == v.tobytes(), k
        if direction.endswith("port"):
            assert target[k].dtype == getattr(torch, dtype)


# ml_dtypes names the JAX package writes beyond DTYPES: three have a
# torch dtype of the same bytes; the others restore in the port as their
# raw bytes, uint8.
MORE_FLOAT8 = ["float8_e4m3fnuz", "float8_e5m2fnuz", "float8_e8m0fnu"]
RAW_BYTE_NAMES = ["int4", "uint4", "float4_e2m1fn", "float8_e4m3b11fnuz"]


def _ml_array(name, shape, seed):
    rng = np.random.default_rng(seed)
    dtype = getattr(ml_dtypes, name)
    if name in ("int4", "uint4"):
        info = ml_dtypes.iinfo(dtype)
        return rng.integers(int(info.min), int(info.max) + 1, shape).astype(dtype)
    if name == "float8_e8m0fnu":  # powers of two only
        return (2.0 ** rng.integers(-8, 8, shape)).astype(dtype)
    return rng.standard_normal(shape).astype(dtype)


@pytest.mark.parametrize("direction", ["port->jax", "jax->port"])
@pytest.mark.parametrize("name", MORE_FLOAT8)
def test_more_float8_names_cross_packages(tmp_path, name, direction):
    arr = _ml_array(name, (2, 3), seed=1)
    path = str(tmp_path / "snap")
    if direction == "port->jax":
        tensor = torch.from_numpy(arr.view(np.uint8).copy()).view(getattr(torch, name))
        Snapshot.take(path, {"m": StateDict(w=tensor)})
        target = jsnap.StateDict(w=np.zeros_like(arr))
        jsnap.Snapshot(path).restore({"m": target})
        assert np.asarray(target["w"]).dtype == arr.dtype
    else:
        jsnap.Snapshot.take(path, {"m": jsnap.StateDict(w=jnp.asarray(arr))})
        target = StateDict(w=torch.zeros(2, 3, dtype=getattr(torch, name)))
        Snapshot(path).restore({"m": target})
        assert target["w"].dtype == getattr(torch, name)
        assert _bytes(Snapshot(path).read_object("m/w")) == arr.tobytes()
    assert _bytes(target["w"]) == arr.tobytes()


@pytest.mark.parametrize("name", RAW_BYTE_NAMES)
def test_raw_byte_names_restore_as_uint8_and_cross_back(tmp_path, name):
    """A JAX snapshot of an array with no torch dtype restores in the port
    as its raw bytes (uint8, one element a byte, as ml_dtypes stores it);
    a port take of those bytes restores through JAX to the same values."""
    arr = _ml_array(name, (2, 3), seed=2)
    path, back = str(tmp_path / "snap"), str(tmp_path / "back")
    jsnap.Snapshot.take(path, {"m": jsnap.StateDict(w=jnp.asarray(arr))})
    target = StateDict(w=torch.zeros(2, 3, dtype=torch.uint8))
    Snapshot(path).restore({"m": target})
    raw = arr.view(np.uint8)
    assert target["w"].dtype == torch.uint8 and torch.equal(target["w"], torch.from_numpy(raw))
    read = Snapshot(path).read_object("m/w")
    assert read.dtype == torch.uint8 and torch.equal(read, torch.from_numpy(raw))
    Snapshot.take(back, {"m": StateDict(w=target["w"])})
    holder = jsnap.StateDict(w=np.zeros((2, 3), np.uint8))
    jsnap.Snapshot(back).restore({"m": holder})
    assert np.asarray(holder["w"]).view(arr.dtype).tobytes() == arr.tobytes()


def test_primitives_objects_and_layouts_round_trip(tmp_path):
    base = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    sd = StateDict(
        step=7, lr=1e-3, name="run", done=True, none=None, z=1 + 2j,
        nested={"a": [1, (2, "x"), {"b": 3.5}], 11: "int key"},
        obj={1, 2, 3},
        scalar=torch.tensor(2.5, dtype=torch.float64),
        transposed=base.t(),
        strided=base[:, ::2],
        host=np.arange(6, dtype=np.int16).reshape(2, 3),
    )
    path = str(tmp_path / "snap")
    Snapshot.take(path, {"s": sd})
    target = StateDict(
        step=0, lr=0.0, name="", done=False, none=1, z=0j,
        nested={"a": [0, (0, ""), {"b": 0.0}], 11: ""},
        obj=None,
        scalar=torch.tensor(0.0, dtype=torch.float64),
        transposed=torch.zeros(6, 4),
        strided=torch.zeros(4, 3),
        host=np.zeros((2, 3), dtype=np.int16),
    )
    Snapshot(path).restore({"s": target})
    for key in ("step", "lr", "name", "done", "none", "z", "nested", "obj"):
        assert target[key] == sd[key]
        assert type(target[key]) is type(sd[key])
    for key in ("scalar", "transposed", "strided"):
        assert torch.equal(target[key], sd[key]), key
        assert target[key].is_contiguous()
    np.testing.assert_array_equal(target["host"], sd["host"])
    # Non-contiguous views are stored in C order: the JAX package reads them.
    jtarget = jsnap.StateDict(
        transposed=np.zeros((6, 4), np.float32), strided=np.zeros((4, 3), np.float32)
    )
    jsnap.Snapshot(path).restore({"s": jtarget}, paths=["s/transposed", "s/strided"])
    np.testing.assert_array_equal(jtarget["transposed"], base.t().numpy())
    np.testing.assert_array_equal(jtarget["strided"], base[:, ::2].numpy())


@pytest.mark.parametrize("shape", [(40, 8), (8, 40)])
def test_chunked_dense_path(tmp_path, monkeypatch, shape):
    """Above the chunk cap a dense tensor is stored as several objects,
    split as the JAX package splits it; both packages restore it. (40, 8)
    splits along dim 0 (each chunk one byte run of the target), (8, 40)
    along dim 1 (chunks scattered into boxes)."""
    monkeypatch.setattr(io_preparer, "MAX_CHUNK_SIZE_BYTES", 256)
    arr = _np_array("float32", shape, seed=3)
    path = str(tmp_path / "snap")
    Snapshot.take(path, {"m": StateDict(w=_to_torch(arr))})
    entry = Snapshot(path).get_manifest()["0/m/w"]
    assert isinstance(entry, ShardedArrayEntry) and entry.per_rank
    assert len(entry.shards) == 5
    assert all(s.array.location.startswith("chunked/0/m/w__chunk_") for s in entry.shards)
    target = StateDict(w=torch.zeros(shape))
    Snapshot(path).restore({"m": target})
    assert _bytes(target["w"]) == arr.tobytes()
    jtarget = jsnap.StateDict(w=np.zeros(shape, np.float32))
    jsnap.Snapshot(path).restore({"m": jtarget})
    np.testing.assert_array_equal(jtarget["w"], arr)


def test_read_object(tmp_path):
    w = torch.randn(3, 4, generator=torch.Generator().manual_seed(0))
    path = str(tmp_path / "snap")
    Snapshot.take(path, {"m": StateDict(w=w, cfg={"depth": 2, "tags": ["a", "b"]})})
    snap = Snapshot(path)
    got = snap.read_object("m/w")
    assert isinstance(got, torch.Tensor) and torch.equal(got, w)
    as_np = snap.read_object("m/w", template=np.zeros((3, 4), np.float32))
    np.testing.assert_array_equal(as_np, w.numpy())
    assert snap.read_object("m/cfg") == {"depth": 2, "tags": ["a", "b"]}
    assert snap.read_object("m/cfg/depth") == 2
    with pytest.raises(KeyError, match="not in the snapshot"):
        snap.read_object("m/nope")
    with pytest.raises(RuntimeError, match="shape"):
        snap.read_object("m/w", template=torch.zeros(4, 3))


def test_rng_state_round_trip_and_jax_snapshot(tmp_path):
    torch.manual_seed(5)
    np.random.seed(5)
    path = str(tmp_path / "snap")
    Snapshot.take(path, {"rng": RNGState()})
    expected = (torch.rand(3), np.random.rand(3))
    torch.rand(10)
    np.random.rand(10)
    Snapshot(path).restore({"rng": RNGState()})
    assert torch.equal(torch.rand(3), expected[0])
    np.testing.assert_array_equal(np.random.rand(3), expected[1])
    # A JAX-package RNGState snapshot has no torch streams: it still loads,
    # restoring numpy's and Python's and leaving torch's as they are.
    np.random.seed(9)
    jpath = str(tmp_path / "jax_rng")
    jsnap.Snapshot.take(jpath, {"rng": jsnap.RNGState()})
    jax_expected = np.random.rand(3)
    torch_before = torch.get_rng_state()
    Snapshot(jpath).restore({"rng": RNGState()})
    np.testing.assert_array_equal(np.random.rand(3), jax_expected)
    assert torch.equal(torch.get_rng_state(), torch_before)
    # ...and the port's RNG snapshot loads into the JAX package.
    np.random.seed(11)
    Snapshot.take(path, {"rng": RNGState()})
    port_expected = np.random.rand(3)
    jsnap.Snapshot(path).restore({"rng": jsnap.RNGState()})
    np.testing.assert_array_equal(np.random.rand(3), port_expected)


def test_jax_mesh_sharded_array_restores_into_one_tensor(tmp_path):
    devices = np.array(jax.devices()[:8]).reshape(4, 2)
    mesh = Mesh(devices, ("x", "y"))
    arr = _np_array("float32", (16, 6), seed=4)
    sharded = jax.device_put(arr, NamedSharding(mesh, P("x", "y")))
    path = str(tmp_path / "snap")
    jsnap.Snapshot.take(path, {"m": jsnap.StateDict(w=sharded)})
    entry = Snapshot(path).get_manifest()["0/m/w"]
    assert isinstance(entry, ShardedArrayEntry) and len(entry.shards) == 8
    target = StateDict(w=torch.zeros(16, 6))
    Snapshot(path).restore({"m": target})
    assert _bytes(target["w"]) == arr.tobytes()


def _tiny_config(**kw):
    return dict(vocab_size=64, d_model=64, n_heads=4, n_kv_heads=2,
                n_layers=2, d_ff=128, max_seq_len=32, **kw)


def test_manifests_match_between_packages(tmp_path):
    params = jtf.init_params(jtf.TransformerConfig(**_tiny_config()), jax.random.key(0))
    np_params = _to_numpy(params)
    jsnap.Snapshot.take(str(tmp_path / "jax"), {"model": _JaxState(params)})
    model = ttf.Transformer(
        ttf.TransformerConfig(**_tiny_config()), ttf.params_from_numpy(np_params, "cpu")
    )
    Snapshot.take(str(tmp_path / "port"), {"model": ttf.TransformerState(model)})
    jm = jsnap.Snapshot(str(tmp_path / "jax")).get_manifest()
    pm = Snapshot(str(tmp_path / "port")).get_manifest()
    assert sorted(jm) == sorted(pm)
    n_arrays = 0
    for path, pe in pm.items():
        je = jm[path]
        assert je.type == pe.type, path
        if isinstance(pe, ArrayEntry):
            n_arrays += 1
            assert (je.dtype, je.shape, je.location) == (pe.dtype, pe.shape, pe.location)
            # Same payload bytes, hence the same crc32.
            assert je.checksum == pe.checksum, path
        else:
            assert je.__dict__ == pe.__dict__, path
    assert n_arrays == 3 + 8 * 2


def test_jax_transformer_snapshot_restores_into_port(tmp_path):
    config = _tiny_config()
    jcfg = jtf.TransformerConfig(**config)
    params = jtf.init_params(jcfg, jax.random.key(1))
    path = str(tmp_path / "snap")
    jsnap.Snapshot.take(path, {"model": _JaxState(params)})
    other = _to_numpy(jtf.init_params(jcfg, jax.random.key(2)))
    tcfg = ttf.TransformerConfig(**config)
    model = ttf.Transformer(tcfg, ttf.params_from_numpy(other, "cpu"))
    Snapshot(path).restore({"model": ttf.TransformerState(model)})
    tokens = np.random.default_rng(0).integers(0, 64, (2, 32)).astype(np.int32)
    expected = np.asarray(jtf.forward(params, jnp.asarray(tokens), jcfg))
    with torch.no_grad():  # the parameters are trainable
        got = model(torch.from_numpy(tokens).long()).numpy()
    # f32 matmuls reassociate between XLA:CPU and ATen.
    np.testing.assert_allclose(got, expected, atol=1e-4, rtol=1e-4)


def test_entries_the_port_cannot_read_raise(tmp_path):
    """Compressed entries read since the deduplication slice; an
    algorithm neither package knows still raises, before any byte lands."""
    path = str(tmp_path / "snap")
    arr = _np_array("float32", (8,), seed=5)
    jsnap.Snapshot.take(path, {"m": jsnap.StateDict(w=jnp.asarray(arr))}, compression="zlib")
    target = StateDict(w=torch.zeros(8))
    Snapshot(path).restore({"m": target})
    assert np.array_equal(target["w"].numpy(), arr)
    meta = tmp_path / "snap" / ".snapshot_metadata"
    meta.write_text(meta.read_text().replace("zlib", "lz77"))
    target = StateDict(w=torch.zeros(8))
    with pytest.raises(ValueError, match="Unknown compression"):
        Snapshot(path).restore({"m": target})
    assert not target["w"].any()


def test_jax_prng_key_leaf_restores_as_key_data(tmp_path):
    key = jax.random.key(3)
    path = str(tmp_path / "snap")
    jsnap.Snapshot.take(path, {"m": jsnap.StateDict(k=key)})
    got = Snapshot(path).read_object("m/k")
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax.random.key_data(key)))


def test_memory_storage_and_unported_backends(tmp_path):
    w = torch.arange(10, dtype=torch.int64)
    Snapshot.take("memory://bucket/step-1", {"m": StateDict(w=w)})
    target = StateDict(w=torch.zeros(10, dtype=torch.int64))
    Snapshot("memory://bucket/step-1").restore({"m": target})
    assert torch.equal(target["w"], w)
    # A snapserve:// path writes straight to its backend; with no server
    # listening, its reads degrade to direct backend reads, bit-exact.
    Snapshot.take("snapserve://127.0.0.1:1/memory://bucket/x", {"m": StateDict(w=w)})
    target = StateDict(w=torch.zeros(10, dtype=torch.int64))
    Snapshot("memory://bucket/x").restore({"m": target})
    assert torch.equal(target["w"], w)
    target = StateDict(w=torch.zeros(10, dtype=torch.int64))
    Snapshot("snapserve://127.0.0.1:1/memory://bucket/x").restore({"m": target})
    assert torch.equal(target["w"], w)


def test_coordination_pieces(tmp_path):
    assert isinstance(get_coordinator(), NoOpCoordinator)
    coord = NoOpCoordinator()
    assert get_coordinator(coord) is coord
    assert coord.all_gather_object("x") == ["x"]
    for store in (DictStore(), FileStore(str(tmp_path / "kv"))):
        store.set("a/b", b"1")
        assert store.get("a/b") == b"1"
        store.delete("a/b")
        with pytest.raises(TimeoutError):
            store.get("a/b", timeout_s=0.01)


def test_available_memory_reads_meminfo(tmp_path):
    meminfo = tmp_path / "meminfo"
    meminfo.write_text("MemTotal: 100 kB\nMemAvailable:  2048 kB\n")
    assert available_memory_bytes(str(meminfo)) == 2048 * 1024
    assert available_memory_bytes() > 0


def test_oom_classification():
    from torchsnapshot_tpu_torch.ops.transfer import is_oom_error

    assert is_oom_error(MemoryError())
    assert is_oom_error(torch.cuda.OutOfMemoryError("CUDA out of memory"))
    assert not is_oom_error(RuntimeError("Out of memory"))


def test_storage_ops_retry_transient_failures_only(monkeypatch):
    import asyncio

    from torchsnapshot_tpu_torch.io_types import IOReq, RetryingStoragePlugin
    from torchsnapshot_tpu_torch.storage_plugins.memory import MemoryStoragePlugin

    class Flaky(MemoryStoragePlugin):
        failures = 1
        reads = 0

        async def read(self, io_req):
            Flaky.reads += 1
            if Flaky.failures:
                Flaky.failures -= 1
                raise ConnectionError("transient")
            await super().read(io_req)

    monkeypatch.setenv("TPUSNAPSHOT_STORAGE_RETRY_CAP_S", "0.01")
    plugin = RetryingStoragePlugin(Flaky(store={"x": b"payload"}))
    req = IOReq(path="x")
    asyncio.run(plugin.read(req))
    assert req.data == b"payload" and Flaky.reads == 2
    # Not-found is deterministic: no retry.
    with pytest.raises(FileNotFoundError):
        asyncio.run(plugin.read(IOReq(path="missing")))
    assert Flaky.reads == 3


@pytest.mark.parametrize("world", [2, 3])
def test_sync_take_commits_through_storage_above_the_threshold(tmp_path, monkeypatch, world):
    """Above TPUSNAPSHOT_COMMIT_VIA_STORAGE_BYTES the sync take commits
    through storage markers: the same metadata, byte for byte (take_id
    apart), as the gather's, no marker left behind, and a snapshot that
    restores through the JAX package on every rank."""
    from torchsnapshot_tpu.utils.test_utils import run_thread_ranks as jax_thread_ranks
    from torchsnapshot_tpu_torch import snapshot as snapshot_mod
    from torchsnapshot_tpu_torch.utils.test_utils import run_thread_ranks

    shared = np.random.default_rng(1).standard_normal(300).astype(np.float32)

    def app(rank):
        return {"m": StateDict(
            w=torch.full((16,), float(rank)), shared=torch.from_numpy(shared.copy()),
            step=rank, name=f"rank-{rank}",
        )}

    routes = []
    real = snapshot_mod._acommit_via_storage

    async def spy(*args, **kwargs):
        routes.append(kwargs["snapshot_path"])
        return await real(*args, **kwargs)

    monkeypatch.setattr(snapshot_mod, "_acommit_via_storage", spy)

    def take(path):
        run_thread_ranks(world, lambda c, r: Snapshot.take(path, app(r), coord=c, replicated=["m/shared"]))
        return (tmp_path / path / ".snapshot_metadata").read_bytes()

    gathered = take(str(tmp_path / "gathered"))
    assert routes == []
    monkeypatch.setenv("TPUSNAPSHOT_COMMIT_VIA_STORAGE_BYTES", "100")
    stored = take(str(tmp_path / "stored"))
    assert routes == [str(tmp_path / "stored")] * world  # every rank's marker
    assert not [p for p in (tmp_path / "stored").rglob(".completed/**/*") if p.is_file()]
    ids = [SnapshotMetadata.from_yaml(doc.decode()).take_id for doc in (gathered, stored)]
    assert gathered.replace(ids[0].encode(), b"ID") == stored.replace(ids[1].encode(), b"ID")

    def restore(coord, rank):
        target = jsnap.StateDict(w=np.zeros(16, np.float32), shared=np.zeros(300, np.float32),
                                 step=-1, name="")
        jsnap.Snapshot(str(tmp_path / "stored")).restore({"m": target}, coord=coord)
        assert np.asarray(target["w"]).tobytes() == np.full(16, rank, np.float32).tobytes()
        assert np.asarray(target["shared"]).tobytes() == shared.tobytes()
        assert (target["step"], target["name"]) == (rank, f"rank-{rank}")

    jax_thread_ranks(world, restore)
