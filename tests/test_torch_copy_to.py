"""``Snapshot.copy_to`` of the port, the cases of tests/test_copy_to.py:
copies that restore bit-exactly through either package (a port copy of
either package's snapshot, and the JAX package's copy of a port
snapshot), in-transit checks that leave no metadata at the destination,
an interrupted copy that commits nothing, sharded and compressed
snapshots, a copy to a fake GCS bucket, the byte budget's knob, and
object entries sized by the backend."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torchsnapshot_tpu as jsnap
from torch_cloud_fakes import FakeGCSClient, route_to_fakes
from torchsnapshot_tpu_torch import Snapshot, io_preparer
from torchsnapshot_tpu_torch import snapshot as snapshot_mod
from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin


class _Holder:
    def __init__(self, sd):
        self.sd = sd

    def state_dict(self):
        return self.sd

    def load_state_dict(self, sd):
        self.sd = sd


def _w(n=4096, seed=0):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def _app(kind, w, **extra):
    conv = torch.from_numpy if kind == "port" else jnp.asarray
    return {"m": _Holder({"w": conv(w.copy()), "meta": {"step": 7, "name": "run"}, **extra})}


def _restores(path, w, kind):
    """Restore ``path`` through ``kind``'s package into zeros; check it."""
    target = _app(kind, np.zeros_like(w))
    (Snapshot if kind == "port" else jsnap.Snapshot)(path).restore(target)
    assert np.asarray(target["m"].sd["w"]).tobytes() == w.tobytes()
    assert target["m"].sd["meta"] == {"step": 7, "name": "run"}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_copy_to_fs_round_trip(tmp_path, writer):
    """A port copy of either package's snapshot restores bit-exactly
    through both, and stands alone once the source is deleted."""
    w = _w()
    src, dst = str(tmp_path / "src"), str(tmp_path / "dst")
    (Snapshot if writer == "port" else jsnap.Snapshot).take(src, _app(writer, w))
    copied = Snapshot(src).copy_to(dst)
    assert copied.path == dst
    Snapshot(src).delete()
    for kind in ("port", "jax"):
        _restores(dst, w, kind)
    assert Snapshot(dst).verify() == jsnap.Snapshot(dst).verify() == {}


def test_jax_copy_of_a_port_snapshot_restores_through_the_port(tmp_path):
    w = _w(seed=1)
    src, dst = str(tmp_path / "src"), str(tmp_path / "dst")
    Snapshot.take(src, _app("port", w))
    jsnap.Snapshot(src).copy_to(dst)
    _restores(dst, w, "port")


def _corrupt(path, lo=100, hi=104):
    raw = bytearray(path.read_bytes())
    raw[lo:hi] = b"\xde\xad\xbe\xef"
    path.write_bytes(bytes(raw))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_copy_to_verifies_in_transit(tmp_path, writer):
    """A corrupt source object raises in transit, in both packages, and
    the destination gets no metadata."""
    src = str(tmp_path / "src")
    (Snapshot if writer == "port" else jsnap.Snapshot).take(src, _app(writer, _w()))
    _corrupt(tmp_path / "src" / "0" / "m" / "w")
    for pkg, name in ((Snapshot, "dst"), (jsnap.Snapshot, "jax_dst")):
        with pytest.raises(RuntimeError, match="[Cc]hecksum"):
            pkg(src).copy_to(str(tmp_path / name))
        assert not (tmp_path / name / ".snapshot_metadata").exists()
    # verify=False copies the bytes as they are.
    Snapshot(src).copy_to(str(tmp_path / "unchecked"), verify=False)
    assert list(Snapshot(str(tmp_path / "unchecked")).verify()) == ["0/m/w"]


def test_copy_to_interrupted_leaves_no_commit(tmp_path, monkeypatch):
    """A copy that dies after its first payload write leaves the
    destination without metadata: no reader sees a half copy."""
    app = _app("port", _w(8192))
    app["m"].sd["w2"] = torch.arange(64, dtype=torch.float32)
    src = str(tmp_path / "src")
    Snapshot.take(src, app)
    calls = {"n": 0}

    class _DyingFS(FSStoragePlugin):
        async def write(self, io_req):
            calls["n"] += 1
            if calls["n"] >= 2:
                raise IOError("disk on fire")
            await super().write(io_req)

    monkeypatch.setenv("TPUSNAPSHOT_STORAGE_RETRIES", "0")
    real = snapshot_mod.url_to_storage_plugin
    monkeypatch.setattr(
        snapshot_mod, "url_to_storage_plugin",
        lambda path: _DyingFS(path) if path.endswith("dst") else real(path),
    )
    with pytest.raises(IOError, match="disk on fire"):
        Snapshot(src).copy_to(str(tmp_path / "dst"))
    assert not (tmp_path / "dst" / ".snapshot_metadata").exists()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_copy_to_sharded_and_compressed(tmp_path, writer, monkeypatch):
    """Sharded (mesh-sharded by JAX, chunked dense by the port) and
    zlib-compressed: the copy restores through both packages."""
    arr = np.random.default_rng(1).standard_normal((64, 16)).astype(np.float32)
    src, dst = str(tmp_path / "src"), str(tmp_path / "dst")
    if writer == "jax":
        mesh = Mesh(np.array(jax.devices()[:2]), ("x",))
        sharded = jax.device_put(jnp.asarray(arr), NamedSharding(mesh, P("x", None)))
        jsnap.Snapshot.take(src, {"m": _Holder({"w": sharded})}, compression="zlib")
    else:
        monkeypatch.setattr(io_preparer, "MAX_CHUNK_SIZE_BYTES", 1024)
        Snapshot.take(src, {"m": _Holder({"w": torch.from_numpy(arr.copy())})}, compression="zlib")
    Snapshot(src).copy_to(dst)
    assert Snapshot(dst).get_manifest()["0/m/w"].type == "ShardedArray"
    for kind, zeros in (("port", torch.zeros(64, 16)), ("jax", jnp.zeros((64, 16), jnp.float32))):
        target = {"m": _Holder({"w": zeros})}
        (Snapshot if kind == "port" else jsnap.Snapshot)(dst).restore(target)
        assert np.asarray(target["m"].sd["w"]).tobytes() == arr.tobytes()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_copy_to_fake_gcs(tmp_path, monkeypatch, writer):
    """fs → gs://: the port's copy lands in a (fake) bucket through the
    port's GCS plugin and restores from it through both packages."""
    route_to_fakes(monkeypatch, gcs=FakeGCSClient())
    w = _w(2048)
    src = str(tmp_path / "src")
    (Snapshot if writer == "port" else jsnap.Snapshot).take(src, _app(writer, w))
    Snapshot(src).copy_to("gs://bucket/promoted")
    for kind in ("port", "jax"):
        _restores("gs://bucket/promoted", w, kind)


def test_copy_to_malformed_budget_env_falls_back(tmp_path, monkeypatch):
    """A malformed TPUSNAPSHOT_COPY_BUDGET_BYTES falls back to the
    default, as the other knobs do, instead of failing the copy."""
    monkeypatch.setenv("TPUSNAPSHOT_COPY_BUDGET_BYTES", "not-a-number")
    w = _w(256)
    src, dst = str(tmp_path / "src"), str(tmp_path / "dst")
    Snapshot.take(src, _app("port", w))
    Snapshot(src).copy_to(dst)
    _restores(dst, w, "jax")


def test_copy_to_a_budget_below_every_object_copies_them_one_by_one(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUSNAPSHOT_COPY_BUDGET_BYTES", "16")
    w = _w(512)
    src, dst = str(tmp_path / "src"), str(tmp_path / "dst")
    Snapshot.take(src, _app("port", w, b=torch.ones(300)))
    Snapshot(src).copy_to(dst)
    _restores(dst, w, "port")


def test_copy_to_sizes_object_entries_from_backend(tmp_path, monkeypatch):
    """An object entry (no size in the manifest) is admitted at its
    stored size, asked of the backend."""
    sized = []
    real = FSStoragePlugin.object_size_bytes

    async def spy(self, path):
        size = await real(self, path)
        sized.append((path, size))
        return size

    monkeypatch.setattr(FSStoragePlugin, "object_size_bytes", spy)
    src, dst = str(tmp_path / "src"), str(tmp_path / "dst")
    Snapshot.take(src, {"m": _Holder({"w": torch.arange(8.0), "tags": {"a", "b", "c"}})})
    Snapshot(src).copy_to(dst)
    assert sized and all("tags" in p for p, _ in sized)
    for path, size in sized:
        assert size == (tmp_path / "src" / path).stat().st_size > 0
    target = {"m": _Holder({"w": jnp.zeros(8, jnp.float32), "tags": set()})}
    jsnap.Snapshot(dst).restore(target)
    assert target["m"].sd["tags"] == {"a", "b", "c"}
