"""The port's reference-format interop against the JAX package's: a
snapshot written by either package's ``convert_back`` read bit for bit
through the other package's ``ReferenceSnapshotReader`` (f32, bf16,
int64, a sharded array, objects, primitives, nested containers and
tuples); the JSON metadata the port writes without PyYAML read by
``yaml.safe_load``; the reader's availability rules, restore and convert;
``TorchStateful`` and the tree converters; and the JAX package's
reference-gated cases mirrored, skipping as they do where the reference
torchsnapshot is not importable."""

import builtins
import io
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import yaml
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torchsnapshot_tpu as jsnap
from test_interop import ref  # noqa: F401 (the fixture: the reference package or a skip)
from torchsnapshot_tpu.interop import ReferenceSnapshotReader as JaxReader
from torchsnapshot_tpu.interop import TorchStateful as JaxTorchStateful
from torchsnapshot_tpu.interop.reference_writer import convert_back as jax_convert_back
from torchsnapshot_tpu.utils.train_state import PytreeStateful as JaxPytree
from torchsnapshot_tpu_torch import PytreeStateful, Snapshot, StateDict
from torchsnapshot_tpu_torch import io_preparer
from torchsnapshot_tpu_torch.inspect import main as inspect_main
from torchsnapshot_tpu_torch.interop import (
    ReferenceSnapshotReader,
    TorchStateful,
    numpy_to_torch_tree,
    torch_to_numpy_tree,
)
from torchsnapshot_tpu_torch.interop._torch_convert import (
    numpy_to_torch_tensor,
    torch_dtype_from_name,
    torch_tensor_to_numpy,
)
from torchsnapshot_tpu_torch.interop.reference_writer import convert_back


class _Holder:
    def __init__(self, sd):
        self.sd = sd

    def state_dict(self):
        return self.sd

    def load_state_dict(self, sd):
        self.sd = sd


def _bits(x):
    """A tensor's or array's bytes, for bit-for-bit comparison."""
    if isinstance(x, torch.Tensor):
        return x.detach().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(x).view(np.uint8).tobytes()


W = np.arange(64, dtype=np.float32).reshape(8, 8) / 7
B16 = (np.arange(16, dtype=np.float32) / 3).astype(ml_dtypes.bfloat16)
IDS = np.arange(-5, 5, dtype=np.int64) * (1 << 40)
SHARDED = np.arange(32, dtype=np.float32).reshape(8, 4) - 0.5


def _jax_native(path):
    mesh = Mesh(np.array(jax.devices()[:4]), ("x",))
    state = {
        "w": jnp.asarray(W),
        "b16": jnp.asarray(B16),
        "ids": np.asarray(IDS),
        "sharded": jax.device_put(jnp.asarray(SHARDED), NamedSharding(mesh, P("x", None))),
        "nested": {"scale": jnp.full((4,), 2.5)},
        "pair": (1, "two"),
        "steps": [1, 2, 3],
        "name": "run-b",
        "epoch": 7,
        "blob": {"a": {1, 2}},
    }
    jsnap.Snapshot.take(path, {"m": _Holder(state)})


def _port_native(path, monkeypatch):
    # A chunked dense entry (a ShardedArrayEntry in the port's format) for
    # the sharded case.
    monkeypatch.setattr(io_preparer, "MAX_CHUNK_SIZE_BYTES", 64)
    state = {
        "w": torch.from_numpy(W.copy()),
        "b16": numpy_to_torch_tensor(B16),
        "ids": torch.from_numpy(IDS.copy()),
        "sharded": torch.from_numpy(SHARDED.copy()),
        "nested": {"scale": torch.full((4,), 2.5)},
        "pair": (1, "two"),
        "steps": [1, 2, 3],
        "name": "run-b",
        "epoch": 7,
        "blob": {"a": {1, 2}},
    }
    Snapshot.take(path, {"m": _Holder(state)})


def _check_tree(read, to_bits):
    assert to_bits(read("m/w")) == _bits(W)
    assert to_bits(read("m/b16")) == _bits(B16)
    assert to_bits(read("m/ids")) == _bits(IDS)
    assert to_bits(read("m/sharded")) == _bits(SHARDED)
    assert to_bits(read("m/nested/scale")) == _bits(np.full((4,), 2.5, np.float32))
    assert read("m/name") == "run-b" and read("m/epoch") == 7
    assert read("m/blob/a") == {1, 2}


def test_jax_convert_back_read_by_the_port_reader(tmp_path):
    _jax_native(str(tmp_path / "native"))
    jax_convert_back(str(tmp_path / "native"), str(tmp_path / "ref"))
    with ReferenceSnapshotReader(str(tmp_path / "ref")) as reader:
        _check_tree(reader.read, _bits)
        assert reader.read("m/b16").dtype == torch.bfloat16
        tree = reader.load("m")
        assert tree["steps"] == [1, 2, 3] and tree["pair"] == [1, "two"]
        assert _bits(tree["sharded"]) == _bits(SHARDED)


def test_port_convert_back_read_by_the_jax_reader(tmp_path, monkeypatch):
    _port_native(str(tmp_path / "native"), monkeypatch)
    monkeypatch.setattr(io_preparer, "MAX_CHUNK_SIZE_BYTES", 512 << 20)
    convert_back(str(tmp_path / "native"), str(tmp_path / "ref"))
    reader = JaxReader(str(tmp_path / "ref"))
    _check_tree(reader.read, _bits)
    assert reader.read("m/b16").dtype == np.dtype(ml_dtypes.bfloat16)
    tree = reader.load("m")
    assert tree["steps"] == [1, 2, 3] and tree["pair"] == [1, "two"]
    manifest = reader.manifest()
    assert manifest["0/m/sharded"]["replicated"] is True  # assembled dense
    assert manifest["0/m/pair"] == {"type": "list"}
    reader.close()


def test_port_convert_back_of_a_jax_sharded_snapshot(tmp_path):
    """The port exports a JAX mesh-sharded snapshot (its shards assembled
    dense) that the JAX reader reads like the JAX export."""
    _jax_native(str(tmp_path / "native"))
    convert_back(str(tmp_path / "native"), str(tmp_path / "port_ref"))
    jax_convert_back(str(tmp_path / "native"), str(tmp_path / "jax_ref"))
    ours, theirs = JaxReader(str(tmp_path / "port_ref")), JaxReader(str(tmp_path / "jax_ref"))
    assert sorted(ours.manifest()) == sorted(theirs.manifest())
    for path in ("m/w", "m/b16", "m/ids", "m/sharded"):
        assert _bits(ours.read(path)) == _bits(theirs.read(path))
    assert ours.load("m")["steps"] == theirs.load("m")["steps"]


def test_port_metadata_without_pyyaml_is_json_that_yaml_reads(tmp_path, monkeypatch):
    _jax_native(str(tmp_path / "native"))
    real_import = builtins.__import__

    def no_yaml(name, *args, **kwargs):
        if name == "yaml":
            raise ImportError("yaml is blocked")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_yaml)
    convert_back(str(tmp_path / "native"), str(tmp_path / "ref"))
    with ReferenceSnapshotReader(str(tmp_path / "ref")) as reader:
        assert _bits(reader.read("m/w")) == _bits(W)
    monkeypatch.setattr(builtins, "__import__", real_import)
    text = (tmp_path / "ref" / ".snapshot_metadata").read_text()
    doc = json.loads(text)
    assert yaml.safe_load(text) == doc
    assert doc["version"] == "0.0.3" and doc["world_size"] == 1
    assert _bits(JaxReader(str(tmp_path / "ref")).read("m/w")) == _bits(W)


def test_port_metadata_with_pyyaml_is_yaml(tmp_path):
    _jax_native(str(tmp_path / "native"))
    convert_back(str(tmp_path / "native"), str(tmp_path / "ref"))
    text = (tmp_path / "ref" / ".snapshot_metadata").read_text()
    with pytest.raises(ValueError):
        json.loads(text)
    assert yaml.safe_load(text)["manifest"]["0/m/w"]["dtype"] == "torch.float32"


def test_block_yaml_metadata_needs_pyyaml(tmp_path, monkeypatch):
    _jax_native(str(tmp_path / "native"))
    jax_convert_back(str(tmp_path / "native"), str(tmp_path / "ref"))
    real_import = builtins.__import__

    def no_yaml(name, *args, **kwargs):
        if name == "yaml":
            raise ImportError("yaml is blocked")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_yaml)
    with pytest.raises(RuntimeError, match="PyYAML"):
        ReferenceSnapshotReader(str(tmp_path / "ref")).metadata


def test_multi_rank_export_keeps_rank_namespaces_in_both_packages(tmp_path):
    from torchsnapshot_tpu_torch.utils.test_utils import run_thread_ranks

    native = str(tmp_path / "native")

    def worker(coord, rank):
        Snapshot.take(native, {"m": _Holder({
            "mine": torch.full((4,), float(rank)),
            "shared": torch.arange(8, dtype=torch.float32),
        })}, coord=coord, replicated=["m/shared"])

    run_thread_ranks(2, worker)
    convert_back(native, str(tmp_path / "port_ref"))
    jax_convert_back(native, str(tmp_path / "jax_ref"))
    for reader in (ReferenceSnapshotReader(str(tmp_path / "port_ref")), JaxReader(str(tmp_path / "port_ref")),
                   ReferenceSnapshotReader(str(tmp_path / "jax_ref"))):
        for rank in (0, 1):
            assert _bits(reader.read("m/mine", rank=rank)) == _bits(np.full((4,), rank, np.float32))
            assert _bits(reader.read("m/shared", rank=rank)) == _bits(np.arange(8, dtype=np.float32))
        with pytest.raises(RuntimeError, match="per-rank"):
            reader.convert(str(tmp_path / f"out{id(reader)}"))
        reader.close()


def _write_reference(root, manifest, world_size, dump=yaml.dump):
    (root / ".snapshot_metadata").write_text(
        dump({"version": "0.0.3", "world_size": world_size, "manifest": manifest})
    )


def _save(root, loc, obj):
    path = root / loc
    path.parent.mkdir(parents=True, exist_ok=True)
    buf = io.BytesIO()
    torch.save(obj, buf)
    path.write_bytes(buf.getvalue())


@pytest.mark.parametrize("dump", [yaml.dump, json.dumps], ids=["yaml", "json"])
def test_sharded_tensor_reassembly(tmp_path, dump):
    """A hand-made 2-rank reference manifest with a ShardedTensor: shards
    merge across ranks and reassemble dense for any rank."""
    full = np.arange(32, dtype=np.float32).reshape(8, 4)
    manifest = {}
    for rank, row0 in enumerate((0, 4)):
        loc = f"sharded/emb/t_{row0}_0"
        _save(tmp_path, loc, torch.from_numpy(full[row0:row0 + 4].copy()))
        manifest[f"{rank}/emb/t"] = {"type": "ShardedTensor", "shards": [{
            "offsets": [row0, 0], "sizes": [4, 4],
            "tensor": {"type": "Tensor", "location": loc, "serializer": "torch_save",
                       "dtype": "torch.float32", "shape": [4, 4], "replicated": False},
        }]}
    _write_reference(tmp_path, manifest, 2, dump)
    for rank in (0, 1):
        assert _bits(ReferenceSnapshotReader(str(tmp_path)).read("emb/t", rank=rank)) == _bits(full)
        assert _bits(JaxReader(str(tmp_path)).read("emb/t", rank=rank)) == _bits(full)


def test_rank_is_parsed_from_the_whole_first_token(tmp_path):
    manifest = {}
    for rank in (1, 11):
        _save(tmp_path, f"{rank}/s/v", torch.tensor([rank]))
        manifest[f"{rank}/s/v"] = {"type": "Tensor", "location": f"{rank}/s/v", "serializer": "torch_save",
                                   "dtype": "torch.int64", "shape": [1], "replicated": False}
    _write_reference(tmp_path, manifest, 12)
    reader = ReferenceSnapshotReader(str(tmp_path))
    assert int(reader.read("s/v", rank=11)) == 11 and int(reader.read("s/v", rank=1)) == 1
    with pytest.raises(KeyError):
        reader.read("s/v", rank=0)
    with pytest.raises(RuntimeError, match="per-rank"):
        reader.convert(str(tmp_path / "out"), rank=1)


def test_tampered_payload_is_refused(tmp_path):
    _save(tmp_path, "0/m/w", torch.zeros(3))
    _write_reference(tmp_path, {"0/m/w": {
        "type": "Tensor", "location": "0/m/w", "serializer": "torch_save",
        "dtype": "torch.float32", "shape": [4], "replicated": False}}, 1)
    with pytest.raises(RuntimeError, match="tampered"):
        ReferenceSnapshotReader(str(tmp_path)).read("m/w")


def test_reader_restores_into_torch_templates_in_place(tmp_path):
    _jax_native(str(tmp_path / "native"))
    jax_convert_back(str(tmp_path / "native"), str(tmp_path / "ref"))
    w = torch.nn.Parameter(torch.zeros(8, 8))
    template = {"w": w, "b16": torch.zeros(16, dtype=torch.bfloat16), "sharded": np.zeros((8, 4), np.float32),
                "epoch": 0, "nested": {"scale": torch.zeros(4)}}
    holder = _Holder(template)
    ReferenceSnapshotReader(str(tmp_path / "ref")).restore({"m": holder})
    assert holder.sd["w"] is w and _bits(w) == _bits(W)
    assert _bits(holder.sd["b16"]) == _bits(B16)
    assert isinstance(holder.sd["sharded"], np.ndarray) and _bits(holder.sd["sharded"]) == _bits(SHARDED)
    assert holder.sd["epoch"] == 7


def test_reader_restores_into_a_dtensor_template(tmp_path):
    import torch.distributed as dist
    from torchsnapshot_tpu_torch.parallel.mesh import make_mesh, shard_pytree

    _jax_native(str(tmp_path / "native"))
    jax_convert_back(str(tmp_path / "native"), str(tmp_path / "ref"))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}", rank=0, world_size=1)
    try:
        mesh = make_mesh({"ep": 1}, "cpu")
        template = shard_pytree({"sharded": torch.zeros(8, 4)}, mesh, lambda keys, leaf: ("ep",))
        holder = _Holder(template)
        ReferenceSnapshotReader(str(tmp_path / "ref")).restore({"m": holder})
        assert _bits(holder.sd["sharded"].to_local()) == _bits(SHARDED)
    finally:
        dist.destroy_process_group()


def test_reader_restore_refuses_a_dtype_mismatch(tmp_path):
    _jax_native(str(tmp_path / "native"))
    jax_convert_back(str(tmp_path / "native"), str(tmp_path / "ref"))
    with pytest.raises(RuntimeError, match="dtype mismatch"):
        ReferenceSnapshotReader(str(tmp_path / "ref")).restore(
            {"m": _Holder({"w": torch.zeros(8, 8, dtype=torch.bfloat16)})})


def test_reader_convert_writes_a_native_snapshot_both_packages_read(tmp_path):
    _jax_native(str(tmp_path / "native"))
    jax_convert_back(str(tmp_path / "native"), str(tmp_path / "ref"))
    ReferenceSnapshotReader(str(tmp_path / "ref")).convert(str(tmp_path / "converted"))
    assert _bits(Snapshot(str(tmp_path / "converted")).read_object("m/sharded")) == _bits(SHARDED)
    assert jsnap.Snapshot(str(tmp_path / "converted")).read_object("m/epoch") == 7
    got = jsnap.Snapshot(str(tmp_path / "converted")).read_object("m/b16")
    assert _bits(got) == _bits(B16)


def test_inspect_convert_back_exports_what_the_jax_reader_restores(tmp_path, capsys):
    _jax_native(str(tmp_path / "native"))
    dest = str(tmp_path / "ref")
    assert inspect_main([str(tmp_path / "native"), "--convert-back", dest]) == 0
    assert capsys.readouterr().out == f"exported {tmp_path / 'native'} -> {dest} (reference format)\n"
    holder = JaxPytree({"w": np.zeros((8, 8), np.float32)})
    JaxReader(dest).restore({"m": holder})
    assert _bits(holder.tree["w"]) == _bits(W)
    with pytest.raises(SystemExit):
        inspect_main([str(tmp_path / "native"), "--convert-back", dest, "--verify"])


# ------------------------------------------------------------ TorchStateful


def _trained_linear_and_adam(seed):
    torch.manual_seed(seed)
    model = torch.nn.Linear(6, 3)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    model(torch.randn(2, 6)).sum().backward()
    opt.step()
    return model, opt


def test_torch_stateful_roundtrip(tmp_path):
    model, opt = _trained_linear_and_adam(11)
    Snapshot.take(str(tmp_path / "s"), {"model": TorchStateful(model), "opt": TorchStateful(opt)})
    model2, opt2 = _trained_linear_and_adam(12)
    weight = model2.weight
    Snapshot(str(tmp_path / "s")).restore({"model": TorchStateful(model2), "opt": TorchStateful(opt2)})
    assert model2.weight is weight
    for (k1, t1), (k2, t2) in zip(model.state_dict().items(), model2.state_dict().items()):
        assert k1 == k2 and _bits(t1) == _bits(t2)
    s1, s2 = opt.state_dict()["state"], opt2.state_dict()["state"]
    for idx in s1:
        for field in s1[idx]:
            assert _bits(s1[idx][field]) == _bits(s2[idx][field])


def test_torch_stateful_crosses_both_ways(tmp_path):
    torch.manual_seed(3)
    model = torch.nn.Linear(5, 2).to(torch.bfloat16)
    Snapshot.take(str(tmp_path / "port"), {"model": TorchStateful(model)})
    holder = JaxPytree({"weight": np.zeros((2, 5), ml_dtypes.bfloat16), "bias": np.zeros(2, ml_dtypes.bfloat16)})
    jsnap.Snapshot(str(tmp_path / "port")).restore({"model": holder})
    assert _bits(holder.tree["weight"]) == _bits(model.weight)

    jsnap.Snapshot.take(str(tmp_path / "jax"), {"model": JaxTorchStateful(model)})
    other = torch.nn.Linear(5, 2).to(torch.bfloat16)
    Snapshot(str(tmp_path / "jax")).restore({"model": TorchStateful(other)})
    assert _bits(other.weight) == _bits(model.weight) and _bits(other.bias) == _bits(model.bias)


def test_torch_restore_refuses_a_dtype_mismatch(tmp_path):
    Snapshot.take(str(tmp_path / "s"), {"model": StateDict(weight=torch.zeros(2, 4), bias=torch.zeros(2))})
    with pytest.raises(RuntimeError, match="dtype mismatch"):
        TorchStateful(torch.nn.Linear(4, 2).bfloat16()).load_state_dict(
            {"weight": np.zeros((2, 4), np.float32), "bias": np.zeros(2, np.float32)})


def test_numpy_never_leaks_through_conversion():
    tree = numpy_to_torch_tree({"a": np.ones((2,), np.float32)}, template={"a": 5})
    assert isinstance(tree["a"], torch.Tensor)


def test_tree_conversion_is_bitwise_for_bf16_and_float8():
    t = (torch.arange(7, dtype=torch.float32) / 3).bfloat16()
    f8 = torch.linspace(-2, 2, 5).to(torch.float8_e4m3fn)
    tree = torch_to_numpy_tree({"a": t, "b": [t, 5], "c": "x", "f8": f8})
    assert tree["a"].dtype == np.dtype(ml_dtypes.bfloat16)
    assert tree["f8"].dtype == np.dtype(ml_dtypes.float8_e4m3fn)
    back = numpy_to_torch_tree(tree)
    assert back["a"].dtype == torch.bfloat16 and _bits(back["a"]) == _bits(t)
    assert _bits(back["b"][0]) == _bits(t) and back["b"][1] == 5 and back["c"] == "x"
    assert back["f8"].dtype == torch.float8_e4m3fn and _bits(back["f8"]) == _bits(f8)
    assert torch_tensor_to_numpy(torch.tensor(3.0)).shape == ()


def test_reference_dtype_names():
    assert torch_dtype_from_name("torch.float32") is torch.float32
    assert torch_dtype_from_name("torch.float") is torch.float32
    assert torch_dtype_from_name("torch.bfloat16") is torch.bfloat16
    with pytest.raises(RuntimeError):
        torch_dtype_from_name("torch.nonsense")


def test_bf16_numpy_array_without_ml_dtypes_raises_naming_it(monkeypatch):
    real_import = builtins.__import__

    def no_ml_dtypes(name, *args, **kwargs):
        if name == "ml_dtypes":
            raise ImportError("blocked")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_ml_dtypes)
    with pytest.raises(RuntimeError, match="ml_dtypes"):
        torch_tensor_to_numpy(torch.zeros(2, dtype=torch.bfloat16))
    # The bits come back without it.
    assert numpy_to_torch_tensor(np.zeros(2, ml_dtypes.bfloat16)).dtype == torch.bfloat16


class _SubDict(dict):
    """A dict subclass, as the reference's pickled StateDict is."""


def test_pytree_stateful_converts_reference_state_dicts(tmp_path):
    """A reference-written object leaf (a dict subclass) converts to plain
    containers, leaf per object."""
    _save(tmp_path, "0/p/state", _SubDict(epoch=3, steps=[1, 2]))
    _write_reference(tmp_path, {"0/p": {"type": "dict", "keys": ["state"]}, "0/p/state": {
        "type": "object", "location": "0/p/state", "serializer": "torch_save",
        "obj_type": "_SubDict", "replicated": False}}, 1)
    ReferenceSnapshotReader(str(tmp_path)).convert(str(tmp_path / "native"))
    assert Snapshot(str(tmp_path / "native")).read_object("p/state/epoch") == 3
    target = PytreeStateful({"state": {"epoch": 0, "steps": [0, 0]}})
    Snapshot(str(tmp_path / "native")).restore({"p": target})
    assert target.tree == {"state": {"epoch": 3, "steps": [1, 2]}}


# ------------------------------------- mirrored reference-gated JAX cases


@pytest.fixture()
def ref_snapshot(ref, tmp_path):  # noqa: F811
    torch.manual_seed(7)
    model = torch.nn.Sequential(torch.nn.Linear(8, 4), torch.nn.ReLU(), torch.nn.Linear(4, 2))
    progress = ref.StateDict(epoch=3, steps=[1, 2, 3], name="run-a")
    path = str(tmp_path / "ref_snap")
    ref.Snapshot.take(path=path, app_state={"model": model, "progress": progress})
    return path, model, progress


def test_ref_read_leaf_bitwise(ref_snapshot):
    path, model, _ = ref_snapshot
    assert _bits(ReferenceSnapshotReader(path).read("model/0.weight")) == _bits(model.state_dict()["0.weight"])


def test_ref_load_subtree_and_objects(ref_snapshot):
    path, model, _ = ref_snapshot
    reader = ReferenceSnapshotReader(path)
    tree = reader.load("progress")
    assert tree["epoch"] == 3 and tree["steps"] == [1, 2, 3] and tree["name"] == "run-a"
    model_tree = reader.load("model")
    for key, tensor in model.state_dict().items():
        assert _bits(model_tree[key]) == _bits(tensor)


def test_ref_restore_into_torch_templates(ref_snapshot):
    path, model, _ = ref_snapshot
    template = {k: torch.zeros_like(t) for k, t in model.state_dict().items()}
    holder = _Holder(template)
    ReferenceSnapshotReader(path).restore({"model": holder})
    for key, tensor in model.state_dict().items():
        assert _bits(holder.sd[key]) == _bits(tensor)


def test_ref_convert_to_native_format(ref_snapshot, tmp_path):
    path, model, _ = ref_snapshot
    ReferenceSnapshotReader(path).convert(str(tmp_path / "native"))
    template = {k: torch.zeros_like(t) for k, t in model.state_dict().items()}
    holder = PytreeStateful(template)
    Snapshot(str(tmp_path / "native")).restore({"model": holder})
    for key, tensor in model.state_dict().items():
        assert _bits(holder.tree[key]) == _bits(tensor)
    assert Snapshot(str(tmp_path / "native")).read_object("progress/epoch") == 3


def test_ref_bfloat16_reference_roundtrip(ref, tmp_path):  # noqa: F811
    t = torch.arange(16, dtype=torch.float32).view(4, 4).bfloat16()
    path = str(tmp_path / "bf16")
    ref.Snapshot.take(path=path, app_state={"h": _Holder({"t": t})})
    got = ReferenceSnapshotReader(path).read("h/t")
    assert got.dtype == torch.bfloat16 and _bits(got) == _bits(t)


def test_ref_convert_back_restored_by_reference(ref, tmp_path, monkeypatch):  # noqa: F811
    _port_native(str(tmp_path / "native"), monkeypatch)
    convert_back(str(tmp_path / "native"), str(tmp_path / "ref_format"))
    holder = _Holder({
        "w": torch.zeros(8, 8), "b16": torch.zeros(16, dtype=torch.bfloat16),
        "ids": torch.zeros(10, dtype=torch.int64), "sharded": torch.zeros(8, 4),
        "nested": {"scale": torch.zeros(4)}, "steps": [0, 0, 0], "name": "", "epoch": 0,
    })
    ref.Snapshot(str(tmp_path / "ref_format")).restore({"m": holder})
    assert _bits(holder.sd["w"]) == _bits(W) and _bits(holder.sd["b16"]) == _bits(B16)
    assert _bits(holder.sd["sharded"]) == _bits(SHARDED)
    assert holder.sd["steps"] == [1, 2, 3] and holder.sd["name"] == "run-b" and holder.sd["epoch"] == 7


def test_ref_convert_back_multi_rank(ref, tmp_path):  # noqa: F811
    from torchsnapshot_tpu_torch.utils.test_utils import run_thread_ranks

    native = str(tmp_path / "native")

    def worker(coord, rank):
        Snapshot.take(native, {"m": _Holder({
            "mine": torch.full((4,), float(rank)), "shared": torch.arange(8, dtype=torch.float32),
        })}, coord=coord, replicated=["m/shared"])

    run_thread_ranks(2, worker)
    convert_back(native, str(tmp_path / "ref_format"))
    holder = _Holder({"mine": torch.full((4,), -1.0), "shared": torch.full((8,), -1.0)})
    ref.Snapshot(str(tmp_path / "ref_format")).restore({"m": holder})
    assert _bits(holder.sd["mine"]) == _bits(torch.zeros(4))
    assert _bits(holder.sd["shared"]) == _bits(torch.arange(8, dtype=torch.float32))


def test_ref_inspect_cli_convert_back(ref, tmp_path, capsys):  # noqa: F811
    Snapshot.take(str(tmp_path / "native"), {"m": _Holder({"w": torch.arange(8.0)})})
    dest = str(tmp_path / "ref")
    assert inspect_main([str(tmp_path / "native"), "--convert-back", dest]) == 0
    assert "exported" in capsys.readouterr().out
    holder = _Holder({"w": torch.zeros(8)})
    ref.Snapshot(dest).restore({"m": holder})
    assert _bits(holder.sd["w"]) == _bits(torch.arange(8.0))


def test_port_reader_reads_port_export_of_a_port_snapshot(tmp_path, monkeypatch):
    _port_native(str(tmp_path / "native"), monkeypatch)
    convert_back(str(tmp_path / "native"), str(tmp_path / "ref"))
    with ReferenceSnapshotReader(str(tmp_path / "ref")) as reader:
        _check_tree(reader.read, _bits)
    assert os.path.exists(tmp_path / "ref" / "replicated" / "m" / "sharded")
