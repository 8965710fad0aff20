"""The port at world sizes above one: DTensor shard boxes, sharded and
replicated takes by spawned gloo ranks, elastic restores onto other
layouts and world sizes, and snapshots crossing between the port and the
JAX package in both directions, bit for bit.

The spawned ranks run the functions of ``torch_rank_workers.py``."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
from torch.distributed.tensor.placement_types import _StridedShard

import torch_rank_workers as workers
import torchsnapshot_tpu as jsnap
from torchsnapshot_tpu.models import transformer as jtf
from torchsnapshot_tpu.parallel import mesh as jmesh
from torchsnapshot_tpu.utils.test_utils import run_thread_ranks as jax_thread_ranks
from torchsnapshot_tpu_torch import (
    CheckpointManager,
    Snapshot,
    StateDict,
    StoreCoordinator,
    get_coordinator,
)
from torchsnapshot_tpu_torch.flatten import flatten
from torchsnapshot_tpu_torch.manifest import ArrayEntry, ShardedArrayEntry
from torchsnapshot_tpu_torch.models import transformer as ttf
from torchsnapshot_tpu_torch.parallel.mesh import make_mesh, placements_for
from torchsnapshot_tpu_torch.resharding import shard_box
from torchsnapshot_tpu_torch.serialization import tensor_bytes
from torchsnapshot_tpu_torch.utils.test_utils import run_multiprocess, run_thread_ranks
from torchsnapshot_tpu_torch.utils.train_state import PytreeStateful

# max_seq_len 33: the positions, replicated in the tensor-parallel
# layouts, split unevenly (17 + 16) in the FSDP-style one.
TINY = dict(vocab_size=64, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
            d_ff=128, max_seq_len=33)


class _JaxState:
    def __init__(self, tree):
        self.tree = tree

    def state_dict(self):
        return self.tree

    def load_state_dict(self, sd):
        self.tree = sd


def _to_numpy(tree):
    """A JAX params pytree as numpy arrays, dict key order kept."""
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_numpy(v) for v in tree]
    return np.asarray(tree)


def _zeros_like_np(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like_np(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeros_like_np(v) for v in tree]
    return np.zeros_like(tree)


def _assert_port_tree_bytes(got, expected_np):
    """Every leaf of ``got`` a plain tensor with the bytes of the leaf of
    ``expected_np`` at the same path (key order may differ: a JAX tree
    sorts its dict keys)."""
    _, got_leaves = flatten(got)
    _, want_leaves = flatten(expected_np)
    assert sorted(got_leaves) == sorted(want_leaves)
    for path, g in got_leaves.items():
        assert not isinstance(g, DTensor), path
        assert tensor_bytes(g).numpy().tobytes() == want_leaves[path].tobytes(), path


class _FakeMesh:
    """The attributes ``compute_local_shape_and_global_offset`` reads of
    a DeviceMesh, at one coordinate."""

    def __init__(self, shape, coordinate):
        self.shape = tuple(shape)
        self._coordinate = list(coordinate)

    def _is_current_rank_part_of_mesh(self):
        return True

    def _sym_get_coordinate(self, dim):
        return self._coordinate[dim]


@pytest.mark.parametrize(
    "global_shape,mesh_shape,placements",
    [
        ((50257, 1600), (4,), (Shard(0),)),
        ((1600, 6400), (2,), (Shard(1),)),
        ((67, 5), (3,), (Shard(-2),)),
        ((33,), (2,), (Shard(0),)),
        ((3, 8), (4,), (Shard(0),)),  # empty last shards
        ((64, 30), (2, 4), (Shard(0), Shard(1))),
        ((65, 9), (2, 3), (Shard(0), Shard(0))),
        ((10, 7), (2, 2), (Replicate(), Shard(1))),
    ],
)
def test_shard_box_matches_torch(global_shape, mesh_shape, placements):
    coordinates = np.stack(
        np.meshgrid(*[np.arange(n) for n in mesh_shape], indexing="ij"), -1
    ).reshape(-1, len(mesh_shape))
    covered = np.zeros(global_shape, dtype=np.int64)
    for coordinate in coordinates.tolist():
        offsets, sizes = shard_box(global_shape, mesh_shape, coordinate, placements)
        shape, offset = compute_local_shape_and_global_offset(
            global_shape, _FakeMesh(mesh_shape, coordinate), placements
        )
        assert tuple(sizes) == shape
        if all(sizes):
            assert tuple(offsets) == offset
        covered[tuple(slice(o, o + s) for o, s in zip(offsets, sizes))] += 1
    # Each element is held by as many ranks as the Replicate dims hold.
    copies = np.prod([n for n, p in zip(mesh_shape, placements) if isinstance(p, Replicate)])
    assert (covered == copies).all()


def test_shard_box_refuses_partial_and_strided_placements():
    with pytest.raises(ValueError, match="Partial"):
        shard_box((8,), (2,), (0,), (Partial(),))
    with pytest.raises(ValueError, match="placement"):
        shard_box((8,), (2,), (0,), (_StridedShard(0, split_factor=2),))


@pytest.fixture
def world1():
    """A gloo world of one rank in this process, torn down after."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_world_of_one_dtensor_take_and_restore(world1, tmp_path):
    coord = get_coordinator()
    assert isinstance(coord, StoreCoordinator) and get_coordinator() is coord
    mesh = make_mesh({"tp": 1}, "cpu")
    w = torch.arange(24, dtype=torch.float32).reshape(6, 4)
    sharded = DTensor.from_local(w.clone(), mesh, [Shard(0)], run_check=False)
    replicated = DTensor.from_local(w + 1, mesh, [Replicate()], run_check=False)
    path = str(tmp_path / "snap")
    Snapshot.take(path, {"m": StateDict(s=sharded, r=replicated)}, replicated=["**"])
    manifest = Snapshot(path).get_manifest()
    assert isinstance(manifest["0/m/s"], ShardedArrayEntry)
    assert manifest["0/m/s"].shards[0].array.location == "sharded/m/s_0_0"
    # All-Replicate is dense, and a glob makes it replicated.
    assert isinstance(manifest["0/m/r"], ArrayEntry) and manifest["0/m/r"].replicated
    target = StateDict(
        s=DTensor.from_local(torch.zeros(6, 4), mesh, [Shard(0)], run_check=False),
        r=torch.zeros(6, 4),
    )
    Snapshot(path).restore({"m": target})
    assert isinstance(target["s"], DTensor) and target["s"].placements == (Shard(0),)
    assert torch.equal(target["s"].to_local(), w)
    assert torch.equal(target["r"], w + 1)

    with pytest.raises(ValueError, match="Partial"):
        partial = DTensor.from_local(w, mesh, [Partial()], run_check=False)
        Snapshot.take(str(tmp_path / "partial"), {"m": StateDict(p=partial)})
    assert not os.path.exists(tmp_path / "partial" / ".snapshot_metadata")
    assert placements_for(mesh, (None, "tp")) == (Shard(1),)


def test_new_default_group_gets_a_new_coordinator():
    seen = []
    for _ in range(2):
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
        try:
            seen.append(get_coordinator())
            assert get_coordinator() is seen[-1]
        finally:
            dist.destroy_process_group()
    assert seen[0] is not seen[1]
    assert not isinstance(get_coordinator(), StoreCoordinator)


def test_one_rank_read_object_then_new_group_take(tmp_path):
    """read_object on one rank does not build that rank's coordinator: in
    the next default group every rank's take still meets, and writes
    what it would have."""
    arr = np.arange(60, dtype=np.float32).reshape(10, 6)
    first, path = str(tmp_path / "first"), str(tmp_path / "snap")
    Snapshot.take(first, {"m": StateDict(w=torch.from_numpy(arr))})
    run_multiprocess(workers.read_then_regroup_take, 2, (first, path, arr), timeout_s=60)
    target = StateDict(w=torch.zeros(10, 6))
    Snapshot(path).restore({"m": target})
    assert torch.equal(target["w"], torch.from_numpy(arr))


def test_jax_tp4_take_restores_into_port_at_world_2_and_1(tmp_path):
    """The JAX package takes the tiny transformer tensor-parallel on the
    8-device CPU mesh (tp 4); the port restores it in an FSDP-style
    layout at world 2 (boxes straddle stored shards; only the boxes'
    bytes are read) and into plain tensors at world 1."""
    jcfg = jtf.TransformerConfig(**TINY)
    params = jtf.init_params(jcfg, jax.random.key(7))
    mesh8 = jmesh.make_mesh({"dp": 2, "tp": 4})
    path = str(tmp_path / "snap")
    jsnap.Snapshot.take(
        path, {"model": _JaxState(jtf.shard_params(params, mesh8))}, replicated=["**"]
    )
    expected = _to_numpy(params)
    run_multiprocess(workers.restore_fsdp, 2, (path, expected))

    target = PytreeStateful(ttf.params_from_numpy(_zeros_like_np(expected), "cpu"))
    Snapshot(path).restore({"model": target})
    _assert_port_tree_bytes(target.tree, expected)
    tokens = np.random.default_rng(0).integers(0, 64, (2, 32)).astype(np.int32)
    want = np.asarray(jtf.forward(params, jnp.asarray(tokens), jcfg))
    got = ttf.forward(target.tree, torch.from_numpy(tokens).long(), ttf.TransformerConfig(**TINY))
    # f32 matmuls reassociate between XLA:CPU and ATen.
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_port_world2_manager_take_restores_through_jax_and_port(tmp_path):
    """Two spawned ranks save the tiny transformer tensor-parallel
    (Megatron, tp 2) through the manager — save, an in-place change,
    async save, retention — and the latest step restores through the JAX
    package onto a 4-device half mesh and onto a 2-rank split of the
    8-device mesh, and through the port at world 1."""
    params = _to_numpy(jtf.init_params(jtf.TransformerConfig(**TINY), jax.random.key(3)))
    extra = np.random.default_rng(4).standard_normal((67, 5)).astype(np.float32)
    base = str(tmp_path / "run")
    run_multiprocess(workers.manager_take, 2, (base, params, extra))
    expected = _to_numpy(params)
    expected["layers"][0]["mlp"]["w1"] = expected["layers"][0]["mlp"]["w1"] + np.float32(1.0)

    assert not [f for _, _, fs in os.walk(os.path.join(base, "step-1")) for f in fs]
    assert jsnap.CheckpointManager(base).all_steps() == [2]
    model = PytreeStateful(ttf.params_from_numpy(_zeros_like_np(expected), "cpu"))
    extra_state = PytreeStateful({"w": torch.zeros(67, 5)})
    progress = StateDict(step=0)
    step = CheckpointManager(base).restore(
        {"model": model, "extra": extra_state, "progress": progress}
    )
    assert step == 2 and progress["step"] == 2
    _assert_port_tree_bytes(model.tree, expected)
    assert torch.equal(extra_state.tree["w"], torch.from_numpy(extra))

    path = os.path.join(base, "step-2")
    zeros = jax.tree.map(jnp.zeros_like, jtf.init_params(jtf.TransformerConfig(**TINY), jax.random.key(0)))
    want = [np.asarray(x) for x in jax.tree.leaves(expected)]

    def check(tree):
        got = [np.asarray(x) for x in jax.tree.leaves(tree)]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.tobytes() == w.tobytes()

    half_axes = jmesh.auto_axes(4, prefer_tp=2)
    holder = _JaxState(jtf.shard_params(zeros, jmesh.make_mesh(half_axes, jax.devices()[:4])))
    jsnap.Snapshot(path).restore({"model": holder})
    check(holder.tree)

    def restore_rank(coord, rank):
        devices = jax.devices()[4 * rank: 4 * rank + 4]
        h = _JaxState(jtf.shard_params(zeros, jmesh.make_mesh(half_axes, devices)))
        jsnap.Snapshot(path).restore({"model": h}, coord=coord)
        check(h.tree)

    jax_thread_ranks(2, restore_rank)


def test_port_world2_sharded_entries_match_jax_format(tmp_path):
    """A port world-2 take of a DTensor and a JAX take of the same array
    over a 2-device mesh write the same objects, and the manifests
    describe them alike."""
    arr = np.random.default_rng(5).standard_normal((10, 6)).astype(np.float32)
    jpath, ppath = str(tmp_path / "jax"), str(tmp_path / "port")
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    mesh2 = Mesh(np.array(jax.devices()[:2]), ("tp",))
    jsnap.Snapshot.take(
        jpath,
        {"m": _JaxState({"w": jax.device_put(jnp.asarray(arr), NamedSharding(mesh2, P(None, "tp")))})},
    )
    run_multiprocess(workers.take_columns, 2, (ppath, arr))
    # Payload objects; the dot-named records (metadata, the JAX
    # package's flight report) differ in world size and telemetry.
    files = [
        sorted(
            os.path.relpath(os.path.join(d, f), root)
            for d, _, fs in os.walk(root)
            for f in fs
            if not os.path.relpath(os.path.join(d, f), root).startswith(".")
        )
        for root in (jpath, ppath)
    ]
    assert files[0] == files[1] == ["sharded/m/w_0_0", "sharded/m/w_0_3"]
    for name in files[0]:
        with open(os.path.join(jpath, name), "rb") as a, open(os.path.join(ppath, name), "rb") as b:
            assert a.read() == b.read(), name
    from torchsnapshot_tpu.manifest import get_available_entries as jax_available
    from torchsnapshot_tpu_torch.manifest import get_available_entries

    # The JAX take ran in one process, the port's in two: compare the
    # merged view any rank restores from.
    jentry = jax_available(jsnap.Snapshot(jpath).get_manifest(), 0)["m/w"]
    pentry = get_available_entries(Snapshot(ppath).get_manifest(), 1)["m/w"]
    assert (jentry.dtype, jentry.shape) == (pentry.dtype, pentry.shape)
    assert sorted(
        (s.offsets, s.sizes, s.array.location, s.array.checksum) for s in jentry.shards
    ) == sorted(
        (s.offsets, s.sizes, s.array.location, s.array.checksum) for s in pentry.shards
    )


def _run_read(storage, req):
    import asyncio

    from torchsnapshot_tpu_torch.scheduler import execute_read_reqs

    return asyncio.run(execute_read_reqs([req], storage, 1 << 30, 0))


@pytest.mark.parametrize("backend", ["memory", "fs"])
def test_ranged_reads_read_only_the_range(tmp_path, backend):
    import asyncio

    from torchsnapshot_tpu_torch.io_types import BufferConsumer, IOReq, ReadReq
    from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin
    from torchsnapshot_tpu_torch.storage_plugins.memory import MemoryStoragePlugin

    read_sizes = []
    base = MemoryStoragePlugin if backend == "memory" else FSStoragePlugin

    class Counting(base):
        async def read(self, io_req):
            await super().read(io_req)
            read_sizes.append(len(io_req.data))

    storage = Counting() if backend == "memory" else Counting(str(tmp_path))
    payload = bytes(range(256)) * 16
    req = IOReq(path="a/obj")
    req.buf.write(payload)
    asyncio.run(storage.write(req))

    got = []

    class Keep(BufferConsumer):
        async def consume_buffer(self, buf, executor=None):
            got.append(bytes(buf))

        def get_consuming_cost_bytes(self):
            return 100

    assert _run_read(storage, ReadReq("a/obj", Keep(), byte_range=(1000, 1100))) == 100
    assert _run_read(storage, ReadReq("a/obj", Keep())) == len(payload)
    assert got == [payload[1000:1100], payload]
    assert read_sizes == [100, len(payload)]


def test_restore_refuses_corrupt_and_short_payloads(tmp_path):
    """A whole-object read is checked against the stored checksum; a
    ranged read (which no checksum covers) against its length."""
    from torchsnapshot_tpu_torch.io_preparer import ArrayRestorePlan, _ChunkCopyConsumer
    from torchsnapshot_tpu_torch.resharding import compute_overlap

    path = str(tmp_path / "snap")
    w = torch.arange(16, dtype=torch.float32).reshape(4, 4)
    Snapshot.take(path, {"m": StateDict(w=w)})
    payload = tmp_path / "snap" / "0" / "m" / "w"
    data = bytearray(payload.read_bytes())
    data[5] ^= 0xFF
    payload.write_bytes(bytes(data))
    with pytest.raises(RuntimeError, match="Checksum mismatch"):
        Snapshot(path).restore({"m": StateDict(w=torch.zeros(4, 4))})

    entry = Snapshot(path).get_manifest()["0/m/w"]
    plan = ArrayRestorePlan(entry, torch.zeros(4, 4), lambda v: None)
    shard = plan._shards[0]
    rows = compute_overlap([0, 0], [4, 4], [1, 0], [2, 4])
    whole = tuple(slice(0, n) for n in rows.sizes)
    consumer = _ChunkCopyConsumer(
        plan, list(rows.sizes), whole, rows.target_slices, None, shard.array.location
    )
    with pytest.raises(RuntimeError, match="read 8 bytes where the manifest describes 32"):
        consumer._consume(bytes(8))


def _rank_state(rank, torch_side):
    """A replicated weight and a per-rank value, made from a seed."""
    w = np.random.default_rng(0).standard_normal(64).astype(np.float32)
    r = np.full(8, rank, np.float32)
    if torch_side:
        return {"m": StateDict(w=torch.from_numpy(w), r=torch.from_numpy(r))}, (w, r)
    return {"m": jsnap.StateDict(w=w, r=r)}, (w, r)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_rank_with_another_path_writes_under_rank_0s(tmp_path, writer):
    """A rank passing another path than rank 0's warns and writes under
    rank 0's path: one snapshot, which restores bit-exactly at world 2
    through the other package; rank 1's path stays empty."""
    paths = [str(tmp_path / "rank0"), str(tmp_path / "rank1")]

    def take(coord, rank):
        app, _ = _rank_state(rank, writer == "port")
        pkg = Snapshot if writer == "port" else jsnap.Snapshot
        return pkg.take(paths[rank], app, coord=coord, replicated=["m/w"]).path

    launch = run_thread_ranks if writer == "port" else jax_thread_ranks
    assert launch(2, take) == [paths[0], paths[0]]
    assert not os.path.exists(paths[1])
    assert os.path.exists(os.path.join(paths[0], ".snapshot_metadata"))

    def restore(coord, rank):
        _, (w, r) = _rank_state(rank, True)
        if writer == "port":
            target = jsnap.StateDict(w=np.zeros(64, np.float32), r=np.zeros(8, np.float32))
            jsnap.Snapshot(paths[0]).restore({"m": target}, coord=coord)
            got = (np.asarray(target["w"]), np.asarray(target["r"]))
        else:
            target = StateDict(w=torch.zeros(64), r=torch.zeros(8))
            Snapshot(paths[0]).restore({"m": target}, coord=coord)
            got = (target["w"].numpy(), target["r"].numpy())
        assert got[0].tobytes() == w.tobytes() and got[1].tobytes() == r.tobytes()

    (jax_thread_ranks if writer == "port" else run_thread_ranks)(2, restore)
