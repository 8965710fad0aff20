"""Rank functions for the port's spawned multi-rank tests.

Each runs in a process that ``run_multiprocess`` spawned into a gloo
process group. Kept apart from the test files, which import JAX, so a
spawned rank imports only torch and the port."""

import os

import torch
import torch.distributed as dist

from torchsnapshot_tpu_torch import (
    CheckpointManager,
    Snapshot,
    StateDict,
    StoreCoordinator,
    get_coordinator,
)
from torchsnapshot_tpu_torch.models import transformer as ttf
from torchsnapshot_tpu_torch.parallel.mesh import make_mesh, shard_pytree
from torchsnapshot_tpu_torch.storage_plugins import fs
from torchsnapshot_tpu_torch.utils.test_utils import assert_state_dict_eq
from torchsnapshot_tpu_torch.utils.train_state import PytreeStateful


def fsdp_rule(keys, leaf):
    """Shard dim 0 of every leaf over "tp": a layout other than the
    Megatron one, so local boxes straddle stored shards."""
    return ("tp",)


def _count_read_bytes():
    """Count the payload bytes this process reads through the fs plugin."""
    counter = {"bytes": 0}
    read = fs.FSStoragePlugin._read_sync

    def counting(self, io_req):
        read(self, io_req)
        counter["bytes"] += len(io_req.data)

    fs.FSStoragePlugin._read_sync = counting
    return counter


def _local_bytes(tree):
    return sum(
        t.to_local().numel() * t.element_size()
        for t in ttf.param_leaves(tree)
    )


def restore_fsdp(rank, world, path, expected_np):
    """Restore a tensor-parallel snapshot into an FSDP-style layout and
    hold every local shard byte-equal to its box of ``expected_np``; read
    no byte outside the local boxes (every overlap is one run)."""
    assert isinstance(get_coordinator(), StoreCoordinator)
    mesh = make_mesh({"tp": world}, "cpu")
    expected = shard_pytree(ttf.params_from_numpy(expected_np, "cpu"), mesh, fsdp_rule)
    template = shard_pytree(_zeroed(ttf.params_from_numpy(expected_np, "cpu")), mesh, fsdp_rule)
    state = PytreeStateful(template)
    counter = _count_read_bytes()
    Snapshot(path).restore({"model": state})
    assert_state_dict_eq(state.tree, expected)
    metadata_bytes = os.path.getsize(os.path.join(path, ".snapshot_metadata"))
    assert counter["bytes"] == _local_bytes(template) + metadata_bytes, (
        counter["bytes"], _local_bytes(template), metadata_bytes)


def _zeroed(tree):
    if isinstance(tree, dict):
        return {k: _zeroed(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeroed(v) for v in tree]
    return torch.zeros_like(tree)


def manager_take(rank, world, base, params_np, extra_np):
    """World-N Megatron take through the manager: a sync save of step 1,
    an in-place change to one leaf, an async save of step 2 and the
    retention that prunes step 1. ``extra`` is a DTensor of uneven
    shards."""
    assert isinstance(get_coordinator(), StoreCoordinator)
    mesh = make_mesh({"tp": world}, "cpu")
    params = ttf.shard_params(ttf.params_from_numpy(params_np, "cpu"), mesh)
    extra = shard_pytree({"w": torch.from_numpy(extra_np)}, mesh, fsdp_rule)
    app = {
        "model": PytreeStateful(params),
        "extra": PytreeStateful(extra),
        "progress": StateDict(step=1),
    }
    mgr = CheckpointManager(base, max_to_keep=1)
    mgr.save(1, app, replicated=["**"])
    w1 = params["layers"][0]["mlp"]["w1"]
    w1.to_local().add_(1.0)
    app["progress"]["step"] = 2
    mgr.async_save(2, app, replicated=["**"], stage="host").wait()
    if rank == 0:  # retention is rank 0's, after the step's barrier
        assert mgr.all_steps() == [2]


def cuda_take(rank, world, path, params_np):
    """Ranks sharing one card over gloo: a Megatron take of CUDA DTensors."""
    torch.cuda.set_device(rank % torch.cuda.device_count())
    mesh = make_mesh({"tp": world}, "cuda")
    params = ttf.shard_params(ttf.params_from_numpy(params_np, "cuda"), mesh)
    Snapshot.take(path, {"model": PytreeStateful(params)}, replicated=["**"])


def take_columns(rank, world, path, arr):
    """A world-N take of one array split by columns."""
    mesh = make_mesh({"tp": world}, "cpu")
    tree = shard_pytree({"w": torch.from_numpy(arr)}, mesh, lambda keys, leaf: (None, "tp"))
    Snapshot.take(path, {"m": PytreeStateful(tree)})


def read_then_regroup_take(rank, world, first, path, arr):
    """Rank 0 alone reads one object of ``first``; after a new default
    group on the same store, every rank takes ``arr`` split by columns.
    The take meets only if the one-rank read left the coordinator
    namespaces of the ranks alike."""
    if rank == 0:
        assert Snapshot(first).read_object("m/w").shape == arr.shape
    store = dist.distributed_c10d._get_default_store()
    dist.destroy_process_group()
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    take_columns(rank, world, path, arr)


def take_chunked(rank, world, path, arr, spec, max_chunk):
    """A world-N take of one array laid out by ``spec`` (per dim, "tp" or
    None), each box stored in chunks of at most ``max_chunk`` bytes."""
    from torchsnapshot_tpu_torch import io_preparer

    io_preparer.MAX_CHUNK_SIZE_BYTES = max_chunk
    mesh = make_mesh({"tp": world}, "cpu")
    tree = shard_pytree({"w": torch.from_numpy(arr)}, mesh, lambda keys, leaf: spec)
    Snapshot.take(path, {"m": PytreeStateful(tree)})


def restore_columns_unstreamed(rank, world, path, arr):
    """Restore into column halves, which cut every stored row block: the
    boxes are byte-equal and no byte arrived as a streamed sub-range."""
    from torchsnapshot_tpu_torch import snapshot

    mesh = make_mesh({"tp": world}, "cpu")
    columns = lambda keys, leaf: (None, "tp")  # noqa: E731
    state = PytreeStateful(shard_pytree({"w": torch.zeros(arr.shape)}, mesh, columns))
    Snapshot(path).restore({"m": state})
    want = shard_pytree({"w": torch.from_numpy(arr)}, mesh, columns)["w"].to_local()
    assert torch.equal(state.tree["w"].to_local(), want)
    report = snapshot._last_restore_report["scheduler"]
    assert report["streamed_bytes"] == 0, report
    assert report["private_bytes"] == want.numel() * want.element_size(), report
