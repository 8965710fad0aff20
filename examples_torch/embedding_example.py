"""Row-sharded embedding tables: the expert/embedding-parallel workload.

The port of ``examples/embedding_example.py``: several embedding tables
row-sharded over an ``ep`` mesh (``Shard(0)`` DTensors built with
``parallel.mesh.make_mesh``), momentum optimizer state sharded the same
way, trained a few steps, snapshotted, and restored **onto a narrower
mesh** (elastic) with bit-exact verification; then one table is read
alone onto a column-sharded layout. Beside the snapshot, ``taken_state/``
keeps a host copy of the (gathered) state the take saw.

Where the JAX script uses every local device of one process, this one
spawns a gloo world of ``--world`` ranks (4 by default; on a card the
ranks share it) for the take, then a world of half as many for the
restore.

Run:  PYTHONPATH=. python examples_torch/embedding_example.py [--work-dir DIR] [--device cpu]
"""

import argparse
import os
import tempfile
import zlib
from typing import List

import numpy as np
import torch
import torch.distributed as dist

from torchsnapshot_tpu_torch import Snapshot, StateDict
from torchsnapshot_tpu_torch.parallel.mesh import make_mesh, shard_pytree
from torchsnapshot_tpu_torch.utils.test_utils import record_taken_state, run_multiprocess

TABLE_SPECS = {  # name -> (rows, dim)
    "user_id": (1 << 14, 64),
    "item_id": (1 << 15, 64),
    "category": (1 << 10, 32),
}


def expected_lines(device: str) -> List[str]:
    """The lines this script prints, as its JAX counterpart in ``examples/``
    prints them (on ``device``)."""
    return [
        "snapshotted 3,178,496 elements of row-sharded embeddings",
        "OK: elastic restore 4-way -> 2-way row sharding, tables + momentum bit-exact",
        "OK: random-access read of one table, row->column resharded",
    ]


def _rows(_path, _leaf):
    return ("ep", None)


class EmbeddingCollection:
    """Row-sharded tables + momentum state; a Stateful."""

    def __init__(self, mesh, device, seed: int = 0):
        self.mesh = mesh
        g = torch.Generator().manual_seed(seed)
        tables = {
            name: (torch.randn(shape, generator=g) * 0.01).to(device)
            for name, shape in TABLE_SPECS.items()
        }
        momentum = {name: torch.zeros(shape, device=device) for name, shape in TABLE_SPECS.items()}
        self.tables = shard_pytree(tables, mesh, _rows)
        self.momentum = shard_pytree(momentum, mesh, _rows)

    def state_dict(self):
        return {"tables": self.tables, "momentum": self.momentum}

    def load_state_dict(self, sd):
        self.tables = sd["tables"]
        self.momentum = sd["momentum"]


def _row_offset(dt) -> int:
    """The first global row of this rank's box of a row-sharded DTensor."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    _, offset = compute_local_shape_and_global_offset(dt.shape, dt.device_mesh, dt.placements)
    return offset[0]


def train_step(emb: EmbeddingCollection, indices, step: int) -> None:
    """A toy update: gather rows, draw a fake gradient, apply momentum SGD
    scattered back — each rank to the rows of its own box, in place."""
    for name, table in emb.tables.items():
        idx = indices[name]
        g = torch.Generator().manual_seed(step * 1000 + zlib.crc32(name.encode()) % 1000)
        grad = torch.randn(idx.shape[0], table.shape[1], generator=g)
        t_local, m_local = table.to_local(), emb.momentum[name].to_local()
        lo = _row_offset(table)
        mine = (idx >= lo) & (idx < lo + t_local.shape[0])
        rows = (idx[mine] - lo).to(t_local.device)
        m_local[rows] *= 0.9
        m_local.index_add_(0, rows, 0.1 * grad[mine].to(t_local.device))
        t_local.index_add_(0, rows, -0.05 * m_local[rows])


def _expected(work_dir: str, world: int, kind: str, name: str) -> torch.Tensor:
    """The global table (or momentum) the take saw, from each rank's box."""
    return torch.cat(
        [torch.load(os.path.join(work_dir, f"box_{r}.pt"))[kind][name] for r in range(world)]
    )


def take_rank(rank: int, world: int, device_type: str, work_dir: str) -> None:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    device = _device(device_type, rank)
    mesh = make_mesh({"ep": world}, device_type)
    emb = EmbeddingCollection(mesh, device, seed=0)
    progress = StateDict(step=0)
    rng = np.random.RandomState(0)
    for i in range(3):
        indices = {
            name: torch.from_numpy(rng.randint(0, shape[0], size=128))
            for name, shape in TABLE_SPECS.items()
        }
        train_step(emb, indices, i)
        progress["step"] += 1
    snap_path = f"{work_dir}/snap"
    Snapshot.take(snap_path, {"emb": emb, "progress": progress})
    record_taken_state(work_dir, snap_path, {"emb": emb, "progress": progress})
    torch.save(
        {kind: {n: t.to_local().cpu() for n, t in getattr(emb, kind).items()}
         for kind in ("tables", "momentum")},
        os.path.join(work_dir, f"box_{rank}.pt"),
    )
    if rank == 0:
        n = sum(t.numel() for t in emb.tables.values())
        print(f"snapshotted {n:,} elements of row-sharded embeddings -> {snap_path}", flush=True)


def restore_rank(rank: int, world: int, device_type: str, work_dir: str, take_world: int) -> None:
    from torch.distributed.tensor import DTensor, Shard

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    device = _device(device_type, rank)
    mesh = make_mesh({"ep": world}, device_type)
    emb2 = EmbeddingCollection(mesh, device, seed=99)
    progress2 = StateDict(step=-1)
    snap = Snapshot(f"{work_dir}/snap")
    snap.restore({"emb": emb2, "progress": progress2})
    assert progress2["step"] == 3
    for name in TABLE_SPECS:
        for kind in ("tables", "momentum"):
            got = getattr(emb2, kind)[name]
            assert got.device_mesh.shape == (world,)
            want = _expected(work_dir, take_world, kind, name)
            lo = _row_offset(got)
            local = got.to_local()
            assert torch.equal(local.cpu(), want[lo:lo + local.shape[0]]), (kind, name)
    dist.barrier()
    if rank == 0:
        print(f"OK: elastic restore {take_world}-way -> {world}-way row sharding, "
              f"tables + momentum bit-exact", flush=True)

    # Random access: fetch a single table without restoring the rest —
    # onto a *column*-sharded (transposed) layout, exercising arbitrary
    # resharding of the row-sharded chunks.
    rows, dim = TABLE_SPECS["category"]
    col_template = DTensor.from_local(
        torch.zeros(rows, dim // world, device=device), mesh, (Shard(1),),
        run_check=False, shape=torch.Size((rows, dim)), stride=(dim, 1),
    )
    one = snap.read_object("emb/tables/category", template=col_template)
    assert tuple(one.placements) == (Shard(1),)
    want = _expected(work_dir, take_world, "tables", "category")
    c = dim // world
    assert torch.equal(one.to_local().cpu(), want[:, rank * c:(rank + 1) * c])
    dist.barrier()
    if rank == 0:
        print("OK: random-access read of one table, row->column resharded", flush=True)


def _device(device_type: str, rank: int) -> torch.device:
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device_type)


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--work-dir", default=None)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--world", type=int, default=4)
    parser.add_argument("--timeout-s", type=float, default=600.0)
    args = parser.parse_args()
    work_dir = args.work_dir or tempfile.mkdtemp(prefix="tpusnapshot-emb-")
    os.makedirs(work_dir, exist_ok=True)
    half = max(1, args.world // 2)
    run_multiprocess(take_rank, args.world, (args.device, work_dir), timeout_s=args.timeout_s)
    run_multiprocess(
        restore_rank, half, (args.device, work_dir, args.world), timeout_s=args.timeout_s
    )


if __name__ == "__main__":
    main()
