"""Elastic restore over thread ranks (tests/test_elastic.py and
tests/test_replication_glob.py, on the port): replicated values restore
at any world size, per-rank values only on their own rank; replicated
globs intersect across ranks; the replicated writes are striped by the
JAX package's owner map; and a thread-rank take writes the objects and
manifest a JAX take of the same state writes."""

import os

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jsnap
from torchsnapshot_tpu.snapshot import _assign_replicated_owners as jax_owners
from torchsnapshot_tpu.utils.test_utils import run_thread_ranks as jax_thread_ranks
from torchsnapshot_tpu_torch import Snapshot, StateDict
from torchsnapshot_tpu_torch.manifest import get_available_entries
from torchsnapshot_tpu_torch.snapshot import _assign_replicated_owners
from torchsnapshot_tpu_torch.storage_plugin import url_to_storage_plugin
from torchsnapshot_tpu_torch.utils.test_utils import check_state_dict_eq, run_thread_ranks
from torchsnapshot_tpu_torch.utils.train_state import PytreeStateful


class _Stub:
    """One rank of a larger world whose collectives are the identity."""

    def __init__(self, rank, world):
        self._rank, self._world = rank, world

    def get_rank(self):
        return self._rank

    def get_world_size(self):
        return self._world

    def barrier(self, timeout_s=None):
        pass

    def all_gather_object(self, obj):
        return [obj] * self._world

    def broadcast_object(self, obj, src=0):
        return obj


def _state(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "foo": torch.from_numpy(rng.standard_normal(16).astype(np.float32)),
        "bar": torch.from_numpy(rng.integers(0, 9, (3, 4))),
        "baz": {"qux": torch.from_numpy(rng.standard_normal((2, 2))), "n": 7},
    }


def test_replicated_elastic_shrink(tmp_path):
    """Saved at world 4, replicated: restores at world 1, and each value
    was written once."""
    path = str(tmp_path / "snap")
    value = torch.arange(32, dtype=torch.float32)
    run_thread_ranks(
        4,
        lambda c, r: Snapshot.take(
            path, {"st": PytreeStateful({"w": value, "o": {1, 2}})}, coord=c, replicated=["**"]
        ),
    )
    target = PytreeStateful({"w": torch.zeros(32), "o": None})
    Snapshot(path).restore({"st": target})
    assert torch.equal(target.tree["w"], value) and target.tree["o"] == {1, 2}
    assert sorted(os.listdir(tmp_path / "snap" / "replicated" / "st")) == ["o", "w"]


def test_replicated_elastic_grow(tmp_path):
    """Saved at world 2, replicated: restores at world 3."""
    path = str(tmp_path / "snap")
    run_thread_ranks(
        2, lambda c, r: Snapshot.take(path, {"st": PytreeStateful(_state())}, coord=c, replicated=["**"])
    )

    def restore(c, r):
        target = PytreeStateful({"foo": torch.zeros(16), "bar": torch.zeros(3, 4, dtype=torch.int64),
                                 "baz": {"qux": torch.zeros(2, 2, dtype=torch.float64), "n": 0}})
        Snapshot(path).restore({"st": target}, coord=c)
        return check_state_dict_eq(target.tree, _state())

    assert run_thread_ranks(3, restore) == [True] * 3


def test_per_rank_state_and_world_change_error(tmp_path):
    """Without replication a value binds to its rank: it restores on that
    rank at any world size, and a rank without one gets the JAX package's
    error, naming DTensors."""
    path = str(tmp_path / "snap")
    run_thread_ranks(2, lambda c, r: Snapshot.take(path, {"st": StateDict(x=r * 100)}, coord=c))

    def restore(c, r):
        app = {"st": StateDict(x=-1)}
        Snapshot(path).restore(app, coord=c)
        return app["st"]["x"]

    assert run_thread_ranks(2, restore) == [0, 100]
    with pytest.raises(RuntimeError, match=r"world size 2; the restoring world size is 3.*sharded DTensors"):
        Snapshot(path).restore({"st": StateDict(x=-1)}, coord=_Stub(rank=2, world=3))
    app = {"st": StateDict(x=-1)}
    Snapshot(path).restore(app, coord=_Stub(rank=1, world=3))
    assert app["st"]["x"] == 100


def test_replicated_globs_subset_and_intersection(tmp_path):
    path = str(tmp_path / "snap")

    def take(c, r):
        globs = ["st/baz/**", "st/foo"] if r == 0 else ["st/baz/**"]
        Snapshot.take(path, {"st": PytreeStateful(_state())}, coord=c, replicated=globs)

    run_thread_ranks(2, take)
    manifest = Snapshot(path).get_manifest()
    assert manifest["0/st/baz/qux"].replicated and manifest["1/st/baz/n"].replicated
    # Only rank 0 matched st/foo: the intersection leaves it per-rank.
    assert not manifest["0/st/foo"].replicated
    available = get_available_entries(manifest, 5)
    assert "st/baz/qux" in available and "st/foo" not in available


SIZES = [
    {"big": 1 << 30, **{f"small{i:03d}": 1 << 20 for i in range(100)}},
    {f"p{i}": 100 for i in range(8)},
    {"big": 10 << 20, **{f"obj{i}": 0 for i in range(10)}},
    {"a": 5, "b": 5, "c": 3, "d": 0, "e": 9},
]


@pytest.mark.parametrize("world", [1, 3, 4])
@pytest.mark.parametrize("sizes", SIZES, ids=["skewed", "equal", "objects", "mixed"])
def test_owner_map_matches_jax(sizes, world):
    assert _assign_replicated_owners(sizes, world) == jax_owners(sizes, world)


def test_replicated_take_matches_jax_take(tmp_path):
    """At world 2 over thread ranks, both packages take the same values
    with the same globs: the same objects with the same bytes, and the
    same entries (locations, replication, checksums) in every rank's
    namespace."""
    rng = np.random.default_rng(9)
    arrays = {f"w{i}": rng.standard_normal((i + 1, 8)).astype(np.float32) for i in range(5)}
    globs = ["st/w*", "st/meta"]

    def port_take(c, r):
        tree = {k: torch.from_numpy(v) for k, v in arrays.items()}
        Snapshot.take(str(tmp_path / "port"), {"st": PytreeStateful({**tree, "meta": "m", "r": r})},
                      coord=c, replicated=globs)

    def jax_take(c, r):
        tree = dict(arrays)
        jsnap.Snapshot.take(str(tmp_path / "jax"), {"st": jsnap.StateDict({**tree, "meta": "m", "r": r})},
                            coord=c, replicated=globs)

    run_thread_ranks(2, port_take)
    jax_thread_ranks(2, jax_take)

    def files(root):
        return sorted(
            os.path.relpath(os.path.join(d, f), root)
            for d, _, fs in os.walk(root) for f in fs
            if not os.path.relpath(os.path.join(d, f), root).startswith(".")
        )

    assert files(tmp_path / "port") == files(tmp_path / "jax")
    for name in files(tmp_path / "port"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    pman = Snapshot(str(tmp_path / "port")).get_manifest()
    jman = jsnap.Snapshot(str(tmp_path / "jax")).get_manifest()
    assert sorted(pman) == sorted(jman)
    for key, entry in pman.items():
        for field in ("location", "replicated", "checksum", "shape", "dtype", "readable"):
            assert getattr(entry, field, None) == getattr(jman[key], field, None), (key, field)


def test_sync_take_commits_the_gathered_manifests(tmp_path):
    """A sync take gathers every rank's manifest: rank 0 commits their
    merge under its own take_id, with the replicated entry mirrored into
    every rank's namespace; no rank returns before the commit, and no
    completion marker is left behind."""
    path = str(tmp_path / "snap")

    def take(c, r):
        snap = Snapshot.take(
            path, {"st": PytreeStateful({"w": torch.full((4,), float(r)), "s": 1})},
            coord=c, replicated=["st/s"])
        return (os.path.exists(os.path.join(path, ".snapshot_metadata")),
                snap._metadata.take_id)

    results = run_thread_ranks(3, take)
    assert all(committed for committed, _ in results)
    take_ids = {take_id for _, take_id in results}
    assert len(take_ids) == 1 and None not in take_ids
    assert Snapshot(path)._read_metadata(url_to_storage_plugin(path)).take_id in take_ids
    manifest = Snapshot(path).get_manifest()
    assert all(manifest[f"{r}/st/s"].replicated for r in range(3))
    assert not os.path.exists(tmp_path / "snap" / ".completed")
    for rank in range(3):
        target = PytreeStateful({"w": torch.zeros(4), "s": 0})
        Snapshot(path).restore({"st": target}, coord=_Stub(rank, 3))
        assert torch.equal(target.tree["w"], torch.full((4,), float(rank)))
        assert target.tree["s"] == 1
