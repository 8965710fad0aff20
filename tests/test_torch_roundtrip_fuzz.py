"""Seeded whole-stack fuzz across the packages, from
tests/test_roundtrip_fuzz.py: random nested app states (dicts,
OrderedDicts, lists, tuples; arrays of six dtypes and ranks 0–3,
primitives, strings, bytes, sets) taken by the port restore bit-exactly
through the JAX package, and the other way round, over the same seeds
and both split-read thresholds. Array leaves are the taking package's
tensors or numpy arrays; the restoring package's templates hold
sentinels of the same structure, so a skipped leaf fails."""

import random
from collections import OrderedDict

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jsnap
from test_roundtrip_fuzz import _N_SEEDS, _assert_tree_equal, _rand_tree
from torchsnapshot_tpu_torch import Snapshot


class _Holder:
    def __init__(self, sd):
        self.sd = sd

    def state_dict(self):
        return self.sd

    def load_state_dict(self, sd):
        self.sd = sd


def _map(tree, fn):
    if isinstance(tree, (dict, OrderedDict)):
        return type(tree)((k, _map(v, fn)) for k, v in tree.items())
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    if isinstance(tree, tuple):
        return tuple(_map(v, fn) for v in tree)
    return fn(tree)


def _as_port(x):
    """The generator's jax arrays as torch tensors of the same bytes."""
    return torch.from_numpy(np.array(x)) if isinstance(x, jnp.ndarray) else x


def _sentinel(kind):
    """A leaf of another value and the same type: arrays filled with 1 (a
    ``kind`` "jax" template keeps jax arrays, "port" turns them to torch
    tensors)."""

    def fn(x):
        if hasattr(x, "shape"):
            filled = np.full(np.asarray(x).shape, 1, np.asarray(x).dtype)
            if not isinstance(x, np.ndarray):
                return jnp.asarray(filled) if kind == "jax" else torch.from_numpy(filled)
            return filled
        if isinstance(x, bool):
            return not x
        if isinstance(x, int):
            return x - 12345
        if isinstance(x, float):
            return 123.456
        if isinstance(x, str):
            return "SENTINEL"
        if isinstance(x, bytes):
            return b"SENTINEL"
        if x is None:
            return None
        return {"WRONG_OBJECT"}  # a set stays an object leaf

    return fn


def test_port_tensors_cover_every_array_dtype_of_the_seeds():
    dtypes = set()

    def note(x):
        if isinstance(x, torch.Tensor):
            dtypes.add(str(x.dtype))
        return x

    for seed in range(_N_SEEDS):
        _map(_map(_rand_tree(random.Random(seed), depth=3), _as_port), note)
    assert {"torch.float32", "torch.bool"} <= dtypes, sorted(dtypes)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
@pytest.mark.parametrize("split_threshold", [None, 64])
@pytest.mark.parametrize("seed", range(_N_SEEDS))
def test_random_tree_crosses_packages(seed, split_threshold, direction, tmp_path, monkeypatch):
    # A 64-byte threshold sends nearly every array restore through the
    # split-read paths of the restoring package.
    if split_threshold is not None:
        monkeypatch.setenv("TPUSNAPSHOT_PARALLEL_READ_THRESHOLD", str(split_threshold))
    tree = {"root": _rand_tree(random.Random(seed), depth=3)}
    path = str(tmp_path / "snap")
    if direction == "port_to_jax":
        Snapshot.take(path, {"m": _Holder(_map(tree, _as_port))})
        target = _Holder(_map(tree, _sentinel("jax")))
        jsnap.Snapshot(path).restore({"m": target})
    else:
        jsnap.Snapshot.take(path, {"m": _Holder(tree)})
        target = _Holder(_map(tree, _sentinel("port")))
        Snapshot(path).restore({"m": target})
    _assert_tree_equal(tree, target.sd, "m")
