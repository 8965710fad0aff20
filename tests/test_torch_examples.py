"""The six ported example scripts (``examples_torch/``) on the CPU: each
runs as a user would run it (``--device cpu``, a temporary
``--work-dir``), exits 0 and prints the lines its JAX counterpart in
``examples/`` prints (each script's ``expected_lines``, which
``chip_smoke.py`` reads too). Then every leaf of every snapshot it left
reads back through the JAX package's ``Snapshot.read_object``, and
through the port's, with the bytes the port's state held when it was
taken: the host copy the script keeps beside its snapshots
(``utils/test_utils.record_taken_state``). The embedding and
long-context examples spawn gloo worlds through ``run_multiprocess``,
under its deadline (``--timeout-s``)."""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jsnap
from torchsnapshot_tpu_torch import Snapshot
from torchsnapshot_tpu_torch.manifest import DictEntry, ListEntry
from torchsnapshot_tpu_torch.utils.test_utils import read_taken_states

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = [
    "simple_example",
    "checkpoint_manager_example",
    "async_checkpoint_example",
    "incremental_example",
    "embedding_example",
    "long_context_example",
]
_SPAWNS = ("embedding_example", "long_context_example")


def _expected_lines(name):
    path = os.path.join(ROOT, "examples_torch", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"examples_torch_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.expected_lines("cpu")


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if hasattr(x, "__array__") and not isinstance(x, np.ndarray):
        return np.asarray(x)  # a JAX array
    return x


def _same(a, b) -> bool:
    """Equal values; arrays compare by their bytes."""
    a, b = _host(a), _host(b)
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    if isinstance(a, dict) and isinstance(b, dict):
        return set(map(str, a)) == set(map(str, b)) and all(
            _same(a[k], b[k]) for k in a
        )
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def _snapshots(work_dir):
    return sorted(
        dp for dp, _, files in os.walk(work_dir) if ".snapshot_metadata" in files
    )


def _leaves_read_back_as_taken(path, taken) -> int:
    """Every leaf of the snapshot at ``path``, through both packages'
    ``read_object``, against what the state held at the take."""
    port, jax_snap = Snapshot(path), jsnap.Snapshot(path)
    leaves = set()
    for key, entry in port.get_manifest().items():
        if isinstance(entry, (DictEntry, ListEntry)):
            continue
        rank, _, leaf = key.partition("/")
        leaves.add(leaf)
        assert leaf in taken, (path, key)
        # A sharded leaf is the whole array from every rank; the other
        # leaves of these examples hold one value on every rank.
        assert _same(jax_snap.read_object(leaf, rank=int(rank)), taken[leaf]), (path, key)
        assert _same(port.read_object(leaf, rank=int(rank)), taken[leaf]), (path, key)
    assert leaves == set(taken), (path, set(taken) ^ leaves)
    return len(leaves)


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_on_the_cpu_and_reads_back_through_jax(name, tmp_path):
    work_dir = str(tmp_path / "work")
    cmd = [sys.executable, os.path.join(ROOT, "examples_torch", f"{name}.py"),
           "--device", "cpu", "--work-dir", work_dir]
    if name in _SPAWNS:
        cmd += ["--timeout-s", "240"]
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=400, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    for line in _expected_lines(name):
        assert line in proc.stdout, (line, proc.stdout)
    snapshots = _snapshots(work_dir)
    taken = read_taken_states(work_dir)
    assert snapshots
    for path in snapshots:
        assert os.path.normpath(path) in taken, (path, sorted(taken))
        assert _leaves_read_back_as_taken(path, taken[os.path.normpath(path)]) > 0
