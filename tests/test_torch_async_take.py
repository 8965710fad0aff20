"""The port's async take on the CPU: the consistent cut under in-place
mutation, the handle's contract, and asynchronously taken snapshots
crossing between the port and the JAX package in both directions, bit
for bit. (The device-clone path runs on the card in chip_smoke.py and
tests/test_torch_cuda.py.)"""

import asyncio
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jsnap
from torchsnapshot_tpu_torch import (
    CheckpointManager,
    PendingSnapshot,
    RNGState,
    Snapshot,
    StateDict,
)
from torchsnapshot_tpu_torch import snapshot as snapshot_mod
from torchsnapshot_tpu_torch.io_types import RetryingStoragePlugin
from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((64, 33)).astype(np.float32),
        "b": rng.standard_normal((17,)).astype(np.float16),
        "i": rng.integers(-5, 5, (3, 4)).astype(np.int64),
    }


@pytest.mark.parametrize("stage", ["auto", "device", "host"])
def test_async_take_wait_restore_bit_exact(tmp_path, stage):
    src = {k: torch.from_numpy(v) for k, v in _arrays().items()}
    pending = Snapshot.async_take(
        str(tmp_path / "snap"), {"m": StateDict(src, step=3), "rng": RNGState()}, stage=stage
    )
    assert isinstance(pending, PendingSnapshot)
    snapshot = pending.wait()
    target = StateDict({k: torch.zeros_like(v) for k, v in src.items()}, step=0)
    snapshot.restore({"m": target})
    for k, v in src.items():
        assert target[k].dtype == v.dtype and torch.equal(target[k], v), k
    assert target["step"] == 3
    # The commit markers are gone once the metadata is written.
    assert not [f for _, _, fs in os.walk(tmp_path / "snap" / ".completed") for f in fs]


@pytest.mark.parametrize("stage", ["auto", "host"])
def test_in_place_mutation_after_return_does_not_reach_the_snapshot(tmp_path, stage):
    src = {k: torch.from_numpy(v) for k, v in _arrays(1).items()}
    expected = {k: v.clone() for k, v in src.items()}
    counter = torch.zeros(1, dtype=torch.int64)
    pending = Snapshot.async_take(
        str(tmp_path / "snap"), {"m": StateDict(src, counter=counter)}, stage=stage
    )
    # Mutate at once, in place, as an optimizer step would.
    for v in src.values():
        v.add_(1)
    counter.add_(5)
    snapshot = pending.wait()
    target = StateDict({k: torch.zeros_like(v) for k, v in src.items()},
                       counter=torch.zeros(1, dtype=torch.int64))
    snapshot.restore({"m": target})
    for k, v in expected.items():
        assert torch.equal(target[k], v), k
    assert int(target["counter"]) == 0


def test_done_and_wait_are_idempotent(tmp_path):
    pending = Snapshot.async_take(str(tmp_path / "snap"), {"m": StateDict(x=torch.ones(4))})
    first = pending.wait()
    assert pending.done()
    assert pending.wait() is first and pending.done()


class _BlockingFS(FSStoragePlugin):
    """An fs plugin whose payload writes wait for ``release`` (or fail)."""

    release = threading.Event()
    fail = False

    async def write(self, io_req):
        if not io_req.path.startswith("."):
            if self.fail:
                raise OSError("disk on fire")
            while not self.release.is_set():
                await asyncio.sleep(0.01)
        await super().write(io_req)


@pytest.fixture
def blocking_storage(monkeypatch):
    _BlockingFS.release = threading.Event()
    _BlockingFS.fail = False
    monkeypatch.setenv("TPUSNAPSHOT_STORAGE_RETRIES", "0")
    monkeypatch.setattr(
        snapshot_mod, "url_to_storage_plugin",
        lambda path: RetryingStoragePlugin(_BlockingFS(root=path)),
    )
    yield _BlockingFS
    _BlockingFS.release.set()


def test_drain_error_surfaces_at_wait(tmp_path, blocking_storage):
    blocking_storage.fail = True
    pending = Snapshot.async_take(str(tmp_path / "snap"), {"m": StateDict(x=torch.ones(4))})
    with pytest.raises(OSError, match="disk on fire"):
        pending.wait()
    assert pending.done()
    assert not (tmp_path / "snap" / ".snapshot_metadata").exists()


def test_bounded_wait_names_the_stuck_phase(tmp_path, blocking_storage):
    pending = Snapshot.async_take(str(tmp_path / "snap"), {"m": StateDict(x=torch.ones(4))})
    with pytest.raises(TimeoutError, match="stuck in phase: storage writes"):
        pending.wait(timeout_s=0.2)
    assert not pending.done()
    blocking_storage.release.set()
    target = StateDict(x=torch.zeros(4))
    pending.wait(timeout_s=60).restore({"m": target})
    assert torch.equal(target["x"], torch.ones(4))


def test_stage_is_validated(tmp_path):
    with pytest.raises(ValueError, match="stage must be"):
        Snapshot.async_take(str(tmp_path / "snap"), {"m": StateDict()}, stage="disk")


def test_positional_arguments_follow_jax(tmp_path):
    """async_take(path, app_state, coord, replicated) and
    async_save(step, app_state, replicated) as in the JAX package; the
    options after them are keyword-only."""
    path = str(tmp_path / "snap")
    Snapshot.async_take(path, {"m": StateDict(x=torch.ones(4))}, None, ["**"]).wait()
    assert Snapshot(path).get_manifest()["0/m/x"].replicated
    mgr = CheckpointManager(str(tmp_path / "run"))
    mgr.async_save(1, {"m": StateDict(x=torch.ones(4))}, ["**"]).wait()
    assert Snapshot(str(tmp_path / "run" / "step-1")).get_manifest()["0/m/x"].replicated
    with pytest.raises(TypeError):
        Snapshot.async_take(path, {"m": StateDict()}, None, None, "host")
    with pytest.raises(TypeError):
        mgr.async_save(2, {"m": StateDict()}, None, "host")


@pytest.mark.parametrize("direction", ["port->jax", "jax->port"])
def test_async_snapshots_cross_packages_bit_exact(tmp_path, direction):
    src = _arrays(2)
    path = str(tmp_path / "snap")
    if direction == "port->jax":
        Snapshot.async_take(
            path, {"m": StateDict({k: torch.from_numpy(v) for k, v in src.items()})}
        ).wait()
        target = jsnap.StateDict({k: np.zeros_like(v) for k, v in src.items()})
        jsnap.Snapshot(path).restore({"m": target})
    else:
        # 8-byte dtypes go in as numpy arrays: JAX keeps 64-bit values
        # only on the host (x64 is off).
        jsnap.Snapshot.async_take(
            path,
            {"m": jsnap.StateDict(
                {k: v if v.itemsize == 8 else jnp.asarray(v) for k, v in src.items()}
            )},
        ).wait()
        target = StateDict({k: torch.zeros(v.shape, dtype=getattr(torch, v.dtype.name))
                            for k, v in src.items()})
        Snapshot(path).restore({"m": target})
    for k, v in src.items():
        assert np.asarray(target[k]).tobytes() == v.tobytes(), k
